"""The device mesh and placing state and batches on it (port of
fmvfi_tpu/parallel/mesh.py).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over the processes of
the default group, one device each: a 1-D `data` mesh by default.  State is
replicated by broadcasting rank 0's values; a batch is sharded by giving
each process its rows.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from . import distributed
from .dp import _group


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("data",),
    shape: Optional[Sequence[int]] = None,
) -> DeviceMesh:
    """A mesh over the group's processes (formed by distributed.initialize
    if there is none yet): 1-D by default; axis_names with a shape for more
    axes, e.g. make_mesh(8, ("data", "spatial"), (4, 2)).  `n_devices` is
    the group's size (one device per process), the default.  The mesh's
    device type is the backend's: CUDA under NCCL, else the CPU."""
    distributed.initialize()
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"a mesh of {n} devices over {world} processes (one device each)")
    if len(axis_names) == 1:
        layout = torch.arange(n)
    else:
        if shape is None:
            raise ValueError(f"multi-axis mesh {tuple(axis_names)} needs an explicit shape")
        if int(torch.tensor(shape).prod()) != n:
            raise ValueError(f"mesh shape {tuple(shape)} != {n} devices")
        layout = torch.arange(n).reshape(tuple(shape))
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, layout, mesh_dim_names=tuple(axis_names))


def batch_sharding(mesh: DeviceMesh):
    """The placements of a batch: its leading axis over the data axis."""
    return tuple(Shard(0) if n == "data" else Replicate() for n in mesh.mesh_dim_names)


def replicated(mesh: DeviceMesh):
    """The placements of replicated state."""
    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def _tensors(tree):
    """The tensors of a module, an optimizer, a tensor, or a tuple, list or
    dict of these (a TrainState and its adversarial state included), in a
    fixed order: parameters and buffers, then optimizer state."""
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, torch.optim.Optimizer):
        return [v for s in tree.state.values() for v in s.values() if torch.is_tensor(v)]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    return []


def replicate(mesh: DeviceMesh, tree):
    """Make every process hold rank 0's values of `tree` (see `_tensors`),
    broadcast in place; returns `tree`."""
    group = _group(mesh)
    src = dist.get_global_rank(group, 0)
    with torch.no_grad():
        for t in _tensors(tree):
            dist.broadcast(t.data, src, group=group)
    return tree


def shard_batch(mesh: DeviceMesh, batch):
    """This process's rows of a global batch: an array or tensor with the
    batch leading, or a tuple or list of them."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(mesh, b) for b in batch)
    group = _group(mesh)
    n, i = dist.get_world_size(group), dist.get_rank(group)
    if batch.shape[0] % n:
        raise ValueError(f"batch {batch.shape[0]} not divisible by {n} processes")
    per = batch.shape[0] // n
    return batch[i * per : (i + 1) * per]
