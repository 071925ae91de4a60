"""Data-parallel training and inference steps (port of
fmvfi_tpu/parallel/dp.py).

In the JAX package `data_parallel` is the step jitted with the batch sharded
and the state replicated: XLA partitions one step on the global batch and
inserts the collectives.  Here each process runs the step on its own rows,
and the step's cross-sample work is made global by hand while
`data_parallel` has its group active:

- the parameter gradients are averaged over the processes before the
  optimizer (train/trainer.py's `_grads`, the critic's in
  train/adversarial.py), so the clip and the finite check see the global
  gradient and every process takes the same decision;
- train-mode batch statistics are the global batch's (models/flax_bn.py);
- a loss that normalizes over the batch normalizes over the global one
  (train/trainer.py's `fusion_loss` with loss_balance), and a random draw
  per sample is drawn for the global batch and sliced (the gradient
  penalty's epsilon, train/adversarial.py);
- the step's metrics are averaged over the processes.

The processes hold equal shares of the global batch, so that the mean of
the per-process means is the global mean.  Only all_reduce and broadcast
are used: gloo supports no other collective on CUDA tensors, and NCCL and
gloo then run the same code.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, NamedTuple, Optional

import torch
import torch.distributed as dist


class Context(NamedTuple):
    """The process group a data-parallel step runs over."""

    group: object
    rank: int
    world: int


_active: Optional[Context] = None


def _group(mesh):
    """The process group of the mesh's data axis."""
    return mesh.get_group("data") if mesh.ndim > 1 else mesh.get_group()


@contextmanager
def running(mesh):
    """Make the mesh's data axis the active context inside the block."""
    global _active
    group = _group(mesh)
    outer = _active
    _active = Context(group, dist.get_rank(group), dist.get_world_size(group))
    try:
        yield _active
    finally:
        _active = outer


def world_size() -> int:
    """The processes of the active context (1 outside one)."""
    return 1 if _active is None else _active.world


def global_batch(local: int):
    """(global batch size, this process's first row) for a local batch of
    `local` rows: (local, 0) outside a context."""
    if _active is None:
        return local, 0
    return local * _active.world, local * _active.rank


class _AllReduceSum(torch.autograd.Function):
    """Sum over the processes, differentiable: the gradient of a sum is the
    sum of the cotangents."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g.contiguous(), ctx.group), None


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the active context's processes (x itself outside one),
    differentiable."""
    if _active is None:
        return x
    return _AllReduceSum.apply(x, _active.group)


def global_mean_(tensors):
    """Average the tensors over the active context's processes, in place,
    in one collective; returns them (untouched outside a context)."""
    if _active is None or not tensors:
        return tensors
    with torch.no_grad():
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=_active.group)
        flat /= _active.world
        i = 0
        for t in tensors:
            t.copy_(flat[i : i + t.numel()].view_as(t))
            i += t.numel()
    return tensors


def data_parallel(step_fn: Callable, mesh) -> Callable:
    """Wrap `state, metrics = step_fn(state, batch)` into one step on the
    global batch: `batch` is this process's rows (distributed.
    local_batch_slice, or mesh.shard_batch of the global batch), the state
    replicated (mesh.replicate); the returned metrics are the global
    batch's, on every process."""

    def step(state, batch):
        with running(mesh):
            state, metrics = step_fn(state, batch)
            names = list(metrics)
            values = global_mean_([torch.as_tensor(metrics[k]).detach().float().reshape(1).clone()
                                   for k in names])
        return state, {k: v[0] for k, v in zip(names, values)}

    return step


def _tree_map(fn, tree):
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def data_parallel_apply(fn: Callable, mesh) -> Callable:
    """Wrap `out = fn(weights, *batched_args)` for batch-sharded inference:
    each process passes its rows, runs fn on them, and every process gets
    the global batch's output (tensors, or a tuple, list or dict of them
    with the batch leading), gathered by an all-reduce of zero-filled
    global buffers where each process wrote its rows.  The JAX package
    keeps one compiled executable per arity; the port compiles nothing."""

    def wrapper(weights, *args):
        with running(mesh) as ctx:
            out = fn(weights, *args)

            def gather(x):
                n, lo = global_batch(x.shape[0])
                buf = x.new_zeros((n,) + tuple(x.shape[1:]))
                buf[lo : lo + x.shape[0]] = x
                dist.all_reduce(buf, group=ctx.group)
                return buf

            return _tree_map(gather, out)

    return wrapper
