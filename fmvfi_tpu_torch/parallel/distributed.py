"""The process group and the split of the global batch between processes
(port of fmvfi_tpu/parallel/distributed.py).

The JAX package runs one process per host over a global device mesh; the
port runs one process per GPU, joined by torch.distributed: NCCL when the
run is on CUDA, gloo on the CPU (or when asked for: gloo also reduces CUDA
tensors, which lets several processes share one card, where NCCL refuses
two ranks on one device).  Each process loads only its slice of the global
batch (`local_batch_slice`).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
    backend: Optional[str] = None,
) -> None:
    """Join (or form) the default process group; a no-op once it exists.

    - `coordinator_address` ("host:port"): the group of `num_processes`
      processes, this one being `process_id`, rendezvousing there.
    - else torchrun's environment (MASTER_ADDR, MASTER_PORT, RANK,
      WORLD_SIZE): the group it describes.
    - else a group of this one process, as the JAX package degrades to the
      local devices without a coordinator.
    `backend` defaults to NCCL when a card is present, else gloo.  On CUDA
    the process takes the card `local_device_ids[0]`, else LOCAL_RANK's
    (modulo the cards present), before the group forms."""
    if dist.is_initialized():
        return
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if torch.cuda.is_available():
        if local_device_ids:
            torch.cuda.set_device(int(local_device_ids[0]))
        elif "LOCAL_RANK" in os.environ:
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]) % torch.cuda.device_count())
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and process_id")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=int(num_processes), rank=int(process_id))
    elif all(k in os.environ for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")):
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0)


def process_index() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The processes in the group (1 without a group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def local_batch_slice(global_batch: int) -> Tuple[int, int]:
    """[start, stop) of the global batch this process loads."""
    n, i = process_count(), process_index()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} processes")
    per = global_batch // n
    return i * per, (i + 1) * per


def global_batch_array(mesh, local_batch) -> torch.Tensor:
    """This process's shard of a batch sharded over the mesh's data axis: its
    local rows as a tensor on the mesh's device (the process's card on a
    CUDA mesh).  The global batch is the ranks' shards in rank order."""
    x = torch.as_tensor(np.asarray(local_batch))
    if mesh.device_type == "cuda":
        return x.to(torch.device("cuda", torch.cuda.current_device()))
    return x
