"""Data parallelism over a process group (port of fmvfi_tpu/parallel/): one
process per GPU, collectives through torch.distributed (NCCL on CUDA, gloo
on the CPU).  `mesh` builds the device mesh and moves state and batches
onto it, `distributed` forms the process group and splits the global batch
between the processes, `dp` runs a training or inference step as one step
on the global batch.  Spatial sharding (fmvfi_tpu/parallel/spatial.py) is
not ported (ROADMAP Queue 1, item 20)."""
