"""Data parallelism and spatial (height) sharding over a process group (port
of fmvfi_tpu/parallel/): one process per GPU, collectives through
torch.distributed (NCCL on CUDA, gloo on the CPU).  `mesh` builds the device
mesh and moves state and batches onto it, `distributed` forms the process
group and splits the global batch between the processes, `dp` runs a
training or inference step as one step on the global batch, `spatial`
serves frames split by rows over a mesh's spatial axis with hand-written
halo exchanges (serving only: the spatial trainers are ROADMAP Queue 1,
item 20b)."""
