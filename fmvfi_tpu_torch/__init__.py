"""fmvfi_tpu_torch: the PyTorch/CUDA port of fmvfi_tpu (fusion video frame
interpolation: AdaCoF + PhaseNet + FusionNet).

Layout mirrors fmvfi_tpu (ops/, models/, pipeline/, utils/, eval/); the
hand-written CUDA kernels live in csrc/ and are built with nvcc at first use
(_build.py).  The package imports no JAX and nothing of fmvfi_tpu.
"""
