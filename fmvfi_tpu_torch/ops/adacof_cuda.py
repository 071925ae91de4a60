"""K1, the AdaCoF warp forward as a hand-written CUDA kernel
(csrc/adacof_warp.cu), replacing the Pallas kernel
fmvfi_tpu/ops/adacof_pallas.py::_kernel.

`adacof_warp` takes the same arguments as the plain `ops.adacof.adacof_warp`
with offsets clamped to +-max_offset (None: unclamped).  A CUDA tensor goes
to the kernel or raises; a CPU tensor goes to the plain version.  Forward
only: the field gradients (the Pallas backward kernel, K2) come with the
training slice.
"""

from __future__ import annotations

import torch

from .. import _build
from .adacof import adacof_warp as adacof_warp_plain
from .adacof import check_warp_shapes

NAME = "adacof_warp_fwd"
SOURCE = "fmvfi_tpu_torch/csrc/adacof_warp.cu"
REPLACES = "fmvfi_tpu/ops/adacof_pallas.py:54"

launches = 0  # kernel launches since the last reset (set to 0 to reset)


def adacof_warp(
    x: torch.Tensor,
    weight: torch.Tensor,
    offset_i: torch.Tensor,
    offset_j: torch.Tensor,
    dilation: int = 1,
    max_offset: int | None = 48,
) -> torch.Tensor:
    """AdaCoF warp, offsets clamped to +-max_offset.  x (B, C, H_in, W_in)
    pre-padded by (F-1)*dilation; fields (B, F*F, H, W); returns (B, C, H, W)."""
    global launches
    tensors = (x, weight, offset_i, offset_j)
    if all(t.device.type == "cpu" for t in tensors):
        return adacof_warp_plain(x, weight, offset_i, offset_j, dilation, max_offset)
    if any(t.device != x.device for t in tensors) or x.device.type != "cuda":
        raise ValueError(
            f"K1 takes tensors on one CUDA device, got {[str(t.device) for t in tensors]}"
        )
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors[1:]):
        raise NotImplementedError(
            "K1 is forward only: the field gradients need the AdaCoF warp "
            "backward kernel K2 (fmvfi_tpu/ops/adacof_pallas.py::_bwd_kernel), "
            "which is not ported yet"
        )
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"K1 takes float32, got {[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("K1 takes contiguous tensors")
    k, h, w = check_warp_shapes(x, weight, offset_i, offset_j, dilation)
    b, c, h_in, w_in = x.shape
    r = -1 if max_offset is None else int(max_offset)
    if max_offset is not None and (r != max_offset or r < 0):
        raise ValueError(f"max_offset must be a non-negative integer or None, got {max_offset}")

    lib = _build.library()
    out = torch.empty((b, c, h, w), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.adacof_warp_fwd(
            x.data_ptr(), weight.data_ptr(), offset_i.data_ptr(),
            offset_j.data_ptr(), out.data_ptr(), stream,
            k, dilation, r, b, c, h, w, h_in, w_in,
        )
    if err != 0:
        raise RuntimeError(f"{NAME} launch failed: cudaError {err}")
    launches += 1
    return out
