"""Bilinear resizing and pooling (port of fmvfi_tpu/ops/resize.py).

The reference mixes both bilinear corner conventions: align_corners=False
(PhaseNet level upsampling, the FusionNet decoder) and align_corners=True
(the AdaCoF U-Net and head tails); torch's own interpolation implements both
exactly as the JAX package's separable gather + lerp does.

A bfloat16 input is resized as the JAX package resizes it in that dtype: one axis at a time (height, then width), each a contraction with
the interpolation weights rounded to the input's dtype, accumulated in
float32 and rounded back after each axis.  Float32 and float64 take
`F.interpolate`.

Layout: NCHW; every function resizes or pools the last two axes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

def _axis_weights(n_in: int, n_out: int, align_corners: bool):
    """(i0, i1, m0, m1) of one axis: output j reads i0[j] with weight m0[j]
    and i1[j] with m1[j], float32, as the JAX package's banded interpolation
    matrix holds them (where i0 == i1 the two weights meet in one entry)."""
    dst = np.arange(n_out, dtype=np.float64)
    if align_corners:
        src = np.zeros(1) if n_out == 1 else dst * (n_in - 1) / (n_out - 1)
    else:
        src = np.clip((dst + 0.5) * (n_in / n_out) - 0.5, 0.0, None)
    i0 = np.clip(np.floor(src).astype(np.int64), 0, n_in - 1)
    i1 = np.minimum(i0 + 1, n_in - 1)
    m1 = (src - i0).astype(np.float32)
    m0 = np.float32(1.0) - m1
    same = i0 == i1
    m0[same] += m1[same]
    m1[same] = 0.0
    return i0, i1, m0, m1


@functools.lru_cache(maxsize=None)
def _axis_tensors(n_in: int, n_out: int, align_corners: bool, device: torch.device,
                  dtype: torch.dtype):
    """_axis_weights on `device`, the weights rounded to `dtype` and held in
    float32; cached, since a copy to the card per call would make the host
    wait for it."""
    i0, i1, m0, m1 = _axis_weights(n_in, n_out, align_corners)
    return tuple(torch.from_numpy(i).to(device) for i in (i0, i1)) + tuple(
        torch.from_numpy(m).to(device, dtype).float() for m in (m0, m1))


def _resize_axis_bf16(x: torch.Tensor, dim: int, n_out: int, align_corners: bool):
    """Resize dimension `dim` of a bfloat16 `x` to n_out: the weights
    rounded to x's dtype, the two-tap sum in float32, the result in x's dtype."""
    n_in = x.shape[dim]
    if n_in == n_out:
        return x
    i0, i1, m0, m1 = _axis_tensors(n_in, n_out, align_corners, x.device, x.dtype)
    shape = [1] * x.dim()
    shape[dim] = n_out
    xf = x.float()
    out = xf.index_select(dim, i0) * m0.view(shape) + xf.index_select(dim, i1) * m1.view(shape)
    return out.to(x.dtype)


def resize_bilinear(x: torch.Tensor, out_hw, *, align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of (B, C, H, W) to (out_h, out_w), in x's dtype."""
    out_hw = (int(out_hw[0]), int(out_hw[1]))
    if tuple(x.shape[-2:]) == out_hw:
        return x
    if x.dtype == torch.bfloat16:
        x = _resize_axis_bf16(x, x.dim() - 2, out_hw[0], align_corners)
        return _resize_axis_bf16(x, x.dim() - 1, out_hw[1], align_corners)
    return F.interpolate(x, size=out_hw, mode="bilinear", align_corners=align_corners)


def upsample2x(x: torch.Tensor, *, align_corners: bool) -> torch.Tensor:
    return resize_bilinear(x, (x.shape[-2] * 2, x.shape[-1] * 2), align_corners=align_corners)


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 average pooling over (B, C, H, W)."""
    return F.avg_pool2d(x, 2)


def max_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 max pooling over (B, C, H, W)."""
    return F.max_pool2d(x, 2)
