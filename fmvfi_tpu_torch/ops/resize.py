"""Bilinear resizing and pooling (port of fmvfi_tpu/ops/resize.py).

The reference mixes both bilinear corner conventions: align_corners=False
(PhaseNet level upsampling, the FusionNet decoder) and align_corners=True
(the AdaCoF U-Net and head tails); torch's own interpolation implements both
exactly as the JAX package's separable gather + lerp does.

A bfloat16 input is resized as the JAX package resizes it in that dtype: one axis at a time (height, then width), each a contraction with
the interpolation weights rounded to the input's dtype, accumulated in
float32 and rounded back after each axis.  Float32 and float64 take
`F.interpolate`.

Under active spatial bands (parallel/spatial.py) `upsample2x`, `avg_pool2`
and `max_pool2` take a band of rows and give the band's rows of the whole
frame's result.  The pools are local (every band has an even row count at
every level).  A 2x upsample takes one halo row from each neighbouring band:
with align_corners=False the band is upsampled with its halo and cropped
(output row 2o + k of an input band starting at row o reads the same rows
with the same weights as on the whole frame: the map is translation-
invariant by even offsets); with align_corners=True output row g reads
input row g (n-1)/(2n-1) of the WHOLE frame's n rows, which no band can
reproduce as an image of its own, so the band's weights come from its
first row and the frame's height.

Layout: NCHW; every function resizes or pools the last two axes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel import spatial


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
    return _lerp(x.float(), dim, *_axis_tensors(n_in, n_out, align_corners, x.device,
                                                 x.dtype)).to(x.dtype)


def resize_bilinear(x: torch.Tensor, out_hw, *, align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of (B, C, H, W) to (out_h, out_w), in x's dtype."""
    out_hw = (int(out_hw[0]), int(out_hw[1]))
    if tuple(x.shape[-2:]) == out_hw:
        return x
    if x.dtype == torch.bfloat16:
        x = _resize_axis_bf16(x, x.dim() - 2, out_hw[0], align_corners)
        return _resize_axis_bf16(x, x.dim() - 1, out_hw[1], align_corners)
    return F.interpolate(x, size=out_hw, mode="bilinear", align_corners=align_corners)


def _aligned_axis(n_in: int, n_out: int, dtype: torch.dtype):
    """(i0, i1, m0, m1) of one align_corners=True axis as F.interpolate
    computes them in `dtype` (float32 for float32 input, float64 for
    float64): scale (n_in-1)/(n_out-1) and source dst * scale rounded to
    that type, trunc, the fraction clamped to [0, 1]."""
    t = np.float64 if dtype == torch.float64 else np.float32
    scale = t(n_in - 1) / t(n_out - 1) if n_out > 1 else t(0)
    src = scale * np.arange(n_out, dtype=t)
    i0 = np.minimum(src.astype(np.int64), n_in - 1)
    m1 = np.clip(src - i0.astype(t), 0, 1).astype(t)
    return i0, np.minimum(i0 + 1, n_in - 1), (t(1) - m1).astype(t), m1


@functools.lru_cache(maxsize=None)
def _aligned_tensors(n_in: int, lo: int, hi: int, shift: int, dtype: torch.dtype,
                     device: torch.device):
    """(i0 - shift, i1 - shift, m0, m1) of output entries [lo, hi) of the
    align_corners=True 2x upsample of an axis of n_in, on `device`: for a
    bfloat16 input the JAX package's weights rounded to bfloat16, held in
    float32 (resize_bilinear's), else F.interpolate's in `dtype`; cached."""
    if dtype == torch.bfloat16:
        i0, i1, m0, m1 = _axis_weights(n_in, 2 * n_in, True)
    else:
        i0, i1, m0, m1 = _aligned_axis(n_in, 2 * n_in, dtype)
    idx = (torch.from_numpy(np.ascontiguousarray(i[lo:hi] - shift)).to(device) for i in (i0, i1))
    wgt = (torch.from_numpy(np.ascontiguousarray(m[lo:hi])).to(device, dtype) for m in (m0, m1))
    if dtype == torch.bfloat16:
        wgt = (m.float() for m in wgt)
    return tuple(idx) + tuple(wgt)


def _lerp(x: torch.Tensor, dim: int, i0, i1, m0, m1) -> torch.Tensor:
    """x[i0] * m0 + x[i1] * m1 along `dim`."""
    shape = [1] * x.dim()
    shape[dim] = len(i0)
    return x.index_select(dim, i0) * m0.view(shape) + x.index_select(dim, i1) * m1.view(shape)


def _upsample_band_aligned(x: torch.Tensor, top: int, start: int, n: int, rows: int):
    """Output rows [2 start, 2 start + 2 rows) of the align_corners=True 2x
    upsample of a frame of n rows, from x, its rows from start - top on (a
    band with `top` halo rows above), in x's dtype as resize_bilinear
    computes the whole frame: bfloat16 axis by axis, each rounded, height
    first; float32 and float64 with F.interpolate's weights, width then
    height (float32: within rounding of F.interpolate, which may fuse the
    multiply-adds)."""
    dev, w = x.device, x.shape[-1]
    hdim, wdim = x.dim() - 2, x.dim() - 1
    band = _aligned_tensors(n, 2 * start, 2 * (start + rows), start - top, x.dtype, dev)
    if x.dtype == torch.bfloat16:
        y = _lerp(x.float(), hdim, *band).to(x.dtype)
        return _resize_axis_bf16(y, wdim, 2 * w, True)
    y = _lerp(x, wdim, *_aligned_tensors(w, 0, 2 * w, 0, x.dtype, dev))
    return _lerp(y, hdim, *band)


def upsample2x(x: torch.Tensor, *, align_corners: bool) -> torch.Tensor:
    bands = spatial.active()
    if bands is None:
        return resize_bilinear(x, (x.shape[-2] * 2, x.shape[-1] * 2),
                               align_corners=align_corners)
    rows = x.shape[-2]
    start, n = bands.at(rows)
    ext, top, _ = spatial.extend_rows(x, 1, 1, None)
    if align_corners:
        return _upsample_band_aligned(ext, top, start, n, rows)
    y = resize_bilinear(ext, (ext.shape[-2] * 2, x.shape[-1] * 2), align_corners=False)
    return y[..., 2 * top : 2 * (top + rows), :]


def _even_band(x: torch.Tensor) -> torch.Tensor:
    if spatial.active() is not None and x.shape[-2] % 2:
        raise ValueError(f"a band of {x.shape[-2]} rows does not pool: every band must have "
                         "an even row count at every level")
    return x


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 average pooling over (B, C, H, W)."""
    return F.avg_pool2d(_even_band(x), 2)


def max_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 max pooling over (B, C, H, W)."""
    return F.max_pool2d(_even_band(x), 2)
