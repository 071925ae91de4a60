"""AdaCoF deformable warping, plain PyTorch (port of fmvfi_tpu/ops/adacof.py).

  out[b, c, i, j] = sum_t W[b,t,i,j] * bilinear(x[b, c], i + (t // F)*d + alpha,
                                                        j + (t % F)*d + beta)

with the reference CUDA module's corner rule: integer part by truncation
toward zero, fraction alpha - trunc(alpha) taken before clamping, and each of
the two corner rows / columns clamped to the image separately.  The input is
pre-padded: H_in = H + (F-1)*d.

`adacof_warp` is the CPU path and the plain version the CUDA kernel K1
(ops/adacof_cuda.py) is held against; `adacof_warp_field_grads` is the same
for the backward kernel K2.  With `max_offset` set, offsets are
clamped to [-max_offset, max_offset] first (K1's contract); with None the
warp is unclamped, as the JAX package runs it off the TPU.

Layout: NCHW images, fields (B, F*F, H, W).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def check_warp_shapes(x, weight, offset_i, offset_j, dilation):
    """Validate the warp's shape contract; return (F, H, W)."""
    if x.dim() != 4 or weight.dim() != 4:
        raise ValueError(f"expected 4-D x and fields, got {x.shape}, {weight.shape}")
    if offset_i.shape != weight.shape or offset_j.shape != weight.shape:
        raise ValueError(
            f"field shapes differ: {weight.shape}, {offset_i.shape}, {offset_j.shape}"
        )
    b, c, h_in, w_in = x.shape
    bf, f2, h, w = weight.shape
    k = math.isqrt(f2)
    if k * k != f2:
        raise ValueError(f"tap axis {f2} is not a square")
    if bf != b or h_in != h + (k - 1) * dilation or w_in != w + (k - 1) * dilation:
        raise ValueError(
            f"x {tuple(x.shape)} is not fields {tuple(weight.shape)} padded by "
            f"(F-1)*d = {(k - 1) * dilation}"
        )
    return k, h, w


def adacof_warp(
    x: torch.Tensor,
    weight: torch.Tensor,
    offset_i: torch.Tensor,
    offset_j: torch.Tensor,
    dilation: int = 1,
    max_offset: float | None = None,
) -> torch.Tensor:
    """Plain AdaCoF warp.  x (B, C, H_in, W_in); fields (B, F*F, H, W);
    returns (B, C, H, W)."""
    k, h, w = check_warp_shapes(x, weight, offset_i, offset_j, dilation)
    b, c, h_in, w_in = x.shape
    if max_offset is not None:
        r = float(max_offset)
        offset_i = offset_i.clamp(-r, r)
        offset_j = offset_j.clamp(-r, r)
    xf = x.reshape(b, c, h_in * w_in)
    ii = torch.arange(h, device=x.device).view(1, h, 1)
    jj = torch.arange(w, device=x.device).view(1, 1, w)

    def gather(iy, jx):
        idx = (iy * w_in + jx).reshape(b, 1, h * w).expand(b, c, h * w)
        return torch.gather(xf, 2, idx).reshape(b, c, h, w)

    acc = torch.zeros((b, c, h, w), dtype=x.dtype, device=x.device)
    for t in range(k * k):
        alpha = offset_i[:, t]
        beta = offset_j[:, t]
        a_int = torch.trunc(alpha)
        b_int = torch.trunc(beta)
        fi = (alpha - a_int).unsqueeze(1)
        fj = (beta - b_int).unsqueeze(1)
        i0 = ii + (t // k) * dilation + a_int.long()
        j0 = jj + (t % k) * dilation + b_int.long()
        i0c = i0.clamp(0, h_in - 1)
        i1c = (i0 + 1).clamp(0, h_in - 1)
        j0c = j0.clamp(0, w_in - 1)
        j1c = (j0 + 1).clamp(0, w_in - 1)
        sample = (
            gather(i0c, j0c) * ((1.0 - fi) * (1.0 - fj))
            + gather(i1c, j0c) * (fi * (1.0 - fj))
            + gather(i0c, j1c) * ((1.0 - fi) * fj)
            + gather(i1c, j1c) * (fi * fj)
        )
        acc = acc + weight[:, t : t + 1] * sample
    return acc


def adacof_warp_field_grads(
    x: torch.Tensor,
    weight: torch.Tensor,
    offset_i: torch.Tensor,
    offset_j: torch.Tensor,
    g: torch.Tensor,
    dilation: int = 1,
    max_offset: float | None = None,
):
    """Field gradients (dW, dalpha, dbeta) of the plain warp for the output
    cotangent g (B, C, H, W): autograd through `adacof_warp`, then the
    saturation mask of the clamped contract, dalpha and dbeta zero where
    |offset| >= max_offset (the clamp's own gradient lets |offset| == R
    through).  With max_offset=None: unclamped, no mask.

    The CPU path of the backward kernel K2 (ops/adacof_cuda.py) and the plain
    version it is held against."""
    with torch.enable_grad():
        fields = [t.detach().requires_grad_(True) for t in (weight, offset_i, offset_j)]
        out = adacof_warp(x.detach(), *fields, dilation, max_offset)
        dw, da, db = torch.autograd.grad(out, fields, g)
    if max_offset is not None:
        r = float(max_offset)
        da = da * (offset_i.abs() < r).to(da.dtype)
        db = db * (offset_j.abs() < r).to(db.dtype)
    return dw, da, db


def pad_replicate(x: torch.Tensor, pad: int) -> torch.Tensor:
    """ReplicationPad2d on NCHW."""
    if pad == 0:
        return x
    return F.pad(x, (pad, pad, pad, pad), mode="replicate")


def flow_stats(weight: torch.Tensor, offset_i: torch.Tensor, offset_j: torch.Tensor):
    """Weighted mean and variance of the per-pixel offset field over the tap
    axis: mean_c = sum_t W_t * off_c_t, var_c = sum_t W_t * (mean_c - off_c_t)^2.

    Fields (B, F*F, H, W); returns (mean, var), each (B, 2, H, W) with
    components (i, j)."""
    mi = torch.sum(weight * offset_i, dim=1)
    mj = torch.sum(weight * offset_j, dim=1)
    vi = torch.sum(weight * (mi.unsqueeze(1) - offset_i) ** 2, dim=1)
    vj = torch.sum(weight * (mj.unsqueeze(1) - offset_j) ** 2, dim=1)
    return torch.stack([mi, mj], dim=1), torch.stack([vi, vj], dim=1)
