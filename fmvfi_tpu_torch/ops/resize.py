"""Bilinear resizing and pooling (port of fmvfi_tpu/ops/resize.py).

The reference mixes both bilinear corner conventions: align_corners=False
(PhaseNet level upsampling, the FusionNet decoder) and align_corners=True
(the AdaCoF U-Net and head tails); torch's own interpolation implements both
exactly as the JAX package's separable gather + lerp does.

Layout: NCHW; every function resizes or pools the last two axes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, out_hw, *, align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of (B, C, H, W) to (out_h, out_w)."""
    out_hw = (int(out_hw[0]), int(out_hw[1]))
    if tuple(x.shape[-2:]) == out_hw:
        return x
    return F.interpolate(x, size=out_hw, mode="bilinear", align_corners=align_corners)


def upsample2x(x: torch.Tensor, *, align_corners: bool) -> torch.Tensor:
    return resize_bilinear(x, (x.shape[-2] * 2, x.shape[-1] * 2), align_corners=align_corners)


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 average pooling over (B, C, H, W)."""
    return F.avg_pool2d(x, 2)


def max_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 max pooling over (B, C, H, W)."""
    return F.max_pool2d(x, 2)
