"""FusionNet: residual correction over a baseline composite frame
(port of fmvfi_tpu/models/fusion_net.py).

Encoder: 3 reflect-padded convs (5x5/5x5/3x3 -> 32/64/128), each ReLU'd and
kept as a skip before a 2x max-pool; a 3x3 bottleneck conv; decoder: bilinear
2x upsample (align_corners=False) of ReLU'd features, additive skip, conv
(5x5/5x5/1x1 -> 64/32/head).  Heads:
- variant 0: clamp(base + tanh(res), 0, 1); variant 1: the same on `phase`;
- variant 2: 6 channels, a per-pixel softmax selection over {base, adacof,
  phase} plus a tanh residual muted by (1 - the largest selection weight).

Layout: NCHW.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import max_pool2, upsample2x


def infer_variant(fusion_vars) -> int:
    """Head variant encoded in a weight tree: 2 when the final 1x1 conv emits
    6 channels, else 0 (variants 0 and 1 share a tree shape).  Takes a flax
    variable tree (nested dicts, HWIO kernels) or a FusionNet state dict."""
    if "dec2.weight" in fusion_vars:
        return 2 if fusion_vars["dec2.weight"].shape[0] == 6 else 0
    p = fusion_vars.get("params", fusion_vars)
    return 2 if p["dec2"]["kernel"].shape[-1] == 6 else 0


class _RConv(nn.Conv2d):
    """Conv with reflect padding of k//2 ('VALID' conv on the padded input)."""

    def __init__(self, c_in: int, c_out: int, k: int):
        super().__init__(c_in, c_out, k)
        self.pad = k // 2

    def forward(self, x):
        p = self.pad
        if p:
            x = F.pad(x, (p, p, p, p), mode="reflect")
        return super().forward(x)


class FusionNet(nn.Module):
    def __init__(self, uncertainty_maps: int = 3, variant: int = 0):
        super().__init__()
        if variant not in (0, 1, 2):
            raise ValueError(f"variant must be 0, 1 or 2, got {variant}")
        self.uncertainty_maps = uncertainty_maps
        self.variant = variant
        c_in = 15 + uncertainty_maps  # base, adacof, phase, frame1, frame2 (Lab)
        self.enc0 = _RConv(c_in, 32, 5)
        self.enc1 = _RConv(32, 64, 5)
        self.enc2 = _RConv(64, 128, 3)
        self.bottleneck = _RConv(128, 128, 3)
        self.dec0 = _RConv(128, 64, 5)
        self.dec1 = _RConv(64, 32, 5)
        self.dec2 = _RConv(32, 6 if variant == 2 else 3, 1)
        if variant == 2:
            # a zero head, as the JAX module initializes it: a fresh net
            # starts at the component mean with a zero residual
            nn.init.zeros_(self.dec2.weight)
            nn.init.zeros_(self.dec2.bias)

    def forward(self, base, adacof, phase, other, maps=None):
        """Images (B, 3, H, W); other (B, 6, H, W) = frame1 || frame2 (Lab);
        maps (B, uncertainty_maps, H, W) ordered [ada_unc, phase_unc,
        flow_var].  H and W must be divisible by 8."""
        parts = [base, adacof, phase, other]
        if self.uncertainty_maps:
            if maps is None or maps.shape[1] != self.uncertainty_maps:
                raise ValueError(f"expected {self.uncertainty_maps} uncertainty maps")
            parts.append(maps)
        x = torch.cat(parts, dim=1)

        skips = []
        for conv in (self.enc0, self.enc1, self.enc2):
            x = F.relu(conv(x))
            skips.append(x)
            x = max_pool2(x)
        x = self.bottleneck(x)
        for conv, s in zip((self.dec0, self.dec1, self.dec2), skips[::-1]):
            x = conv(upsample2x(F.relu(x), align_corners=False) + s)

        if self.variant == 2:
            wgt = torch.softmax(x[:, :3], dim=1)
            res = torch.tanh(x[:, 3:]) * (1.0 - torch.amax(wgt, dim=1, keepdim=True))
            out = wgt[:, 0:1] * base + wgt[:, 1:2] * adacof + wgt[:, 2:3] * phase + res
            return torch.clamp(out, 0.0, 1.0)
        res = torch.tanh(x)
        out = phase + res if self.variant == 1 else base + res
        return torch.clamp(out, 0.0, 1.0)
