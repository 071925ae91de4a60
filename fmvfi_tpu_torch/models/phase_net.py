"""PhaseNet: coarse-to-fine phase/amplitude prediction over pyramid levels
(port of fmvfi_tpu/models/phase_net.py).

- `PhaseNetBlock`: reflect-padded conv -> BN -> ELU -> conv -> ELU feature
  head, plus a 1x1 conv -> tanh prediction head.  BN uses the running
  statistics unless the call passes train=True (the module's own
  train/eval mode does not matter); in train mode it follows flax's
  BatchNorm(momentum=0.9).
- `PhaseNetCore(num_img)`: 8 blocks; blocks 0..2 are 1x1, 3..7 are 3x3;
  level idx uses block min(idx+1, 7), so one weight set serves any pyramid
  height.  Level 0 predicts an alpha-blend of the first two frames'
  low-res residuals; each level predicts `nbands` phases plus beta-weights
  that blend the first two frames' amplitudes.  With num_img=3 (the two
  frames and AdaCoF's prediction) a second blend mixes the third input
  into both.
- Normalization state is an explicit `NormState` value.

The network runs per Lab channel: the batch axis is B*3, the channel axis
carries the frames' band stacks ([f0 b0..b3, f1 b0..b3, ...]).
Layout: NCHW.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.decomp import Decomp
from ..ops.resize import resize_bilinear
from . import flax_bn
from .conv import Conv2d, upcast


class PhaseNetBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, pred_out: int, kernel: int):
        super().__init__()
        self.pad = kernel // 2
        self.conv1 = Conv2d(c_in, c_out, kernel)
        self.bn = nn.BatchNorm2d(c_out, eps=1e-5)
        self.conv2 = Conv2d(c_out, c_out, kernel)
        self.pred = Conv2d(c_out, pred_out, 1)

    def _rpad(self, x):
        p = self.pad
        return F.pad(x, (p, p, p, p), mode="reflect") if p else x

    def forward(self, x: torch.Tensor, train: bool = False, compute_dtype=None):
        # train: the batch moments, moving the running statistics; else the
        # running statistics, whatever the module's mode.  compute_dtype:
        # the block runs in it (BN included, as flax's BatchNorm(dtype=...))
        # and returns it
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        x = F.elu(flax_bn.normalize(self.conv1(self._rpad(x)), self.bn, train, move=train))
        feat = F.elu(self.conv2(self._rpad(x)))
        return feat, torch.tanh(self.pred(feat))


class NormState(NamedTuple):
    """Per-sample normalizers: max_amps coarse-first, each (B,1,1,1);
    max_low (B,1,1,1)."""

    max_amps: Tuple[torch.Tensor, ...]
    max_low: torch.Tensor


def normalize_inputs(low, phases: Sequence[torch.Tensor], amps: Sequence[torch.Tensor], eps: float = 1e-8):
    """Amplitudes / per-sample max, phases / pi, low / per-sample max.
    Inputs NCHW, levels coarse-first."""
    max_amps = tuple(torch.amax(a, dim=(1, 2, 3), keepdim=True) + eps for a in amps)
    amps_n = [a / m for a, m in zip(amps, max_amps)]
    phases_n = [p / math.pi for p in phases]
    max_low = torch.amax(low, dim=(1, 2, 3), keepdim=True) + eps
    return low / max_low, phases_n, amps_n, NormState(max_amps, max_low)


class PhaseNetCore(nn.Module):
    """The 8-block PhaseNet over `num_img` input frames: 2 (the two frames),
    3 (and AdaCoF's prediction) or 4 (and both AdaCoF-warped frames)."""

    def __init__(self, num_img: int = 2):
        super().__init__()
        if num_img not in (2, 3, 4):
            raise ValueError(f"num_img must be 2, 3 or 4, got {num_img}")
        self.num_img = num_img
        self.nbands = nbands = 4
        width = 64
        bands = num_img * nbands  # the input frames' bands
        # (pred_out, kernel) per block, as the JAX module's specs
        if num_img == 3:
            specs = [(2, 1), (12, 1), (12, 1)] + [(12, 3)] * 5
        else:
            specs = [(1, 1), (8, 1), (8, 1)] + [(8, 3)] * 5
        # block 0 sees the low residuals; block i >= 1 the resized features,
        # the level's phases and amplitudes and block i-1's prediction
        c_in = [num_img] + [width + 2 * bands + specs[i - 1][0] for i in range(1, len(specs))]
        self.blocks = nn.ModuleList(
            PhaseNetBlock(ci, width, pred_out, k) for ci, (pred_out, k) in zip(c_in, specs)
        )

    def init_params(self, generator: torch.Generator) -> "PhaseNetCore":
        """Seeded init: conv weights and biases uniform in +-1/sqrt(fan_in)
        (torch's default bounds), BN at identity with running stats 0/1."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    bound = 1.0 / math.sqrt(m.weight[0].numel())
                    for p in (m.weight, m.bias):
                        p.copy_(torch.rand(p.shape, generator=generator) * 2 * bound - bound)
                elif isinstance(m, nn.BatchNorm2d):
                    m.reset_parameters()
        return self

    def forward(
        self,
        low,
        phases: Sequence[torch.Tensor],
        amps: Sequence[torch.Tensor],
        m: Optional[int] = None,
        train: bool = False,
        compute_dtype=None,
    ):
        """Normalized inputs, levels coarse-first (ops.decomp.concat_for_net
        + normalize_inputs).  `m` predicts only the m coarsest levels (all
        by default); `train` normalizes with batch statistics and updates
        the running ones, once per block call (block 7 serves every level
        from the 7th on).  Returns (low_pred (B,1,h,w), phase_preds,
        amp_preds), per level (B, nbands, h, w), coarse-first.

        `compute_dtype` (bfloat16): the blocks run in it and the features and
        predictions stay in it between levels; each level's phases and
        amplitudes are cast into its block, while the blends read the
        float32 inputs and the predictions cast to float32, whose dtype the
        outputs have."""
        nb = self.nbands
        three = self.num_img == 3
        cdt = compute_dtype
        feat, pred = self.blocks[0](low, train, cdt)
        predf = upcast(pred)
        alpha = (predf[:, 0:1] + 1.0) / 2.0
        low_pred = alpha * low[:, 0:1] + (1.0 - alpha) * low[:, 1:2]
        if three:
            fusion_alpha = (predf[:, 1:2] + 1.0) / 2.0
            low_pred = fusion_alpha * low_pred + (1.0 - fusion_alpha) * low[:, 2:3]

        phase_preds: List[torch.Tensor] = []
        amp_preds: List[torch.Tensor] = []
        for idx in range(len(phases) if m is None else m):
            hw = phases[idx].shape[-2:]
            feat_r = resize_bilinear(feat, hw, align_corners=False)
            pred_r = resize_bilinear(pred, hw, align_corners=False)
            pin, ain = phases[idx], amps[idx]
            if cdt is not None:
                pin, ain = pin.to(cdt), ain.to(cdt)
            x = torch.cat([feat_r, pin, ain, pred_r], dim=1)
            feat, pred = self.blocks[min(idx + 1, len(self.blocks) - 1)](x, train, cdt)
            predf = upcast(pred)
            a = amps[idx]
            beta = (predf[:, nb : 2 * nb] + 1.0) / 2.0
            amp = beta * a[:, nb : 2 * nb] + (1.0 - beta) * a[:, 0:nb]
            if three:
                fusion_beta = (predf[:, 2 * nb : 3 * nb] + 1.0) / 2.0
                amp = fusion_beta * amp + (1.0 - fusion_beta) * a[:, 2 * nb : 3 * nb]
            phase_preds.append(predf[:, 0:nb])
            amp_preds.append(amp)
        return low_pred, phase_preds, amp_preds


def predictions_to_decomp(
    low_pred, phase_preds, amp_preds, norm: NormState, high, total_levels: Optional[int] = None
) -> Decomp:
    """Denormalize the net's coarse-first predictions and repack them into a
    fine-first Decomp; `high` is the highpass residual to carry.
    `total_levels`, the pyramid's band levels, raises when fewer were
    predicted: reconstruction needs them all, so a caller that predicts
    fewer exchanges the missing levels in (ops.decomp.exchange_levels)
    from a full decomposition instead."""
    if total_levels is not None and len(phase_preds) < total_levels:
        raise ValueError(
            "predict fewer levels than the pyramid has: exchange_levels() the "
            "missing ones before reconstruction (hierarchical training)"
        )
    phase_out = [p * math.pi for p in phase_preds]
    amp_out = [a * s for a, s in zip(amp_preds, norm.max_amps)]
    low = (low_pred * norm.max_low)[:, 0]
    return Decomp(
        high=high, low=low, phase=tuple(phase_out[::-1]), amplitude=tuple(amp_out[::-1])
    )
