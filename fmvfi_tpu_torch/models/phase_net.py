"""PhaseNet: coarse-to-fine phase/amplitude prediction over pyramid levels
(port of fmvfi_tpu/models/phase_net.py).

- `PhaseNetBlock`: reflect-padded conv -> eval-mode BN -> ELU -> conv -> ELU
  feature head, plus a 1x1 conv -> tanh prediction head.
- `PhaseNetCore`: 8 blocks; blocks 0..2 are 1x1, 3..7 are 3x3; level idx
  uses block min(idx+1, 7), so one weight set serves any pyramid height.
  Level 0 predicts an alpha-blend of the two low-res residuals; each level
  predicts `nbands` phases plus beta-weights that blend the two frames'
  amplitudes.
- Normalization state is an explicit `NormState` value.

The network runs per Lab channel: the batch axis is B*3, the channel axis
carries the frames' band stacks ([f0 b0..b3, f1 b0..b3] for num_img=2).
Layout: NCHW.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.decomp import Decomp
from ..ops.resize import resize_bilinear


class PhaseNetBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, pred_out: int, kernel: int):
        super().__init__()
        self.pad = kernel // 2
        self.conv1 = nn.Conv2d(c_in, c_out, kernel)
        self.bn = nn.BatchNorm2d(c_out, eps=1e-5)
        self.conv2 = nn.Conv2d(c_out, c_out, kernel)
        self.pred = nn.Conv2d(c_out, pred_out, 1)

    def _rpad(self, x):
        p = self.pad
        return F.pad(x, (p, p, p, p), mode="reflect") if p else x

    def forward(self, x: torch.Tensor):
        bn = self.bn  # eval-mode statistics whatever the module's mode
        x = self.conv1(self._rpad(x))
        x = F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0, bn.eps)
        x = F.elu(x)
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
    """The 8-block PhaseNet for two input frames."""

    def __init__(self):
        super().__init__()
        self.nbands = nbands = 4
        width = 64
        nb2 = 2 * nbands  # both frames' bands
        # (c_in, pred_out, kernel); block1 sees block0's 1-channel prediction
        specs = [(2, 1, 1), (width + 2 * nb2 + 1, nb2, 1), (width + 3 * nb2, nb2, 1)]
        specs += [(width + 3 * nb2, nb2, 3)] * 5
        self.blocks = nn.ModuleList(
            PhaseNetBlock(c_in, width, pred_out, k) for c_in, pred_out, k in specs
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

    def forward(self, low, phases: Sequence[torch.Tensor], amps: Sequence[torch.Tensor]):
        """Normalized inputs, levels coarse-first (ops.decomp.concat_for_net
        + normalize_inputs).  Returns (low_pred (B,1,h,w), phase_preds,
        amp_preds), per level (B, nbands, h, w), coarse-first."""
        nb = self.nbands
        feat, pred = self.blocks[0](low)
        alpha = (pred[:, 0:1] + 1.0) / 2.0
        low_pred = alpha * low[:, 0:1] + (1.0 - alpha) * low[:, 1:2]

        phase_preds: List[torch.Tensor] = []
        amp_preds: List[torch.Tensor] = []
        for idx in range(len(phases)):
            hw = phases[idx].shape[-2:]
            feat_r = resize_bilinear(feat, hw, align_corners=False)
            pred_r = resize_bilinear(pred, hw, align_corners=False)
            x = torch.cat([feat_r, phases[idx], amps[idx], pred_r], dim=1)
            feat, pred = self.blocks[min(idx + 1, len(self.blocks) - 1)](x)
            beta = (pred[:, nb : 2 * nb] + 1.0) / 2.0
            amp = beta * amps[idx][:, nb : 2 * nb] + (1.0 - beta) * amps[idx][:, 0:nb]
            phase_preds.append(pred[:, 0:nb])
            amp_preds.append(amp)
        return low_pred, phase_preds, amp_preds


def predictions_to_decomp(low_pred, phase_preds, amp_preds, norm: NormState, high) -> Decomp:
    """Denormalize the net's coarse-first predictions and repack them into a
    fine-first Decomp; `high` is the highpass residual to carry."""
    phase_out = [p * math.pi for p in phase_preds]
    amp_out = [a * s for a, s in zip(amp_preds, norm.max_amps)]
    low = (low_pred * norm.max_low)[:, 0]
    return Decomp(
        high=high, low=low, phase=tuple(phase_out[::-1]), amplitude=tuple(amp_out[::-1])
    )
