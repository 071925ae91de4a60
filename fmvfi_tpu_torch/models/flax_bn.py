"""flax's BatchNorm arithmetic on an `nn.BatchNorm2d`'s parameters and
buffers, for the modules that must match flax's train mode (PhaseNet's
blocks, the critics of models/discriminator.py).

flax normalizes by the batch mean and the biased batch variance E[x^2] -
E[x]^2 (clipped at 0), kept differentiable, and moves the running
statistics toward them with momentum 0.9 (running <- 0.9 * running + 0.1 *
batch).  `F.batch_norm` would move `running_var` toward the unbiased
variance, so the statistics are computed and moved here by hand.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BN_MOMENTUM = 0.9  # flax's convention: running <- 0.9 * running + 0.1 * batch


def normalize(x: torch.Tensor, bn: nn.BatchNorm2d, train: bool,
              move: bool = False) -> torch.Tensor:
    """flax's BatchNorm of NCHW `x` with `bn`'s scale, bias and epsilon: the
    batch moments over every axis but the channels with `train` (moving the
    running statistics toward them only when `move`), else the running
    statistics."""
    if not train:
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0,
                            bn.eps)
    dims = (0, 2, 3)
    mean = x.mean(dim=dims)
    var = torch.clamp((x * x).mean(dim=dims) - mean * mean, min=0.0)
    if move:
        with torch.no_grad():
            bn.running_mean.mul_(BN_MOMENTUM).add_((1.0 - BN_MOMENTUM) * mean)
            bn.running_var.mul_(BN_MOMENTUM).add_((1.0 - BN_MOMENTUM) * var)
    scale = torch.rsqrt(var + bn.eps) * bn.weight
    return (x - mean[:, None, None]) * scale[:, None, None] + bn.bias[:, None, None]
