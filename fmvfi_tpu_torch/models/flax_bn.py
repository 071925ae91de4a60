"""flax's BatchNorm arithmetic on an `nn.BatchNorm2d`'s parameters and
buffers, for the modules that must match flax's train mode (PhaseNet's
blocks, the critics of models/discriminator.py).

flax normalizes by the batch mean and the biased batch variance E[x^2] -
E[x]^2 (clipped at 0), kept differentiable, and moves the running
statistics toward them with momentum 0.9 (running <- 0.9 * running + 0.1 *
batch).  `F.batch_norm` would move `running_var` toward the unbiased
variance, so the statistics are computed and moved here by hand.

Inside a data-parallel step (parallel/dp.py) the train-mode moments are the
global batch's: the per-channel sums of x and x^2 and the element count are
summed over the processes (differentiably) before the division.

A bfloat16 `x` is normalized as flax's BatchNorm(dtype=...)
normalizes it: the statistics and the normalization in float32 from x,
(x - mean) * (rsqrt(var + eps) * scale) + bias, rounded back to x's dtype
once, at the end.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import dp

BN_MOMENTUM = 0.9  # flax's convention: running <- 0.9 * running + 0.1 * batch


def normalize(x: torch.Tensor, bn: nn.BatchNorm2d, train: bool,
              move: bool = False) -> torch.Tensor:
    """flax's BatchNorm of NCHW `x` with `bn`'s scale, bias and epsilon: the
    batch moments over every axis but the channels with `train` (moving the
    running statistics toward them only when `move`), else the running
    statistics."""
    if x.dtype == torch.bfloat16:
        return _normalize(x.float(), bn, train, move, flax_order=True).to(x.dtype)
    return _normalize(x, bn, train, move)


def _normalize(x: torch.Tensor, bn: nn.BatchNorm2d, train: bool, move: bool,
               flax_order: bool = False) -> torch.Tensor:
    if not train:
        if flax_order:  # F.batch_norm folds the mean into the bias: another rounding
            scale = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
            return ((x - bn.running_mean[:, None, None]) * scale[:, None, None]
                    + bn.bias[:, None, None])
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0,
                            bn.eps)
    dims = (0, 2, 3)
    if dp.world_size() > 1:
        c = x.shape[1]
        sums = dp.global_sum(torch.cat([x.sum(dim=dims), (x * x).sum(dim=dims),
                                        x.new_full((1,), x.numel() // c)]))
        mean, mean2 = sums[:c] / sums[2 * c], sums[c : 2 * c] / sums[2 * c]
    else:
        mean, mean2 = x.mean(dim=dims), (x * x).mean(dim=dims)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    if move:
        with torch.no_grad():
            bn.running_mean.mul_(BN_MOMENTUM).add_((1.0 - BN_MOMENTUM) * mean)
            bn.running_var.mul_(BN_MOMENTUM).add_((1.0 - BN_MOMENTUM) * var)
    scale = torch.rsqrt(var + bn.eps) * bn.weight
    return (x - mean[:, None, None]) * scale[:, None, None] + bn.bias[:, None, None]
