"""GAN critics for the adversarial loss terms (port of
fmvfi_tpu/models/discriminator.py), NCHW.

- `_Trunk`: 8 bias-free 3x3 conv blocks (64 -> 512 channels, stride 2 on
  blocks 1, 3, 5 and 7), each with flax's BatchNorm when `use_bn`, then
  LeakyReLU(0.2); the features flattened in (h, w, c) order (the
  activations are permuted to NHWC before the flatten, so fc1's weight is
  flax's kernel transposed); fc1 (1024) -> LeakyReLU -> fc2 (1).  fc1's
  width depends on the crop, so a critic is built for one `patch_size`.
- `Discriminator(gan_type)`: one frame; BN unless WGAN_GP.
- `FIDiscriminator`: a channel-concatenated frame pair, with BN.
- `TemporalDiscriminator`: a (prev, mid, next) triplet stacked on a time
  axis, two (2, 3, 3) 3-D convs with bias that collapse T=3 to 1, then
  the trunk without BN.

The stride-2 convs pad as flax's "SAME" does: a total of max((out - 1) *
2 + 3 - in, 0) split low = total // 2, high = the rest, so an even size
pads (0, 1) and an odd one (1, 1); `nn.Conv2d(padding=1)` would pad (1, 1)
always and shift every window by a pixel.

With `train=True` BN normalizes by the batch moments (flax's train mode)
and leaves the running statistics as they are unless the call also passes
`move_stats=True`; with `train=False` it uses the running statistics.
`make_critic(..., generator)` initialises as flax does: lecun_normal
kernels, zero biases, BN at identity.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from . import flax_bn

Patch = Union[int, Tuple[int, int]]
_SLOPE = 0.2
DEPTH = 7  # trunk blocks after the first


def _pair(patch: Patch) -> Tuple[int, int]:
    return tuple(patch) if isinstance(patch, (tuple, list)) else (patch, patch)


def _same_pads(size: int, stride: int, k: int = 3) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _blocks():
    """(c_out, stride) of the trunk's conv blocks, conv0 first."""
    c, out = 64, [(64, 1)]
    for i in range(DEPTH):
        if i % 2 == 1:
            c *= 2
        out.append((c, 1 if i % 2 == 1 else 2))
    return out


class _Trunk(nn.Module):
    def __init__(self, c_in: int, patch_size: Patch, use_bn: bool):
        super().__init__()
        self.use_bn = use_bn
        self.strides = []
        h, w = _pair(patch_size)
        for i, (c_out, stride) in enumerate(_blocks()):
            setattr(self, f"conv{i}", nn.Conv2d(c_in, c_out, 3, stride=stride, bias=False))
            if use_bn:
                setattr(self, f"bn{i}", nn.BatchNorm2d(c_out, eps=1e-5))
            self.strides.append(stride)
            h, w, c_in = -(-h // stride), -(-w // stride), c_out
        self.fc1 = nn.Linear(h * w * c_in, 1024)
        self.fc2 = nn.Linear(1024, 1)

    def forward(self, x: torch.Tensor, train: bool = False, move_stats: bool = False):
        for i, stride in enumerate(self.strides):
            ph, pw = _same_pads(x.shape[2], stride), _same_pads(x.shape[3], stride)
            x = getattr(self, f"conv{i}")(F.pad(x, (*pw, *ph)))
            if self.use_bn:
                x = flax_bn.normalize(x, getattr(self, f"bn{i}"), train, move=move_stats)
            x = F.leaky_relu(x, _SLOPE)
        x = x.permute(0, 2, 3, 1).flatten(1)  # flax's (h, w, c) order
        return self.fc2(F.leaky_relu(self.fc1(x), _SLOPE))


class Discriminator(nn.Module):
    """Single-frame critic: (B, 3, H, W) -> (B, 1)."""

    def __init__(self, gan_type: str = "GAN", patch_size: Patch = 96):
        super().__init__()
        self.trunk = _Trunk(3, patch_size, use_bn=gan_type != "WGAN_GP")

    def forward(self, x, train: bool = False, move_stats: bool = False):
        return self.trunk(x, train, move_stats)


class FIDiscriminator(nn.Module):
    """Critic over an (earlier, later) frame pair, channel-concatenated."""

    def __init__(self, patch_size: Patch = 96):
        super().__init__()
        self.trunk = _Trunk(6, patch_size, use_bn=True)

    def forward(self, f0, f1, train: bool = False, move_stats: bool = False):
        return self.trunk(torch.cat([f0, f1], 1), train, move_stats)


class TemporalDiscriminator(nn.Module):
    """Critic over a (prev, mid, next) triplet via two (2, 3, 3) 3-D convs
    that collapse the time axis, then the 2-D trunk (no BN)."""

    def __init__(self, patch_size: Patch = 96):
        super().__init__()
        self.conv3d_0 = nn.Conv3d(3, 64, (2, 3, 3), padding=(0, 1, 1))
        self.conv3d_1 = nn.Conv3d(64, 64, (2, 3, 3), padding=(0, 1, 1))
        self.trunk = _Trunk(64, patch_size, use_bn=False)

    def forward(self, f0, f1, f2, train: bool = False, move_stats: bool = False):
        x = torch.stack([f0, f1, f2], 2)  # (B, C, T=3, H, W)
        x = self.conv3d_1(self.conv3d_0(x))[:, :, 0]
        return self.trunk(x, train, move_stats)


def _truncated_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """A standard normal truncated to [-2, 2], by redrawing what falls out
    (nn.init.trunc_normal_ takes ~9 s for a 134 M-entry fc1 on a CPU)."""
    x = torch.randn(shape, generator=generator)
    out = x.abs() > 2
    while out.any():
        x[out] = torch.randn(int(out.sum()), generator=generator)
        out = x.abs() > 2
    return x


def flax_init(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """flax's default init from `generator`: every conv and linear kernel
    lecun_normal (a normal of std sqrt(1 / fan_in) / 0.8796, truncated at
    two of its stds), every bias zero; BN left at identity."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.Linear)):
                std = math.sqrt(1.0 / m.weight[0].numel()) / 0.87962566103423978
                m.weight.copy_(_truncated_normal(m.weight.shape, generator) * std)
                if m.bias is not None:
                    m.bias.zero_()
    return module


def make_critic(gan_type: str, patch_size: Patch,
                generator: Optional[torch.Generator] = None) -> nn.Module:
    """The critic of a gan type, built for crops of `patch_size`;
    initialised as flax does from `generator` when one is given."""
    if gan_type == "T_WGAN_GP":
        critic = TemporalDiscriminator(patch_size)
    elif gan_type == "FI_GAN":
        critic = FIDiscriminator(patch_size)
    else:
        critic = Discriminator(gan_type, patch_size)
    return critic if generator is None else flax_init(critic, generator)
