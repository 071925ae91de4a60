"""Convolutions that compute in their input's dtype, as flax's
`nn.Conv(dtype=...)` does: the parameters stay float32 and are cast per call,
so that one module serves float32 requests, bfloat16 requests and training.

In bfloat16 the convolution takes operands rounded to bfloat16, accumulates
in float32 and rounds its result once, and the bias is added after that
rounding, in bfloat16, as flax adds it.  On CUDA that is cuDNN's bfloat16
convolution; on the CPU, where oneDNN's bfloat16 convolution does not
round as XLA's does, a float32 convolution of the rounded operands.  A float32 input takes `nn.Conv2d`'s
fused path unchanged.

Under active spatial bands (parallel/spatial.py) a zero-padded convolution
takes a band of rows and gives the band's rows of the whole frame's
output: the rows of its padding come from the neighbouring bands, zero rows
only at the frame's top and bottom.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import spatial


def upcast(x: torch.Tensor) -> torch.Tensor:
    """x in float32 if it is bfloat16, else x as it is (float32, or float64
    where a check runs a net in double precision)."""
    return x.float() if x.dtype == torch.bfloat16 else x


def _bf16(conv, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """conv(x, weight) of a bfloat16 x with the weight rounded to bfloat16,
    accumulated in float32, the result in bfloat16."""
    w = weight.to(x.dtype)
    if x.device.type == "cpu":
        return conv(x.float(), w.float()).to(x.dtype)
    return conv(x, w)


def _band_rows(x: torch.Tensor, pad: int) -> torch.Tensor:
    """x with `pad` halo rows above and below: a band's (zero rows at the
    frame's top and bottom) under active bands; else the zero rows of
    the padding itself."""
    if spatial.active() is not None:
        return spatial.extend_rows(x, pad, pad, "zeros")[0]
    return F.pad(x, (0, 0, pad, pad))


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        padding = self.padding
        if padding[0] and spatial.active() is not None:
            x, padding = _band_rows(x, padding[0]), (0, padding[1])
        conv = lambda a, w, b: F.conv2d(a, w, b, self.stride, padding, self.dilation, self.groups)
        if x.dtype == self.weight.dtype:
            return conv(x, self.weight, self.bias)
        y = _bf16(lambda a, w: conv(a, w, None), x, self.weight)
        return y + self.bias.to(x.dtype)[:, None, None]


class TapConv2d(Conv2d):
    """A 3x3 zero-padded Conv2d that, in bfloat16, sums its nine taps one at
    a time, each a 1x1 convolution rounded to bfloat16: the JAX package's
    tap-major head-tail convolution (fmvfi_tpu/models/adacof.py,
    `_conv3x3_tap_major`), nine contractions accumulated in the compute
    dtype.  Float32 is the plain convolution, the same sum."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__(c_in, c_out, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        h, wd = x.shape[-2:]
        xp = F.pad(_band_rows(x, 1), (1, 1, 0, 0))
        out = None
        for dy in range(3):
            for dx in range(3):
                term = _bf16(F.conv2d, xp[:, :, dy : dy + h, dx : dx + wd],
                             self.weight[:, :, dy : dy + 1, dx : dx + 1])
                out = term if out is None else out + term
        return out + self.bias.to(x.dtype)[:, None, None]
