"""Image quality metrics (port of fmvfi_tpu/eval/metrics.py): PSNR, SSIM
(11x11 gaussian window), SSD, L1 sum, mean difference, variance of the
difference, and `gradient_distance`, the documented stand-in for LPIPS
(`lpips_sub`).

Images are (..., H, W, C) tensors; every metric reduces the last three axes
and keeps the leading ones, so a batch (N, H, W, C) gives (N,) per-image
values, as the JAX package's vmapped metrics do.  The VGG LPIPS
(make_vgg_lpips) needs a vgg16 weights file and is not ported.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

_IMG = (-3, -2, -1)


def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    mse = torch.mean((a - b) ** 2, dim=_IMG)
    return 10.0 * torch.log10(data_range**2 / torch.clamp(mse, min=1e-12))


def ssd(a, b):
    return torch.sum((a - b) ** 2, dim=_IMG)


def l1(a, b):
    return torch.sum(torch.abs(a - b), dim=_IMG)


def mean_diff(a, b):
    return torch.mean(a - b, dim=_IMG)


def var_diff(a, b):
    return torch.var(a - b, dim=_IMG, correction=0)


@functools.lru_cache(maxsize=4)
def _ssim_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-0.5 * (x / sigma) ** 2)
    w = np.outer(g, g)
    return (w / w.sum()).astype(np.float32)


def _images(a: torch.Tensor):
    """(..., H, W, C) -> ((N, C, H, W), the leading shape)."""
    lead = a.shape[:-3]
    return a.reshape((-1,) + tuple(a.shape[-3:])).permute(0, 3, 1, 2), lead


def ssim(
    a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0, size: int = 11, sigma: float = 1.5
) -> torch.Tensor:
    """Mean SSIM per image (gaussian window, K1 = 0.01, K2 = 0.03, the Wang
    et al. formulation piq implements), over the valid window positions."""
    x, lead = _images(a)
    y, _ = _images(b)
    c = x.shape[1]
    win = torch.from_numpy(_ssim_window(size, sigma)).to(x.device, x.dtype)
    kern = win.expand(c, 1, size, size)

    def filt(t):  # depthwise valid conv
        return F.conv2d(t, kern, groups=c)

    mu_a, mu_b = filt(x), filt(y)
    mu_a2, mu_b2, mu_ab = mu_a**2, mu_b**2, mu_a * mu_b
    sig_a = filt(x * x) - mu_a2
    sig_b = filt(y * y) - mu_b2
    sig_ab = filt(x * y) - mu_ab
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    s = ((2 * mu_ab + c1) * (2 * sig_ab + c2)) / ((mu_a2 + mu_b2 + c1) * (sig_a + sig_b + c2))
    return s.mean(dim=(1, 2, 3)).reshape(lead)


def gradient_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The LPIPS stand-in (documented in the JAX package): the RMS difference
    of the luminance gradients.  Not the trained LPIPS metric."""

    def grads(x):
        y = x.mean(-1)
        return torch.stack(
            [y[..., 1:, :-1] - y[..., :-1, :-1], y[..., :-1, 1:] - y[..., :-1, :-1]], -1
        )

    return torch.sqrt(torch.mean((grads(a) - grads(b)) ** 2, dim=_IMG))


def all_metrics(pred: torch.Tensor, target: torch.Tensor, lpips_fn=None) -> dict:
    """The reference harness's metric vector per image: SSIM, lpips_sub,
    PSNR, SSD, L1, mean and variance of the difference.  `lpips_fn(pred,
    target)` on one (H, W, 3) image pair adds the `lpips_vgg` column."""
    out = {
        "ssim": ssim(pred, target),
        "lpips_sub": gradient_distance(pred, target),
        "psnr": psnr(pred, target),
        "ssd": ssd(pred, target),
        "l1": l1(pred, target),
        "mean_diff": mean_diff(pred, target),
        "var_diff": var_diff(pred, target),
    }
    if lpips_fn is not None:
        p, lead = _images(pred)
        t, _ = _images(target)
        vals = [lpips_fn(pi.permute(1, 2, 0), ti.permute(1, 2, 0)) for pi, ti in zip(p, t)]
        out["lpips_vgg"] = torch.stack([torch.as_tensor(v) for v in vals]).reshape(lead)
    return out
