"""RGB <-> CIELAB color transforms (port of fmvfi_tpu/ops/color.py).

sRGB D65, the formulas of skimage.color, with the reference's normalization
on top: L -> L/100, a,b -> (v + 128)/255, so all channels are ~[0, 1].

Layout: channels on axis -3, i.e. (..., 3, H, W) (NCHW).
"""

from __future__ import annotations

import numpy as np
import torch

# sRGB -> XYZ (D65), rows = X,Y,Z; identical to skimage.color.rgb2xyz.
_RGB2XYZ = np.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ],
    dtype=np.float32,
)
_XYZ2RGB = np.linalg.inv(_RGB2XYZ).astype(np.float32)

# D65 reference white (skimage's xyz_ref_white for illuminant D65, observer 2).
_WHITE = np.array([0.95047, 1.0, 1.08883], dtype=np.float32)

_EPS = 0.008856451679035631  # (6/29)**3
_KAPPA = 903.2962962962963  # (29/3)**3


def _srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    return torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def _linear_to_srgb(c: torch.Tensor) -> torch.Tensor:
    c = torch.clamp(c, 0.0, 1.0)
    safe = torch.clamp(c, min=1e-12)
    return torch.where(c <= 0.0031308, c * 12.92, 1.055 * safe ** (1.0 / 2.4) - 0.055)


def _mat3(c0, c1, c2, m: np.ndarray):
    """Rows of m applied to the channel planes as explicit multiply-adds
    (float32 constants, the JAX package's order of operations)."""
    return [
        float(m[r, 0]) * c0 + float(m[r, 1]) * c1 + float(m[r, 2]) * c2
        for r in range(3)
    ]


def _lab_f(t: torch.Tensor) -> torch.Tensor:
    safe = torch.clamp(t, min=1e-12)
    return torch.where(t > _EPS, safe ** (1.0 / 3.0), (_KAPPA * t + 16.0) / 116.0)


def _lab_f_inv(f: torch.Tensor) -> torch.Tensor:
    f3 = f**3
    return torch.where(f3 > _EPS, f3, (116.0 * f - 16.0) / _KAPPA)


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """sRGB in [0,1] -> normalized CIELAB.  Shape (..., 3, H, W)."""
    lin = _srgb_to_linear(rgb)
    x, y, z = _mat3(lin[..., 0, :, :], lin[..., 1, :, :], lin[..., 2, :, :], _RGB2XYZ)
    fx = _lab_f(x / float(_WHITE[0]))
    fy = _lab_f(y / float(_WHITE[1]))
    fz = _lab_f(z / float(_WHITE[2]))
    L = 116.0 * fy - 16.0
    a = 500.0 * (fx - fy)
    b = 200.0 * (fy - fz)
    return torch.stack([L / 100.0, (a + 128.0) / 255.0, (b + 128.0) / 255.0], dim=-3)


def lab_to_rgb(lab: torch.Tensor) -> torch.Tensor:
    """Normalized CIELAB -> sRGB in [0,1].  Shape (..., 3, H, W)."""
    L = lab[..., 0, :, :] * 100.0
    a = lab[..., 1, :, :] * 255.0 - 128.0
    b = lab[..., 2, :, :] * 255.0 - 128.0
    fy = (L + 16.0) / 116.0
    fx = fy + a / 500.0
    fz = fy - b / 200.0
    xyz = [
        _lab_f_inv(fx) * float(_WHITE[0]),
        _lab_f_inv(fy) * float(_WHITE[1]),
        _lab_f_inv(fz) * float(_WHITE[2]),
    ]
    return torch.stack([_linear_to_srgb(c) for c in _mat3(*xyz, _XYZ2RGB)], dim=-3)
