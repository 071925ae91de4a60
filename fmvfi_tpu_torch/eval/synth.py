"""Synthetic frame triplets (copy of fmvfi_tpu/eval/synth.py's
translation_triplet and its helpers; numpy only)."""

from __future__ import annotations

import numpy as np


def _texture(rng: np.random.Generator, h: int, w: int, octaves: int = 5) -> np.ndarray:
    """Multi-octave value-noise RGB texture in [0, 1]."""
    img = np.zeros((h, w, 3), np.float32)
    amp = 1.0
    for o in range(octaves):
        step = 2**o
        hh, ww = max(h // step, 2), max(w // step, 2)
        coarse = rng.uniform(0, 1, (hh, ww, 3)).astype(np.float32)
        yi = np.linspace(0, hh - 1, h)
        xi = np.linspace(0, ww - 1, w)
        y0 = np.floor(yi).astype(int)
        x0 = np.floor(xi).astype(int)
        y1 = np.minimum(y0 + 1, hh - 1)
        x1 = np.minimum(x0 + 1, ww - 1)
        fy = (yi - y0)[:, None, None]
        fx = (xi - x0)[None, :, None]
        up = (
            coarse[y0][:, x0] * (1 - fy) * (1 - fx)
            + coarse[y1][:, x0] * fy * (1 - fx)
            + coarse[y0][:, x1] * (1 - fy) * fx
            + coarse[y1][:, x1] * fy * fx
        )
        img += amp * up
        amp *= 0.55
    img -= img.min()
    img /= img.max()
    return img


def _sample_bilinear(img: np.ndarray, yy: np.ndarray, xx: np.ndarray) -> np.ndarray:
    h, w, _ = img.shape
    y0 = np.clip(np.floor(yy).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xx).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    fy = (yy - y0)[..., None]
    fx = (xx - x0)[..., None]
    return (
        img[y0, x0] * (1 - fy) * (1 - fx)
        + img[y1, x0] * fy * (1 - fx)
        + img[y0, x1] * (1 - fy) * fx
        + img[y1, x1] * fy * fx
    )


def translation_triplet(
    h: int = 256, w: int = 256, dx: float = 6.0, dy: float = 2.0, seed: int = 0
):
    """(frame1, middle, frame2) under uniform translation (dx, dy) total;
    the middle frame sits at exactly half the displacement."""
    rng = np.random.default_rng(seed)
    margin = int(np.ceil(max(abs(dx), abs(dy)))) + 2
    big = _texture(rng, h + 2 * margin, w + 2 * margin)
    yy, xx = np.meshgrid(
        np.arange(h, dtype=np.float64), np.arange(w, dtype=np.float64), indexing="ij"
    )
    frames = []
    for t in (0.0, 0.5, 1.0):
        frames.append(
            _sample_bilinear(
                big, yy + margin + t * dy, xx + margin + t * dx
            ).astype(np.float32)
        )
    return tuple(frames)
