"""Two uint8 resamplers, each bit-equal to a library's without it:
`resize_u8` is PIL's `Image.resize(size, Image.LANCZOS)`, `resize_bilinear_u8`
cv2's `cv2.resize(img, size)` (INTER_LINEAR).

`resize_u8` is the port's copy of Pillow's libImaging/Resample.c for 8-bit
images.

Two separable passes, horizontal first, each skipped when its axis keeps its
size; the intermediate image is clipped to uint8.  For an axis of `n_in`
samples resized to `n_out`, output sample `i` reads the input samples
`lo_i .. lo_i + k_i - 1` with weights that Resample.c's `precompute_coeffs`
computes in double (a Lanczos-3 window stretched by the downscale factor,
normalised to sum 1) and `normalize_coeffs_8bpc` rounds to 22-bit fixed
point; the output is `clip((2**21 + sum k * in) >> 22, 0, 255)`, summed in
int32 as Resample.c sums it.  The sines
are the C library's (math.sin), as Pillow's are.

`resize_bilinear_u8` repeats OpenCV's resize.cpp for 8-bit images: output
sample d reads source position f = float32((d + 0.5) * n_in / n_out - 0.5),
taps floor(f) and floor(f) + 1 weighted 1 - frac and frac in 11-bit fixed
point (each weight rounded to even from float32).  Horizontally a position
before the first sample or past the last takes the edge sample whole;
vertically the weights stay and the row indices are clamped.  The
horizontal pass sums in int32 (S, 19 bits), the vertical pass computes
((b0 * (S0 >> 4)) >> 16) + ((b1 * (S1 >> 4)) >> 16), adds 2 and shifts by
2, as its SIMD kernel does, saturated to 0-255.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

PRECISION_BITS = 32 - 8 - 2
SUPPORT = 3.0  # Lanczos-3


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    if -3.0 <= x < 3.0:
        return _sinc(x) * _sinc(x / 3)
    return 0.0


def coefficients(n_in: int, n_out: int) -> Tuple[np.ndarray, np.ndarray]:
    """(lo (n_out,) int64, k (n_out, taps) int64): the first input index and
    the fixed-point weights of each output sample (zero past its own taps)."""
    scale = n_in / n_out
    fs = max(scale, 1.0)
    support = SUPPORT * fs
    ss = 1.0 / fs
    taps = int(math.ceil(support)) * 2 + 1
    lo = np.zeros(n_out, np.int64)
    k = np.zeros((n_out, taps), np.int64)
    one = float(1 << PRECISION_BITS)
    for xx in range(n_out):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        n = min(int(center + support + 0.5), n_in) - xmin
        w = [_lanczos((x + xmin - center + 0.5) * ss) for x in range(n)]
        total = 0.0
        for v in w:  # left to right, as Resample.c adds them (sum() compensates)
            total += v
        if total != 0.0:
            w = [v / total for v in w]
        lo[xx] = xmin
        k[xx, :n] = [int(-0.5 + v * one) if v < 0 else int(0.5 + v * one) for v in w]
    return lo, k


def _pass(img: np.ndarray, axis: int, n_out: int) -> np.ndarray:
    """Resize `img` (uint8, any trailing channels) along `axis` to n_out, one
    gather-and-add per tap, in int32 as Resample.c accumulates."""
    n_in = img.shape[axis]
    lo, k = coefficients(n_in, n_out)
    k = k.astype(np.int32)
    idx = np.minimum(lo[:, None] + np.arange(k.shape[1]), n_in - 1)  # zero weights past the end
    src = np.moveaxis(img, axis, 0)
    acc = np.full((n_out,) + src.shape[1:], 1 << (PRECISION_BITS - 1), np.int32)
    term = np.empty_like(acc)
    expand = (slice(None),) + (None,) * (src.ndim - 1)
    for t in range(k.shape[1]):
        np.multiply(k[:, t][expand], src[idx[:, t]], out=term)
        acc += term
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_u8(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """`img` (H, W, C) or (H, W) uint8 resized to size = (width, height) as
    PIL's Image.resize(size, Image.LANCZOS) resizes it."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"resize_u8 takes (H, W[, C]) uint8, got {img.shape} {img.dtype}")
    w, h = (int(v) for v in size)
    if w < 1 or h < 1:
        raise ValueError(f"resize_u8: size {size} must be positive")
    if w != img.shape[1]:
        img = _pass(img, 1, w)
    if h != img.shape[0]:
        img = _pass(img, 0, h)
    return np.ascontiguousarray(img)


COEF_BITS = 11  # OpenCV's INTER_RESIZE_COEF_BITS


def _linear_taps(n_in: int, n_out: int, clamp: bool) -> Tuple[np.ndarray, np.ndarray]:
    """(first tap (n_out,) int64, weights (n_out, 2) int32) of OpenCV's
    INTER_LINEAR along one axis; `clamp` moves a position outside the
    samples onto the edge sample with weights (2048, 0)."""
    pos = ((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5).astype(np.float32)
    lo = np.floor(pos)
    frac = (pos - lo).astype(np.float32)
    lo = lo.astype(np.int64)
    if clamp:
        edge = (lo < 0) | (lo >= n_in - 1)
        frac[edge] = 0
        lo = np.clip(lo, 0, n_in - 1)
    one = np.float32(1 << COEF_BITS)
    w = np.stack([np.rint((np.float32(1) - frac) * one), np.rint(frac * one)], 1)
    return lo, w.astype(np.int32)


def resize_bilinear_u8(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """`img` (H, W, C) or (H, W) uint8 resized to size = (width, height) as
    cv2.resize(img, size) (INTER_LINEAR) resizes it."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"resize_bilinear_u8 takes (H, W[, C]) uint8, got {img.shape} "
                         f"{img.dtype}")
    w, h = (int(v) for v in size)
    if w < 1 or h < 1:
        raise ValueError(f"resize_bilinear_u8: size {size} must be positive")
    n_h, n_w = img.shape[:2]
    x0, ax = _linear_taps(n_w, w, clamp=True)
    y0, ay = _linear_taps(n_h, h, clamp=False)
    col = (slice(None),) + (None,) * (img.ndim - 2)  # a weight per column
    row = col + (None,)  # a weight per row
    src = img.astype(np.int32)
    rows = (src[:, x0] * ax[:, 0][col] +
            src[:, np.minimum(x0 + 1, n_w - 1)] * ax[:, 1][col])  # (H, w[, C])
    s0 = rows[np.clip(y0, 0, n_h - 1)] >> 4
    s1 = rows[np.clip(y0 + 1, 0, n_h - 1)] >> 4
    out = (((ay[:, 0][row] * s0) >> 16) + ((ay[:, 1][row] * s1) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)
