"""Complex steerable pyramid in torch.fft (port of fmvfi_tpu/ops/pyramid.py).

FFT-domain decomposition with a radial raised-cosine high/low split, `nbands`
oriented angular masks per level and frequency-domain downsampling by
`scale_factor` (sqrt(2): half-octave levels).  The masks are built once per
(H, W, height) in numpy, exactly as the JAX package builds them, and kept as
float32 tensors on the device they serve; a decompose or reconstruct is then
only FFTs, mask multiplies and crops, in complex64.

Shapes: `decompose(img)` takes (N, H, W) and returns a `Decomp` with high
(N, H, W), low (N, hL, wL) and per level (finest first) phase and amplitude
(N, nbands, h_l, w_l); `reconstruct` inverts it (tight frame).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Tuple

import numpy as np
import torch

from .decomp import Decomp


@dataclasses.dataclass(frozen=True)
class PyramidFilters:
    """Filter bank for one (H, W, height, nbands, scale) bucket on one device.
    All masks are real float32 tensors; the unit complex factors
    (-+i)^(nbands-1) are applied as scalars."""

    height: int
    nbands: int
    scale_factor: float
    in_shape: Tuple[int, int]
    crops: Tuple[Tuple[int, int, int, int], ...]
    level_shapes: Tuple[Tuple[int, int], ...]
    low_shape: Tuple[int, int]
    hi0: torch.Tensor
    lo0: torch.Tensor
    band_masks: Tuple[torch.Tensor, ...]
    synth_masks: Tuple[torch.Tensor, ...]
    lo_masks: Tuple[torch.Tensor, ...]


def max_pyr_height(h: int, w: int) -> int:
    """Resolution-dependent pyramid height: ceil((log2(min(H,W))-3)*2)+2."""
    return int(np.ceil((np.log2(min(h, w)) - 3) * 2) + 2)


def _prepare_grid(h: int, w: int) -> Tuple[np.ndarray, np.ndarray]:
    """Normalized log-radius and angle grids over the fftshifted frequency plane."""
    y = (np.arange(h) - h // 2) / (h / 2)
    x = (np.arange(w) - w // 2) / (w / 2)
    xv, yv = np.meshgrid(x, y)
    angle = np.arctan2(yv, xv)
    rad = np.sqrt(xv**2 + yv**2)
    # avoid log(0) at DC: reuse the neighbour's radius
    rad[h // 2, w // 2] = rad[h // 2, max(w // 2 - 1, 0)]
    log_rad = np.log2(rad)
    return log_rad, angle


def _hi_mask(log_rad: np.ndarray, pos: float) -> np.ndarray:
    t = np.clip(log_rad - pos, 0.0, 1.0)
    return np.sin(0.5 * np.pi * t).astype(np.float32)


def _lo_mask(log_rad: np.ndarray, pos: float) -> np.ndarray:
    t = np.clip(log_rad - pos, 0.0, 1.0)
    return np.cos(0.5 * np.pi * t).astype(np.float32)


def _angle_const(nbands: int) -> float:
    order = nbands - 1
    return (
        (2.0 ** (2 * order))
        * (math.factorial(order) ** 2)
        / (nbands * math.factorial(2 * order))
    )


def _angle_masks(angle: np.ndarray, nbands: int) -> np.ndarray:
    """Analysis angular masks: oriented half-plane cos^(nbands-1)."""
    order = nbands - 1
    const = _angle_const(nbands)
    masks = []
    for b in range(nbands):
        shifted = angle - np.pi * b / nbands
        wrapped = np.mod(shifted + np.pi, 2 * np.pi) - np.pi
        m = (
            2.0
            * np.sqrt(const)
            * (np.cos(wrapped) ** order)
            * (np.abs(wrapped) < np.pi / 2)
        )
        masks.append(m.astype(np.float32))
    return np.stack(masks, axis=0)


def _angle_masks_synth(angle: np.ndarray, nbands: int) -> np.ndarray:
    """Synthesis angular masks: sqrt(const) * cos^(nbands-1), full plane."""
    order = nbands - 1
    const = _angle_const(nbands)
    masks = []
    for b in range(nbands):
        shifted = angle - np.pi * b / nbands
        m = np.sqrt(const) * (np.cos(shifted) ** order)
        masks.append(m.astype(np.float32))
    return np.stack(masks, axis=0)


def _crop_indices(dims: Tuple[int, int], scale_factor: float):
    """Centered frequency-domain crop implementing downsampling by scale_factor."""
    d = np.asarray(dims, dtype=np.float64)
    new = np.ceil((d - 0.5) / scale_factor).astype(int)
    start = (np.ceil((d + 0.5) / 2) - np.ceil((new + 0.5) / 2)).astype(int)
    end = start + new
    return (int(start[0]), int(end[0]), int(start[1]), int(end[1])), (
        int(new[0]),
        int(new[1]),
    )


NBANDS = 4  # oriented bands per level
SCALE_FACTOR = math.sqrt(2)  # half-octave levels


@functools.lru_cache(maxsize=8)
def _make_filters(h, w, height, device) -> PyramidFilters:
    nbands, scale_factor = NBANDS, SCALE_FACTOR
    nlevels = height - 2
    if nlevels < 1:
        raise ValueError(f"height must be >= 3, got {height}")
    log_rad, angle = _prepare_grid(h, w)
    # transition start of the canonical rcosFn(width=1, position=-0.5)
    pos = -1.0
    hi0 = _hi_mask(log_rad, pos)
    lo0 = _lo_mask(log_rad, pos)

    band_masks, synth_masks, lo_masks, crops, level_shapes = [], [], [], [], []
    cur_log_rad, cur_angle = log_rad, angle
    cur_dims = (h, w)
    for _ in range(nlevels):
        pos = pos - math.log2(scale_factor)
        him = _hi_mask(cur_log_rad, pos)
        band_masks.append((_angle_masks(cur_angle, nbands) * him[None]).astype(np.float32))
        synth_masks.append(
            (_angle_masks_synth(cur_angle, nbands) * him[None]).astype(np.float32)
        )
        level_shapes.append(cur_dims)

        (r0, r1, c0, c1), new_dims = _crop_indices(cur_dims, scale_factor)
        if min(new_dims) < 2:
            raise ValueError(
                f"pyramid too deep for {h}x{w}: level shape would be {new_dims}"
            )
        crops.append((r0, r1, c0, c1))
        cur_log_rad = cur_log_rad[r0:r1, c0:c1]
        cur_angle = cur_angle[r0:r1, c0:c1]
        cur_dims = new_dims
        lo_masks.append(_lo_mask(cur_log_rad, pos))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return PyramidFilters(
        height=height,
        nbands=nbands,
        scale_factor=scale_factor,
        in_shape=(h, w),
        crops=tuple(crops),
        level_shapes=tuple(level_shapes),
        low_shape=cur_dims,
        hi0=t(hi0),
        lo0=t(lo0),
        band_masks=tuple(t(m) for m in band_masks),
        synth_masks=tuple(t(m) for m in synth_masks),
        lo_masks=tuple(t(m) for m in lo_masks),
    )


def make_filters(h: int, w: int, height: int, device="cpu") -> PyramidFilters:
    """The filter bank for input shape (h, w), cached per shape and device.

    `height` counts all levels including the high/low residuals, so there are
    `height - 2` oriented band levels."""
    return _make_filters(int(h), int(w), int(height), torch.device(device))


def _cfact(nbands: int) -> complex:
    return (0.0 - 1.0j) ** (nbands - 1)


def _cfact_synth(nbands: int) -> complex:
    return (0.0 + 1.0j) ** (nbands - 1)


def _fft2s(x: torch.Tensor) -> torch.Tensor:
    return torch.fft.fftshift(torch.fft.fft2(x), dim=(-2, -1))


def _ifft2s(x: torch.Tensor) -> torch.Tensor:
    return torch.fft.ifft2(torch.fft.ifftshift(x, dim=(-2, -1)))


def _amp_phase(band: torch.Tensor):
    return torch.abs(band), torch.atan2(band.imag, band.real)


def _band(amplitude: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
    """amplitude * exp(i * phase) as complex64."""
    return torch.polar(amplitude.float(), phase.float())


def finest_recon_mask(filters: PyramidFilters) -> torch.Tensor:
    """Mask M0 such that, for a real image x, the reconstruction from the
    highpass and the finest band level alone is real(ifft2s(fft2s(x) * M0)):
    M0 = hi0^2 + lo0^2 * sum_b a_b * s_b."""
    band0 = torch.sum(filters.band_masks[0] * filters.synth_masks[0], dim=0)
    return filters.hi0 * filters.hi0 + filters.lo0 * filters.lo0 * band0


def coarse_window(filters: PyramidFilters, start: int):
    """Full-resolution frequency window of pyramid grid `start` (the
    composition of crops[0..start-1]): returns (r0, c0, (h, w))."""
    r0 = c0 = 0
    for lvl in range(start):
        a, _, c, _ = filters.crops[lvl]
        r0 += a
        c0 += c
    shape = (
        filters.level_shapes[start]
        if start < len(filters.level_shapes)
        else filters.low_shape
    )
    return r0, c0, shape


def coarse_window_mask(filters: PyramidFilters, start: int) -> torch.Tensor:
    """The lowpass mask accumulated between the full-res grid and grid
    `start`, on grid `start`'s window.  Shape = level_shapes[start]."""
    r0, c0, (hk, wk) = coarse_window(filters, start)
    mask = filters.lo0[r0 : r0 + hk, c0 : c0 + wk]
    for j in range(start):
        rj = cj = 0
        for lvl in range(j + 1, start):
            a, _, c, _ = filters.crops[lvl]
            rj += a
            cj += c
        mask = mask * filters.lo_masks[j][rj : rj + hk, cj : cj + wk]
    return mask


def fft2s_window(img: torch.Tensor, r0: int, c0: int, hk: int, wk: int):
    """fft2s(img)[..., r0:r0+hk, c0:c0+wk]: full FFT along W, crop columns,
    then the H-axis FFT on the narrow array only."""
    x = torch.fft.fftshift(torch.fft.fft(img.to(torch.complex64), dim=-1), dim=-1)
    x = x[..., :, c0 : c0 + wk]
    x = torch.fft.fftshift(torch.fft.fft(x, dim=-2), dim=-2)
    return x[..., r0 : r0 + hk, :]


def decompose_coarse(img: torch.Tensor, filters: PyramidFilters, start: int) -> Decomp:
    """Decomposition of levels >= `start` plus the lowpass; the finer levels
    come back as zeros and high as zeros.  The spectrum is evaluated only on
    grid `start`'s window."""
    nlevels = filters.height - 2
    n = img.shape[0]
    dev = img.device
    r0, c0, (hk, wk) = coarse_window(filters, start)
    lodft = fft2s_window(img, r0, c0, hk, wk)
    lodft = lodft * coarse_window_mask(filters, start)

    cf = _cfact(filters.nbands)
    phases, amps = [], []
    for lvl in range(nlevels):
        if lvl < start:
            shape = (n, filters.nbands) + tuple(filters.level_shapes[lvl])
            amps.append(torch.zeros(shape, device=dev))
            phases.append(torch.zeros(shape, device=dev))
            continue
        band = _ifft2s(lodft[:, None] * filters.band_masks[lvl][None]) * cf
        a, p = _amp_phase(band)
        amps.append(a)
        phases.append(p)
        a0, _, c, _ = filters.crops[lvl]
        hl, wl = (
            filters.level_shapes[lvl + 1] if lvl + 1 < nlevels else filters.low_shape
        )
        lodft = lodft[:, a0 : a0 + hl, c : c + wl] * filters.lo_masks[lvl]

    low = _ifft2s(lodft).real
    high = torch.zeros((n,) + tuple(filters.in_shape), device=dev)
    return Decomp(high=high, low=low, phase=tuple(phases), amplitude=tuple(amps))


def reconstruct_coarse(vals: Decomp, filters: PyramidFilters, start: int) -> torch.Tensor:
    """Reconstruction from the lowpass and band levels >= `start` only (the
    highpass and the finer levels count as zero): the fine prefix collapses
    to one mask multiply, and the final spectrum (zero outside grid
    `start`'s window) is inverted with narrow axis FFTs."""
    nlevels = filters.height - 2
    n = vals.low.shape[0]
    dev = vals.low.device
    lodft = _fft2s(vals.low.float())
    for lvl in reversed(range(start, nlevels)):
        a, _, c, _ = filters.crops[lvl]
        hl, wl = filters.level_shapes[lvl]
        up = torch.zeros((n, hl, wl), dtype=torch.complex64, device=dev)
        up[:, a : a + lodft.shape[1], c : c + lodft.shape[2]] = lodft * filters.lo_masks[lvl]
        band_dft = _fft2s(_band(vals.amplitude[lvl], vals.phase[lvl]))
        band_dft = band_dft * _cfact_synth(filters.nbands)
        lodft = up + torch.sum(band_dft * filters.synth_masks[lvl][None], dim=1)

    r0, c0, (hk, wk) = coarse_window(filters, start)
    h, w = filters.in_shape
    dk = lodft * coarse_window_mask(filters, start)
    # inverse of fft2s_window: pad rows to full H, ifft along H, pad cols, ifft W
    xr = torch.zeros((n, h, wk), dtype=torch.complex64, device=dev)
    xr[:, r0 : r0 + hk, :] = dk
    xr = torch.fft.ifft(torch.fft.ifftshift(xr, dim=-2), dim=-2)
    xc = torch.zeros((n, h, w), dtype=torch.complex64, device=dev)
    xc[:, :, c0 : c0 + wk] = xr
    return torch.fft.ifft(torch.fft.ifftshift(xc, dim=-1), dim=-1).real


def decompose(img: torch.Tensor, filters: PyramidFilters) -> Decomp:
    """(N, H, W) float -> Decomp."""
    if tuple(img.shape[-2:]) != tuple(filters.in_shape):
        raise ValueError(f"image {tuple(img.shape)} vs filters {filters.in_shape}")
    dft = _fft2s(img.float())
    high = _ifft2s(dft * filters.hi0).real
    lodft = dft * filters.lo0

    cf = _cfact(filters.nbands)
    phases, amps = [], []
    for lvl in range(filters.height - 2):
        band = _ifft2s(lodft[:, None] * filters.band_masks[lvl][None]) * cf
        a, p = _amp_phase(band)
        amps.append(a)
        phases.append(p)
        r0, r1, c0, c1 = filters.crops[lvl]
        lodft = lodft[:, r0:r1, c0:c1] * filters.lo_masks[lvl]

    low = _ifft2s(lodft).real
    return Decomp(high=high, low=low, phase=tuple(phases), amplitude=tuple(amps))


def reconstruct(vals: Decomp, filters: PyramidFilters) -> torch.Tensor:
    """Decomp -> (N, H, W) float.  Inverse of `decompose` (tight frame)."""
    n = vals.high.shape[0]
    dev = vals.high.device
    lodft = _fft2s(vals.low.float())
    for lvl in reversed(range(filters.height - 2)):
        # upsample the lowpass: re-embed into the level's grid, through its mask
        r0, r1, c0, c1 = filters.crops[lvl]
        hl, wl = filters.level_shapes[lvl]
        up = torch.zeros((n, hl, wl), dtype=torch.complex64, device=dev)
        up[:, r0:r1, c0:c1] = lodft * filters.lo_masks[lvl]
        band_dft = _fft2s(_band(vals.amplitude[lvl], vals.phase[lvl]))
        band_dft = band_dft * _cfact_synth(filters.nbands)
        lodft = up + torch.sum(band_dft * filters.synth_masks[lvl][None], dim=1)

    dft = lodft * filters.lo0 + _fft2s(vals.high.float()) * filters.hi0
    return _ifft2s(dft).real
