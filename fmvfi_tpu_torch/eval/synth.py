"""Synthetic motion sequences with exact ground truth (a copy of the numpy
generators of fmvfi_tpu/eval/synth.py:83-206,397-411 and their helpers):
textured scenes under known translation, rotation, zoom, occlusion and
brightness change, one per motion regime of `benchmark_sets`.  The
photograph regimes (photo_video, natural_video) need matplotlib and PIL and
are not copied."""

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


def translation_video(
    n_frames: int, h: int = 720, w: int = 1280, step: float = 3.0, seed: int = 0
):
    """A sequence of frames under constant translation (for throughput
    benchmarks and video-interpolation smoke tests)."""
    rng = np.random.default_rng(seed)
    margin = int(np.ceil(step * n_frames)) + 2
    big = _texture(rng, h + 2 * margin, w + 2 * margin, octaves=6)
    yy, xx = np.meshgrid(
        np.arange(h, dtype=np.float64), np.arange(w, dtype=np.float64), indexing="ij"
    )
    return np.stack(
        [
            _sample_bilinear(big, yy + margin, xx + margin + i * step).astype(
                np.float32
            )
            for i in range(n_frames)
        ]
    )


def _warp_grid(h: int, w: int):
    return np.meshgrid(
        np.arange(h, dtype=np.float64), np.arange(w, dtype=np.float64), indexing="ij"
    )


def rotation_video(
    n_frames: int, h: int = 512, w: int = 512, deg_per_frame: float = 1.0, seed: int = 1
):
    """Rigid rotation about the image center — the large-coherent-motion
    regime PhaseNet handles and per-pixel kernels (max offset F·d) cannot
    track far from the center."""
    rng = np.random.default_rng(seed)
    margin = int(np.ceil(0.21 * max(h, w))) + 2  # covers rotations <= ~22deg
    big = _texture(rng, h + 2 * margin, w + 2 * margin, octaves=6)
    cy, cx = (h - 1) / 2, (w - 1) / 2
    yy, xx = _warp_grid(h, w)
    frames = []
    for i in range(n_frames):
        a = np.deg2rad(deg_per_frame * i)
        ys = cy + (yy - cy) * np.cos(a) - (xx - cx) * np.sin(a)
        xs = cx + (yy - cy) * np.sin(a) + (xx - cx) * np.cos(a)
        frames.append(_sample_bilinear(big, ys + margin, xs + margin).astype(np.float32))
    return np.stack(frames)


def zoom_video(
    n_frames: int, h: int = 512, w: int = 512, scale_per_frame: float = 1.01, seed: int = 2
):
    """Zoom-in about the center (camera dolly): radial motion field."""
    rng = np.random.default_rng(seed)
    margin = int(np.ceil(0.3 * max(h, w))) + 2
    big = _texture(rng, h + 2 * margin, w + 2 * margin, octaves=6)
    cy, cx = (h - 1) / 2, (w - 1) / 2
    yy, xx = _warp_grid(h, w)
    frames = []
    for i in range(n_frames):
        s = scale_per_frame ** (-i)  # sample from a shrinking source window
        ys = cy + (yy - cy) * s
        xs = cx + (xx - cx) * s
        frames.append(_sample_bilinear(big, ys + margin, xs + margin).astype(np.float32))
    return np.stack(frames)


def occlusion_video(
    n_frames: int,
    h: int = 512,
    w: int = 512,
    fg_step: float = 6.0,
    bg_step: float = -2.0,
    seed: int = 3,
):
    """Two textured layers with independent motion: a foreground square
    (sharp boundary) occludes/disoccludes the background — exactly the
    regime the fusion architecture exists for (AdaCoF artifacts at
    disocclusions, PhaseNet blur on the sharp boundary)."""
    rng = np.random.default_rng(seed)
    margin = int(np.ceil(max(abs(fg_step), abs(bg_step)) * n_frames)) + 2
    bg = _texture(rng, h + 2 * margin, w + 2 * margin, octaves=6)
    fg = _texture(rng, h + 2 * margin, w + 2 * margin, octaves=4) * 0.8 + 0.2
    yy, xx = _warp_grid(h, w)
    # foreground support: centered square, half the frame
    sq_y0, sq_y1 = h // 4, 3 * h // 4
    sq_x0, sq_x1 = w // 4, 3 * w // 4
    frames = []
    for i in range(n_frames):
        bgs = _sample_bilinear(bg, yy + margin, xx + margin + i * bg_step)
        fgs = _sample_bilinear(fg, yy + margin, xx + margin + i * fg_step)
        # the square boundary moves rigidly with the foreground texture
        # (content sampled at xx + i*step appears shifted by -i*step on
        # screen, so the mask uses the same source-space coordinates)
        fy = yy
        fx = xx + i * fg_step
        mask = (
            (fy >= sq_y0) & (fy < sq_y1) & (fx >= sq_x0) & (fx < sq_x1)
        ).astype(np.float32)[..., None]
        frames.append((mask * fgs + (1 - mask) * bgs).astype(np.float32))
    return np.stack(frames)


def brightness_video(
    n_frames: int,
    h: int = 512,
    w: int = 512,
    step: float = 2.0,
    gain_per_frame: float = 0.93,
    seed: int = 4,
):
    """Translation + global brightness decay (flash/exposure change):
    violates brightness constancy, the failure mode of pure warping —
    the phase/amplitude decomposition absorbs it in amplitude."""
    frames = translation_video(n_frames, h, w, step=step, seed=seed)
    gains = gain_per_frame ** np.arange(n_frames, dtype=np.float32)
    return np.clip(frames * gains[:, None, None, None], 0.0, 1.0)


def large_motion_video(
    n_frames: int, h: int = 512, w: int = 512, step: float = 24.0, seed: int = 5
):
    """Translation far beyond AdaCoF's reach (kernel_size*dilation taps ~ a
    few px): PhaseNet's coarse pyramid levels still lock on."""
    return translation_video(n_frames, h, w, step=step, seed=seed)


def benchmark_sets(dim: int = 512, n_frames: int = 4, seed_offset: int = 0):
    """The full synthetic benchmark: one set per motion regime (the regimes
    the reference's README motivates the fusion with).  `seed_offset` shifts
    every regime's texture/motion seed so independent replicas of the suite
    can be drawn (the widened dominance eval scores 3 seeds per regime;
    sub-dB conclusions on a single 2-triplet draw are noise-fragile)."""
    o = seed_offset
    return {
        "translation": translation_video(n_frames, dim, dim, step=4.0, seed=0 + o),
        "large_motion": large_motion_video(n_frames, dim, dim, seed=5 + o),
        "rotation": rotation_video(n_frames, dim, dim, deg_per_frame=1.5, seed=1 + o),
        "zoom": zoom_video(n_frames, dim, dim, scale_per_frame=1.02, seed=2 + o),
        "occlusion": occlusion_video(n_frames, dim, dim, seed=3 + o),
        "brightness": brightness_video(n_frames, dim, dim, seed=4 + o),
    }
