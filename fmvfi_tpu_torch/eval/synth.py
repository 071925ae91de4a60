"""Synthetic motion sequences with exact ground truth (a copy of the numpy
generators of fmvfi_tpu/eval/synth.py and their helpers): textured scenes
under known translation, rotation, zoom, occlusion and brightness change,
one per motion regime of `benchmark_sets`, and the photograph regimes
(`photo_video`, `natural_video`) over the natural images of
`photo_sources`.

The photographs are matplotlib's sample data, carried in
fmvfi_tpu_torch/data/sample_data/ (see its README): the JPEG is decoded by
utils.imageio.read_jpeg and resized by utils.resample.resize_u8, bit-equal
to PIL, and the elevation maps are shaded by eval.shade as matplotlib
shades them.
"""

from __future__ import annotations

import gzip
import os
import threading

import numpy as np

from ..utils.imageio import read_jpeg
from ..utils.resample import resize_u8
from .shade import shade

SAMPLE_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "data", "sample_data")


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


def photo_video(
    n_frames: int, h: int = 512, w: int = 512, step: float = 3.0,
    deg_per_frame: float = 0.3, seed: int = 11,
):
    """Real-photograph motion with exact ground truth: the Grace Hopper
    portrait (natural image statistics: edges, smooth skin, text on books)
    under a rigid translation + rotation, sampled with the same bilinear
    warp as the texture regimes (fmvfi_tpu/eval/synth.py:208-245)."""
    margin = int(np.ceil(abs(step) * n_frames + 0.02 * max(h, w))) + 2
    src = np.asarray(
        resize_u8(read_jpeg(os.path.join(SAMPLE_DATA, "grace_hopper.jpg")),
                  (w + 2 * margin, h + 2 * margin)),
        dtype=np.float32,
    ) / 255.0
    rng = np.random.default_rng(seed)
    angle0 = rng.uniform(0, 2 * np.pi)
    dy, dx = np.sin(angle0) * step, np.cos(angle0) * step
    cy, cx = (h - 1) / 2, (w - 1) / 2
    yy, xx = _warp_grid(h, w)
    frames = []
    for i in range(n_frames):
        a = np.deg2rad(deg_per_frame * i)
        ys = cy + (yy - cy) * np.cos(a) - (xx - cx) * np.sin(a) + dy * i
        xs = cx + (yy - cy) * np.sin(a) + (xx - cx) * np.cos(a) + dx * i
        frames.append(_sample_bilinear(src, ys + margin, xs + margin).astype(np.float32))
    return np.stack(frames)


_PHOTO_SOURCES = None
_PHOTO_LOCK = threading.Lock()


def photo_sources():
    """The natural images as float32 RGB in [0, 1], in fmvfi_tpu's order:
    the Grace Hopper portrait and three crops of it, shaded-relief renders
    of the two elevation maps, and an MRI slice.  Built on the first call
    and cached (the list is shared: do not modify it).  A missing or
    unreadable file raises: the pool never shrinks, so a seed always picks
    the same photo."""
    global _PHOTO_SOURCES
    with _PHOTO_LOCK:
        if _PHOTO_SOURCES is None:
            _PHOTO_SOURCES = _load_photo_sources()
        return _PHOTO_SOURCES


def _load_photo_sources():
    out = []
    hopper = np.asarray(read_jpeg(os.path.join(SAMPLE_DATA, "grace_hopper.jpg")),
                        dtype=np.float32) / 255.0
    out.append(hopper)
    hh, hw = hopper.shape[:2]
    out.append(hopper[: hh // 2, : hw // 2])          # face / cap
    out.append(hopper[hh // 3 :, hw // 3 :])          # books / uniform
    out.append(hopper[hh // 4 : 3 * hh // 4, hw // 4 : 3 * hw // 4])
    with np.load(os.path.join(SAMPLE_DATA, "jacksboro_fault_dem.npz")) as dem:
        out.append(shade(dem["elevation"]))
    with np.load(os.path.join(SAMPLE_DATA, "topobathy.npz")) as dem:
        out.append(shade(dem[list(dem.keys())[0]]))
    with gzip.open(os.path.join(SAMPLE_DATA, "s1045.ima.gz")) as f:
        mri = np.frombuffer(f.read(), np.uint16).astype(np.float32)
    mri = mri.reshape(256, 256)
    mri = (mri - mri.min()) / max(mri.max() - mri.min(), 1e-6)
    out.append(np.repeat(mri[..., None], 3, axis=-1))
    return out


def _resized_source(img: np.ndarray, h: int, w: int) -> np.ndarray:
    u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    return np.asarray(resize_u8(u8, (w, h)), np.float32) / 255.0


def natural_video(
    n_frames: int,
    h: int,
    w: int,
    *,
    dx: float = 0.0,
    dy: float = 0.0,
    deg_per_frame: float = 0.0,
    scale_per_frame: float = 1.0,
    gain_per_frame: float = 1.0,
    fg_step: float = 0.0,
    seed: int = 0,
):
    """Rigid motion over the natural photographs with exact ground truth
    (fmvfi_tpu/eval/synth.py:320-395): translation (dx/dy px/frame),
    rotation about the center, zoom, global brightness decay, and, with
    `fg_step` nonzero, a foreground square cut from a second photo moving
    over the background.  The photos, their flips and the motion are drawn
    from `seed`."""
    rng = np.random.default_rng(seed)
    pool = photo_sources()

    def _pick():
        img = pool[int(rng.integers(len(pool)))]
        if rng.random() < 0.5:
            img = img[:, ::-1]
        if rng.random() < 0.5:
            img = img[::-1]
        return img

    step_max = max(abs(dx), abs(dy), abs(fg_step))
    rot_margin = 0.21 * max(h, w) if deg_per_frame else 0.0
    zoom_margin = (
        (max(scale_per_frame ** (n_frames - 1), 1.0) - 1.0) * 0.5 * max(h, w)
        if scale_per_frame != 1.0
        else 0.0
    )
    margin = int(np.ceil(step_max * n_frames + rot_margin + zoom_margin)) + 2
    src = _resized_source(_pick(), h + 2 * margin, w + 2 * margin)
    fg = _resized_source(_pick(), h + 2 * margin, w + 2 * margin) if fg_step else None

    cy, cx = (h - 1) / 2, (w - 1) / 2
    yy, xx = _warp_grid(h, w)
    sq_y0, sq_y1 = h // 4, 3 * h // 4
    sq_x0, sq_x1 = w // 4, 3 * w // 4
    frames = []
    for i in range(n_frames):
        a = np.deg2rad(deg_per_frame * i)
        s = scale_per_frame ** (-i)
        ys = cy + ((yy - cy) * np.cos(a) - (xx - cx) * np.sin(a)) * s + dy * i
        xs = cx + ((yy - cy) * np.sin(a) + (xx - cx) * np.cos(a)) * s + dx * i
        frame = _sample_bilinear(src, ys + margin, xs + margin)
        if fg is not None:
            fgs = _sample_bilinear(fg, yy + margin, xx + margin + i * fg_step)
            fx = xx + i * fg_step
            mask = (
                (yy >= sq_y0) & (yy < sq_y1) & (fx >= sq_x0) & (fx < sq_x1)
            ).astype(np.float32)[..., None]
            frame = mask * fgs + (1 - mask) * frame
        if gain_per_frame != 1.0:
            frame = np.clip(frame * gain_per_frame**i, 0.0, 1.0)
        frames.append(frame.astype(np.float32))
    return np.stack(frames)


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
