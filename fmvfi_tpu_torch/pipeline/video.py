"""Frame-rate doubling of a frame sequence (port of
fmvfi_tpu/pipeline/video.py): per pair, `batch` pairs per dispatch (with
`seq_chunk`), or the streaming fusion, each with a one-deep prefetch; and
directories of PNG or JPEG frames, read with utils.imageio (PNGs written).

Frames are host arrays (N, H, W, 3), float32 in [0, 1]; the frames yielded
are numpy (H, W, 3).  On the card, frames go up through pinned memory and
results come down into pinned memory, both copied asynchronously, so the
host waits only for a finished result: pair i+1's work is queued on the card
before the host waits for pair i's.  Video files are read when they hold
Motion-JPEG (AVI, utils/avi.py), MPEG-4 Part 2 (AVI, or MP4 / M4V / MOV
through utils/mp4.py), VP8 (utils/mkv.py: Matroska and WebM, which also
carry Motion-JPEG and MPEG-4 Part 2) or VP9 (WebM, Matroska, MP4 and AVI),
each frame decoded as cv2.VideoCapture decodes it (FFmpeg's decoders and
swscale's conversion, native/mjpeg.cpp, native/mpeg4.cpp, native/vp8.cpp
and native/vp9.cpp, an MP4 track's rotation applied as cv2 applies it); the
container is told from the file's bytes, as FFmpeg probes it.  Other codecs
and containers (H.264, HEVC, AV1; FLV, Ogg, ...) raise NotImplementedError:
the card's machine has no decoder for them (ROADMAP Queue 1, item 18.4).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, List, Sequence

import numpy as np
import torch

from .. import native
from ..ops.pyramid import make_filters, max_pyr_height
from ..utils import avi, imageio, mkv, mp4
from ..utils.resample import resize_bilinear_u8
from .interpolate import (
    FusionModels,
    _device,
    _nhwc,
    _pad8,
    adacof_interpolate,
    baseline_interpolate,
    fusion_interpolate,
    fusion_stream_init,
    fusion_stream_scan,
    phase_interpolate,
)

METHODS = ("fusion", "phase", "adacof", "baseline")
FRAME_SUFFIXES = (".png", ".jpg", ".jpeg")  # JAX's


ISO_BOXES = (b"ftyp", b"moov", b"mdat", b"free", b"skip", b"wide", b"pnot", b"uuid")
MATROSKA = b"\x1aE\xdf\xa3"  # the EBML header's id
OTHER_CONTAINERS = ((b"FLV", "an FLV file"), (b"OggS", "an Ogg file"),
                    (b"\x00\x00\x01\xba", "an MPEG program stream"),
                    (b"0&\xb2u", "an ASF (WMV) file"))


def _no_decoder(path: str, what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{path}: {what}; reading it needs a decoder the card's machine lacks (ROADMAP Queue 1, "
        "item 18.4); pass a Motion-JPEG, MPEG-4 Part 2 (mp4v) or VP9 AVI, an mp4v or VP9 MP4, "
        "an mp4v MOV file, an .mkv or .webm file of VP8, VP9, Motion-JPEG or mp4v video, or a "
        "directory of PNG or JPEG frames")


def _container(path: str) -> str:
    """"avi", "mp4" or "mkv" from the file's first bytes, as FFmpeg probes them;
    NotImplementedError for a container the port does not read, ValueError
    for a file that is none (cv2 decodes no frames from it)."""
    try:
        with open(path, "rb") as f:
            head = f.read(16)
    except OSError:
        raise ValueError(f"no frames decoded from {path}") from None
    if head[:4] == b"RIFF" and head[8:12] == b"AVI ":
        return "avi"
    if head[4:8] in ISO_BOXES:
        return "mp4"
    if head.startswith(MATROSKA):
        return "mkv"
    for magic, what in OTHER_CONTAINERS:
        if head.startswith(magic):
            raise _no_decoder(path, what)
    raise ValueError(f"no frames decoded from {path}")


def _as_refusal(path: str, where: str, e: Exception) -> Exception:
    """A decoder's error about `where` in `path`; NotImplementedError names
    item 18.4."""
    if isinstance(e, NotImplementedError):
        return NotImplementedError(f"{path}: {where}{e} (ROADMAP Queue 1, item 18.4: FFmpeg "
                                   "decodes it otherwise)")
    return ValueError(f"{path}: {where}{e}")


def _iter_decoded(path: str) -> Iterator[np.ndarray]:
    """A video file's frames as cv2.VideoCapture returns them, (H, W, 3)
    uint8 RGB: Motion-JPEG, MPEG-4 Part 2 or VP9 in AVI, MPEG-4 Part 2 in
    MP4, M4V or MOV and VP9 in MP4 (turned by the track's display matrix),
    VP8, VP9, Motion-JPEG or MPEG-4 Part 2 in Matroska or WebM.  A VP9
    packet yields the frames it shows: none for a hidden frame, two for a
    superframe showing two."""
    rotation = 0
    try:
        container = _container(path)
        if container == "mkv":
            try:
                track = mkv.open_video(path)
            except ValueError as e:  # cv2 opens no stream in it
                raise ValueError(f"no frames decoded from {path} ({e})") from None
            samples, decode = mkv.iter_samples(track), mkv.decoder(track)
        elif container == "avi":
            stream = avi.open_video(path)
            samples = avi.iter_frames(stream)
            if stream.codec == "mjpeg":
                decode = native.mjpeg_decode
            elif stream.codec == "vp9":
                decode = native.Vp9Decoder().decode
            else:
                decode = native.Mpeg4Decoder(fourcc=stream.strf["compression"]).decode
        else:
            track = mp4.open_video(path)
            samples, rotation = mp4.iter_samples(track), track.rotation
            if track.codec == b"vp09":
                decode = native.Vp9Decoder().decode
            else:
                decode = native.Mpeg4Decoder(track.config).decode
    except (ValueError, NotImplementedError) as e:
        if "18.4" in str(e) or str(e).startswith(("no frames decoded", path)):
            raise
        raise _as_refusal(path, "", e) from None
    for i, data in enumerate(samples):
        try:
            frame = decode(data)
        except (ValueError, NotImplementedError) as e:
            raise _as_refusal(path, f"frame {i}: ", e) from None
        if frame is None:  # a packet of headers or a not-coded VOP
            continue
        for f in frame if isinstance(frame, list) else [frame]:  # VP9: the frames it shows
            yield mp4.rotate(f, rotation)


def iter_video_frames(path: str, resize=None) -> Iterator[np.ndarray]:
    """Decode a video file one frame at a time as (H, W, 3) uint8 RGB, as
    JAX's iter_video_frames reads it through cv2.VideoCapture
    (fmvfi_tpu/pipeline/video.py:44-68), each frame resized to resize =
    (h, w) as cv2.resize does (bilinear) when given.  Like JAX's, a
    generator: at its first next() it raises ValueError when no frame
    decodes (a missing file, or bytes of no container cv2 reads), and
    NotImplementedError for what the port cannot decode as cv2 does (item
    18.4)."""
    got_any = False
    for frame in _iter_decoded(path):
        if resize is not None:
            frame = resize_bilinear_u8(frame, (resize[1], resize[0]))
        got_any = True
        yield frame
    if not got_any:
        raise ValueError(f"no frames decoded from {path}")


def read_video_frames(path: str, resize=None) -> np.ndarray:
    """A video file's frames (iter_video_frames) as (N, H, W, 3) float32
    RGB in [0, 1] (x / 255 in float32, as JAX reads them;
    fmvfi_tpu/pipeline/video.py:26-41), resized to resize = (h, w) when
    given."""
    return np.stack(list(iter_video_frames(path, resize))).astype(np.float32) / 255.0


def interpolate_video_file(src: str, dst_dir: str, models: FusionModels, method: str = "fusion",
                           resize=None, *, device="cuda") -> int:
    """Read a video file, double its frame rate and write the frames as
    PNGs into dst_dir (fmvfi_tpu/pipeline/video.py:370-381); returns
    the number of frames written."""
    frames = read_video_frames(src, resize=resize)
    out = list(double_frame_rate(frames, models, method, device=device))
    write_frame_dir(dst_dir, out)
    return len(out)


def _frame_names(path: str) -> List[str]:
    names = sorted(f for f in os.listdir(path) if f.lower().endswith(FRAME_SUFFIXES))
    if not names:
        raise ValueError(f"no frames in {path}")
    return names


def iter_frame_dir(path: str) -> Iterator[np.ndarray]:
    """Stream a directory of frames, in sorted name order, as (H, W, 3)
    uint8 RGB (fmvfi_tpu/pipeline/video.py:71-84)."""
    for n in _frame_names(path):
        yield imageio.imread(os.path.join(path, n))


def read_frame_dir(path: str) -> np.ndarray:
    """A directory of frames, in sorted name order, as (N, H, W, 3) float32
    in [0, 1] (x / 255 in float32, as JAX reads them)."""
    frames = [imageio.imread(os.path.join(path, n)) for n in _frame_names(path)]
    return np.stack(frames).astype(np.float32) / 255.0


def quantize(frame) -> np.ndarray:
    """A [0, 1] float frame as the uint8 JAX writes: x * 255 in the frame's
    dtype, clipped, truncated (not rounded)."""
    return (np.asarray(frame) * 255).clip(0, 255).astype(np.uint8)


def write_frame_dir(path: str, frames: Sequence[np.ndarray]) -> None:
    """Write frames as <path>/00000.png, 00001.png, ... (quantized as JAX
    does).  The frames are encoded on a few threads: zlib and the row
    filters release the interpreter lock."""
    os.makedirs(path, exist_ok=True)
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        futures = [ex.submit(imageio.imwrite, os.path.join(path, f"{i:05d}.png"), quantize(f))
                   for i, f in enumerate(frames)]
        for fut in futures:
            fut.result()


def to_device(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array as a tensor on dev.  To a card it is copied through
    pinned memory without blocking the host (a copy from pageable memory
    waits until the card has finished its queued work)."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if dev.type != "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


def _to_host(t: torch.Tensor):
    """Queue the copy of t to host memory; returns (host tensor, event to
    wait on before reading it, or None on the CPU)."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def _fetch(host: torch.Tensor, done) -> np.ndarray:
    """Wait for a queued copy; the result in ordinary host memory (the pinned
    buffer goes back to the allocator)."""
    if done is not None:
        done.synchronize()
    return np.array(host.numpy())


def _interp_fn(
    models: FusionModels, method: str, seq_chunk: int = 0, *, device="cuda"
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """The two-frame function of `method` for (B, H, W, 3) frames on the
    device: fusion (which pads to /8 and takes its filter bank at the padded
    size), phase, adacof or baseline (fmvfi_tpu/pipeline/video.py:167-183).
    JAX's takes the frame size to fetch a filter bank for it; here every
    method finds its bank in the cache of `make_filters`, by shape and
    device.  The fusion head's variant and maps are those of
    models.fusion_net."""
    if method == "fusion":
        return lambda a, b: fusion_interpolate(models, a, b, device=device, seq_chunk=seq_chunk)
    if method == "phase":
        return lambda a, b: phase_interpolate(models.phase_net, a, b, device=device)
    if method == "adacof":
        return lambda a, b: adacof_interpolate(models.adacof, a, b, device=device)
    if method == "baseline":
        return lambda a, b: baseline_interpolate(models, a, b, device=device)
    raise ValueError(f"unknown method {method!r}; expected one of {METHODS}")


def double_frame_rate(
    frames: np.ndarray,
    models: FusionModels,
    method: str = "fusion",
    stream: bool = False,
    batch: int = 1,
    stream_window: int = 8,
    seq_chunk: int = 0,
    *,
    device="cuda",
) -> Iterator[np.ndarray]:
    """Yield the 2x-rate sequence f0, mid01, f1, mid12, f2, ...
    (fmvfi_tpu/pipeline/video.py:186-235).

    Per pair by default, with pair i+1's work queued on the card before pair
    i's result is copied back.  `batch` > 1 interpolates that many
    consecutive pairs per dispatch (the ragged tail padded with the last
    pair, whose repeats are dropped), with `seq_chunk` as in
    `fusion_interpolate`; it overrides `stream`.  `stream=True` (fusion
    only) runs the streaming fusion, fetching `stream_window` outputs at a
    time.  A clip of fewer than 2 frames is yielded as it is."""
    frames = np.asarray(frames)
    n = frames.shape[0]
    if n < 2:  # nothing to interpolate between
        yield from frames
        return
    dev = _device(device)
    if batch <= 1 and stream and method == "fusion":
        yield from _double_frame_rate_stream(frames, models, stream_window, dev)
    else:
        yield from _double_frame_rate_batched(frames, models, method, max(batch, 1), seq_chunk, dev)


def multiply_frame_rate(
    frames: np.ndarray,
    models: FusionModels,
    method: str = "fusion",
    factor: int = 2,
    stream: bool = False,
    batch: int = 1,
    stream_window: int = 8,
    seq_chunk: int = 0,
    *,
    device="cuda",
) -> Iterator[np.ndarray]:
    """Yield the `factor`x-rate sequence by repeated midpoint doubling
    (fmvfi_tpu/pipeline/video.py:238-270).  `factor` must be a power of two:
    the models are trained for the t = 0.5 midpoint."""
    if factor < 2 or factor & (factor - 1):
        raise ValueError(f"factor must be a power of two >= 2, got {factor}")
    opts = dict(stream=stream, batch=batch, stream_window=stream_window, seq_chunk=seq_chunk,
                device=device)
    cur = np.asarray(frames)
    while factor > 2:
        cur = np.stack(list(double_frame_rate(cur, models, method, **opts)))
        factor //= 2
    yield from double_frame_rate(cur, models, method, **opts)


def _emit(frames: np.ndarray, firsts: List[int], host, done) -> Iterator[np.ndarray]:
    """For each pair (firsts[k], firsts[k] + 1): its first frame, then its
    interpolated frame, row k of the fetched result."""
    out = _fetch(host, done)
    for k, i in enumerate(firsts):
        yield frames[i]
        yield out[k]


def _double_frame_rate_batched(
    frames: np.ndarray, models: FusionModels, method: str, batch: int, seq_chunk: int,
    dev: torch.device,
) -> Iterator[np.ndarray]:
    """`batch` consecutive pairs per dispatch (batch 1: per pair), the ragged
    tail padded with the last pair so every dispatch has one shape, and a
    one-deep prefetch (fmvfi_tpu/pipeline/video.py:273-311)."""
    fn = _interp_fn(models, method, seq_chunk, device=dev)
    n_pairs = len(frames) - 1
    pending = None  # (first frames of the valid pairs, host result, event)
    for s in range(0, n_pairs, batch):
        valid = list(range(s, min(s + batch, n_pairs)))
        idx = np.array(valid + [n_pairs - 1] * (batch - len(valid)))
        result = fn(to_device(frames[idx], dev), to_device(frames[idx + 1], dev))
        queued = (valid, *_to_host(result))
        if pending is not None:
            yield from _emit(frames, *pending)
        pending = queued
    yield from _emit(frames, *pending)
    yield frames[-1]


def _double_frame_rate_stream(
    frames: np.ndarray, models: FusionModels, window: int, dev: torch.device
) -> Iterator[np.ndarray]:
    """The streaming fusion (fmvfi_tpu/pipeline/video.py:314-367).  Global
    step k takes frame min(k+1, n-1) and finishes pair (k-1, k): step 0
    primes (its output dropped) and step n-1 repeats the last frame (the
    flush), so an n-frame clip takes n steps.  The steps run `window` at a
    time through `fusion_stream_scan`, and a window's outputs are fetched
    while the next window runs.  JAX pads the last window to keep one
    compiled scan; the steps are causal, so here the padding is not run."""
    n, h, w, _ = frames.shape
    ph, pw = (-h) % 8, (-w) % 8
    filters = make_filters(h + ph, w + pw, max_pyr_height(h + ph, w + pw), device=dev)
    window = max(1, min(window, n))

    def up(idx):  # frames idx as (T, 1, H', W', 3) on the /8 grid
        x = to_device(frames[idx], dev).permute(0, 3, 1, 2)
        return _nhwc(_pad8(x))[:, None]

    carry = fusion_stream_init(up([0])[0], filters, models.fusion_net.uncertainty_maps,
                               device=dev)
    pending = None  # (first frames of the finished pairs, host result, event)
    for s in range(0, n, window):
        e = min(s + window, n)
        carry, fused = fusion_stream_scan(models, carry, up(np.minimum(np.arange(s, e) + 1, n - 1)),
                                          filters, device=dev)
        first = max(s, 1)  # step 0's output finishes no pair
        queued = None
        if first < e:
            queued = ([k - 1 for k in range(first, e)],
                      *_to_host(fused[first - s :, 0, :h, :w]))
        if pending is not None:
            yield from _emit(frames, *pending)
        pending = queued
    if pending is not None:
        yield from _emit(frames, *pending)
    yield frames[-1]
