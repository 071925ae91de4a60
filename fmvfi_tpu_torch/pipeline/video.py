"""Frame-rate doubling of a frame sequence (port of
fmvfi_tpu/pipeline/video.py): per pair, `batch` pairs per dispatch (with
`seq_chunk`), or the streaming fusion, each with a one-deep prefetch; and
directories of PNG or JPEG frames, read with utils.imageio (PNGs written).

Frames are host arrays (N, H, W, 3), float32 in [0, 1]; the frames yielded
are numpy (H, W, 3).  On the card, frames go up through pinned memory and
results come down into pinned memory, both copied asynchronously, so the
host waits only for a finished result: pair i+1's work is queued on the card
before the host waits for pair i's.  Video files are read when they hold
what utils/formats.py's table lists: Motion-JPEG, MPEG-4 Part 2, MPEG-1/2,
VP8 or VP9 (8, 10 and 12 bits), H.263, Sorenson Spark, MS-MPEG4 v2 / v3,
PNG and raw frames in AVI (utils/avi.py), MP4 / M4V / MOV / 3GP
(utils/mp4.py), Matroska / WebM (utils/mkv.py), MPEG transport and program
streams and raw MPEG video (utils/mpegts.py), IVF (utils/ivf.py) and FLV
(utils/flv.py), each frame decoded as cv2.VideoCapture decodes it
(FFmpeg's decoders and swscale's conversion: native/mjpeg.cpp, mpeg4.cpp,
mpeg12.cpp, vp8.cpp, vp9.cpp, h263.cpp, msmpeg4.cpp, png.cpp and
rawvideo.cpp; an MP4 track's rotation applied as cv2 applies it;
MPEG-1/2's display order and the frame it holds back until the end of the
stream, as cv2 drains the decoder); the container is told from the file's
bytes, as FFmpeg probes it.  Other codecs and containers (H.264, HEVC,
AV1, VP6; Ogg, ASF, ...) raise NotImplementedError naming ROADMAP item
18.4 (the card's machine has no decoder for them), what the H.263 family's
decoders decode otherwise item 18.4i.  A lone PNG, JPEG or WebP image, and a printf pattern
of them or of GIFs (`frames/%05d.png`), read as one video as
cv2.VideoCapture reads them (FFmpeg's image2 demuxer, or cv2's own image
backend for GIFs: utils/image2.py); a lone GIF is a clip of every image in
it, composited as FFmpeg's gif demuxer and decoder composite them
(utils/gif.py); lone images and sequences of other formats raise
NotImplementedError naming item 18.4k.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, List, Sequence

import numpy as np
import torch

from .. import native
from ..ops.pyramid import make_filters, max_pyr_height
from ..utils import avi, flv, formats, gif, image2, imageio, ivf, mkv, mp4, mpegts
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
OTHER_CONTAINERS = ((b"OggS", "an Ogg file"), (b"0&\xb2u", "an ASF (WMV) file"))


def _container(path: str) -> str:
    """"avi", "mp4", "mkv", "ivf", "flv", "ts", "ps" or "es" (a raw MPEG video
    stream) from the file's first bytes, as FFmpeg probes them, "gif" for a
    GIF (FFmpeg's gif demuxer: every image a frame), or "image" for another
    lone image or a numbered image sequence (FFmpeg's image2, read by
    utils/image2.py); NotImplementedError for a container the port does not
    read, ValueError for a file that is none (cv2 decodes no frames from
    it)."""
    if image2.is_sequence(path):
        return "image"
    try:
        with open(path, "rb") as f:
            head = f.read(192 * 5)
    except OSError:
        raise ValueError(f"no frames decoded from {path}") from None
    if head[:4] == b"RIFF" and head[8:12] == b"AVI ":
        return "avi"
    if head[4:8] in ISO_BOXES:
        return "mp4"
    if head.startswith(MATROSKA):
        return "mkv"
    if head.startswith(ivf.MAGIC):
        return "ivf"
    if flv.is_flv(head):
        return "flv"
    if mpegts.ts_packet_size(head):
        return "ts"
    if head.startswith(mpegts.PACK):
        return "ps"
    if head.startswith(mpegts.SEQUENCE):
        return "es"
    if gif.is_gif(head):
        return "gif"
    if imageio.image_format(head) is not None:  # a video of one frame
        return "image"
    for magic, what in OTHER_CONTAINERS:
        if head.startswith(magic):
            raise formats.unsupported(path, what)
    raise ValueError(f"no frames decoded from {path}")


def _as_refusal(path: str, where: str, e: Exception, item: str = "18.4") -> Exception:
    """A decoder's error about `where` in `path`; NotImplementedError names
    ROADMAP item `item`."""
    if isinstance(e, NotImplementedError):
        return NotImplementedError(f"{path}: {where}{e} (ROADMAP Queue 1, item {item}: FFmpeg "
                                   "decodes it otherwise)")
    return ValueError(f"{path}: {where}{e}")


def _open(path: str):
    """(packets, (decode, flush), rotation, codec) of a video file."""
    container = _container(path)
    if container == "mkv":
        try:
            track = mkv.open_video(path)
        except ValueError as e:  # cv2 opens no stream in it
            raise ValueError(f"no frames decoded from {path} ({e})") from None
        # CodecPrivate configures mp4v (the VOL) and MPEG-1/2 (the sequence header)
        return (mkv.iter_samples(track), formats.decoder(track.codec, track.config), 0,
                track.codec)
    if container == "avi":
        stream = avi.open_video(path)
        return (avi.iter_frames(stream),
                formats.decoder(stream.codec, fourcc=stream.strf["compression"],
                                size=(stream.strf["width"], stream.strf["height"])), 0,
                stream.codec)
    if container == "mp4":
        track = mp4.open_video(path)
        return (mp4.iter_samples(track),
                formats.decoder(track.decoder, track.config, track.codec,
                                (track.width, track.height)), track.rotation, track.decoder)
    if container == "ivf":
        clip = ivf.open_video(path)
        return ivf.iter_frames(clip), formats.decoder(clip.codec), 0, clip.codec
    if container == "flv":
        clip = flv.open_video(path)
        return flv.iter_frames(clip), formats.decoder("flv1"), 0, "flv1"
    stream = mpegts.open_stream(path, container)
    return mpegts.iter_packets(stream), formats.decoder(stream.codec), 0, stream.codec


def _iter_decoded(path: str) -> Iterator[np.ndarray]:
    """A video file's frames as cv2.VideoCapture returns them, (H, W, 3)
    uint8 RGB, in the decoder's output order: a VP9 packet yields the frames
    it shows (none for a hidden frame, two for a superframe showing two), an
    MPEG-1/2 packet the frame its picture lets out (display order), and the
    end of the stream the frame an MPEG-1/2 decoder still holds; a GIF its
    images (utils/gif.py); a lone image or a numbered sequence its images
    (utils/image2.py)."""
    container = _container(path)
    if container == "image":
        yield from image2.iter_frames(path)
        return
    if container == "gif":
        with open(path, "rb") as f:
            data = f.read()
        try:
            yield from gif.frames(data)
        except ValueError as e:
            raise ValueError(f"{path}: GIF: {e}") from None
        except NotImplementedError as e:
            raise _as_refusal(path, "", e, "18.4k") from None
        return
    try:
        samples, (decode, flush), rotation, codec = _open(path)
    except (ValueError, NotImplementedError) as e:
        if "18.4" in str(e) or str(e).startswith(("no frames decoded", path)):
            raise
        raise _as_refusal(path, "", e) from None
    item = {"mpeg12": "18.4h", "png": "18.4g", "rawvideo": "18.4g", "h263": "18.4i",
            "flv1": "18.4i", "msmpeg4": "18.4i"}.get(codec, "18.4")
    for i, data in enumerate(samples):
        try:
            frame = decode(data)
        except native.EndOfStream:  # FFmpeg fails the packet: cv2 reads no further
            return
        except (ValueError, NotImplementedError) as e:
            raise _as_refusal(path, f"frame {i}: ", e, item) from None
        if frame is None:  # a packet of headers or a not-coded VOP
            continue
        for f in frame if isinstance(frame, list) else [frame]:
            yield mp4.rotate(f, rotation)
    if flush is not None:
        for f in flush():
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
