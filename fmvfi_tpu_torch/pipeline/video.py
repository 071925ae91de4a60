"""Frame-rate doubling of a frame sequence (port of the array side of
fmvfi_tpu/pipeline/video.py:111-367): per pair, `batch` pairs per dispatch
(with `seq_chunk`), or the streaming fusion, each with a one-deep prefetch.

Frames are host arrays (N, H, W, 3), float32 in [0, 1]; the frames yielded
are numpy (H, W, 3).  On the card, frames go up through pinned memory and
results come down into pinned memory, both copied asynchronously, so the
host waits only for a finished result: pair i+1's work is queued on the card
before the host waits for pair i's.  The file readers and writers of the JAX
module (cv2) are not ported.
"""

from __future__ import annotations

from typing import Callable, Iterator, List

import numpy as np
import torch

from ..ops.pyramid import make_filters, max_pyr_height
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
