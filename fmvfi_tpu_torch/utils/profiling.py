"""Profiling and debug-mode utilities (port of fmvfi_tpu/utils/profiling.py).

- `trace(log_dir)`: a context manager around `torch.profiler` (CPU and,
  with a card, CUDA activity) that writes a Chrome trace into `log_dir`
  (view it in chrome://tracing, Perfetto or TensorBoard's profiler).
- `timed(fn, x0)`: the time of one iteration of a self-composable fn,
  chained through the device and synchronized once at each end; on a card
  timed with CUDA events.
- `stage_timer`: per-stage host-clock times for pipeline breakdowns.
- `checked(fn)`: raises FloatingPointError on the first NaN or Inf in an
  output, the port's counterpart of checkify's float checks.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Iterator, Tuple

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; yields the `torch.profiler.profile` (for
    `key_averages()`), and writes its Chrome trace to
    `<log_dir>/<host>_<pid>.<ns>.pt.trace.json` when the block ends."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ) as prof:
        yield prof


def _leaves(x, path: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every tensor in nested tuples, lists and dicts."""
    if isinstance(x, torch.Tensor):
        yield path or "output", x
    elif isinstance(x, dict):
        for k, v in x.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(x, (tuple, list)):
        for i, v in enumerate(x):
            yield from _leaves(v, f"{path}[{i}]")


def _sync(x) -> None:
    """Wait for the device of x's first tensor (nothing to wait for on the
    CPU)."""
    for _, t in _leaves(x):
        if t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
        return


def timed(fn: Callable, x0, iters: int = 10, warmup: int = 1) -> float:
    """Seconds per iteration of a self-composable fn(x) -> x: `warmup`
    iterations, a synchronize, then `iters` iterations chained through the
    device, each fed the last one's output, and one synchronize at the end.
    On a CUDA tensor the iterations are timed with CUDA events, else with
    the host clock."""
    x = x0
    for _ in range(warmup):
        x = fn(x)
    _sync(x)
    dev = next((t.device for _, t in _leaves(x)), torch.device("cpu"))
    if dev.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with torch.cuda.device(dev):
            start.record()
            for _ in range(iters):
                x = fn(x)
            end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        x = fn(x)
    return (time.perf_counter() - t0) / iters


class stage_timer:
    """with stage_timer() as t:  ...  t.stage('decode'); ...  t.stage('warp')

    `times[name]` accumulates the host-clock seconds since the previous
    stage (or the block's start); `stage(name, block_on=tensors)` first
    waits for the device of `block_on`, so that its work counts to this
    stage."""

    def __init__(self):
        self.times: Dict[str, float] = {}
        self._last = None

    def __enter__(self):
        self._last = time.perf_counter()
        return self

    def stage(self, name: str, block_on=None):
        if block_on is not None:
            _sync(block_on)
        now = time.perf_counter()
        self.times[name] = self.times.get(name, 0.0) + (now - self._last)
        self._last = now

    def __exit__(self, *exc):
        return False


def checked(fn: Callable) -> Callable:
    """Wrap fn so that it raises FloatingPointError, naming the leaf, on the
    first NaN or Inf in a floating-point tensor of its output (a tensor, or
    nested tuples, lists and dicts of them).

    The counterpart of checkify's float checks in fmvfi_tpu: it reads the
    outputs, not every intermediate, and reading them waits for the
    device, so it belongs in debug runs.  checkify's index and division
    checks have no counterpart: an out-of-range index raises in PyTorch
    itself (on the card as a device-side assertion), and a float division
    by zero shows here as the Inf or NaN it leaves in an output."""

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        for path, t in _leaves(out):
            if t.is_floating_point() or t.is_complex():
                bad = ~torch.isfinite(t)
                if bool(bad.any()):
                    n = int(bad.sum())
                    kind = "NaN" if bool(torch.isnan(t).any()) else "Inf"
                    raise FloatingPointError(
                        f"{getattr(fn, '__name__', 'fn')}: {kind} in {path} "
                        f"({n} of {t.numel()} values are not finite)"
                    )
        return out

    return wrapper

