"""The training loop (port of fmvfi_tpu/train/loop.py): epochs,
checkpoints with resume, a JSONL metrics stream, a PSNR probe and an image
probe.

- `MetricsWriter`: one JSON record per logged step, and the loss-curve PNG
  (`plot`, drawn by eval/visualize.py without matplotlib).
- `PsnrProbe`: fixed probe triplets scored after every epoch (the
  reference's per-epoch Middlebury-other PSNR, adacof/TestModule.py:43-64).
- `fit()`: the epoch loop gluing a (state, step_fn) pair from train.trainer
  to a batch iterator, resuming from the latest checkpoint, with the
  hierarchical-m schedule of PhaseNet training, the probes, and an outer
  wrapper (`wrap_step`, e.g. parallel.dp.data_parallel) kept across the
  schedule's rebuilds.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Iterable, Optional, Sequence, Union

import numpy as np
import torch

from ..parallel.distributed import process_index
from ..utils import imageio
from ..utils.checkpoint import Checkpointer


class MetricsWriter:
    """Appends one JSON record per `write` to <out_dir>/<name>_metrics.jsonl
    and keeps each metric's (step, value) history for `plot`."""

    def __init__(self, out_dir: str, name: str = "train"):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.name = name
        self.path = os.path.join(out_dir, f"{name}_metrics.jsonl")
        self._f = open(self.path, "a")
        self.history: Dict[str, list] = {}

    def write(self, step: int, metrics: Dict[str, float], **extra):
        rec = {"step": int(step), "time": time.time(), **extra}
        for k, v in metrics.items():
            v = float(v)
            rec[k] = v
            self.history.setdefault(k, []).append((step, v))
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def plot(self, keys: Optional[Sequence[str]] = None) -> str:
        """<out_dir>/<name>_curve.png, 800 x 400: one line per key (by
        default those ending in "loss") against step, in tab10 order, with
        axis labels and a legend, laid out as JAX's matplotlib figure
        (fmvfi_tpu/train/loop.py:47-67)."""
        from ..eval.visualize import curve_figure

        keys = keys or [k for k in self.history if k.endswith("loss") or k == "loss"]
        series = {k: tuple(zip(*self.history[k])) for k in keys if k in self.history}
        path = os.path.join(self.out_dir, f"{self.name}_curve.png")
        imageio.imwrite(path, curve_figure(series).render())
        return path

    def close(self):
        self._f.close()


class PsnrProbe:
    """Score fixed triplets with predict_fn(state, f1, f2) -> pred, frames
    (1, H, W, 3) in [0, 1]; calling the probe returns the mean PSNR in dB
    (fmvfi_tpu/train/loop.py:73-98)."""

    def __init__(self, triplets, predict_fn: Callable):
        self.triplets = triplets  # list of (f1, mid, f2) arrays (H, W, 3)
        self.predict_fn = predict_fn

    @classmethod
    def from_middlebury(cls, input_dir: str, gt_dir: str, predict_fn: Callable):
        """The Middlebury-other probe (the reference's training regression
        gate, adacof/trainer.py:33,60 + TestModule.py:43-64), scenes in
        sorted order."""
        from ..eval.datasets import middlebury_other

        scenes = middlebury_other(input_dir, gt_dir)
        return cls([scenes[k] for k in sorted(scenes)], predict_fn)

    def __call__(self, state) -> float:
        psnrs = []
        for f1, mid, f2 in self.triplets:
            pred = self.predict_fn(state, f1[None], f2[None])
            pred = pred.detach().cpu().numpy() if torch.is_tensor(pred) else np.asarray(pred)
            mse = np.mean((pred[0] - mid) ** 2)
            psnrs.append(-10 * np.log10(max(mse, 1e-12)))
        return float(np.mean(psnrs))


def _write_image_probe(out_dir: str, step: int, img) -> str:
    """An (H, W, 3) [0, 1] frame as <out_dir>/result/step_<N>.png, quantized
    as JAX's fit writes it (x 255, clipped, truncated)."""
    img = img.detach().cpu().numpy() if torch.is_tensor(img) else np.asarray(img)
    d = os.path.join(out_dir, "result")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"step_{step:06d}.png")
    imageio.imwrite(path, (img * 255).clip(0, 255).astype(np.uint8))
    return path


def fit(
    state,
    step_fn: Callable,
    batches: Iterable,
    out_dir: str,
    epochs: int = 1,
    steps_per_epoch: Optional[int] = None,
    log_every: int = 50,
    ckpt_every: int = 500,
    probe: Optional[Union[PsnrProbe, Callable]] = None,
    resume: bool = True,
    make_step: Optional[Callable[[Optional[int]], Callable]] = None,
    m_init: Optional[int] = None,
    m_update: int = 500,
    m_max: int = 10,
    image_probe: Optional[Callable] = None,
    image_every: int = 100,
    wrap_step: Optional[Callable[[Callable], Callable]] = None,
):
    """Run the loop.  `batches` yields (f1, target, f2) NHWC batches; an
    epoch is `steps_per_epoch` batches (or one pass if the iterator is finite
    and steps_per_epoch is None).  Checkpoints go to <out_dir>/checkpoint
    every `ckpt_every` steps and at the end of each epoch; with `resume`, the
    latest one is restored first and the epoch count picks up where it
    stopped.  `probe(state) -> float` (a PsnrProbe, or any callable) is
    scored and logged as probe_psnr after each epoch.  `image_probe(state)
    -> (H, W, 3) [0, 1] frame` is written to <out_dir>/result/step_<N>.png
    every `image_every` steps (the reference's fixed sample-frame renders,
    train/trainer.py:140-142).

    Hierarchical-m training (PhaseNet): with `make_step` (from
    make_phase_trainer) and `m_init`, the step is `make_step(m)`, m rising
    by one every `m_update` batches within an epoch (the count restarts
    each epoch, m does not) up to `m_max`, and the step is rebuilt at each
    rise; a resumed run starts at the m an uninterrupted run would have.
    Each metrics record carries m.

    `wrap_step(step_fn) -> step_fn` wraps the step once and again at every
    rebuild of the m schedule (JAX's fit once lost its data-parallel
    wrapper there, fmvfi_tpu/train/loop.py:141-146).  In a group of
    processes every process restores, steps and scores the probes alike,
    and only process 0 writes the metrics, checkpoints, images and the
    loss curve (<out_dir>/train_curve.png, at each checkpoint, as JAX's fit
    draws it)."""
    writes = process_index() == 0
    writer = MetricsWriter(out_dir) if writes else None
    ckptr = Checkpointer(os.path.join(out_dir, "checkpoint"))
    if resume and ckptr.latest() is not None:
        state = ckptr.restore(state)
    wrap = wrap_step or (lambda f: f)

    it = iter(batches)
    step = state.step
    # resume mid-schedule: land on the epoch and in-epoch count an
    # uninterrupted run would be at for the restored step
    if step and steps_per_epoch:
        start_epoch, resume_n = divmod(step, steps_per_epoch)
    else:
        start_epoch, resume_n = 0, 0

    m = m_init
    if make_step is not None and m is not None:
        if step:
            if steps_per_epoch:
                inc = start_epoch * (steps_per_epoch // m_update) + resume_n // m_update
            else:
                inc = step // m_update  # one continuous pass
            m = min(m_max, m_init + inc)
        step_fn = make_step(m)
    step_fn = wrap(step_fn)

    try:
        for epoch in range(start_epoch, epochs):
            n = resume_n if epoch == start_epoch else 0
            while steps_per_epoch is None or n < steps_per_epoch:
                try:
                    batch = next(it)
                except StopIteration:
                    break
                state, metrics = step_fn(state, batch)
                step += 1
                n += 1
                if writes and step % log_every == 0:
                    writer.write(step, metrics, epoch=epoch, **({} if m is None else {"m": m}))
                if writes and step % ckpt_every == 0:
                    ckptr.save(step, state)
                    writer.plot()
                if image_probe is not None and step % image_every == 0:
                    img = image_probe(state)
                    if writes:
                        _write_image_probe(out_dir, step, img)
                if make_step is not None and m is not None and n % m_update == 0 and m < m_max:
                    m += 1
                    step_fn = wrap(make_step(m))
            if probe is not None:
                score = probe(state)
                if writes:
                    writer.write(step, {"probe_psnr": score}, epoch=epoch)
            if writes:
                ckptr.save(step, state)
                writer.plot()
    finally:
        if writes:
            writer.close()
    return state
