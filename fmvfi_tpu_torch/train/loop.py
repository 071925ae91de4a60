"""The training loop (port of fmvfi_tpu/train/loop.py): epochs,
checkpoints with resume, a JSONL metrics stream and an optional probe.

- `MetricsWriter`: one JSON record per logged step.
- `fit()`: the epoch loop gluing a (state, step_fn) pair from train.trainer
  to a batch iterator, resuming from the latest checkpoint, with the
  hierarchical-m schedule of PhaseNet training.
Still to be ported (ROADMAP Queue 1, item 17): the loss-curve plot and the
image probe.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Iterable, Optional

from ..utils.checkpoint import Checkpointer


class MetricsWriter:
    def __init__(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, "train_metrics.jsonl")
        self._f = open(self.path, "a")

    def write(self, step: int, metrics: Dict[str, float], **extra):
        rec = {"step": int(step), "time": time.time(), **extra}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


def fit(
    state,
    step_fn: Callable,
    batches: Iterable,
    out_dir: str,
    epochs: int = 1,
    steps_per_epoch: Optional[int] = None,
    log_every: int = 50,
    ckpt_every: int = 500,
    probe: Optional[Callable] = None,
    resume: bool = True,
    make_step: Optional[Callable[[Optional[int]], Callable]] = None,
    m_init: Optional[int] = None,
    m_update: int = 500,
    m_max: int = 10,
):
    """Run the loop.  `batches` yields (f1, target, f2) NHWC batches; an
    epoch is `steps_per_epoch` batches (or one pass if the iterator is finite
    and steps_per_epoch is None).  Checkpoints go to <out_dir>/checkpoint
    every `ckpt_every` steps and at the end of each epoch; with `resume`, the
    latest one is restored first and the epoch count picks up where it
    stopped.  `probe(state) -> float` is scored and logged after each
    epoch.

    Hierarchical-m training (PhaseNet): with `make_step` (from
    make_phase_trainer) and `m_init`, the step is `make_step(m)`, m rising
    by one every `m_update` batches within an epoch (the count restarts
    each epoch, m does not) up to `m_max`, and the step is rebuilt at each
    rise; a resumed run starts at the m an uninterrupted run would have.
    Each metrics record carries m."""
    writer = MetricsWriter(out_dir)
    ckptr = Checkpointer(os.path.join(out_dir, "checkpoint"))
    if resume and ckptr.latest() is not None:
        state = ckptr.restore(state)

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
                if step % log_every == 0:
                    writer.write(step, metrics, epoch=epoch, **({} if m is None else {"m": m}))
                if step % ckpt_every == 0:
                    ckptr.save(step, state)
                if make_step is not None and m is not None and n % m_update == 0 and m < m_max:
                    m += 1
                    step_fn = make_step(m)
            if probe is not None:
                writer.write(step, {"probe_psnr": probe(state)}, epoch=epoch)
            ckptr.save(step, state)
    finally:
        writer.close()
    return state
