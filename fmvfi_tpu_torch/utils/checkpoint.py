"""Train-state checkpoints with resume (port of the `Checkpointer` of
fmvfi_tpu/utils/checkpoint.py, on torch.save instead of orbax).

One file per step, `<directory>/step_%08d`, holding the model's state dict
("params"), the optimizer's ("opt_state"), the step and, where the state
has one, the state dict of `state.extra` ("extra": the adversarial term's
critic with its BN statistics, its optimizer and its generator).  A save
writes a private temporary name and renames it into place, so a reader
never sees half a checkpoint.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

import torch


class Checkpointer:
    """Step-numbered checkpoints of a train.trainer.TrainState."""

    def __init__(self, directory: str):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"step_{step:08d}")

    def save(self, step: int, state) -> None:
        payload = {
            "params": state.model.state_dict(),
            "opt_state": state.optimizer.state_dict(),
            "step": int(state.step),
        }
        if getattr(state, "extra", None) is not None:
            payload["extra"] = state.extra.state_dict()
        fd, tmp = tempfile.mkstemp(prefix=".tmp_", dir=self._dir)
        try:
            with os.fdopen(fd, "wb") as f:
                torch.save(payload, f)
            os.replace(tmp, self._path(step))
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def latest(self) -> Optional[int]:
        steps = []
        for name in os.listdir(self._dir):
            if name.startswith("step_"):
                try:
                    steps.append(int(name[5:]))
                except ValueError:
                    pass
        return max(steps) if steps else None

    def restore(self, state, step: Optional[int] = None):
        """Load a checkpoint (the latest by default) into state's model,
        optimizer and extra; return the state with its step."""
        step = step if step is not None else self.latest()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self._dir}")
        dev = next(state.model.parameters()).device
        payload = torch.load(self._path(step), map_location=dev, weights_only=True)
        state.model.load_state_dict(payload["params"])
        state.optimizer.load_state_dict(payload["opt_state"])
        if "extra" in payload:
            state.extra.load_state_dict(payload["extra"])
        return state._replace(step=payload["step"])
