"""Checkpoints (port of fmvfi_tpu/utils/checkpoint.py).

`save_msgpack` / `load_msgpack`: flax-layout weight trees (nested dicts of
numpy arrays, as utils/convert.py's `*_to_flax` make them) in the repo's
published-model format, *.msgpack, through utils/msgpack_io.py: a file the
JAX package, `load_adacof_weights` / `load_fusion_weights` and the command
line's --adacof_checkpoint / --fusion_checkpoint read.

`Checkpointer`: train-state checkpoints with resume, on torch.save instead
of orbax.

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
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from . import msgpack_io


def _write_atomic(path: str, write: Callable) -> None:
    """write(f) to a private temporary name beside `path`, then rename it
    into place: a reader never sees half a file."""
    fd, tmp = tempfile.mkstemp(prefix=".tmp_", dir=os.path.dirname(path))
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save_msgpack(path: str, tree: Dict[str, Any]) -> None:
    """Write a flax-layout tree as flax.serialization.to_bytes writes it
    (the parent directory is made if missing)."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    data = msgpack_io.dumps(tree)
    _write_atomic(path, lambda f: f.write(data))


def _restore(like, tree, where: str):
    """`tree` in `like`'s structure: every key of `like` must be in `tree`
    (flax's rule), and every array of `like` must have its shape."""
    if isinstance(like, dict):
        if not isinstance(tree, dict):
            raise ValueError(f"{where or 'the tree'}: expected a dict, got {type(tree).__name__}")
        missing = [k for k in like if k not in tree]
        if missing:
            raise ValueError(f"{where or 'the tree'}: keys {missing} are not in the file")
        return {k: _restore(v, tree[k], f"{where}/{k}") for k, v in like.items()}
    if isinstance(tree, dict) or np.shape(like) != np.shape(tree):
        held = "a dict" if isinstance(tree, dict) else np.shape(tree)
        raise ValueError(f"{where}: the file holds {held}, the template {np.shape(like)}")
    return tree


def load_msgpack(path: str, like: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Read a flax .msgpack file; with `like` (a template tree), the result
    has its structure and is checked against it (ValueError)."""
    tree = msgpack_io.load(path)
    return tree if like is None else _restore(like, tree, "")


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
        _write_atomic(self._path(step), lambda f: torch.save(payload, f))

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
