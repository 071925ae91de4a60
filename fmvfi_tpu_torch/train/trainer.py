"""Training steps (port of fmvfi_tpu/train/trainer.py; the AdaCoF regime).

`make_adacof_trainer` returns `(state, step_fn)` as the JAX trainer does, and
`state, metrics = step_fn(state, batch)` takes one optimizer step on an NHWC
(frame1, target, frame2) batch.  PyTorch updates the model and the
optimizer in place; the returned state carries the same objects and the
step count advanced by one.  The PhaseNet and FusionNet trainers come with a
later slice (ROADMAP Queue 1, item 16).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch import nn

from ..models.adacof import AdaCoFNet, smoothness_penalties
from ..pipeline.interpolate import _device, _nchw
from .losses import LossSpec, charbonnier, gan_terms, has_term, l1, mse, parse_loss_spec

DEFAULT_LOSS = "1*Charb+0.01*g_Spatial+0.005*g_Occlusion"


class TrainState(NamedTuple):
    """The model (its parameters are the params), the optimizer (its state
    is the opt_state; its param group's `updates` counts the updates
    applied, which drives the LR schedule) and `step`, the steps taken,
    skipped ones included."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int


def staircase_lr(lr: float, decay_steps: Optional[int], rate: float) -> Callable[[int], float]:
    """The LR after `count` applied updates: lr * rate**(count // decay_steps),
    optax.exponential_decay(lr, decay_steps, rate, staircase=True); constant
    without decay_steps."""
    if not decay_steps:
        return lambda count: lr
    return lambda count: lr * rate ** (count // decay_steps)


_OPTIMIZERS = {
    # torch's defaults are optax's: Adam/Adamax b1 0.9, b2 0.999, eps 1e-8;
    # Adamax nu = max(b2 * nu, |g| + eps) with bias-corrected mu, as optax
    "adam": torch.optim.Adam,
    "adamax": torch.optim.Adamax,
    "sgd": torch.optim.SGD,
}


def adacof_loss(model: AdaCoFNet, spec: LossSpec, f1, target, f2):
    """The AdaCoF training loss of NCHW frames: (total, dict of the terms
    Charb, L1, MSE, g_Spatial and g_Occlusion)."""
    out = model(f1, f2)
    g_spatial, g_occ = smoothness_penalties(*out.heads, out.occ_raw)
    values = {
        "Charb": charbonnier(out.blended, target),
        "L1": l1(out.blended, target),
        "MSE": mse(out.blended, target),
        "g_Spatial": g_spatial,
        "g_Occlusion": g_occ,
    }
    return spec(values), values


def make_adacof_trainer(
    kernel_size: int = 5,
    dilation: int = 1,
    lr: float = 1e-3,
    loss_spec: Optional[LossSpec] = None,
    optimizer: str = "adamax",
    lr_decay_steps: Optional[int] = None,
    lr_decay_rate: float = 0.5,
    grad_clip: float = 1.0,
    seed: int = 0,
    device="cuda",
):
    """AdaCoF training: the loss spec (default 1*Charb+0.01*g_Spatial
    +0.005*g_Occlusion) on the blended prediction, Adamax at lr 1e-3.

    - `lr_decay_steps`: the LR is multiplied by `lr_decay_rate` every N
      applied updates (staircase).
    - `grad_clip` > 0: clip by global norm (g * clip / norm where norm >=
      clip) and skip the update when the gradient is not finite: params and
      optimizer state stay, `step` advances (optax.apply_if_finite).  0: the
      plain optimizer.
    - The model is AdaCoFNet(kernel_size, dilation) with the 48 px offset
      clamp, initialised from `seed`; load weights into `state.model` to
      start from them.
    The warp runs K1 / K2 on CUDA and the plain versions on the CPU."""
    spec = loss_spec or parse_loss_spec(DEFAULT_LOSS)
    unported = [n for _, n in gan_terms(spec)] + (["VGG"] if has_term(spec, "VGG") else [])
    if unported:
        raise NotImplementedError(
            f"loss terms {unported} are not ported yet (ROADMAP Queue 1, item 17: "
            "train/vgg.py, train/adversarial.py)"
        )
    if optimizer not in _OPTIMIZERS:
        raise ValueError(f"unknown optimizer {optimizer!r} (have {sorted(_OPTIMIZERS)})")
    dev = _device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = AdaCoFNet(kernel_size=kernel_size, dilation=dilation)
    model = model.to(dev).train()
    schedule = staircase_lr(lr, lr_decay_steps, lr_decay_rate)
    opt = _OPTIMIZERS[optimizer](model.parameters(), lr=schedule(0))
    opt.param_groups[0]["updates"] = 0

    def step_fn(state: TrainState, batch):
        model, opt = state.model, state.optimizer
        loss, values = adacof_loss(model, spec, *(_nchw(a, dev) for a in batch))
        params = list(model.parameters())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in values.items()}}

        if grad_clip:
            norms = torch.stack([torch.linalg.vector_norm(g) for g in grads])
            if not bool(torch.isfinite(norms).all()):
                return state._replace(step=state.step + 1), metrics
            norm = torch.linalg.vector_norm(norms)
            if float(norm) >= grad_clip:
                grads = [g / norm * grad_clip for g in grads]
        group = opt.param_groups[0]
        group["lr"] = schedule(group["updates"])
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
        opt.zero_grad(set_to_none=True)
        group["updates"] += 1
        return state._replace(step=state.step + 1), metrics

    return TrainState(model, opt, 0), step_fn
