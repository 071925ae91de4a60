"""Training steps for the three regimes (port of fmvfi_tpu/train/trainer.py).

- PhaseNet (`make_phase_trainer`): Adam on L1 of the Lab image plus 0.005 x
  the circular phase loss, the target riding through the inputs' pyramid
  pass; hierarchical training through `make_step(m)`.
- AdaCoF (`make_adacof_trainer`): the loss spec, Adamax, clip + finite
  skip; a VGG perceptual term and one adversarial term, whose critic state
  rides in `TrainState.extra`.
- FusionNet (`make_fusion_trainer`): the frozen PhaseNet and AdaCoF make
  FusionNet's inputs, only FusionNet trains; Adam/AdamW, clip + finite
  skip, plain L1 or the balance / distill / log-MSE modes.

Each returns a `TrainState` and a step, and `state, metrics =
step_fn(state, batch)` takes one optimizer step on an NHWC (frame1, target,
frame2) batch.  PyTorch updates the model and the optimizer in place; the
returned state carries the same objects and the step count advanced by one.
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Sequence

import torch
from torch import nn

from ..models.adacof import AdaCoFNet, smoothness_penalties
from ..models.fusion_net import FusionNet
from ..models.phase_net import PhaseNetCore, normalize_inputs, predictions_to_decomp
from ..ops import decomp as dec_ops
from ..ops.color import rgb_to_lab
from ..ops.pyramid import decompose, make_filters, max_pyr_height, reconstruct
from ..parallel import dp
from ..pipeline.interpolate import FusionModels, _chan_batch, _device, _nchw, fusion_inputs
from .adversarial import Adversarial
from .losses import (
    LossSpec,
    charbonnier,
    gan_terms,
    has_term,
    l1,
    mse,
    parse_loss_spec,
    phase_net_loss,
)
from .vgg import VGGLoss

DEFAULT_LOSS = "1*Charb+0.01*g_Spatial+0.005*g_Occlusion"


class TrainState(NamedTuple):
    """The model (its parameters are the params), the optimizer (its state
    is the opt_state; its param group's `updates` counts the updates
    applied, which drives the LR schedule), `step`, the steps taken,
    skipped ones included, and `extra`, the adversarial term's state
    (train.adversarial.AdvState) or None."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int
    extra: Any = None


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


def _grads(loss: torch.Tensor, params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """d loss / d params, zeros for a parameter the loss does not reach (an
    optax optimizer sees a zero gradient there and still counts the step).
    Inside a data-parallel step, averaged over the processes: the global
    batch's gradient (the step takes it with autograd.grad, which no
    DistributedDataParallel hook sees, so the reduction is here)."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return dp.global_mean_([torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)])


def _apply(opt: torch.optim.Optimizer, params, grads) -> None:
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    opt.zero_grad(set_to_none=True)


def clipped_update(opt: torch.optim.Optimizer, params, grads, clip: float, loss=None) -> bool:
    """optax.apply_if_finite(chain(clip_by_global_norm(clip), opt)): skip the
    update when the gradient (or `loss`) is not finite, so that params and
    optimizer state stay, else scale the gradient by clip / max(norm, clip)
    and step.  `loss` covers what torch's autograd hides: the gradient of
    |x| at x = NaN is 0 in torch and NaN in JAX, so a NaN target leaves an
    L1 gradient finite.  The finite check is the step's one read of the
    device; returns whether the update ran.  Inside a data-parallel step
    `grads` are the global gradient and `loss` is averaged over the
    processes here, so that every process takes the same decision."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    if loss is not None:
        loss = dp.global_mean_([loss.detach().clone()])[0]
    finite = torch.isfinite(norm if loss is None else norm + loss)
    if not bool(finite):
        return False
    scale = clip / torch.clamp(norm, min=clip)
    _apply(opt, params, [g * scale for g in grads])
    return True


def adacof_loss(model: AdaCoFNet, spec: LossSpec, f1, target, f2, terms=None):
    """The AdaCoF training loss of NCHW frames: (total, dict of the terms
    Charb, L1, MSE, g_Spatial and g_Occlusion, and those that
    `terms(prediction, target, f1, f2)` returns)."""
    out = model(f1, f2)
    g_spatial, g_occ = smoothness_penalties(*out.heads, out.occ_raw)
    values = {
        "Charb": charbonnier(out.blended, target),
        "L1": l1(out.blended, target),
        "MSE": mse(out.blended, target),
        "g_Spatial": g_spatial,
        "g_Occlusion": g_occ,
    }
    if terms is not None:
        values.update(terms(out.blended, target, f1, f2))
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
    vgg_checkpoint: Optional[str] = None,
    h: Optional[int] = None,
    w: Optional[int] = None,
):
    """AdaCoF training: the loss spec (default 1*Charb+0.01*g_Spatial
    +0.005*g_Occlusion) on the blended prediction, Adamax at lr 1e-3.

    - `lr_decay_steps`: the LR is multiplied by `lr_decay_rate` every N
      applied updates (staircase).
    - `grad_clip` > 0: `clipped_update`, a global-norm clip and a skip of
      the update when the gradient is not finite (params and optimizer
      state stay, `step` advances).  0: the plain optimizer.
    - The model is AdaCoFNet(kernel_size, dilation) with the 48 px offset
      clamp, initialised from `seed`; load weights into `state.model` to
      start from them.
    - A VGG term: the conv4_3 feature MSE (train.vgg.VGGLoss) from
      `vgg_checkpoint`, a torchvision vgg16 state dict file.
    - At most one adversarial term (GAN, WGAN, WGAN_GP, FI_GAN, T_WGAN_GP):
      train.adversarial.Adversarial with a critic built for h x w crops
      and seeded from `seed`; its state rides in `state.extra` and takes
      one critic step per training step, also when the generator's update
      is skipped.  Its loss and "d_loss" join the metrics.
    The warp runs K1 / K2 on CUDA and the plain versions on the CPU."""
    spec = loss_spec or parse_loss_spec(DEFAULT_LOSS)
    gans = [n for _, n in gan_terms(spec)]
    if len(gans) > 1:
        raise ValueError(f"at most one adversarial term per spec, got {gans}")
    if gans and not (h and w):
        raise ValueError(f"loss spec contains {gans[0]}: pass h= and w=, the crop its critic "
                         "is built for")
    if has_term(spec, "VGG") and not vgg_checkpoint:
        raise ValueError("loss spec contains VGG: pass vgg_checkpoint= (a torchvision vgg16 "
                         "state dict; this offline build cannot download one)")
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
    vgg_loss = VGGLoss(vgg_checkpoint, dev) if has_term(spec, "VGG") else None
    adv = Adversarial(gans[0], (h, w), seed=seed, device=dev) if gans else None

    def step_fn(state: TrainState, batch):
        model, opt = state.model, state.optimizer

        def terms(pred, target, f1, f2):
            values = {}
            if vgg_loss is not None:
                values["VGG"] = vgg_loss(pred, target)
            if adv is not None:
                values[gans[0]], _, aux = adv.step(state.extra, pred, target, (f1, f2))
                values["d_loss"] = aux["d_loss"]
            return values

        loss, values = adacof_loss(model, spec, *(_nchw(a, dev) for a in batch), terms)
        params = list(model.parameters())
        grads = _grads(loss, params)
        metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in values.items()}}
        group = opt.param_groups[0]
        group["lr"] = schedule(group["updates"])
        if grad_clip:
            if clipped_update(opt, params, grads, grad_clip, loss):
                group["updates"] += 1
        else:
            _apply(opt, params, grads)
            group["updates"] += 1
        return state._replace(step=state.step + 1), metrics

    return TrainState(model, opt, 0, adv.init_state() if adv else None), step_fn


# ---------------------------------------------------------------- PhaseNet


def _lab_batch(x: torch.Tensor) -> torch.Tensor:
    """RGB (B, 3, H, W) -> the Lab channel batch (B*3, H, W)."""
    return _chan_batch(rgb_to_lab(x))


def make_phase_trainer(
    h: int,
    w: int,
    lr: float = 1e-3,
    height: Optional[int] = None,
    weighting_factor: float = 0.005,
    mode: str = "phase",
    model_variant: int = 0,
    adacof: Optional[AdaCoFNet] = None,
    high_level: bool = False,
    seed: int = 0,
    device="cuda",
):
    """PhaseNet training on h x w (frame1, target, frame2) RGB triplets.

    - mode 'phase': PhaseNetCore(num_img=2) on the two frames.
    - mode 'fusion': the frozen `adacof` (an AdaCoFNet on `device`) adds
      side inputs: model_variant 0 both warped frames (num_img 4), 1 its
      blended prediction (num_img 3).
    - high_level: the reconstruction carries the highpass residual of
      AdaCoF's prediction instead of zeros; it needs `adacof` too.
    The inputs, the target (and AdaCoF's prediction) go through one pyramid
    pass of `height` (the largest for h x w by default).  The loss is
    phase_net_loss with `weighting_factor`; plain Adam, no clip.  BN trains
    with batch statistics and moves its running ones.  AdaCoF runs under
    no_grad (K1 on CUDA, never K2).

    Returns (state, step_fn, eval_fn, make_step): `make_step(m)` builds a
    step that exchanges the finest [0, min(max(height - m, 0), height - 2))
    predicted levels for the target's before reconstructing, so gradients
    reach the m coarsest levels (hierarchical training); `eval_fn(state,
    f1, f2)` is the phase-mode prediction, the Lab channel batch (B*3, h, w)."""
    if mode not in ("phase", "fusion"):
        raise ValueError(f"mode must be 'phase' or 'fusion', got {mode!r}")
    dev = _device(device)
    height = height or max_pyr_height(h, w)
    filters = make_filters(h, w, height, device=dev)
    num_img = 2 if mode == "phase" else (4 if model_variant == 0 else 3)
    if mode == "fusion" or high_level:
        if adacof is None:
            raise ValueError("fusion-mode and high_level PhaseNet training need an AdaCoF")
        _device(dev, adacof)
    model = PhaseNetCore(num_img=num_img).init_params(torch.Generator().manual_seed(seed))
    model = model.to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=lr)

    def forward(model, f1, f2, target):
        """(target Lab batch, predicted Decomp, target Decomp) of NCHW frames,
        BN in train mode."""
        groups = [_lab_batch(f1), _lab_batch(f2)]
        ada = None
        if adacof is not None and (mode == "fusion" or high_level):
            with torch.no_grad():
                ada = adacof(f1, f2, with_stats=False)
        if mode == "fusion":
            if model_variant == 0:
                groups += [_lab_batch(ada.warped0), _lab_batch(ada.warped2)]
            else:
                groups.append(_lab_batch(ada.blended))
        labt = _lab_batch(target)
        groups.append(labt)
        if high_level:  # only its highpass band is used
            groups.append(_lab_batch(ada.blended))
        parts = dec_ops.split_frames(decompose(torch.cat(groups, 0), filters), len(groups))
        high = parts.pop().high if high_level else None
        vt = parts.pop()
        low, phases, amps = dec_ops.concat_for_net(parts)
        lown, pn, an, norm = normalize_inputs(low, phases, amps)
        lo, pp, ap = model(lown, pn, an, train=True)
        if high is None:
            high = torch.zeros_like(vt.high)
        return labt, predictions_to_decomp(lo, pp, ap, norm, high), vt

    def make_step(m: Optional[int] = None):
        ex_end = 0 if m is None else min(max(height - m, 0), height - 2)

        def step_fn(state: TrainState, batch):
            model = state.model
            f1, target, f2 = (_nchw(a, dev) for a in batch)
            labt, dec, vt = forward(model, f1, f2, target)
            if ex_end > 0:
                dec = dec_ops.exchange_levels(dec, vt, 0, ex_end)
            pred_img = reconstruct(dec, filters)
            total, parts = phase_net_loss(pred_img, labt, dec, vt, weighting_factor)
            params = list(model.parameters())
            _apply(state.optimizer, params, _grads(total, params))
            metrics = {"loss": total.detach(), **{k: v.detach() for k, v in parts.items()}}
            return state._replace(step=state.step + 1), metrics

        return step_fn

    @torch.no_grad()
    def eval_fn(state: TrainState, f1, f2) -> torch.Tensor:
        if mode != "phase":
            raise ValueError("eval_fn is the two-frame (mode 'phase') prediction")
        lab = torch.cat([_lab_batch(_nchw(f1, dev)), _lab_batch(_nchw(f2, dev))], 0)
        v1, v2 = dec_ops.split_frames(decompose(lab, filters), 2)
        lown, pn, an, norm = normalize_inputs(*dec_ops.concat_for_net([v1, v2]))
        lo, pp, ap = state.model(lown, pn, an)
        return reconstruct(predictions_to_decomp(lo, pp, ap, norm, torch.zeros_like(v1.high)),
                           filters)

    return TrainState(model, opt, 0), make_step(None), eval_fn, make_step


# ---------------------------------------------------------------- FusionNet


def _per_sample(x: torch.Tensor) -> torch.Tensor:
    return torch.mean(x, dim=(1, 2, 3))


def fusion_loss(pred, target, teachers=None, distill: float = 0.0, loss_balance: bool = False,
                loss_psnr: bool = False):
    """The FusionNet training loss of (B, C, H, W) predictions: (the
    objective, the plain L1).

    - per sample: L1, or log(MSE + 1e-8) with `loss_psnr`;
    - `distill` > 0 adds distill x the distance to the per-sample teacher,
      the one of `teachers` (AdaCoF's and PhaseNet's predictions, frozen)
      closer to the target, gated on the teacher being strictly better than
      the prediction: L1 in the default mode, log of the MSE floored at
      1e-6 under `loss_psnr` (MSE picks the teacher and gates there);
    - `loss_balance` weights each sample by 1 / (its L1 + 1e-3),
      renormalized over the (global, in a data-parallel step) batch; else
      the mean over samples.
    The gates and weights read the prediction without its gradient.  In a
    data-parallel step the returned objective is this process's share,
    scaled so that the processes' mean is the global batch's objective."""
    per = _per_sample(torch.abs(pred - target))
    plain = per.mean()
    if loss_psnr:
        mse_pred = _per_sample((pred - target) ** 2)
        total = torch.log(mse_pred + 1e-8)
    else:
        total = per
    if distill:
        ada, ph = teachers
        if loss_psnr:
            m_ada, m_ph = _per_sample((ada - target) ** 2), _per_sample((ph - target) ** 2)
            teacher = torch.where((m_ada <= m_ph)[:, None, None, None], ada, ph)
            gate = (torch.minimum(m_ada, m_ph) < mse_pred.detach()).to(pred.dtype)
            dist = torch.log(torch.clamp(_per_sample((pred - teacher) ** 2), min=1e-6))
        else:
            l_ada, l_ph = _per_sample(torch.abs(ada - target)), _per_sample(torch.abs(ph - target))
            teacher = torch.where((l_ada <= l_ph)[:, None, None, None], ada, ph)
            gate = (torch.minimum(l_ada, l_ph) < per.detach()).to(pred.dtype)
            dist = _per_sample(torch.abs(pred - teacher))
        total = total + (distill * gate) * dist
    if loss_balance:
        wgt = 1.0 / (per.detach() + 1e-3)
        return torch.sum(total * wgt / dp.global_sum(torch.sum(wgt))) * dp.world_size(), plain
    return torch.mean(total), plain


def make_fusion_trainer(
    phase_net: PhaseNetCore,
    adacof: AdaCoFNet,
    lr: float = 1e-4,
    weight_decay: float = 0.0,
    variant: int = 0,
    uncertainty_maps: int = 3,
    loss_balance: bool = False,
    distill: float = 0.0,
    loss_psnr: bool = False,
    seed: int = 0,
    device="cuda",
):
    """FusionNet training behind the frozen `phase_net` and `adacof` (both on
    `device`): sections 1-4 of the fusion pipeline run under no_grad
    (PhaseNet on its running statistics, K1 three times on CUDA, never K2),
    FusionNet(variant, uncertainty_maps) with grad.  Adam, or AdamW with
    `weight_decay`, behind `clipped_update` at 1.0.  The loss is
    `fusion_loss` with the three mode flags; the reported "loss" is always
    the plain L1.  `loss_psnr` with `loss_balance` raises: log-MSE balances
    itself, and 1/L1 weights on negative log values would weight the
    converged samples most.

    Returns (state, step_fn); state.model is the FusionNet, initialised
    from `seed` (load weights into it to start from them)."""
    if loss_psnr and loss_balance:
        raise ValueError(
            "loss_psnr and loss_balance are mutually exclusive: per-sample "
            "log-MSE is self-balancing, and 1/L1 weighting applied to "
            "negative log values would up-weight converged samples instead "
            "of lagging ones"
        )
    dev = _device(device, phase_net, adacof)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = FusionNet(uncertainty_maps=uncertainty_maps, variant=variant)
    model = model.to(dev)
    opt = (torch.optim.AdamW(model.parameters(), lr=lr, weight_decay=weight_decay)
           if weight_decay else torch.optim.Adam(model.parameters(), lr=lr))

    def step_fn(state: TrainState, batch):
        model = state.model
        f1, target, f2 = batch
        with torch.no_grad():
            inputs, (h, w) = fusion_inputs(FusionModels(phase_net, adacof, model), f1, f2, dev)
        pred = model(*inputs)[:, :, :h, :w]
        target = _nchw(target, dev)
        teachers = (inputs.adacof[:, :, :h, :w], inputs.phase[:, :, :h, :w])
        total, plain = fusion_loss(pred, target, teachers, distill, loss_balance, loss_psnr)
        params = list(model.parameters())
        clipped_update(state.optimizer, params, _grads(total, params), 1.0, total)
        return state._replace(step=state.step + 1), {"loss": plain.detach()}

    return TrainState(model, opt, 0), step_fn
