"""fmvfi_tpu_torch's AdaCoF training slice against the JAX package on the
CPU: the field gradients of the warp (K2's plain version), the gradient
contract K3, the smoothness terms and losses, the trainer step, the data
order and fit's resume.

Tolerances: the warp's field gradients 2e-4 against the Pallas backward in
interpret mode (the bound of tests/test_adacof_pallas.py, which holds that
kernel against jnp autodiff) and 2e-5 against jnp autodiff itself (f32 sums
of a few taps in another order); losses 1e-6 relative; the train step's
metrics 1e-5 relative, its gradients 1e-4 of the largest gradient of each
tensor, and the params after 3 steps 1e-4 absolute (f32 convolutions summed
in another order through a deep U-Net, then Adamax).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import serialization

from fmvfi_tpu.models import adacof as jx_adacof
from fmvfi_tpu.ops import adacof as jx_ops
from fmvfi_tpu.ops.adacof_pallas import _saturation_mask, adacof_warp_pallas_bwd
from fmvfi_tpu.ops.pyramid import Decomp as JxDecomp
from fmvfi_tpu.train import data as jx_data
from fmvfi_tpu.train import losses as jx_losses
from fmvfi_tpu.train import trainer as jx_trainer
from fmvfi_tpu_torch.eval.synth import translation_triplet
from fmvfi_tpu_torch.models.adacof import AdaCoFNet, smoothness_penalties
from fmvfi_tpu_torch.ops import adacof_cuda
from fmvfi_tpu_torch.ops.adacof import adacof_warp_field_grads
from fmvfi_tpu_torch.ops.decomp import Decomp
from fmvfi_tpu_torch.pipeline.interpolate import _nchw
from fmvfi_tpu_torch.train import data as pt_data
from fmvfi_tpu_torch.train import losses as pt_losses
from fmvfi_tpu_torch.train.loop import fit
from fmvfi_tpu_torch.train.trainer import (
    DEFAULT_LOSS,
    adacof_loss,
    make_adacof_trainer,
    staircase_lr,
)
from fmvfi_tpu_torch.utils import convert, imageio
from fmvfi_tpu_torch.utils.checkpoint import Checkpointer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ADACOF_CKPT = os.path.join(ROOT, "checkpoints", "adacof_synth_demo.msgpack")


def _warp_case(rng, b, h, w, f, d, off):
    """NHWC x and (B, H, W, F^2) fields for JAX, as the JAX package's tests
    draw them, plus a cotangent (B, H, W, 3)."""
    hin, win = h + (f - 1) * d, w + (f - 1) * d
    x = rng.uniform(0, 1, (b, hin, win, 3)).astype(np.float32)
    wgt = rng.uniform(0, 1, (b, h, w, f * f)).astype(np.float32)
    a = (rng.uniform(-1, 1, (b, h, w, f * f)) * off).astype(np.float32)
    be = (rng.uniform(-1, 1, (b, h, w, f * f)) * off).astype(np.float32)
    g = rng.normal(size=(b, h, w, 3)).astype(np.float32)
    return x, wgt, a, be, g


def _t(a):
    """NHWC / fields-last numpy -> NCHW / (B, F^2, H, W) tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _np(t):
    """(B, F^2, H, W) tensor -> (B, H, W, F^2) numpy."""
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _port_grads(x, wgt, a, be, g, d, r):
    return adacof_warp_field_grads(_t(x), _t(wgt), _t(a), _t(be), _t(g), d, r)


R_SAT = 31
WARP_CASES = [(5, 1), (5, 2), (3, 1), (3, 2)]


@pytest.mark.parametrize("f,d", WARP_CASES)
def test_field_grads_match_pallas_backward(f, d):
    """K2's plain version against the Pallas backward kernel (interpret
    mode) plus its saturation mask, offsets to +-40 with R = 31."""
    x, wgt, a, be, g = _warp_case(np.random.default_rng(f * 10 + d), 1, 32, 128, f, d, 40.0)
    dw, da, db = adacof_warp_pallas_bwd(
        jnp.asarray(x), jnp.asarray(wgt), jnp.asarray(a), jnp.asarray(be), jnp.asarray(g),
        d, max_offset=R_SAT, interpret=True,
    )
    da, db = _saturation_mask(da, db, jnp.asarray(a), jnp.asarray(be), R_SAT)
    ours = _port_grads(x, wgt, a, be, g, d, R_SAT)
    assert (np.abs(a) >= R_SAT).any()  # the mask bites
    for o, r in zip(ours, (dw, da, db)):
        np.testing.assert_allclose(_np(o), np.asarray(r), rtol=0, atol=2e-4)


@pytest.mark.parametrize("f,d", WARP_CASES)
def test_field_grads_match_jax_autodiff(f, d):
    """The same gradients against jax.vjp of the clipped jnp warp, masked."""
    x, wgt, a, be, g = _warp_case(np.random.default_rng(f * 10 + d), 1, 32, 128, f, d, 40.0)
    r = float(R_SAT)
    _, vjp = jax.vjp(
        lambda w_, a_, b_: jx_ops.adacof_warp(
            jnp.asarray(x), w_, jnp.clip(a_, -r, r), jnp.clip(b_, -r, r), d
        ),
        jnp.asarray(wgt), jnp.asarray(a), jnp.asarray(be),
    )
    dw, da, db = vjp(jnp.asarray(g))
    da, db = _saturation_mask(da, db, jnp.asarray(a), jnp.asarray(be), R_SAT)
    ours = _port_grads(x, wgt, a, be, g, d, R_SAT)
    for o, ref in zip(ours, (dw, da, db)):
        np.testing.assert_allclose(_np(o), np.asarray(ref), rtol=0, atol=2e-5)


def test_field_grads_unclamped_match_jax_autodiff():
    """max_offset=None: the unclamped warp, no mask."""
    x, wgt, a, be, g = _warp_case(np.random.default_rng(5), 2, 20, 24, 5, 1, 6.0)
    _, vjp = jax.vjp(
        lambda w_, a_, b_: jx_ops.adacof_warp(jnp.asarray(x), w_, a_, b_, 1),
        jnp.asarray(wgt), jnp.asarray(a), jnp.asarray(be),
    )
    ref = vjp(jnp.asarray(g))
    ours = _port_grads(x, wgt, a, be, g, 1, None)
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(_np(o), np.asarray(r), rtol=0, atol=2e-5)


def test_adacof_warp_function_gradient_contract():
    """K3 on the CPU: the field gradients are the plain ones, dx is zero,
    and dalpha / dbeta are zero at |offset| == R exactly (the clamp's own
    gradient would let them through)."""
    r = 4
    x, wgt, a, be, g = _warp_case(np.random.default_rng(9), 2, 9, 11, 3, 1, 6.0)
    a[0, 2, 3, 4], a[1, 0, 0, 0], be[0, 5, 6, 7] = r, -r, r
    xt = _t(x).requires_grad_(True)
    fields = [_t(v).requires_grad_(True) for v in (wgt, a, be)]
    out = adacof_cuda.adacof_warp(xt, *fields, 1, r)
    out.backward(_t(g))
    want = adacof_warp_field_grads(_t(x), *(_t(v) for v in (wgt, a, be)), _t(g), 1, r)
    for f_, w_ in zip(fields, want):
        torch.testing.assert_close(f_.grad, w_, rtol=0, atol=0)
    assert torch.count_nonzero(xt.grad) == 0
    da, db = fields[1].grad, fields[2].grad
    assert da[0, 4, 2, 3] == 0 and da[1, 0, 0, 0] == 0 and db[0, 7, 5, 6] == 0
    assert torch.count_nonzero(da) > 0.5 * da.numel()  # the rest flows


def test_adacof_warp_function_skips_dx_for_data_frames():
    """Data frames (x without requires_grad, as every trainer warps): the
    fields still get their gradients, and on the CPU the plain versions run,
    so neither launch counter moves."""
    x, wgt, a, be, g = _warp_case(np.random.default_rng(2), 1, 8, 8, 3, 1, 2.0)
    fields = [_t(v).requires_grad_(True) for v in (wgt, a, be)]
    k1, k2 = adacof_cuda.launches, adacof_cuda.bwd_launches
    grads = torch.autograd.grad(adacof_cuda.adacof_warp(_t(x), *fields, 1, 48), fields, _t(g))
    assert all(gr.shape == f_.shape for gr, f_ in zip(grads, fields))
    assert (adacof_cuda.launches, adacof_cuda.bwd_launches) == (k1, k2)


def test_adacof_outputs_heads_and_detached_uncertainty(bundled):
    """The two repairs of the model for training: the raw heads and the
    uncropped occlusion map are returned at the padded size, equal to the
    JAX model's (1e-4, as the model tests), and the uncertainty map is
    detached (JAX: stop_gradient) while the prediction is not."""
    tree, sd = bundled
    model = AdaCoFNet(max_offset=None)  # the JAX model off the TPU is unclamped
    model.load_state_dict(sd, strict=True)
    f0, _, f2 = translation_triplet(60, 44, dx=2.0, dy=1.0, seed=1)
    out = model(_nchw(f0[None], torch.device("cpu")), _nchw(f2[None], torch.device("cpu")))
    ref = jx_adacof.AdaCoFNet(kernel_size=5, dilation=1).apply(tree, f0[None], f2[None])
    assert out.blended.requires_grad and not out.uncertainty.requires_grad
    assert len(out.heads) == 6 and out.occ_raw.shape == (1, 1, 64, 64)
    for o, r in zip(out.heads, ref.heads):  # JAX heads are tap-major (K, B, H, W)
        assert o.shape == (1, 25, 64, 64)
        np.testing.assert_allclose(o.detach().numpy(), np.moveaxis(np.asarray(r), 0, 1),
                                   rtol=0, atol=1e-4)
    np.testing.assert_allclose(out.occ_raw.detach().numpy(),
                               np.moveaxis(np.asarray(ref.occ_raw), -1, 1), rtol=0, atol=1e-4)


def _rel_close(ours, ref, rtol):
    ours, ref = float(ours), float(ref)
    assert abs(ours - ref) <= rtol * max(abs(ref), 1e-12), (ours, ref)


def test_smoothness_penalties_match_jax():
    rng = np.random.default_rng(4)
    b, k, h, w = 2, 25, 12, 16
    fields = [rng.normal(size=(b, k, h, w)).astype(np.float32) for _ in range(6)]
    occ = rng.uniform(0, 1, (b, 1, h, w)).astype(np.float32)
    ours = smoothness_penalties(*map(torch.from_numpy, fields), torch.from_numpy(occ))
    ref = jx_adacof.smoothness_penalties(
        *(jnp.asarray(np.moveaxis(f, 1, 0)) for f in fields),  # tap-major (K, B, H, W)
        jnp.asarray(np.moveaxis(occ, 1, -1)),
    )
    for o, r in zip(ours, ref):
        _rel_close(o, r, 1e-6)


def test_losses_match_jax():
    rng = np.random.default_rng(6)
    a, b = (rng.uniform(0, 1, (2, 3, 10, 12)).astype(np.float32) for _ in range(2))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for name in ("l1", "mse", "charbonnier"):
        _rel_close(getattr(pt_losses, name)(ta, tb), getattr(jx_losses, name)(ja, jb), 1e-6)

    def decomps(seed):
        r = np.random.default_rng(seed)
        phase = tuple(r.uniform(-np.pi, np.pi, (3, 4, s, s)).astype(np.float32) for s in (8, 4))
        amp = tuple(r.uniform(0, 1, p.shape).astype(np.float32) for p in phase)
        hi = r.normal(size=(3, 8, 8)).astype(np.float32)
        lo = r.normal(size=(3, 2, 2)).astype(np.float32)
        pt = Decomp(torch.from_numpy(hi), torch.from_numpy(lo),
                    tuple(map(torch.from_numpy, phase)), tuple(map(torch.from_numpy, amp)))
        jx = JxDecomp(jnp.asarray(hi), jnp.asarray(lo),
                      tuple(map(jnp.asarray, phase)), tuple(map(jnp.asarray, amp)))
        return pt, jx

    (p1, j1), (p2, j2) = decomps(0), decomps(1)
    _rel_close(pt_losses.circular_phase_loss(p1, p2), jx_losses.circular_phase_loss(j1, j2), 1e-6)
    img_a, img_b = rng.uniform(0, 1, (2, 3, 3, 8, 8)).astype(np.float32)
    tot, parts = pt_losses.phase_net_loss(torch.from_numpy(img_a), torch.from_numpy(img_b), p1, p2)
    jtot, jparts = jx_losses.phase_net_loss(jnp.asarray(img_a), jnp.asarray(img_b), j1, j2)
    _rel_close(tot, jtot, 1e-6)
    for k in ("l1", "phase"):
        _rel_close(parts[k], jparts[k], 1e-6)


def test_loss_spec_parser():
    """The grammar and errors of fmvfi_tpu.train.losses.parse_loss_spec."""
    for text in (DEFAULT_LOSS, "1*VGG+0.01*GAN", " 2.5e-1 * L1 + 1*MSE+", "0.1*T_WGAN_GP"):
        assert pt_losses.parse_loss_spec(text).terms == jx_losses.parse_loss_spec(text).terms
    spec = pt_losses.parse_loss_spec(DEFAULT_LOSS)
    vals = {"Charb": torch.tensor(2.0), "g_Spatial": torch.tensor(100.0),
            "g_Occlusion": torch.tensor(200.0)}
    assert abs(float(spec(vals)) - (2.0 + 1.0 + 1.0)) < 1e-6
    assert pt_losses.gan_terms(pt_losses.parse_loss_spec("1*VGG+0.01*GAN")) == [(0.01, "GAN")]
    assert pt_losses.has_term(spec, "g_Spatial") and not pt_losses.has_term(spec, "VGG")
    for bad in ("1*Bogus", "Charb", "x*Charb"):
        with pytest.raises(ValueError) as ours:
            pt_losses.parse_loss_spec(bad)
        with pytest.raises(ValueError) as ref:
            jx_losses.parse_loss_spec(bad)
        assert str(ours.value) == str(ref.value)
    with pytest.raises(KeyError, match="g_Spatial"):
        spec({"Charb": torch.tensor(1.0)})


@pytest.mark.parametrize("spec", ["1*Charb+1*VGG", "1*Charb+0.01*WGAN_GP"])
def test_trainer_raises_for_unported_terms(spec):
    """The VGG and GAN terms are ported; what raises now is what JAX's
    trainer raises for (tests/test_wiring.py): a VGG term without
    vgg_checkpoint, and a GAN term without the crop its critic is built
    for (JAX's trainer always has h and w)."""
    match = "vgg_checkpoint" if "VGG" in spec else "h= and w="
    with pytest.raises(ValueError, match=match):
        make_adacof_trainer(loss_spec=pt_losses.parse_loss_spec(spec), device="cpu")
    if "GAN" in spec:
        with pytest.raises(ValueError, match="at most one adversarial term"):
            make_adacof_trainer(loss_spec=pt_losses.parse_loss_spec(spec + "+0.01*GAN"), h=32,
                                w=32, device="cpu")


# ------------------------------------------------------------ trainer parity


def _batch(n, size, seed):
    """n seeded translation triplets stacked as an NHWC (f1, target, f2) batch."""
    items = [
        translation_triplet(size, size, dx=3.0 + i, dy=1.0 - i, seed=seed + i) for i in range(n)
    ]
    return tuple(np.stack([it[j] for it in items]) for j in range(3))


@pytest.fixture(scope="module")
def bundled():
    with open(ADACOF_CKPT, "rb") as f:
        tree = serialization.msgpack_restore(f.read())
    return tree, convert.adacof_from_flax(tree)


@pytest.fixture(scope="module")
def jax_run(bundled):
    """The JAX trainer (use_pallas=True: the clipped warp with the saturation
    mask, as on the TPU) from the bundled weights: the gradients of the first
    step and the metrics and params of 3 steps on one batch."""
    tree, _ = bundled
    batch = _batch(2, 64, 0)
    state, step = jx_trainer.make_adacof_trainer(jax.random.key(0), 64, 64, use_pallas=True)
    state = state._replace(params=jax.tree.map(jnp.asarray, tree["params"]))
    model = jx_adacof.AdaCoFNet(kernel_size=5, dilation=1, use_pallas=True)
    spec = jx_losses.parse_loss_spec(DEFAULT_LOSS)

    def loss_fn(params):  # the JAX trainer's loss_fn, without its adversarial arm
        f1, target, f2 = batch
        out = model.apply({"params": params}, f1, f2)
        g_s, g_o = jx_adacof.smoothness_penalties(*out.heads, out.occ_raw)
        return spec({"Charb": jx_losses.charbonnier(out.blended, target), "g_Spatial": g_s,
                     "g_Occlusion": g_o})

    grads = jax.jit(jax.grad(loss_fn))(state.params)
    jstep = jax.jit(step)
    metrics = []
    for _ in range(3):
        state, m = jstep(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(batch=batch, grads=grads, metrics=metrics, params=state.params,
                step=int(state.step))


def _port_trainer(bundled, **kw):
    _, sd = bundled
    state, step = make_adacof_trainer(device="cpu", **kw)
    state.model.load_state_dict(sd, strict=True)
    return state, step


def test_train_step_gradients_match_jax(bundled, jax_run):
    state, _ = _port_trainer(bundled)
    loss, _ = adacof_loss(state.model, pt_losses.parse_loss_spec(DEFAULT_LOSS),
                          *(_nchw(a, torch.device("cpu")) for a in jax_run["batch"]))
    names, params = zip(*state.model.named_parameters())
    ours = dict(zip(names, torch.autograd.grad(loss, params)))
    ref = convert.adacof_from_flax(jax.tree.map(np.asarray, jax_run["grads"]))
    assert set(ref) == set(ours)
    for k, r in ref.items():
        tol = 1e-4 * float(r.abs().max())
        assert float((ours[k] - r).abs().max()) <= tol, k


def test_train_steps_match_jax(bundled, jax_run):
    """Three Adamax steps (global-norm clip 1.0) on one batch: metrics within
    1e-5 relative at each step, params within 1e-4 after the third."""
    state, step = _port_trainer(bundled)
    for ref in jax_run["metrics"]:
        state, m = step(state, jax_run["batch"])
        assert set(m) == set(ref)
        for k in ref:
            _rel_close(m[k], ref[k], 1e-5)
    assert state.step == jax_run["step"] == 3
    ref = convert.adacof_from_flax(jax.tree.map(np.asarray, jax_run["params"]))
    for k, p in state.model.state_dict().items():
        torch.testing.assert_close(p, ref[k], rtol=0, atol=1e-4, msg=k)


def _snapshot(state):
    params = {k: v.clone() for k, v in state.model.state_dict().items()}
    opt = state.optimizer.state_dict()
    return params, {i: {k: v.clone() for k, v in s.items()} for i, s in opt["state"].items()}


def test_non_finite_gradient_skips_the_update(bundled):
    """A NaN target: params and optimizer state stay, step advances (the JAX
    trainer's optax.apply_if_finite)."""
    state, step = _port_trainer(bundled)
    f1, target, f2 = _batch(1, 32, 3)
    state, _ = step(state, (f1, target, f2))
    before = _snapshot(state)
    bad = target.copy()
    bad[0, 5, 5, 1] = np.nan
    state, m = step(state, (f1, bad, f2))
    assert state.step == 2 and not np.isfinite(float(m["loss"]))
    after = _snapshot(state)
    for k, v in before[0].items():
        assert torch.equal(v, after[0][k]), k
    assert before[1].keys() == after[1].keys()
    for i, s in before[1].items():
        for k, v in s.items():
            assert torch.equal(v, after[1][i][k]), (i, k)
    assert state.optimizer.param_groups[0]["updates"] == 1
    state, m = step(state, (f1, target, f2))  # and training goes on
    assert np.isfinite(float(m["loss"])) and state.optimizer.param_groups[0]["updates"] == 2


def test_staircase_lr_matches_optax():
    ref = optax.exponential_decay(1e-3, 4, 0.5, staircase=True)
    ours = staircase_lr(1e-3, 4, 0.5)
    for count in range(3 * 4 + 2):
        _rel_close(ours(count), ref(count), 1e-6)
    assert staircase_lr(1e-3, None, 0.5)(100) == 1e-3


def test_trainer_decays_the_lr_per_applied_update(bundled):
    state, step = _port_trainer(bundled, lr_decay_steps=2, optimizer="sgd")
    batch = _batch(1, 32, 1)
    lrs = []
    for _ in range(3):
        state, _ = step(state, batch)
        lrs.append(state.optimizer.param_groups[0]["lr"])
    assert lrs == [1e-3, 1e-3, 5e-4]


def test_synthetic_triplets_and_batches_match_jax():
    """Same items, same augmentation draws: a seed gives the batches the JAX
    package's Python path gives, across an epoch boundary."""
    ours_ds = pt_data.SyntheticTriplets(n=5, h=40, w=44)
    ref_ds = jx_data.SyntheticTriplets(n=5, h=40, w=44)
    for i in range(5):
        for o, r in zip(ours_ds.load(i), ref_ds.load(i)):
            np.testing.assert_array_equal(o, r)
    rng_o, rng_r = np.random.default_rng(3), np.random.default_rng(3)
    for i in range(6):
        o = pt_data.augment_triplet(ours_ds.load(i % 5), rng_o, crop=32)
        r = jx_data.augment_triplet(ref_ds.load(i % 5), rng_r, crop=32)
        for a, b in zip(o, r):
            np.testing.assert_array_equal(a, b)
    ours = pt_data.batch_iterator(ours_ds, 2, seed=7, crop=32, epochs=3)
    ref = jx_data.batch_iterator(ref_ds, 2, seed=7, crop=32, epochs=3, use_native=False)
    n = 0
    for o, r in zip(ours, ref, strict=True):
        for a, b in zip(o, r):
            assert a.shape == (2, 32, 32, 3)
            np.testing.assert_array_equal(a, b)
        n += 1
    assert n == 6  # 2 full batches per epoch of 5, 3 epochs


def test_batch_iterator_raises_what_the_producer_raised():
    with pytest.raises(ValueError, match="smaller than crop"):
        next(pt_data.batch_iterator(pt_data.SyntheticTriplets(n=2, h=16, w=16), 1, crop=32))


def test_fit_resumes_where_it_stopped(bundled, tmp_path):
    """fit for 4 steps with a checkpoint at step 2, stopped there and
    resumed, ends where an uninterrupted run ends."""
    batches = [_batch(1, 32, s) for s in range(4)]

    def run(out, parts):
        for part in parts:
            state, step = _port_trainer(bundled)
            state = fit(state, step, iter(part), str(out), epochs=1, steps_per_epoch=4,
                        log_every=1, ckpt_every=2)
        return state

    whole = run(tmp_path / "whole", [batches])
    resumed = run(tmp_path / "resumed", [batches[:2], batches[2:]])
    assert whole.step == resumed.step == 4
    assert Checkpointer(str(tmp_path / "resumed" / "checkpoint")).latest() == 4
    for (k, a), b in zip(whole.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(a, b), k
    lines = (tmp_path / "resumed" / "train_metrics.jsonl").read_text().splitlines()
    assert len(lines) == 4


def test_fit_survives_a_non_finite_loss(bundled, tmp_path):
    """A NaN target at step 2: the step is skipped, its NaN loss is logged,
    and fit still checkpoints and draws the loss curve after it."""
    batches = [_batch(1, 32, s) for s in range(4)]
    batches[1][1][0, 5, 5, 1] = np.nan
    state, step = _port_trainer(bundled)
    state = fit(state, step, iter(batches), str(tmp_path), epochs=1, steps_per_epoch=4,
                log_every=1, ckpt_every=2)
    assert state.step == 4
    assert Checkpointer(str(tmp_path / "checkpoint")).latest() == 4
    losses = [json.loads(l)["loss"] for l in
              (tmp_path / "train_metrics.jsonl").read_text().splitlines()]
    assert np.isnan(losses[1]) and np.isfinite(losses[0]) and np.isfinite(losses[2:]).all()
    assert imageio.imread(str(tmp_path / "train_curve.png")).shape == (400, 800, 3)


def test_checkpoint_restore_round_trip(bundled, tmp_path):
    state, step = _port_trainer(bundled)
    state, _ = step(state, _batch(1, 32, 0))
    ck = Checkpointer(str(tmp_path))
    assert ck.latest() is None
    ck.save(1, state)
    assert ck.latest() == 1 and sorted(os.listdir(tmp_path)) == ["step_00000001"]
    fresh, _ = make_adacof_trainer(device="cpu", seed=1)
    fresh = ck.restore(fresh)
    assert fresh.step == 1 and fresh.optimizer.param_groups[0]["updates"] == 1
    for (k, a), b in zip(state.model.state_dict().items(), fresh.model.state_dict().values()):
        assert torch.equal(a, b), k
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore(fresh)
