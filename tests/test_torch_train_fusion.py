"""fmvfi_tpu_torch's FusionNet training regime against the JAX package on the
CPU: the fusion trainer in each loss mode and head variant, its optimizer
(clip, finite skip, Adam/AdamW) against optax, the split of
`fusion_interpolate` that the trainer shares, and the mixed synthetic diet.

Weights: the bundled AdaCoF and FusionNet (variant 2) checkpoints and a
fixed-key flax PhaseNet, carried across; a fresh FusionNet is JAX's init
(jax.random.key(0)).  The JAX AdaCoF on the CPU warps unclamped, so the
port's runs with max_offset=None.  The JAX trainer runs jitted, each mode
built once.

Tolerances: the reported loss 1e-5 relative; after one step (lr 1e-4)
the gradient within 2e-4 of each tensor's largest (the worst measured is
7.6e-5, at 64x64) and the update within 1e-2 lr where the gradient is
above noise (an Adam step moves an entry by at most ~lr, so the params'
1e-4 alone would pass a step at half the lr or none); the optimizer
against optax 1e-6; the synthetic sets bit-equal.  The weight_decay mode
runs at 0.1: at lr 1e-4 a decay of 1e-4 moves a param by 1e-8 of itself,
below float32's resolution of the update.
"""

import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from fmvfi_tpu.models import phase_net as jx_phase
from fmvfi_tpu.train import data as jx_data
from fmvfi_tpu.train import trainer as jx_trainer
from fmvfi_tpu_torch.eval.synth import translation_triplet
from fmvfi_tpu_torch.models.adacof import AdaCoFNet
from fmvfi_tpu_torch.models.fusion_net import FusionNet
from fmvfi_tpu_torch.models.phase_net import PhaseNetCore
from fmvfi_tpu_torch.pipeline import interpolate as pt_pipe
from fmvfi_tpu_torch.train import data as pt_data
from fmvfi_tpu_torch.train.trainer import clipped_update, make_fusion_trainer
from fmvfi_tpu_torch.utils import convert

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ADACOF_CKPT = os.path.join(ROOT, "checkpoints", "adacof_synth_demo.msgpack")
FUSION_CKPT = os.path.join(ROOT, "checkpoints", "fusion_synth_demo.msgpack")
CPU = dict(device="cpu")
LR = 1e-4  # the fusion trainer's default
GRAD_TOL = 2e-4  # of each tensor's largest gradient entry
UPDATE_TOL = 1e-2  # of LR


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """PyTorch's CPU ops in one thread while this module runs (several test
    processes share the cores; PyTorch's spinning pools oversubscribe them)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _restore(path):
    with open(path, "rb") as f:
        return serialization.msgpack_restore(f.read())


def _batch(n, size, seed):
    items = [translation_triplet(size, size, dx=3.0 + i, dy=1.0 - i, seed=seed + i)
             for i in range(n)]
    return tuple(np.stack([it[j] for it in items]) for j in range(3))


def _rel_close(ours, ref, rtol):
    ours, ref = float(ours), float(ref)
    assert abs(ours - ref) <= rtol * max(abs(ref), 1e-12), (ours, ref)


@pytest.fixture(scope="module")
def trees():
    low = jnp.zeros((1, 4, 4, 2))
    lev = [jnp.zeros((1, 4, 4, 8))] * 7
    phase = jax.jit(lambda k: jx_phase.PhaseNetCore(num_img=2).init(k, low, lev, lev))(
        jax.random.key(0))
    return dict(phase=jax.tree.map(np.asarray, phase), adacof=_restore(ADACOF_CKPT),
                fusion=_restore(FUSION_CKPT))


@pytest.fixture(scope="module")
def frozen(trees):
    """The port's frozen PhaseNet and AdaCoF holding the trees' weights."""
    phase = PhaseNetCore()
    phase.load_state_dict(convert.phase_net_from_flax(trees["phase"]), strict=True)
    ada = AdaCoFNet(max_offset=None)
    ada.load_state_dict(convert.adacof_from_flax(trees["adacof"]), strict=True)
    return phase, ada


# name: (size, start from the bundled variant-2 weights, trainer options)
MODES = {
    "plain": (64, True, dict(variant=2)),
    "loss_balance": (32, True, dict(variant=2, loss_balance=True)),
    "distill": (32, True, dict(variant=2, distill=1.0)),
    "loss_psnr": (32, True, dict(variant=2, loss_psnr=True)),
    "loss_psnr_distill": (32, True, dict(variant=2, loss_psnr=True, distill=1.0)),
    "weight_decay": (32, True, dict(variant=2, weight_decay=0.1)),
    "fresh_v0_no_maps": (32, False, dict(variant=0, uncertainty_maps=0)),
    "fresh_v2": (32, False, dict(variant=2)),
}


@pytest.fixture(scope="module")
def jax_runs(trees):
    """One jitted JAX fusion step per mode: the start params, the batch, the
    reported loss and the params after the step."""
    cache = {}

    def run(name):
        if name not in cache:
            size, bundled, kw = MODES[name]
            state, step = jx_trainer.make_fusion_trainer(
                jax.random.key(0), size, size, trees["phase"], trees["adacof"], **kw)
            if bundled:
                state = state._replace(params=jax.tree.map(jnp.asarray, trees["fusion"]["params"]))
            batch = _batch(2, size, 0)
            start = jax.tree.map(np.asarray, state.params)
            state, met = jax.jit(step)(state, batch)
            mu = [s for s in jax.tree_util.tree_leaves(state.opt_state,
                                                       is_leaf=lambda x: hasattr(x, "mu"))
                  if hasattr(s, "mu")][0].mu
            cache[name] = dict(batch=batch, start=start, loss=float(met["loss"]),
                               params=jax.tree.map(np.asarray, state.params),
                               mu=jax.tree.map(np.asarray, mu), kw=kw)
        return cache[name]

    return run


@pytest.mark.parametrize("name", list(MODES))
def test_fusion_trainer_step_matches_jax(jax_runs, frozen, name):
    """One step from the same weights and batch: the reported (plain L1)
    loss within 1e-5 relative; the clipped gradient (Adam's first moment
    after the step, 0.1 x it) within 2e-4 of each tensor's largest entry;
    the update within 1e-2 lr on the entries whose gradient is at least
    1e-2 of their tensor's largest, and every FusionNet param within 1e-4;
    the frozen PhaseNet and AdaCoF unchanged and without gradients."""
    ref = jax_runs(name)
    phase, ada = frozen
    before = [{k: v.clone() for k, v in m.state_dict().items()} for m in frozen]
    state, step = make_fusion_trainer(phase, ada, **ref["kw"], **CPU)
    state.model.load_state_dict(convert.fusion_net_from_flax({"params": ref["start"]}),
                                strict=True)
    state, met = step(state, ref["batch"])
    assert set(met) == {"loss"} and state.step == 1
    _rel_close(met["loss"], ref["loss"], 1e-5)
    want = convert.fusion_net_from_flax({"params": ref["params"]})
    start = convert.fusion_net_from_flax({"params": ref["start"]})
    mu_ref = convert.fusion_net_from_flax({"params": ref["mu"]})
    grad_gap = update_gap = 0.0
    for k, p in state.model.named_parameters():
        top = mu_ref[k].abs().max()
        mu = state.optimizer.state[p]["exp_avg"]
        grad_gap = max(grad_gap, float((mu - mu_ref[k]).abs().max() / top))
        ours = p.detach().double() - start[k].double()
        theirs = want[k].double() - start[k].double()
        slack = 2 * torch.from_numpy(np.spacing(np.abs(want[k].numpy()))).double()
        off = ((ours - theirs).abs() - slack)[mu_ref[k].abs() >= 1e-2 * top]
        update_gap = max(update_gap, float(off.max()) / LR)
    print(f"GAPS {name}: gradient {grad_gap:.3e}, update {update_gap:.3e} lr")
    assert grad_gap <= GRAD_TOL, f"gradient off by {grad_gap:.3g} of a tensor's largest"
    assert update_gap <= UPDATE_TOL, f"update off by {update_gap:.3g} lr"
    for k, v in state.model.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=1e-4, msg=k)
    for m, b in zip(frozen, before):
        assert all(torch.equal(v, m.state_dict()[k]) for k, v in b.items())
        assert all(p.grad is None for p in m.parameters())


def test_loss_psnr_with_loss_balance_raises(frozen):
    with pytest.raises(ValueError, match="mutually exclusive"):
        make_fusion_trainer(*frozen, loss_psnr=True, loss_balance=True, **CPU)


def test_non_finite_gradient_skips_the_fusion_update(frozen):
    """A NaN target: FusionNet's params and the optimizer state stay, step
    advances, and the next finite batch updates."""
    state, step = make_fusion_trainer(*frozen, variant=2, **CPU)
    f1, target, f2 = _batch(1, 32, 5)
    state, _ = step(state, (f1, target, f2))
    params = {k: v.clone() for k, v in state.model.state_dict().items()}
    opt = {i: {k: v.clone() for k, v in s.items()}
           for i, s in state.optimizer.state_dict()["state"].items()}
    bad = target.copy()
    bad[0, 3, 4, 0] = np.nan
    state, met = step(state, (f1, bad, f2))
    assert state.step == 2 and not np.isfinite(float(met["loss"]))
    assert all(torch.equal(v, state.model.state_dict()[k]) for k, v in params.items())
    after = state.optimizer.state_dict()["state"]
    assert all(torch.equal(v, after[i][k]) for i, s in opt.items() for k, v in s.items())
    state, met = step(state, (f1, target, f2))
    assert np.isfinite(float(met["loss"]))
    assert not all(torch.equal(v, state.model.state_dict()[k]) for k, v in params.items())


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_clipped_update_matches_optax(weight_decay):
    """clipped_update on Adam (AdamW with weight decay) against optax's
    apply_if_finite(chain(clip_by_global_norm(1), adam / adamw)) over a
    gradient sequence with norms under and over the clip and one non-finite
    gradient: params within 1e-6 after each step (float32 at values to
    ~3), the skip in step."""
    rng = np.random.default_rng(0)
    shapes = [(3, 4), (5,), (2, 2, 2)]
    init = [rng.normal(size=s).astype(np.float32) for s in shapes]
    scales = [0.1, 5.0, np.nan, 0.3, 20.0]
    grads = [[(rng.normal(size=s) * sc).astype(np.float32) for s in shapes] for sc in scales]
    tx = optax.adamw(1e-2, weight_decay=weight_decay) if weight_decay else optax.adam(1e-2)
    tx = optax.apply_if_finite(optax.chain(optax.clip_by_global_norm(1.0), tx), 100_000)
    jp = [jnp.asarray(a) for a in init]
    st = tx.init(jp)
    params = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    opt = (torch.optim.AdamW(params, lr=1e-2, weight_decay=weight_decay) if weight_decay
           else torch.optim.Adam(params, lr=1e-2))
    for g in grads:
        upd, st = tx.update([jnp.asarray(a) for a in g], st, jp)
        jp = optax.apply_updates(jp, upd)
        applied = clipped_update(opt, params, [torch.from_numpy(a) for a in g], 1.0)
        assert applied == bool(np.isfinite(np.concatenate([a.ravel() for a in g])).all())
        for p, r in zip(params, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(r), rtol=0, atol=1e-6)


def test_fusion_inputs_compose_fusion_interpolate(frozen, trees):
    """fusion_interpolate is FusionNet on fusion_inputs, cropped: bit-equal,
    parts included, on an off-grid size."""
    phase, ada = frozen
    fusion = FusionNet(variant=2)
    fusion.load_state_dict(convert.fusion_net_from_flax(trees["fusion"]))
    models = pt_pipe.FusionModels(phase, ada, fusion)
    f1, _, f2 = translation_triplet(36, 44, dx=2.0, dy=1.0, seed=3)
    out, parts = pt_pipe.fusion_interpolate(models, f1[None], f2[None], return_parts=True, **CPU)
    with torch.no_grad():
        inputs, (h, w) = pt_pipe.fusion_inputs(models, f1[None], f2[None], torch.device("cpu"))
        final = fusion(*inputs)
    assert (h, w) == (36, 44) and inputs.base.shape[-2:] == (40, 48)
    assert torch.equal(out, final[:, :, :h, :w].permute(0, 2, 3, 1))
    for key, x in (("adacof", inputs.adacof), ("phase", inputs.phase), ("baseline", inputs.base),
                   ("maps", inputs.maps)):
        assert torch.equal(parts[key], x[:, :, :h, :w].permute(0, 2, 3, 1)), key


# ------------------------------------------------------------ the mixed diet


def test_mixed_synthetic_triplets_match_jax():
    """SyntheticTriplets(mixed=True): two cycles of the six regimes, each
    item bit-equal to the JAX package's."""
    ours = pt_data.SyntheticTriplets(n=12, h=64, w=64, mixed=True)
    ref = jx_data.SyntheticTriplets(n=12, h=64, w=64, mixed=True)
    assert len(ours) == len(ref) == 12
    for i in range(12):
        for o, r in zip(ours.load(i), ref.load(i)):
            assert o.shape == (64, 64, 3)
            np.testing.assert_array_equal(o, r)


def test_mixed_synth_stream_matches_jax():
    """MixedSynthStream: each scene's uint8 frames and their float view
    bit-equal to the JAX package's, drawn on 2 threads; with photo_frac 0.5
    the photo scenes too (tests/test_torch_photo.py holds more of them)."""
    ours = pt_data.MixedSynthStream(n=12, h=64, w=64, workers=2)
    ref = jx_data.MixedSynthStream(n=12, h=64, w=64, workers=2)
    assert len(ours) == len(ref) == 12
    for i in range(12):
        assert ours.load_u8(i).dtype == np.uint8
        np.testing.assert_array_equal(ours.load_u8(i), ref.load_u8(i))
        for o, r in zip(ours.load(i), ref.load(i)):
            np.testing.assert_array_equal(o, r)
    ours = pt_data.MixedSynthStream(n=2, h=16, w=16, photo_frac=0.5)
    ref = jx_data.MixedSynthStream(n=2, h=16, w=16, photo_frac=0.5)
    for i in range(2):
        np.testing.assert_array_equal(ours.load_u8(i), ref.load_u8(i))
