"""fmvfi_tpu_torch's PhaseNet training regime against the JAX package on the
CPU: the decomposition helpers, PhaseNetCore with 2, 3 and 4 input frames
(eval and train mode, with `m`), flax's train-mode BatchNorm, the phase
trainer in each of its modes and `fit`'s hierarchical-m schedule.

Weights: the JAX trainer's own init (jax.random.key(0)) carried across with
utils/convert.py; flax creates a block's variables only when a level reaches
it, so blocks a pyramid never reaches exist only in the port (and get zero
gradients there).  The AdaCoF of the fusion and high_level modes is the
bundled one, unclamped on both sides (the JAX AdaCoF on the CPU warps
unclamped).  The JAX side runs jitted, each configuration built once.

Tolerances: the helpers 1e-7; the core's outputs 1e-4 (the models' bound),
in train mode too, and its running statistics 1e-5; one block's train-mode
outputs and statistics 1e-5; a trainer's metrics 1e-5 relative, its
params and running statistics 1e-4 absolute, and each step's update within
5e-2 lr where the gradient is at least 0.1 of its tensor's largest (see
`_update_gap`).  An Adam step moves a parameter by at most ~lr, so the
params' 1e-4 does not see the update at lr 1e-5; the update check does
(half the lr reads 0.5 lr off, no step 1 lr).  The gradient itself is held
against JAX in float64 in test_torch_train_phase_grads.py.  The trainer
comparisons run at lr 1e-5: the loss has sign-like terms (L1, and phases
of near-zero pyramid coefficients) whose gradient entries near zero flip
sign under float noise, which Adam turns into steps of ~2 lr apart; at the
default lr 1e-3 JAX itself, given the batch moved by one ulp, moves 0.16 %
of the entries by more than 1e-4 after one step (on the CPU; held by
`test_default_lr_step_matches_jax_as_closely_as_jax_matches_itself`).
"""

import copy
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from flax import serialization

from fmvfi_tpu.models import phase_net as jx_phase
from fmvfi_tpu.ops import decomp as jx_decomp
from fmvfi_tpu.ops.pyramid import Decomp as JxDecomp
from fmvfi_tpu.train import loop as jx_loop
from fmvfi_tpu.train import trainer as jx_trainer
from fmvfi_tpu_torch.eval.synth import translation_triplet
from fmvfi_tpu_torch.models.adacof import AdaCoFNet
from fmvfi_tpu_torch.models.phase_net import PhaseNetBlock, PhaseNetCore, normalize_inputs
from fmvfi_tpu_torch.models.phase_net import predictions_to_decomp
from fmvfi_tpu_torch.ops import decomp as pt_decomp
from fmvfi_tpu_torch.ops.decomp import Decomp
from fmvfi_tpu_torch.ops.pyramid import decompose, make_filters, max_pyr_height
from fmvfi_tpu_torch.train.loop import fit
from fmvfi_tpu_torch.train.trainer import make_phase_trainer
from fmvfi_tpu_torch.utils import convert

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ADACOF_CKPT = os.path.join(ROOT, "checkpoints", "adacof_synth_demo.msgpack")
PARITY_LR = 1e-5
UPDATE_TOL = 5e-2  # of lr: a step's update where the gradient is above noise (see _update_gap)
CPU = dict(device="cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """PyTorch's CPU ops in one thread while this module runs (several test
    processes share the cores; PyTorch's spinning pools oversubscribe them)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _nhwc(t):
    return np.moveaxis(np.asarray(t.detach()), 1, -1)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def _rel_close(ours, ref, rtol):
    ours, ref = float(ours), float(ref)
    assert abs(ours - ref) <= rtol * max(abs(ref), 1e-12), (ours, ref)


# ------------------------------------------------------------ decomp helpers


def _decomps(seed):
    r = np.random.default_rng(seed)
    phase = tuple(r.uniform(-np.pi, np.pi, (3, 4, s, s)).astype(np.float32) for s in (16, 8, 4))
    amp = tuple(r.uniform(0, 1, p.shape).astype(np.float32) for p in phase)
    hi = r.normal(size=(3, 16, 16)).astype(np.float32)
    lo = r.normal(size=(3, 2, 2)).astype(np.float32)
    pt = Decomp(torch.from_numpy(hi), torch.from_numpy(lo), tuple(map(torch.from_numpy, phase)),
                tuple(map(torch.from_numpy, amp)))
    jx = JxDecomp(jnp.asarray(hi), jnp.asarray(lo), tuple(map(jnp.asarray, phase)),
                  tuple(map(jnp.asarray, amp)))
    return pt, jx


def _assert_decomp_close(ours: Decomp, ref, atol):
    assert len(ours.phase) == len(ref.phase) and len(ours.amplitude) == len(ref.amplitude)
    for o, r in zip([ours.high, ours.low, *ours.phase, *ours.amplitude],
                    [ref.high, ref.low, *ref.phase, *ref.amplitude]):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=atol)


@pytest.mark.parametrize("name,args", [
    ("keep_finest_levels", (1,)), ("keep_finest_levels", (2,)),
    ("keep_coarsest_levels", (1,)), ("keep_coarsest_levels", (5,)),
    ("abs_difference", ()), ("exchange_levels", (0, 2)), ("exchange_levels", (1, 3)),
])
def test_decomp_helpers_match_jax(name, args):
    (p1, j1), (p2, j2) = _decomps(0), _decomps(1)
    if name.startswith("keep"):
        ours, ref = getattr(pt_decomp, name)(p1, *args), getattr(jx_decomp, name)(j1, *args)
    else:
        ours, ref = getattr(pt_decomp, name)(p1, p2, *args), getattr(jx_decomp, name)(j1, j2, *args)
    _assert_decomp_close(ours, ref, 1e-7)


# ------------------------------------------------------------ PhaseNetCore


def _net_inputs(size, num_img, batch=2, seed=0):
    """Normalized PhaseNet inputs of `num_img` random Lab-like frames through
    the port's pyramid at size x size: (torch NCHW, numpy NHWC) triples."""
    rng = np.random.default_rng(seed)
    filters = make_filters(size, size, max_pyr_height(size, size))
    frames = [torch.from_numpy(rng.uniform(0, 1, (batch * 3, size, size)).astype(np.float32))
              for _ in range(num_img)]
    vals = [decompose(f, filters) for f in frames]
    low, phases, amps, _ = normalize_inputs(*pt_decomp.concat_for_net(vals))
    np_in = (_nhwc(low), [_nhwc(p) for p in phases], [_nhwc(a) for a in amps])
    return (low, phases, amps), np_in


def _core_pair(num_img):
    """A flax PhaseNetCore init with all 8 blocks (7 levels reach block 7)
    and running statistics drawn at random, and the port's core holding it,
    loaded strictly."""
    core = jx_phase.PhaseNetCore(num_img=num_img)
    low = jnp.zeros((1, 4, 4, num_img))
    lev = [jnp.zeros((1, 4, 4, 4 * num_img))] * 7
    tree = jax.tree.map(np.asarray, jax.jit(core.init)(jax.random.key(num_img), low, lev, lev))
    rng = np.random.default_rng(num_img)
    for st in tree["batch_stats"].values():
        st["bn"]["mean"] = rng.normal(0, 0.1, st["bn"]["mean"].shape).astype(np.float32)
        st["bn"]["var"] = rng.uniform(0.5, 1.5, st["bn"]["var"].shape).astype(np.float32)
    ours = PhaseNetCore(num_img=num_img)
    ours.load_state_dict(convert.phase_net_from_flax(tree), strict=True)
    return core, tree, ours


def _outputs_close(ours, ref, atol):
    lo, pp, ap = ours
    rlo, rpp, rap = ref
    assert len(pp) == len(rpp) and len(ap) == len(rap)
    for o, r in zip([lo, *pp, *ap], [rlo, *rpp, *rap]):
        np.testing.assert_allclose(_nhwc(o), np.asarray(r), rtol=0, atol=atol)


@pytest.mark.parametrize("num_img,m", [(2, None), (3, None), (4, None), (2, 3), (3, 2)])
def test_phase_net_core_matches_jax(num_img, m):
    """Eval forward (running statistics) on a 64x64 pyramid (6 levels),
    all levels or the m coarsest; the flax tree loads strictly."""
    pt_in, np_in = _net_inputs(64, num_img)
    core, tree, ours = _core_pair(num_img)
    ref = jax.jit(lambda v, *a: core.apply(v, *a, m=m))(tree, *np_in)
    with torch.no_grad():
        out = ours(*pt_in, m=m)
    assert len(out[1]) == (m or 6)
    _outputs_close(out, ref, 1e-4)


def _random_inputs(size, num_img, batch=6, seed=0):
    """Well-conditioned inputs on the level sizes of a size x size pyramid:
    low N(0, 1), phases U(-1, 1), amplitudes U(0, 1)."""
    rng = np.random.default_rng(seed)
    f = make_filters(size, size, max_pyr_height(size, size))
    nb = 4 * num_img
    low = rng.normal(size=(batch, *f.low_shape, num_img)).astype(np.float32)
    shapes = f.level_shapes[::-1]  # coarse first
    ph = [rng.uniform(-1, 1, (batch, *s, nb)).astype(np.float32) for s in shapes]
    am = [rng.uniform(0, 1, (batch, *s, nb)).astype(np.float32) for s in shapes]
    return (_nchw(low), [_nchw(p) for p in ph], [_nchw(a) for a in am]), (low, ph, am)


def _train_forward(core, tree, np_in):
    return jax.jit(lambda v, *a: core.apply(v, *a, train=True, mutable=["batch_stats"]))(
        tree, *np_in)


@pytest.mark.parametrize("num_img,size", [(2, 128), (3, 64), (4, 32)])
def test_phase_net_core_train_mode_matches_flax(num_img, size):
    """train=True against flax's mutable batch_stats on well-conditioned
    inputs: every block's running statistics after one forward within 1e-5,
    the outputs within the models' 1e-4 (8 blocks of batch statistics deep,
    3 of the 1,570,752 outputs at 128x128 are up to 1.12e-5 off:
    tools/phase_train_conditioning.py).  At 128x128 (8
    levels) block 7 serves levels 6 and 7, so its statistics move twice, in
    level order."""
    pt_in, np_in = _random_inputs(size, num_img, seed=size)
    core, tree, ours = _core_pair(num_img)
    ref, upd = _train_forward(core, tree, np_in)
    ours.eval()  # the argument decides, not the module's mode
    out = ours(*pt_in, train=True)
    _outputs_close(out, ref, 1e-4)
    want = convert.phase_net_from_flax(
        {"params": tree["params"], "batch_stats": jax.tree.map(np.asarray, upd["batch_stats"])})
    got = ours.state_dict()
    for k, v in want.items():
        if "running" in k:
            torch.testing.assert_close(got[k], v, rtol=0, atol=1e-5, msg=k)
    if size == 128:  # 8 levels: block 7 ran at levels 6 and 7
        assert len(pt_in[1]) == 8
        assert not torch.equal(got["blocks.7.bn.running_var"], torch.ones(64))


def test_phase_net_core_train_mode_on_a_pyramid_is_as_exact_as_flax():
    """On the normalized pyramid of noise frames at 128x128 the train-mode
    forward is ill-conditioned in float32 (BN's E[x^2] - E[x]^2 of small
    batches, through 8 blocks): flax and the port each differ from the same
    forward in float64 by ~1e-4..1e-2.  The port must be no further from
    the float64 result than flax."""
    pt_in, np_in = _net_inputs(128, 2, seed=128)
    core, tree, ours = _core_pair(2)
    ref, _ = _train_forward(core, tree, np_in)
    exact = copy.deepcopy(ours).double()(
        pt_in[0].double(), [p.double() for p in pt_in[1]], [a.double() for a in pt_in[2]],
        train=True)
    out = ours(*pt_in, train=True)

    exact = [exact[0], *exact[1], *exact[2]]
    ours_err = max(float((o.double() - e).abs().max())
                   for o, e in zip([out[0], *out[1], *out[2]], exact))
    flax_err = max(float(np.abs(np.asarray(r, np.float64) - _nhwc(e)).max())
                   for r, e in zip([ref[0], *ref[1], *ref[2]], exact))
    assert ours_err <= flax_err, (ours_err, flax_err)


def test_train_mode_block_uses_the_biased_variance():
    """A block on 12 values per channel: its running statistics follow
    flax's rule within 1e-5, where torch's own update (F.batch_norm with
    training=True moves running_var toward the unbiased variance) misses the
    bound by far.  Serving (train=False) keeps the running statistics even
    in a module put in train mode."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 2, 2, 6)).astype(np.float32) * 2.0 + 0.5
    block = jx_phase.PhaseNetBlock(16, 4, 1)
    tree = jax.tree.map(np.asarray, block.init(jax.random.key(1), x))
    (feat, pred), upd = block.apply(tree, x, train=True, mutable=["batch_stats"])
    ours = PhaseNetBlock(6, 16, 4, 1)
    sd = convert.phase_net_from_flax({"params": {"block0": tree["params"]},
                                      "batch_stats": {"block0": tree["batch_stats"]}})
    ours.load_state_dict({k.removeprefix("blocks.0."): v for k, v in sd.items()})
    got = ours(_nchw(x), train=True)
    np.testing.assert_allclose(_nhwc(got[0]), np.asarray(feat), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_nhwc(got[1]), np.asarray(pred), rtol=0, atol=1e-5)
    want_var = upd["batch_stats"]["bn"]["var"]
    np.testing.assert_allclose(ours.bn.running_var.numpy(), want_var, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ours.bn.running_mean.numpy(), upd["batch_stats"]["bn"]["mean"],
                               rtol=0, atol=1e-5)

    torch_rm, torch_rv = torch.zeros(16), torch.ones(16)
    with torch.no_grad():
        h = ours.conv1(_nchw(x))
        F.batch_norm(h, torch_rm, torch_rv, None, None, True, 0.1, 1e-5)
    assert float((torch_rv - torch.tensor(np.asarray(want_var))).abs().max()) > 1e-3

    ours.train()
    before = {k: v.clone() for k, v in ours.state_dict().items()}
    with torch.no_grad():
        served = ours(_nchw(x))
        served2 = ours.eval()(_nchw(x))
    assert all(torch.equal(v, ours.state_dict()[k]) for k, v in before.items())
    assert all(torch.equal(a, b) for a, b in zip(served, served2))


def test_predictions_to_decomp_refuses_missing_levels():
    """Fewer predicted levels than `total_levels` raise, as in JAX; a full
    prediction repacks fine-first."""
    (low, phases, amps), _ = _net_inputs(32, 2)
    norm = normalize_inputs(low, phases, amps)[3]
    core = PhaseNetCore().init_params(torch.Generator().manual_seed(0))
    high = torch.zeros(6, 32, 32)
    with torch.no_grad():
        lo, pp, ap = core(low, phases, amps, m=2)
        full = core(low, phases, amps)
    with pytest.raises(ValueError, match="exchange_levels"):
        predictions_to_decomp(lo, pp, ap, norm, high, total_levels=4)
    dec = predictions_to_decomp(*full, norm, high, total_levels=4)
    assert [p.shape[-1] for p in dec.phase] == sorted((p.shape[-1] for p in phases), reverse=True)


# ------------------------------------------------------------ the trainer


def _batch(n, size, seed):
    items = [translation_triplet(size, size, dx=3.0 + i, dy=1.0 - i, seed=seed + i)
             for i in range(n)]
    return tuple(np.stack([it[j] for it in items]) for j in range(3))


def _tree(state):
    return {"params": jax.tree.map(np.asarray, state.params),
            "batch_stats": jax.tree.map(np.asarray, state.extra)}


def _adam_mu(opt_state):
    """Adam's first moment in an optax state, as a params tree."""
    found = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu"))
             if hasattr(s, "mu")]
    return jax.tree.map(np.asarray, found[0].mu)


@pytest.fixture(scope="module")
def ada_tree():
    with open(ADACOF_CKPT, "rb") as f:
        return serialization.msgpack_restore(f.read())


# (size, make_step's m, steps, trainer options); lr PARITY_LR unless given
CONFIGS = {
    "phase": (64, None, 3, {}),
    "phase_m3": (64, 3, 1, {}),
    "fusion_v0": (32, None, 1, dict(mode="fusion", model_variant=0)),
    "fusion_v1": (32, None, 1, dict(mode="fusion", model_variant=1)),
    "high_level": (32, None, 1, dict(high_level=True)),
    "default_lr": (64, None, 1, dict(lr=1e-3)),
}


@pytest.fixture(scope="module")
def jax_runs(ada_tree):
    """The JAX phase trainer per configuration, jitted and built once: the
    init, the metrics of each step, the params and statistics after each
    step (and for default_lr also after one step on the batch moved up by
    one ulp)."""
    cache = {}

    def run(name):
        if name in cache:
            return cache[name]
        size, m, steps, kw = CONFIGS[name]
        kw = dict(kw)
        lr = kw.pop("lr", PARITY_LR)
        needs_ada = kw.get("mode") == "fusion" or kw.get("high_level")
        state, step, eval_fn, make_step = jx_trainer.make_phase_trainer(
            jax.random.key(0), size, size, lr=lr, adacof_vars=ada_tree if needs_ada else None, **kw)
        batch = _batch(2, size, 0)
        init = _tree(state)
        fn = jax.jit(step if m is None else make_step(m))
        res = dict(batch=batch, init=init, metrics=[], trees=[], mus=[], lr=lr, size=size, m=m,
                   kw=kw, state0=state, eval_fn=eval_fn)
        for _ in range(steps):
            state, met = fn(state, batch)
            res["metrics"].append({k: float(v) for k, v in met.items()})
            res["trees"].append(_tree(state))
            res["mus"].append(_adam_mu(state.opt_state))
        if name == "default_lr":
            nudged = tuple(np.nextafter(b, np.float32(2)) for b in batch)
            res["nudged"] = _tree(fn(res["state0"], nudged)[0])
        cache[name] = res
        return res

    return run


def _port_trainer(ref, ada_sd=None, **extra):
    """The port's trainer at ref's configuration, holding ref's init."""
    kw = dict(ref["kw"])
    ada = None
    if ada_sd is not None:
        ada = AdaCoFNet(max_offset=None)
        ada.load_state_dict(ada_sd)
    state, step, eval_fn, make_step = make_phase_trainer(
        ref["size"], ref["size"], lr=ref["lr"], adacof=ada, **kw, **extra, **CPU)
    missing = state.model.load_state_dict(
        convert.phase_net_from_flax(ref["init"]), strict=False).missing_keys
    reached = {f"blocks.{int(k.removeprefix('block'))}." for k in ref["init"]["params"]}
    assert not [k for k in missing if k[: len("blocks.0.")] in reached], missing
    if ref["m"] is not None:
        step = make_step(ref["m"])
    return state, step, eval_fn


def _entries_off(state, tree, atol):
    """(entries of the params and running statistics off by more than atol,
    entries compared, largest difference) against a flax tree."""
    ref = convert.phase_net_from_flax(tree)
    off = n = 0
    worst = 0.0
    for k, v in state.model.state_dict().items():
        if k in ref and "num_batches" not in k:
            d = (v - ref[k]).abs()
            off += int((d > atol).sum())
            n += d.numel()
            worst = max(worst, float(d.max()))
    return off, n, worst


def _update_gap(state, prev, ref, i):
    """Step i's update against JAX's: the largest |(p - prev) - (p_jax -
    prev_jax)| / lr, less two float32 spacings of p, over the entries whose
    gradient (Adam's first moment, JAX's) is at least 0.1 of its tensor's
    largest.  Adam's step there is ~lr x sign(gradient), which float noise
    cannot flip; at noise-level gradients it is noise too, and so it is
    in all of a conv1 bias, whose gradient train-mode BN makes zero in
    exact arithmetic.  Those and the leaves only the port has (blocks no
    level reaches) are left out.  From step 2 on Adam's step is
    m/sqrt(v) over the steps' gradients, so it carries their errors: JAX's
    float32 gradient of blocks 0-2 is up to 5.7 % of its tensor's largest
    off its own float64 one (test_torch_train_phase_grads.py), which
    moves block 0's step 2 by 2.0e-2 lr at 64x64."""
    stats = ref["init"]["batch_stats"]
    mu_ref = convert.phase_net_from_flax({"params": ref["mus"][i], "batch_stats": stats})
    after = convert.phase_net_from_flax(ref["trees"][i])
    before = convert.phase_net_from_flax(ref["trees"][i - 1] if i else ref["init"])
    gaps = {}
    for k, p in state.model.named_parameters():
        if k not in mu_ref or k.endswith("conv1.bias"):
            continue
        mask = mu_ref[k].abs() >= 0.1 * mu_ref[k].abs().max()
        ours = p.detach().double() - prev[k].double()
        theirs = after[k].double() - before[k].double()
        slack = 2 * torch.from_numpy(np.spacing(np.abs(after[k].numpy()))).double()
        gaps[k] = float(((ours - theirs).abs() - slack)[mask].max()) / ref["lr"]
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def _run_and_compare(jax_runs, name, ada_tree):
    ref = jax_runs(name)
    ada_sd = convert.adacof_from_flax(ada_tree) if ref["kw"] else None
    state, step, _ = _port_trainer(ref, ada_sd)
    for i, want in enumerate(ref["metrics"]):
        prev = {k: v.clone() for k, v in state.model.state_dict().items()}
        state, met = step(state, ref["batch"])
        assert set(met) == set(want) == {"loss", "l1", "phase"}
        for k in want:
            _rel_close(met[k], want[k], 1e-5)
        off, n, worst = _entries_off(state, ref["trees"][i], 1e-4)
        assert off == 0, f"step {i + 1}: {off} of {n} entries off, worst {worst}"
        gap, leaf = _update_gap(state, prev, ref, i)
        print(f"GAPS {name} step {i + 1}: update {gap:.3e} lr {leaf}")
        assert gap <= UPDATE_TOL, f"step {i + 1}: update of {leaf} off by {gap:.3g} lr"
    assert state.step == len(ref["metrics"])
    return state


@pytest.mark.parametrize("name", ["phase", "phase_m3", "fusion_v0", "fusion_v1", "high_level"])
def test_phase_trainer_steps_match_jax(jax_runs, ada_tree, name):
    """Mode phase over 3 steps (held after each), make_step(3) (the finest 5
    of 6 levels exchanged for the target's), mode fusion with variants 0 and
    1 (num_img 4 and 3) and high_level, from the same init and batch:
    metrics within 1e-5 relative, every param and running statistic within
    1e-4 and the update within 5e-2 lr (above-noise gradients) after each
    step."""
    state = _run_and_compare(jax_runs, name, ada_tree)
    before = convert.phase_net_from_flax(jax_runs(name)["init"])
    moved = state.model.state_dict()["blocks.1.bn.running_mean"]
    assert not torch.equal(moved, before["blocks.1.bn.running_mean"])  # train mode was on


def test_default_lr_step_matches_jax_as_closely_as_jax_matches_itself(jax_runs):
    """One step at the default lr 1e-3: metrics within 1e-5 relative and
    running statistics within 1e-4 (the forward is well conditioned); the
    params within 1e-4 but for at most 1 % of the entries, whose gradient is
    at float-noise level so that Adam's first step, ~lr x sign(gradient),
    moves them up to 2 lr apart; the update within 5e-2 lr where the
    gradient is above noise.  JAX against itself with the batch moved by
    one ulp does the same (held here: more than 0.05 % of its entries)."""
    ref = jax_runs("default_lr")
    state, step, _ = _port_trainer(ref)
    prev = {k: v.clone() for k, v in state.model.state_dict().items()}
    state, met = step(state, ref["batch"])
    for k, want in ref["metrics"][0].items():
        _rel_close(met[k], want, 1e-5)
    gap, leaf = _update_gap(state, prev, ref, 0)
    print(f"GAPS default_lr: update {gap:.3e} lr {leaf}")
    assert gap <= UPDATE_TOL, f"update of {leaf} off by {gap:.3g} lr"
    stats = {k: v for k, v in convert.phase_net_from_flax(ref["trees"][0]).items()
             if "running" in k}
    for k, v in stats.items():
        torch.testing.assert_close(state.model.state_dict()[k], v, rtol=0, atol=1e-4, msg=k)
    off, n, worst = _entries_off(state, ref["trees"][0], 1e-4)
    assert off <= 0.01 * n and worst <= 2 * ref["lr"] + 1e-4, (off, n, worst)
    jax_off = _entries_off(state._replace(model=_model_of(ref["nudged"])), ref["trees"][0], 1e-4)
    assert jax_off[0] > 0.0005 * jax_off[1], jax_off


def _model_of(tree):
    model = PhaseNetCore()
    model.load_state_dict(convert.phase_net_from_flax(tree), strict=False)
    return model


def test_eval_fn_matches_jax(jax_runs):
    ref = jax_runs("phase")
    state, _, eval_fn = _port_trainer(ref)
    f1, _, f2 = ref["batch"]
    want = jax.jit(ref["eval_fn"])(ref["state0"], f1, f2)
    got = eval_fn(state, f1, f2)
    assert got.shape == (6, 64, 64) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    _, _, fusion_eval = make_phase_trainer(32, 32, mode="fusion", adacof=AdaCoFNet(), **CPU)[:3]
    with pytest.raises(ValueError, match="mode 'phase'"):
        fusion_eval(state, f1[:, :32, :32], f2[:, :32, :32])


def test_phase_trainer_refuses_a_missing_or_mismatched_adacof():
    with pytest.raises(ValueError, match="need an AdaCoF"):
        make_phase_trainer(32, 32, high_level=True, **CPU)
    with pytest.raises(ValueError, match="weights are on meta"):
        make_phase_trainer(32, 32, mode="fusion", adacof=AdaCoFNet().to("meta"), **CPU)
    with pytest.raises(ValueError, match="mode"):
        make_phase_trainer(32, 32, mode="adacof", **CPU)


# ------------------------------------------------------------ fit's m schedule


def _recording_make_step(seen, bump):
    """make_step(m) that records m and whose step only advances the state."""

    def make_step(m):
        seen.append(m)

        def step(state, batch):
            return bump(state), {"loss": 0.0}

        return step

    return make_step


@pytest.mark.parametrize("steps_per_epoch,epochs,stop_at", [(6, 2, 4), (None, 1, 5)])
def test_fit_m_schedule_and_resume_match_jax(tmp_path, steps_per_epoch, epochs, stop_at):
    """The m each rebuilt step is given, across epochs and after a resume
    from a checkpoint mid-schedule, is JAX's (`fit(jit=False)`), and the
    metrics records carry m."""
    batches = [_batch(1, 16, s) for s in range(12)]
    opts = dict(epochs=epochs, steps_per_epoch=steps_per_epoch, log_every=1, m_init=3,
                m_update=2, m_max=6)

    jx_state = jx_trainer.make_phase_trainer(jax.random.key(0), 16, 16)[0]
    jx_seen = []
    jx_make = _recording_make_step(jx_seen, lambda s: s._replace(step=s.step + 1))
    for part in (batches[:stop_at], batches[stop_at:]):
        jx_loop.fit(jx_state, None, iter(part), str(tmp_path / "jax"), jit=False,
                    make_step=jx_make, ckpt_every=stop_at, **opts)

    pt_seen = []
    pt_make = _recording_make_step(pt_seen, lambda s: s._replace(step=s.step + 1))
    for part in (batches[:stop_at], batches[stop_at:]):
        state = make_phase_trainer(16, 16, **CPU)[0]
        state = fit(state, None, iter(part), str(tmp_path / "pt"), make_step=pt_make,
                    ckpt_every=stop_at, **opts)
    assert pt_seen == jx_seen and len(pt_seen) > 3, (pt_seen, jx_seen)
    recs = [line for line in (tmp_path / "pt" / "train_metrics.jsonl").read_text().splitlines()]
    assert len(recs) == 12 and all('"m": ' in r for r in recs)
    assert state.step == 12


def test_fit_resumes_phase_training_with_its_statistics(tmp_path):
    """A checkpoint of the phase trainer holds the BN running statistics, and
    fit resumed from it ends where an uninterrupted run ends."""
    batches = [_batch(1, 32, s) for s in range(4)]

    def run(out, parts):
        for part in parts:
            state, step, _, make_step = make_phase_trainer(32, 32, **CPU)
            state = fit(state, step, iter(part), str(out), epochs=1, steps_per_epoch=4,
                        ckpt_every=2, make_step=make_step, m_init=2, m_update=1)
        return state

    whole = run(tmp_path / "whole", [batches])
    resumed = run(tmp_path / "resumed", [batches[:2], batches[2:]])
    assert whole.step == resumed.step == 4
    fresh = make_phase_trainer(32, 32, **CPU)[0].model.state_dict()
    for k, a in whole.model.state_dict().items():
        assert torch.equal(a, resumed.model.state_dict()[k]), k
    assert not torch.equal(whole.model.state_dict()["blocks.0.bn.running_var"],
                           fresh["blocks.0.bn.running_var"])
