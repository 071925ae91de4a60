"""The gradients of fmvfi_tpu_torch's PhaseNet training step against the JAX
package's, on the CPU.

The reference is the JAX phase trainer run in float64 (`jax.enable_x64`,
params and batch cast up).  In float32 JAX's gradient is itself up to
5.7e-2 of a tensor's largest entry off its float64 one (blocks 0-2, the
low residual and the coarsest levels, in mode fusion variant 0), so a
float32 reference could not hold the port's to better than that.  The
bound here, 1e-2 of each tensor's largest entry, is float32's reach for
the port: its worst tensor is 4.9e-3 off (blocks 3-4 of mode fusion
variant 1); `python3 tools/phase_train_conditioning.py` prints both
sides' gaps per case.

Each case takes one step of `make_phase_trainer` from JAX's init
(jax.random.key(0), carried across) on a seeded 32x32 batch of 2 and
compares Adam's first moment after it, 0.1 x the gradient, per parameter
tensor relative to its largest entry.  A conv1 bias sits right in front of
a train-mode BN, so its gradient is zero in exact arithmetic and its
entries are float noise: it is held relative to the net's largest gradient
instead.  Blocks that no level reaches exist only in the port (zero
gradients there) and are left out.  Its own file so that the float64
compiles run on another test worker than the float32 parity cases.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from fmvfi_tpu.train import trainer as jx_trainer
from fmvfi_tpu_torch.eval.synth import translation_triplet
from fmvfi_tpu_torch.models.adacof import AdaCoFNet
from fmvfi_tpu_torch.train.trainer import make_phase_trainer
from fmvfi_tpu_torch.utils import convert

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ADACOF_CKPT = os.path.join(ROOT, "checkpoints", "adacof_synth_demo.msgpack")
SIZE = 32
GRAD_TOL = 1e-2  # of each tensor's largest gradient entry


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """PyTorch's CPU ops in one thread while this module runs (several test
    processes share the cores; PyTorch's spinning pools oversubscribe them)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ada_tree():
    with open(ADACOF_CKPT, "rb") as f:
        return serialization.msgpack_restore(f.read())


def _batch():
    items = [translation_triplet(SIZE, SIZE, dx=3.0 + i, dy=1.0 - i, seed=i) for i in range(2)]
    return tuple(np.stack([it[j] for it in items]) for j in range(3))


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64)
                        if jnp.asarray(a).dtype == jnp.float32 else a, tree)


def _jax_float64_step(kw, m, ada_tree, batch):
    """JAX's float32 init and, after one float64 step, Adam's first moment."""
    with jax.enable_x64(True):
        ada = _f64(ada_tree) if (kw.get("mode") == "fusion" or kw.get("high_level")) else None
        state, step, _, make_step = jx_trainer.make_phase_trainer(
            jax.random.key(0), SIZE, SIZE, adacof_vars=ada, **kw)
        init = {"params": jax.tree.map(np.asarray, state.params),
                "batch_stats": jax.tree.map(np.asarray, state.extra)}
        state = state._replace(params=_f64(state.params), extra=_f64(state.extra),
                               opt_state=_f64(state.opt_state))
        fn = jax.jit(step if m is None else make_step(m))
        state, _ = fn(state, tuple(np.asarray(b, np.float64) for b in batch))
        found = [s for s in jax.tree_util.tree_leaves(state.opt_state,
                                                      is_leaf=lambda x: hasattr(x, "mu"))
                 if hasattr(s, "mu")]
        mu = jax.tree.map(np.asarray, found[0].mu)
    return init, mu


# name: (make_step's m, trainer options)
CASES = {
    "phase": (None, {}),
    "phase_m3": (3, {}),
    "fusion_v0": (None, dict(mode="fusion", model_variant=0)),
    "fusion_v1": (None, dict(mode="fusion", model_variant=1)),
    "high_level": (None, dict(high_level=True)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_phase_step_gradients_match_jax_float64(ada_tree, name):
    """Mode phase, make_step(3) (the finest levels exchanged for the
    target's), mode fusion with variants 0 and 1, and high_level: every
    parameter tensor's gradient within 1e-2 of its largest entry of JAX's
    float64 gradient (a conv1 bias, or a block whose levels are all
    exchanged and whose gradient is zero: of the net's largest)."""
    m, kw = CASES[name]
    batch = _batch()
    init, mu = _jax_float64_step(kw, m, ada_tree, batch)

    ada = None
    if kw:
        ada = AdaCoFNet(max_offset=None)
        ada.load_state_dict(convert.adacof_from_flax(ada_tree))
    state, step, _, make_step = make_phase_trainer(SIZE, SIZE, adacof=ada, **kw, device="cpu")
    state.model.load_state_dict(convert.phase_net_from_flax(init), strict=False)
    if m is not None:
        step = make_step(m)
    state, _ = step(state, batch)

    ref = convert.phase_net_from_flax({"params": mu, "batch_stats": init["batch_stats"]})
    ours = {k: state.optimizer.state[p]["exp_avg"].double()
            for k, p in state.model.named_parameters() if k in ref}
    assert len(ours) == 8 * len(init["params"]) >= 8 * 4, sorted(ours)  # the blocks reached
    net_top = max(float(ref[k].abs().max()) for k in ours)
    gaps = {}
    for k, g in ours.items():
        top = float(ref[k].abs().max())
        if k.endswith("conv1.bias") or top == 0.0:
            top = net_top
        gaps[k] = float((g - ref[k]).abs().max()) / top
    worst = max(gaps, key=gaps.get)
    print(f"GAPS {name}: worst {worst} {gaps[worst]:.3e}; "
          + " ".join(f"{k}={v:.1e}" for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:6]))
    assert gaps[worst] <= GRAD_TOL, (worst, gaps[worst])
