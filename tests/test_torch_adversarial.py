"""fmvfi_tpu_torch's adversarial step (train/adversarial.py) against the JAX
package's on the CPU, for each of the five gan types.

Both sides start from one flax critic (biases, BN scale/bias and running
statistics moved to seeded values), one fake/real/frames batch, and, for
the gradient penalty, JAX's own mixing weights epsilon (put into the port
through `draw_eps`).  Both critics are given plain SGD at lr 1e-3 that
records the gradient it applies (an Adam update moves each entry by ~lr
whatever the gradient is, so params after an Adam step cannot tell a
wrong gradient).  Held: d_loss and g_loss within 1e-4 relative; the
critic's gradient within 1e-3 of each tensor's largest; its params after
the update (the WGAN clamp included) within 1e-5; the refreshed BN
statistics within 1e-5 of each tensor's largest (at least 1); d g_loss /
d fake within 1e-3 of its largest (JAX's from jax.grad through its jitted
step).  Three planted faults must read over those bounds: the gradient
penalty weighted 0, a WGAN without its clamp, and a critic whose
train-mode forward moves its running statistics.

JAX runs in float64 (jax.enable_x64) on the float32 values the port gets:
its float32 FI_GAN critic gradient is up to 2.2e-2 of a tensor's largest
off its float64 one (conv0-bn3, where the train-mode BN backward of two
concatenated pairs cancels), the port's within 3.1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from fmvfi_tpu.train import adversarial as jx_adv
from fmvfi_tpu_torch.models import flax_bn
from fmvfi_tpu_torch.train import adversarial as pt_adv
from fmvfi_tpu_torch.utils import convert

GAN_TYPES = ["GAN", "WGAN", "WGAN_GP", "FI_GAN", "T_WGAN_GP"]
SIZE, BATCH, LR = 32, 2, 1e-3
LOSS_TOL, GRAD_TOL, PARAM_TOL, STATS_TOL = 1e-4, 1e-3, 1e-5, 1e-5
_REFS = {}


def _jitter(tree, rng):
    """Every leaf moved by seeded noise at its own scale: kernels by 10 %,
    zero-initialised biases and means to 0.01 scale; the leaves that
    initialise to ones (BN scales and variances) to 0.5 + |1 + N(0, 0.5)|,
    some of them over the WGAN clamp."""
    def f(a):
        a = np.asarray(a)
        noise = rng.normal(size=a.shape)
        if a.ndim == 1 and np.all(a == 1.0):
            return (np.abs(a + 0.5 * noise) + 0.5).astype(np.float32)
        if not a.any():
            return (0.01 * noise).astype(np.float32)
        return (a * (1 + 0.1 * noise)).astype(np.float32)

    return jax.tree.map(f, tree)


def _recording_sgd(lr):
    """optax.sgd(lr) whose state is the last gradient it applied."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(lambda g: -lr * g, grads), grads))


class _RecordingSGD(torch.optim.SGD):
    """torch.optim.SGD that keeps the gradients of its last step."""

    def step(self, closure=None):
        self.grads = [p.grad.clone() for g in self.param_groups for p in g["params"]]
        return super().step(closure)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    fake, real, f0, f2 = (rng.uniform(0, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
                          for _ in range(4))
    return rng, fake, real, (f0, f2)


def jax_ref(gan_type):
    """JAX's step from a jittered critic under SGD: the critic variables
    before, the state after, the critic's gradient, the losses, d g_loss /
    d fake and epsilon."""
    if gan_type in _REFS:
        return _REFS[gan_type]
    rng, fake, real, frames = _inputs()
    adv = jx_adv.Adversarial(gan_type, jax.random.key(0), patch_size=SIZE)
    state = adv.init_state()
    params = _jitter(state.params, rng)
    stats = _jitter(state.batch_stats, rng) if state.batch_stats else {}
    adv.tx = _recording_sgd(LR)
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa: E731
        state = jx_adv.AdvState(f64(params), f64(stats), adv.tx.init(f64(params)), state.rng)

        def g_of_fake(f):
            g_loss, new, aux = adv.step(state, f, f64(real), f64(frames))
            return g_loss, (new, aux)

        (g_loss, (new, aux)), dfake = jax.jit(jax.value_and_grad(g_of_fake, has_aux=True))(
            f64(fake))
        _, sub = jax.random.split(jax.random.wrap_key_data(state.rng))
        eps = np.asarray(jax.random.uniform(sub, fake.shape), np.float32)
    ref = dict(before={"params": params, "batch_stats": stats},
               after={"params": jax.tree.map(np.asarray, new.params),
                      "batch_stats": jax.tree.map(np.asarray, new.batch_stats)},
               # the BN statistics only to fill the converter's tree
               grads={"params": jax.tree.map(np.asarray, new.opt_state),
                      "batch_stats": jax.tree.map(np.asarray, new.batch_stats)},
               g_loss=float(g_loss), d_loss=float(aux["d_loss"]), dfake=np.asarray(dfake),
               eps=eps, inputs=(fake, real, frames))
    _REFS[gan_type] = ref
    return ref


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def port_step(gan_type, ref, monkeypatch):
    """The port's step from the same critic, inputs and epsilon; returns
    (g_loss, d_loss, dfake NHWC, the critic's gradient by name, its state
    dict after)."""
    monkeypatch.setattr(pt_adv, "draw_eps", lambda gen, like: _nchw(ref["eps"]))
    adv = pt_adv.Adversarial(gan_type, SIZE, device="cpu")
    state = adv.init_state()
    state.critic.load_state_dict(convert.discriminator_from_flax(ref["before"], gan_type),
                                 strict=True)
    state = state._replace(optimizer=_RecordingSGD(state.critic.parameters(), lr=LR))
    fake, real, frames = ref["inputs"]
    fake_t = _nchw(fake).requires_grad_(True)
    g_loss, state, aux = adv.step(state, fake_t, _nchw(real), tuple(map(_nchw, frames)))
    dfake, = torch.autograd.grad(g_loss, fake_t)
    assert not any(p.grad is not None for p in state.critic.parameters())
    names = [n for n, _ in state.critic.named_parameters()]
    return (float(g_loss), float(aux["d_loss"]), np.moveaxis(dfake.numpy(), 1, -1),
            dict(zip(names, state.optimizer.grads)), state.critic.state_dict())


def gaps(gan_type, monkeypatch):
    """Each checked quantity's gap, as a fraction of its bound's scale."""
    ref = jax_ref(gan_type)
    g_loss, d_loss, dfake, grads, after = port_step(gan_type, ref, monkeypatch)
    ref_after = convert.discriminator_from_flax(ref["after"], gan_type)
    ref_grads = convert.discriminator_from_flax(ref["grads"], gan_type)
    out = dict(g_loss=abs(g_loss / ref["g_loss"] - 1.0), d_loss=abs(d_loss / ref["d_loss"] - 1.0),
               dfake=float(np.abs(dfake - ref["dfake"]).max()) / float(np.abs(ref["dfake"]).max()),
               grad=0.0, params=0.0, stats=0.0)
    for k, r in ref_after.items():
        if "running" in k:
            scale = max(float(r.abs().max()), 1.0)
            out["stats"] = max(out["stats"], float((after[k] - r).abs().max()) / scale)
        elif not k.endswith("num_batches_tracked"):
            out["params"] = max(out["params"], float((after[k] - r).abs().max()))
            scale = max(float(ref_grads[k].abs().max()), 1e-30)
            out["grad"] = max(out["grad"], float((grads[k] - ref_grads[k]).abs().max()) / scale)
    return out


BOUNDS = dict(g_loss=LOSS_TOL, d_loss=LOSS_TOL, dfake=GRAD_TOL, grad=GRAD_TOL,
              params=PARAM_TOL, stats=STATS_TOL)


@pytest.mark.parametrize("gan_type", GAN_TYPES)
def test_step_matches_jax(gan_type, monkeypatch):
    g = gaps(gan_type, monkeypatch)
    print(gan_type, g)
    for k, bound in BOUNDS.items():
        assert g[k] <= bound, (k, g)


def _moving_normalize(x, bn, train, move=False):
    return _normalize(x, bn, train, move=train)


_normalize = flax_bn.normalize


@pytest.mark.parametrize("fault,gan_type,reads", [
    ("gp_weight_0", "WGAN_GP", ("d_loss", "grad")),
    ("no_clamp", "WGAN", ("params",)),
    ("forward_moves_stats", "GAN", ("stats",)),
])
def test_planted_fault_reads_over_the_bound(fault, gan_type, reads, monkeypatch):
    if fault == "gp_weight_0":
        monkeypatch.setattr(pt_adv, "GP_WEIGHT", 0.0)
    elif fault == "no_clamp":
        monkeypatch.setattr(pt_adv, "WGAN_CLIP", float("inf"))
    else:
        monkeypatch.setattr(flax_bn, "normalize", _moving_normalize)
    g = gaps(gan_type, monkeypatch)
    print(fault, g)
    for k in reads:
        assert g[k] > BOUNDS[k], (k, g)


def test_init_state_is_seeded_and_gp_steps_draw_from_its_generator():
    adv = pt_adv.Adversarial("WGAN_GP", 16, device="cpu")
    a, b = adv.init_state(), adv.init_state()
    for k, v in a.critic.state_dict().items():
        assert torch.equal(v, b.critic.state_dict()[k]), k
    start = a.generator.get_state()
    assert torch.equal(start, b.generator.get_state())
    x = torch.rand(1, 3, 16, 16)
    adv.step(a, x, x)
    assert not torch.equal(a.generator.get_state(), start)
