"""fmvfi_tpu_torch's AdaCoF trainer with the VGG and adversarial terms
against the JAX package's on the CPU, and fit's resume of an adversarial
run.

The trainer step: one step of JAX's make_adacof_trainer and of the port's
with the loss `1*Charb+0.01*g_Spatial+0.005*g_Occlusion+0.01*VGG+
0.005*T_WGAN_GP` at 32x32, batch 2, from the bundled AdaCoF weights, one
seeded vgg16 .pth and JAX's initial critic (converted), with JAX's
gradient-penalty epsilon put into the port; both optimizers plain SGD
without clip, recording the gradient they apply; the same scene and warp
contract as tests/test_torch_train.py (use_pallas=True, |offset| < 48).
Held as that file holds a step: the metrics (VGG, T_WGAN_GP and d_loss
included) within 1e-5 relative and the generator's gradient within 1e-4
of each tensor's largest.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import serialization

from fmvfi_tpu.train import losses as jx_losses
from fmvfi_tpu.train import trainer as jx_trainer
from fmvfi_tpu_torch.eval.synth import translation_triplet
from fmvfi_tpu_torch.train import adversarial as pt_adv
from fmvfi_tpu_torch.train import losses as pt_losses
from fmvfi_tpu_torch.train import trainer as pt_trainer
from fmvfi_tpu_torch.train.loop import fit
from fmvfi_tpu_torch.utils import convert
from fmvfi_tpu_torch.utils.checkpoint import Checkpointer
from test_torch_adversarial import _recording_sgd
from test_torch_vgg import seeded_vgg16

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ADACOF_CKPT = os.path.join(ROOT, "checkpoints", "adacof_synth_demo.msgpack")
SIZE = 32
SPEC = "1*Charb+0.01*g_Spatial+0.005*g_Occlusion+0.01*VGG+0.005*T_WGAN_GP"
METRIC_TOL, GRAD_TOL = 1e-5, 1e-4


def _batch(n, size, seed):
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
def vgg_path(tmp_path_factory):
    return str(seeded_vgg16(tmp_path_factory.mktemp("vgg") / "vgg16.pth"))


@pytest.fixture(scope="module")
def jax_run(bundled, vgg_path):
    """One jitted step of JAX's make_adacof_trainer from the bundled weights,
    its optimizer a plain SGD without clip whose state is the gradient it
    applied: the trainer's critic and epsilon, its metrics and the
    generator's gradient."""
    tree, _ = bundled
    batch = _batch(2, SIZE, 0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(optax, "sgd", _recording_sgd)
        state, step = jx_trainer.make_adacof_trainer(
            jax.random.key(0), SIZE, SIZE, loss_spec=jx_losses.parse_loss_spec(SPEC),
            vgg_checkpoint=vgg_path, optimizer="sgd", grad_clip=0.0, use_pallas=True)
    state = state._replace(params=jax.tree.map(jnp.asarray, tree["params"]))
    new, metrics = jax.jit(step)(state, batch)
    _, sub = jax.random.split(jax.random.wrap_key_data(state.extra.rng))
    eps = np.asarray(jax.random.uniform(sub, (2, SIZE, SIZE, 3)))
    return dict(batch=batch, extra=state.extra, eps=eps, grads=new.opt_state,
                metrics={k: float(v) for k, v in metrics.items()})


def _port_trainer(bundled, spec, vgg_path, **kw):
    _, sd = bundled
    state, step = pt_trainer.make_adacof_trainer(
        loss_spec=pt_losses.parse_loss_spec(spec), vgg_checkpoint=vgg_path, h=SIZE, w=SIZE,
        device="cpu", **kw)
    state.model.load_state_dict(sd, strict=True)
    return state, step


def test_train_step_with_vgg_and_t_wgan_gp_matches_jax(bundled, vgg_path, jax_run,
                                                       monkeypatch):
    state, step = _port_trainer(bundled, SPEC, vgg_path, optimizer="sgd", grad_clip=0.0)
    critic = convert.discriminator_from_flax(
        {"params": jax.tree.map(np.asarray, jax_run["extra"].params)}, "T_WGAN_GP")
    state.extra.critic.load_state_dict(critic, strict=True)
    eps = torch.from_numpy(np.ascontiguousarray(np.moveaxis(jax_run["eps"], -1, 1)))
    monkeypatch.setattr(pt_adv, "draw_eps", lambda gen, like: eps)
    applied = []

    def recording_apply(opt, params, grads):
        applied.append(grads)
        return apply(opt, params, grads)

    apply = pt_trainer._apply
    monkeypatch.setattr(pt_trainer, "_apply", recording_apply)
    state, m = step(state, jax_run["batch"])
    assert set(m) == set(jax_run["metrics"])
    for k, ref in jax_run["metrics"].items():
        assert abs(float(m[k]) / ref - 1.0) <= METRIC_TOL, (k, float(m[k]), ref)
    names = [n for n, _ in state.model.named_parameters()]
    ours = dict(zip(names, applied[0]))
    ref = convert.adacof_from_flax(jax.tree.map(np.asarray, jax_run["grads"]))
    assert set(ref) == set(ours)
    for k, r in ref.items():
        assert float((ours[k] - r).abs().max()) <= GRAD_TOL * float(r.abs().max()), k
    assert not any(p.grad is not None for p in state.extra.critic.parameters())


def test_critic_steps_when_the_generator_update_is_skipped(bundled, vgg_path, monkeypatch):
    """The critic state advances on a step whose generator update is skipped
    as non-finite (JAX's apply_if_finite wraps the generator's optimizer
    only)."""
    state, step = _port_trainer(bundled, "1*Charb+0.01*GAN", None)
    monkeypatch.setattr(pt_trainer, "clipped_update", lambda *a, **k: False)
    gen = {k: v.clone() for k, v in state.model.state_dict().items()}
    critic = {k: v.clone() for k, v in state.extra.critic.state_dict().items()}
    state, m = step(state, _batch(2, SIZE, 1))
    assert state.step == 1 and np.isfinite(float(m["d_loss"]))
    assert all(torch.equal(v, state.model.state_dict()[k]) for k, v in gen.items())
    moved = [k for k, v in state.extra.critic.state_dict().items() if not torch.equal(v, critic[k])]
    assert "trunk.fc2.weight" in moved and "trunk.bn0.running_mean" in moved


def _snapshot(state):
    opt = state.extra.optimizer.state_dict()["state"]
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            {k: v.clone() for k, v in state.extra.critic.state_dict().items()},
            {i: {k: v.clone() for k, v in s.items()} for i, s in opt.items()},
            state.extra.generator.get_state().clone())


@pytest.mark.parametrize("gan", ["FI_GAN", "WGAN_GP"])
def test_fit_resumes_an_adversarial_run_where_it_stopped(bundled, vgg_path, gan, tmp_path):
    """fit for 4 steps with a checkpoint at step 2, stopped there and resumed
    in a fresh trainer (another seed), ends where an uninterrupted run ends:
    the generator, the critic with its BN statistics, the critic's Adam and
    its generator's draws."""
    spec = f"1*Charb+0.01*VGG+0.01*{gan}"
    batches = [_batch(2, SIZE, s) for s in range(4)]

    def run(out, parts):
        for i, part in enumerate(parts):
            state, step = _port_trainer(bundled, spec, vgg_path, seed=i)
            state = fit(state, step, iter(part), str(out), epochs=1, steps_per_epoch=4,
                        log_every=1, ckpt_every=2)
        return state

    whole = run(tmp_path / "whole", [batches])
    resumed = run(tmp_path / "resumed", [batches[:2], batches[2:]])
    assert whole.step == resumed.step == 4
    assert Checkpointer(str(tmp_path / "resumed" / "checkpoint")).latest() == 4
    a, b = _snapshot(whole), _snapshot(resumed)
    for da, db in zip(a[:2], b[:2]):
        for k, v in da.items():
            assert torch.equal(v, db[k]), k
    assert a[2].keys() == b[2].keys() and len(a[2]) > 0
    for i, s in a[2].items():
        for k, v in s.items():
            assert torch.equal(v, b[2][i][k]), (i, k)
    assert torch.equal(a[3], b[3])
    lines = (tmp_path / "resumed" / "train_metrics.jsonl").read_text().splitlines()
    assert len(lines) == 4 and '"d_loss"' in lines[-1] and f'"{gan}"' in lines[-1]
