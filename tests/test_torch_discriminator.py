"""fmvfi_tpu_torch's critics (models/discriminator.py) against the JAX
package's flax critics on the CPU, through utils/convert.py.

Each flax critic is initialised, its running statistics (for the BN
critics) and biases moved to seeded values so that no term is trivially
zero, converted, loaded with strict=True and run on the same numpy inputs
in eval mode (running statistics) and in train mode (batch moments).
Tolerance 1e-4 of the largest output (f32 convolutions summed in another
order through 8 blocks and a 1024-wide fc1); the running statistics
that a train-mode pass with move_stats gives, 1e-5 of each tensor's
largest entry.  The odd crop 33x31 pins
flax's stride-2 SAME padding, (1, 1) for odd sizes and (0, 1) for even.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fmvfi_tpu.models import discriminator as jx_disc
from fmvfi_tpu_torch.models.discriminator import _same_pads, make_critic
from fmvfi_tpu_torch.utils import convert

GAN_TYPES = ["GAN", "WGAN", "WGAN_GP", "FI_GAN", "T_WGAN_GP"]
N_FRAMES = {"FI_GAN": 2, "T_WGAN_GP": 3}
TOL = 1e-4
STATS_TOL = 1e-5  # of each statistic's largest entry (at least 1)


def jax_critic(gan_type):
    if gan_type == "T_WGAN_GP":
        return jx_disc.TemporalDiscriminator()
    if gan_type == "FI_GAN":
        return jx_disc.FIDiscriminator()
    return jx_disc.Discriminator(gan_type=gan_type)


def _jitter(tree, rng, scale):
    """Every leaf plus seeded noise (variances kept positive)."""
    return jax.tree.map(
        lambda a: np.abs(a + scale * rng.normal(size=a.shape)).astype(np.float32) + 0.5
        if a.ndim == 1 and np.all(np.asarray(a) == 1.0)
        else (a + scale * rng.normal(size=a.shape)).astype(np.float32), tree)


def flax_case(gan_type, h, w, b=3, seed=0):
    """A converted flax critic: (jax module, its variables, the port's critic
    with them loaded, NHWC numpy frames)."""
    rng = np.random.default_rng(seed)
    frames = [rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32)
              for _ in range(N_FRAMES.get(gan_type, 1))]
    model = jax_critic(gan_type)
    variables = model.init(jax.random.key(seed), *[f[:1] for f in frames])
    variables = jax.tree.map(np.asarray, dict(variables))
    # bias and BN scale/bias off their init, running statistics off 0 / 1
    variables = {k: _jitter(v, rng, 0.05) for k, v in variables.items()}
    ours = make_critic(gan_type, (h, w))
    ours.load_state_dict(convert.discriminator_from_flax(variables, gan_type), strict=True)
    return model, variables, ours, frames


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _close(ours, ref):
    ours, ref = ours.detach().numpy(), np.asarray(ref)
    assert ours.shape == ref.shape
    err = float(np.abs(ours - ref).max())
    assert err <= TOL * max(float(np.abs(ref).max()), 1.0), err
    return err


@pytest.mark.parametrize("size", [(32, 32), (33, 31)], ids=["32x32", "33x31"])
@pytest.mark.parametrize("gan_type", GAN_TYPES)
def test_critic_matches_flax_in_eval_and_train_mode(gan_type, size):
    model, variables, ours, frames = flax_case(gan_type, *size)
    xs = [jnp.asarray(f) for f in frames]
    ts = [_nchw(f) for f in frames]
    _close(ours(*ts), model.apply(variables, *xs))
    if "batch_stats" in variables:
        ref, _ = model.apply(variables, *xs, train=True, mutable=["batch_stats"])
    else:
        ref = model.apply(variables, *xs, train=True)
    before = {k: v.clone() for k, v in ours.state_dict().items()}
    _close(ours(*ts, train=True), ref)
    for k, v in ours.state_dict().items():  # train mode alone moves no statistic
        assert torch.equal(v, before[k]), k


def test_train_mode_with_move_stats_moves_them_as_flax():
    model, variables, ours, frames = flax_case("GAN", 32, 32)
    _, mut = model.apply(variables, jnp.asarray(frames[0]), train=True, mutable=["batch_stats"])
    with torch.no_grad():
        ours(_nchw(frames[0]), train=True, move_stats=True)
    sd = ours.state_dict()
    for name, s in mut["batch_stats"]["trunk"].items():
        for ours_key, flax_key in (("running_mean", "mean"), ("running_var", "var")):
            ref = np.array(s[flax_key])
            err = float((sd[f"trunk.{name}.{ours_key}"] - torch.from_numpy(ref)).abs().max())
            assert err <= STATS_TOL * max(float(np.abs(ref).max()), 1.0), (name, ours_key, err)


def test_critic_layout():
    """BN where flax has it, bias-free trunk convs, fc1 sized from the crop."""
    for gan_type in GAN_TYPES:
        sd = make_critic(gan_type, 32).state_dict()
        has_bn = gan_type in ("GAN", "WGAN", "FI_GAN")
        assert any(".bn" in k for k in sd) == has_bn, gan_type
        assert not any(k.startswith("trunk.conv") and k.endswith("bias") for k in sd)
        assert sd["trunk.fc1.weight"].shape == (1024, 2 * 2 * 512)
        assert ("conv3d_0.bias" in sd) == (gan_type == "T_WGAN_GP")
    assert make_critic("GAN", (33, 31)).trunk.fc1.in_features == 3 * 2 * 512
    assert [_same_pads(n, 2) for n in (32, 33, 2, 1)] == [(0, 1), (1, 1), (0, 1), (1, 1)]
    assert _same_pads(7, 1) == (1, 1)
