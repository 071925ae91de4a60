"""fmvfi_tpu_torch models against the JAX package on the CPU, with the same
weights carried across by utils/convert.py.

Tolerance 1e-4 absolute: float32 convolutions summed in another order
through a deep U-Net.  The JAX AdaCoF on the CPU warps unclamped, so the
port runs with max_offset=None here; the default 48 px clamp is shown to
change nothing on these scenes, whose offsets stay far inside it.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from fmvfi_tpu.eval.synth import translation_triplet
from fmvfi_tpu.models import adacof as jx_adacof
from fmvfi_tpu.models import fusion_net as jx_fusion
from fmvfi_tpu.models import phase_net as jx_phase
from fmvfi_tpu.ops import decomp as jx_decomp
from fmvfi_tpu.ops import pyramid as jx_pyr
from fmvfi_tpu_torch.models.adacof import AdaCoFNet, warp_max_offset
from fmvfi_tpu_torch.models.fusion_net import FusionNet, infer_variant
from fmvfi_tpu_torch.models.phase_net import PhaseNetCore
from fmvfi_tpu_torch.utils import convert

MODEL_TOL = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ADACOF_CKPT = os.path.join(ROOT, "checkpoints", "adacof_synth_demo.msgpack")
FUSION_CKPT = os.path.join(ROOT, "checkpoints", "fusion_synth_demo.msgpack")


def _restore(path):
    with open(path, "rb") as f:
        return serialization.msgpack_restore(f.read())


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _close(ours, ref, tol=MODEL_TOL):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), rtol=0, atol=tol)


@pytest.fixture(scope="module")
def adacof_tree():
    return _restore(ADACOF_CKPT)


@pytest.fixture(scope="module")
def adacof_port():
    m = AdaCoFNet(max_offset=None).eval()
    m.load_state_dict(convert.load_adacof_weights(ADACOF_CKPT), strict=True)
    return m


@pytest.mark.parametrize("h,w,seed", [(64, 64, 0), (60, 44, 1)])
def test_adacof_net_matches_jax(adacof_tree, adacof_port, h, w, seed):
    f0, _, f2 = translation_triplet(h, w, dx=2.0, dy=1.0, seed=seed)
    f0, f2 = f0[None], f2[None]
    ref = jax.jit(jx_adacof.AdaCoFNet(kernel_size=5, dilation=1).apply)(
        adacof_tree, jnp.asarray(f0), jnp.asarray(f2)
    )
    with torch.no_grad():
        ours = adacof_port(_nchw(f0), _nchw(f2))
    for name in ("warped0", "warped2", "blended", "uncertainty", "occlusion"):
        _close(_nhwc(getattr(ours, name)), getattr(ref, name))
    for k in range(2):
        _close(_nhwc(ours.mean_flow[k]), ref.mean_flow[k])
        _close(_nhwc(ours.var_flow[k]), ref.var_flow[k])
    # the default clamp leaves this scene untouched: its offsets are small
    clamped = AdaCoFNet().eval()
    clamped.load_state_dict(adacof_port.state_dict())
    assert clamped.max_offset == 48
    with torch.no_grad():
        torch.testing.assert_close(
            clamped(_nchw(f0), _nchw(f2)).blended, ours.blended, rtol=0, atol=0
        )


def test_warp_max_offset_follows_the_jax_rule():
    assert warp_max_offset(5, 1) == 48  # fit 61
    assert warp_max_offset(11, 2) == 48  # fit 53
    assert warp_max_offset(11, 4, 80) == 43  # fit 43 < 80
    assert warp_max_offset(21, 4) is None  # fit 23 < 24: unclamped
    assert warp_max_offset(5, 1, None) is None


def _phase_tree():
    """A fixed-key flax init of all 8 blocks, with non-trivial BN affine
    parameters and running statistics."""
    low = jnp.zeros((1, 4, 4, 2))
    lev = [jnp.zeros((1, 4, 4, 8))] * 7
    tree = jax.jit(lambda k: jx_phase.PhaseNetCore(num_img=2).init(k, low, lev, lev))(
        jax.random.key(0)
    )
    tree = jax.tree.map(np.asarray, tree)
    rng = np.random.default_rng(11)
    for name, blk in tree["params"].items():
        c = blk["bn"]["scale"].shape
        blk["bn"]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        blk["bn"]["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
        st = tree["batch_stats"][name]["bn"]
        st["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
        st["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
    return tree


def test_phase_net_core_matches_jax():
    tree = _phase_tree()
    port = PhaseNetCore().eval()
    port.load_state_dict(convert.phase_net_from_flax(tree), strict=True)

    rng = np.random.default_rng(12)
    h = w = 96  # 8 band levels: every block, block 7 reused once
    img = rng.uniform(0, 1, (6, h, w)).astype(np.float32)
    vals = jx_pyr.decompose(jnp.asarray(img), jx_pyr.make_filters(h, w, jx_pyr.max_pyr_height(h, w)))
    low, phases, amps = jx_decomp.concat_for_net(jx_decomp.split_frames(vals, 2))
    lown, pn, an, _ = jx_phase.normalize_inputs(low, phases, amps)
    assert len(pn) == 8
    ref_low, ref_ph, ref_amp = jax.jit(jx_phase.PhaseNetCore(num_img=2).apply)(tree, lown, pn, an)
    with torch.no_grad():
        low_p, ph_p, amp_p = port(_nchw(lown), [_nchw(p) for p in pn], [_nchw(a) for a in an])
    _close(_nhwc(low_p), ref_low)
    for a, b in zip(ph_p, ref_ph):
        _close(_nhwc(a), b)
    for a, b in zip(amp_p, ref_amp):
        _close(_nhwc(a), b)


def _fusion_init_tree(variant, maps):
    z = jnp.zeros((1, 16, 16, 3))
    net = jx_fusion.FusionNet(uncertainty_maps=maps)
    init = jax.jit(lambda k: net.init(k, z, z, z, jnp.zeros((1, 16, 16, 6)),
                                      jnp.zeros((1, 16, 16, maps)) if maps else None, variant))
    tree = jax.tree.map(np.asarray, init(jax.random.key(1)))
    if variant == 2:  # the zero-initialized head would hide the blend
        tree["params"]["dec2"]["kernel"] = np.random.default_rng(13).normal(
            0, 0.5, tree["params"]["dec2"]["kernel"].shape).astype(np.float32)
    return tree


@pytest.mark.parametrize(
    "variant,maps,bundled", [(0, 3, False), (1, 3, False), (0, 0, False), (2, 3, True)]
)
def test_fusion_net_matches_jax(variant, maps, bundled):
    tree = _restore(FUSION_CKPT) if bundled else _fusion_init_tree(variant, maps)
    sd = convert.fusion_net_from_flax(tree)
    assert infer_variant(sd) == jx_fusion.infer_variant(tree) == (2 if variant == 2 else 0)
    port = FusionNet(uncertainty_maps=maps, variant=variant).eval()
    port.load_state_dict(sd, strict=True)

    rng = np.random.default_rng(14)
    base, ada, ph = (rng.uniform(0, 1, (2, 24, 32, 3)).astype(np.float32) for _ in range(3))
    other = rng.uniform(0, 1, (2, 24, 32, 6)).astype(np.float32)
    m = rng.uniform(0, 1, (2, 24, 32, maps)).astype(np.float32) if maps else None
    ref = jax.jit(
        lambda *a: jx_fusion.FusionNet(uncertainty_maps=maps).apply(tree, *a, variant=variant)
    )(base, ada, ph, other, m)
    with torch.no_grad():
        ours = port(_nchw(base), _nchw(ada), _nchw(ph), _nchw(other),
                    _nchw(m) if maps else None)
    _close(_nhwc(ours), ref)


def test_fresh_variant2_fusion_net_starts_at_the_component_mean():
    """A fresh variant-2 FusionNet has a zero head (dec2), as the JAX module's
    init gives it: the output is clamp((base + adacof + phase) / 3) with no
    residual, whatever the other convolutions' random init."""
    maps = 3
    z = jnp.zeros((1, 16, 16, 3))
    tree = jax.jit(lambda k: jx_fusion.FusionNet(uncertainty_maps=maps).init(
        k, z, z, z, jnp.zeros((1, 16, 16, 6)), jnp.zeros((1, 16, 16, maps)), 2))(
        jax.random.key(3))
    torch.manual_seed(3)
    port = FusionNet(uncertainty_maps=maps, variant=2).eval()

    rng = np.random.default_rng(16)
    base, ada, ph = (rng.uniform(0, 1, (2, 24, 32, 3)).astype(np.float32) for _ in range(3))
    other = rng.uniform(0, 1, (2, 24, 32, 6)).astype(np.float32)
    m = rng.uniform(0, 1, (2, 24, 32, maps)).astype(np.float32)
    ref = jax.jit(
        lambda *a: jx_fusion.FusionNet(uncertainty_maps=maps).apply(tree, *a, variant=2)
    )(base, ada, ph, other, m)
    with torch.no_grad():
        ours = port(_nchw(base), _nchw(ada), _nchw(ph), _nchw(other), _nchw(m))
    mean = np.clip((base + ada + ph) / 3.0, 0.0, 1.0)
    _close(np.asarray(ref), mean, tol=1e-6)
    _close(_nhwc(ours), np.asarray(ref), tol=1e-6)
