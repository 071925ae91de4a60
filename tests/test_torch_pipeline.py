"""fmvfi_tpu_torch pipelines against the JAX package on the CPU, with the same
weights: the bundled AdaCoF and FusionNet (variant 2) checkpoints and a
fixed-key flax PhaseNet init carried across.

Agreement is held at >= 60 dB PSNR against the JAX output (the fused frame
and each intermediate frame), and 1e-3 absolute on the uncertainty maps,
whose 50x50 median is a histogram rank filter: an input that moves by float
noise across a bin edge moves the median by up to one bin.  The JAX AdaCoF
on the CPU warps unclamped, so the port runs with max_offset=None.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from fmvfi_tpu.eval.synth import translation_triplet
from fmvfi_tpu.models import phase_net as jx_phase
from fmvfi_tpu.pipeline import interpolate as jx_pipe
from fmvfi_tpu_torch.eval.synth import translation_triplet as pt_translation_triplet
from fmvfi_tpu_torch.models.adacof import AdaCoFNet
from fmvfi_tpu_torch.models.fusion_net import FusionNet, infer_variant
from fmvfi_tpu_torch.models.phase_net import PhaseNetCore
from fmvfi_tpu_torch.pipeline import interpolate as pt_pipe
from fmvfi_tpu_torch.utils import convert

PIPE_DB = 60.0
MAPS_TOL = 1e-3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ADACOF_CKPT = os.path.join(ROOT, "checkpoints", "adacof_synth_demo.msgpack")
FUSION_CKPT = os.path.join(ROOT, "checkpoints", "fusion_synth_demo.msgpack")


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else -10.0 * np.log10(mse)


def _restore(path):
    with open(path, "rb") as f:
        return serialization.msgpack_restore(f.read())


@pytest.fixture(scope="module")
def weights():
    """(JAX FusionWeights, port FusionModels) holding the same weights."""
    low = jnp.zeros((1, 4, 4, 2))
    lev = [jnp.zeros((1, 4, 4, 8))] * 7
    phase_tree = jax.jit(lambda k: jx_phase.PhaseNetCore(num_img=2).init(k, low, lev, lev))(
        jax.random.key(0)
    )
    ada_tree, fusion_tree = _restore(ADACOF_CKPT), _restore(FUSION_CKPT)
    jx = jx_pipe.FusionWeights(phase_net=phase_tree, adacof=ada_tree, fusion_net=fusion_tree)

    phase = PhaseNetCore().eval()
    phase.load_state_dict(convert.phase_net_from_flax(jax.tree.map(np.asarray, phase_tree)))
    ada = AdaCoFNet(max_offset=None).eval()
    ada.load_state_dict(convert.load_adacof_weights(ADACOF_CKPT))
    fusion_sd = convert.load_fusion_weights(FUSION_CKPT)
    fusion = FusionNet(uncertainty_maps=3, variant=infer_variant(fusion_sd)).eval()
    fusion.load_state_dict(fusion_sd)
    return jx, pt_pipe.FusionModels(phase_net=phase, adacof=ada, fusion_net=fusion)


@pytest.mark.parametrize("h,w,seed", [(64, 64, 0), (60, 44, 1)])
def test_fusion_interpolate_matches_jax(weights, h, w, seed):
    jx, pt = weights
    f1, mid, f2 = translation_triplet(h, w, dx=2.0, dy=1.0, seed=seed)
    ref, ref_parts = jax.jit(
        lambda a, b: jx_pipe.fusion_interpolate(jx, a, b, variant=2, return_parts=True)
    )(jnp.asarray(f1[None]), jnp.asarray(f2[None]))
    ours, parts = pt_pipe.fusion_interpolate(pt, f1[None], f2[None], return_parts=True,
                                             device="cpu")
    assert ours.shape == (1, h, w, 3) and ours.device.type == "cpu"
    assert _psnr(ours.numpy(), ref) >= PIPE_DB
    for name in ("phase", "adacof", "baseline"):
        assert _psnr(parts[name].numpy(), ref_parts[name]) >= PIPE_DB, name
    np.testing.assert_allclose(parts["maps"].numpy(), ref_parts["maps"], rtol=0, atol=MAPS_TOL)


def test_phase_and_adacof_interpolate_match_jax(weights):
    jx, pt = weights
    f1, _, f2 = translation_triplet(48, 80, dx=3.0, dy=1.0, seed=2)
    a, b = jnp.asarray(f1[None]), jnp.asarray(f2[None])
    ref_phase = jax.jit(lambda a, b: jx_pipe.phase_interpolate(jx.phase_net, a, b))(a, b)
    ours_phase = pt_pipe.phase_interpolate(pt.phase_net, f1[None], f2[None], device="cpu")
    assert _psnr(ours_phase.numpy(), ref_phase) >= PIPE_DB
    ref_ada = jax.jit(lambda a, b: jx_pipe.adacof_interpolate(jx.adacof, a, b))(a, b)
    ours_ada = pt_pipe.adacof_interpolate(pt.adacof, f1[None], f2[None], device="cpu")
    assert _psnr(ours_ada.numpy(), ref_ada) >= PIPE_DB


def test_fusion_uncertainty_matches_jax():
    rng = np.random.default_rng(15)
    ada, ph = (rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32) for _ in range(2))
    fj = jx_pipe.make_filters(64, 64, jx_pipe.max_pyr_height(64, 64))
    ref_ada, ref_ph = jax.jit(jx_pipe.fusion_uncertainty)(jnp.asarray(ada), jnp.asarray(ph), fj)
    ft = pt_pipe.make_filters(64, 64, pt_pipe.max_pyr_height(64, 64))
    to = lambda a: torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))
    ours_ada, ours_ph = pt_pipe.fusion_uncertainty(to(ada), to(ph), ft)
    np.testing.assert_allclose(ours_ph.numpy(), ref_ph, rtol=0, atol=2e-5)
    np.testing.assert_allclose(ours_ada.numpy(), ref_ada, rtol=0, atol=MAPS_TOL)


def test_entry_points_check_device_and_options(weights):
    _, pt = weights
    f = np.zeros((1, 16, 16, 3), np.float32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pt_pipe.adacof_interpolate(pt.adacof, f, f)  # device defaults to cuda
    with pytest.raises(ValueError, match="weights are on cpu"):
        pt_pipe.adacof_interpolate(pt.adacof, f, f, device="meta")
    with pytest.raises(NotImplementedError):
        pt_pipe.fusion_interpolate(pt, f, f, compute_dtype=torch.bfloat16, device="cpu")
    with pytest.raises(NotImplementedError):
        pt_pipe.fusion_interpolate(pt, f, f, spatial_mesh=object(), device="cpu")


def test_synth_copy_equals_jax_package():
    for a, b in zip(translation_triplet(20, 24, 3.0, 1.5, 5),
                    pt_translation_triplet(20, 24, 3.0, 1.5, 5)):
        np.testing.assert_array_equal(a, b)


def test_fusion_interpolate_without_maps_matches_jax(weights):
    """The no-maps ablation (variant 0, 0 uncertainty maps): sections 3 and
    AdaCoF's flow-stats tail are skipped on both sides."""
    jx, pt = weights
    z = jnp.zeros((1, 16, 16, 3))
    net = jx_pipe.FusionNet(uncertainty_maps=0)
    tree = jax.jit(lambda k: net.init(k, z, z, z, jnp.zeros((1, 16, 16, 6)), None, 0))(
        jax.random.key(2)
    )
    fusion = FusionNet(uncertainty_maps=0, variant=0).eval()
    fusion.load_state_dict(convert.fusion_net_from_flax(jax.tree.map(np.asarray, tree)))
    f1, _, f2 = translation_triplet(40, 56, dx=1.5, dy=-1.0, seed=3)
    ref = jax.jit(lambda a, b: jx_pipe.fusion_interpolate(
        jx._replace(fusion_net=tree), a, b, variant=0, uncertainty_maps=0))(
        jnp.asarray(f1[None]), jnp.asarray(f2[None]))
    ours, parts = pt_pipe.fusion_interpolate(pt._replace(fusion_net=fusion), f1[None], f2[None],
                                             return_parts=True, device="cpu")
    assert "maps" not in parts
    assert _psnr(ours.numpy(), ref) >= PIPE_DB


def test_fusion_at_pyramid_height_10_matches_jax(weights, monkeypatch):
    """128x128: pyramid height 10, so the uncertainty section's coarse
    decomposition starts at level 2 (the 64x64 cases above start at 0).
    The fused frame is held at >= 60 dB.  The adacof artifact map is held
    in its two parts, since its 50x50 histogram median turns float noise at
    a bin edge into a whole bin: the pre-median `adacof_freq_diff` against
    the map JAX's `_fusion_uncertainty_impl` hands its median (to 1e-5), and
    the two medians on one shared input (to 1e-6)."""
    jx, pt = weights
    h = w = 128
    f1, _, f2 = translation_triplet(h, w, dx=2.0, dy=1.0, seed=4)
    ref, ref_parts = jax.jit(
        lambda a, b: jx_pipe.fusion_interpolate(jx, a, b, variant=2, return_parts=True)
    )(jnp.asarray(f1[None]), jnp.asarray(f2[None]))
    ours = pt_pipe.fusion_interpolate(pt, f1[None], f2[None], device="cpu")
    assert _psnr(ours.numpy(), ref) >= PIPE_DB

    fj = jx_pipe.make_filters(h, w, jx_pipe.max_pyr_height(h, w))
    ft = pt_pipe.make_filters(h, w, pt_pipe.max_pyr_height(h, w))
    assert ft.height == 10 and ft.height - 2 - 6 == 2
    ada, ph = np.asarray(ref_parts["adacof"]), np.asarray(ref_parts["phase"])
    seen = []  # the traced input of JAX's median, returned from the jit
    jx_median = jx_pipe.median_filter_fast
    monkeypatch.setattr(jx_pipe, "median_filter_fast",
                        lambda x, size: seen.append(x) or jx_median(x, size=size))
    ref_diff = np.asarray(jax.jit(
        lambda a, p: (jx_pipe._fusion_uncertainty_impl(fj, a, p), seen[-1])[1]
    )(jnp.asarray(ada), jnp.asarray(ph)))
    assert len(seen) == 1
    to = lambda a: torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))
    ours_diff = pt_pipe.adacof_freq_diff(to(ada), to(ph), ft)
    np.testing.assert_allclose(ours_diff.numpy(), ref_diff, rtol=0, atol=1e-5)

    ref_med = np.asarray(jx_median(jnp.asarray(ref_diff), size=50))
    ours_med = pt_pipe.median_filter_fast(torch.from_numpy(ref_diff), size=50)
    np.testing.assert_allclose(ours_med.numpy(), ref_med, rtol=0, atol=1e-6)
