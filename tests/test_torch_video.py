"""fmvfi_tpu_torch's video rate doubling against the JAX package on the CPU,
with the same weights: the bundled AdaCoF and FusionNet (variant 2)
checkpoints and a fixed-key flax PhaseNet carried across.  The JAX AdaCoF on
the CPU warps unclamped, so the port runs with max_offset=None.

Clips are 4-frame 64x64 translations from the port's own `translation_video`
(3 pairs, so `batch=2` pads its tail).  Within the port every mode
(per pair, stream with windows 8 and 2, batch 2 with seq_chunk 0 and 1) is
held to the per-pair frames within 2e-5, in both map modes; against JAX,
each mode's interpolated frames at >= 60 dB PSNR.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from fmvfi_tpu.eval.synth import translation_video as jx_translation_video
from fmvfi_tpu.models import adacof as jx_adacof
from fmvfi_tpu.models import phase_net as jx_phase
from fmvfi_tpu.pipeline import interpolate as jx_pipe
from fmvfi_tpu.pipeline import video as jx_video
from fmvfi_tpu_torch.eval.synth import translation_video
from fmvfi_tpu_torch.models.adacof import AdaCoFNet
from fmvfi_tpu_torch.models.fusion_net import FusionNet, infer_variant
from fmvfi_tpu_torch.models.phase_net import PhaseNetCore
from fmvfi_tpu_torch.pipeline import interpolate as pt_pipe
from fmvfi_tpu_torch.pipeline import video as pt_video
from fmvfi_tpu_torch.utils import convert

PIPE_DB = 60.0
FRAME_TOL = 2e-5  # within the port, mode against per pair (tests/test_pipeline.py:196)
MAPS_TOL = 1e-3  # the histogram median's bin edge (tests/test_torch_pipeline.py)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ADACOF_CKPT = os.path.join(ROOT, "checkpoints", "adacof_synth_demo.msgpack")
FUSION_CKPT = os.path.join(ROOT, "checkpoints", "fusion_synth_demo.msgpack")
CPU = dict(device="cpu")
MODES = {
    "per_pair": {},
    "stream8": dict(stream=True),
    "stream2": dict(stream=True, stream_window=2),
    "batch2": dict(batch=2),
    "batch2_chunk1": dict(batch=2, seq_chunk=1),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """PyTorch's CPU ops in one thread while this module runs: the suite runs
    in several worker processes, and PyTorch's thread pools in several
    processes at once oversubscribe the cores (its waiting threads spin), so
    each process runs many times slower than alone."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else -10.0 * np.log10(mse)


def _restore(path):
    with open(path, "rb") as f:
        return serialization.msgpack_restore(f.read())


@pytest.fixture(scope="module")
def clip():
    return translation_video(4, 64, 64, step=2.0, seed=0)


@pytest.fixture(scope="module")
def weights():
    """(JAX FusionWeights, port FusionModels, {maps: port FusionModels}) with
    the same weights; the 0-map FusionNet is a fixed-key flax init."""
    low = jnp.zeros((1, 4, 4, 2))
    lev = [jnp.zeros((1, 4, 4, 8))] * 7
    phase_tree = jax.jit(lambda k: jx_phase.PhaseNetCore(num_img=2).init(k, low, lev, lev))(
        jax.random.key(0)
    )
    jx = jx_pipe.FusionWeights(
        phase_net=phase_tree, adacof=_restore(ADACOF_CKPT), fusion_net=_restore(FUSION_CKPT)
    )
    phase = PhaseNetCore().eval()
    phase.load_state_dict(convert.phase_net_from_flax(jax.tree.map(np.asarray, phase_tree)))
    ada = AdaCoFNet(max_offset=None).eval()
    ada.load_state_dict(convert.load_adacof_weights(ADACOF_CKPT))
    fusion_sd = convert.load_fusion_weights(FUSION_CKPT)
    fusion = FusionNet(uncertainty_maps=3, variant=infer_variant(fusion_sd)).eval()
    fusion.load_state_dict(fusion_sd)

    z = jnp.zeros((1, 16, 16, 3))
    tree0 = jax.jit(lambda k: jx_pipe.FusionNet(uncertainty_maps=0).init(
        k, z, z, z, jnp.zeros((1, 16, 16, 6)), None, 0))(jax.random.key(2))
    fusion0 = FusionNet(uncertainty_maps=0, variant=0).eval()
    fusion0.load_state_dict(convert.fusion_net_from_flax(jax.tree.map(np.asarray, tree0)))
    pt = pt_pipe.FusionModels(phase_net=phase, adacof=ada, fusion_net=fusion)
    return jx, pt, {3: pt, 0: pt._replace(fusion_net=fusion0)}


@pytest.fixture(scope="module")
def port_runs(weights, clip):
    """{(mode, maps): the port's 2x sequence of the clip}."""
    _, _, by_maps = weights
    return {
        (mode, maps): list(pt_video.double_frame_rate(clip, models, **kw, **CPU))
        for maps, models in by_maps.items()
        for mode, kw in MODES.items()
    }


@pytest.fixture(scope="module")
def jax_per_pair(weights, clip):
    jx = weights[0]
    return list(jx_video.double_frame_rate(clip, jx, "fusion", variant=2))


def test_port_clip_equals_jax_clip(clip):
    np.testing.assert_array_equal(clip, jx_translation_video(4, 64, 64, step=2.0, seed=0))


def test_stream_init_and_steps_match_jax(weights, clip):
    """fusion_stream_init's carry and every fusion_stream_step output (the
    priming step's, the three pairs' and the flush step's) against JAX."""
    jx, pt, _ = weights
    fj = jx_pipe.make_filters(64, 64, jx_pipe.max_pyr_height(64, 64))
    jinit = jax.jit(lambda f: jx_pipe.fusion_stream_init(f, fj, 3))
    jstep = jax.jit(lambda c, f: jx_pipe.fusion_stream_step(jx, c, f, filters=fj, variant=2))
    jc = jinit(jnp.asarray(clip[:1]))
    pc = pt_pipe.fusion_stream_init(clip[:1], **CPU)
    np.testing.assert_allclose(pc.lab.permute(0, 2, 3, 1).numpy(), jc.lab, rtol=0, atol=FRAME_TOL)
    np.testing.assert_allclose(pc.dec.low.numpy(), jc.dec.low, rtol=0, atol=FRAME_TOL)
    np.testing.assert_allclose(pc.dec.high.numpy(), jc.dec.high, rtol=0, atol=FRAME_TOL)
    for k in (1, 2, 3, 3):  # the last step repeats the last frame (the flush)
        jc, jout = jstep(jc, jnp.asarray(clip[k : k + 1]))
        pc, pout = pt_pipe.fusion_stream_step(pt, pc, clip[k : k + 1], **CPU)
        assert pout.shape == (1, 64, 64, 3)
        assert _psnr(pout.numpy(), jout) >= PIPE_DB, k


@pytest.mark.parametrize("maps", [3, 0])
@pytest.mark.parametrize("mode", [m for m in MODES if m != "per_pair"])
def test_modes_match_per_pair(port_runs, clip, mode, maps):
    got, want = port_runs[(mode, maps)], port_runs[("per_pair", maps)]
    assert len(got) == len(want) == 2 * len(clip) - 1
    for i in range(len(clip)):
        np.testing.assert_array_equal(got[2 * i], clip[i])
    for i in range(1, len(got), 2):
        assert got[i].shape == (64, 64, 3) and got[i].dtype == np.float32
        np.testing.assert_allclose(got[i], want[i], rtol=0, atol=FRAME_TOL)


@pytest.mark.parametrize("mode", list(MODES))
def test_modes_match_jax_per_pair(port_runs, jax_per_pair, mode):
    got = port_runs[(mode, 3)]
    assert len(got) == len(jax_per_pair)
    for i in range(1, len(got), 2):
        assert _psnr(got[i], jax_per_pair[i]) >= PIPE_DB, i


def test_seq_chunk_matches_unchunked_with_parts(weights, clip):
    _, pt, _ = weights
    a, b = clip[:2], clip[1:3]
    ref, ref_parts = pt_pipe.fusion_interpolate(pt, a, b, return_parts=True, **CPU)
    got, parts = pt_pipe.fusion_interpolate(pt, a, b, return_parts=True, seq_chunk=1, **CPU)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=FRAME_TOL)
    for name in ("phase", "adacof", "baseline"):
        np.testing.assert_allclose(parts[name].numpy(), ref_parts[name].numpy(), rtol=0,
                                   atol=FRAME_TOL, err_msg=name)
    np.testing.assert_allclose(parts["maps"].numpy(), ref_parts["maps"].numpy(), rtol=0,
                               atol=MAPS_TOL)
    with pytest.raises(ValueError, match="not divisible"):
        pt_pipe.fusion_interpolate(pt, clip[:3], clip[1:], seq_chunk=2, **CPU)


def test_stats_batch_matches_jax(weights, clip):
    """The flow-stats tail for the first entry of a 2-pair batch only."""
    jx, pt, _ = weights
    a, b = clip[:2], clip[1:3]
    net = jx_adacof.AdaCoFNet(stats_batch=1)
    ref = jax.jit(lambda x, y: net.apply(jx.adacof, x, y))(jnp.asarray(a), jnp.asarray(b))
    to = lambda x: torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))
    with torch.no_grad():
        out = pt.adacof(to(a), to(b), stats_batch=1)
    nhwc = lambda t: t.permute(0, 2, 3, 1).numpy()
    assert out.uncertainty.shape[0] == out.mean_flow[0].shape[0] == 1
    pairs = [(out.blended, ref.blended), (out.uncertainty, ref.uncertainty)]
    pairs += list(zip(out.mean_flow + out.var_flow, ref.mean_flow + ref.var_flow))
    for ours, theirs in pairs:
        assert ours.shape[0] == theirs.shape[0]
        np.testing.assert_allclose(nhwc(ours), theirs, rtol=0, atol=1e-4)


def test_baseline_interpolate_and_spectral_baseline_match_jax(weights, clip):
    jx, pt, _ = weights
    a, b = clip[:1], clip[1:2]
    ref = jx_video._interp_fn(jx, 64, 64, "baseline")(jnp.asarray(a), jnp.asarray(b))
    got = pt_pipe.baseline_interpolate(pt, a, b, **CPU)
    assert got.shape == (1, 64, 64, 3)
    assert _psnr(got.numpy(), ref) >= PIPE_DB
    ref_s = jax.jit(jx_pipe.spectral_baseline)(jnp.asarray(clip[2:]), jnp.asarray(clip[:2]))
    got_s = pt_pipe.spectral_baseline(clip[2:], clip[:2], **CPU)
    assert _psnr(got_s.numpy(), ref_s) >= PIPE_DB


@pytest.mark.parametrize("method", ["adacof", "phase", "baseline"])
def test_other_methods_match_jax(weights, clip, method):
    jx, pt, _ = weights
    ref = list(jx_video.double_frame_rate(clip, jx, method))
    got = list(pt_video.double_frame_rate(clip, pt, method, **CPU))
    assert len(got) == len(ref) == 2 * len(clip) - 1
    for i in range(0, len(got), 2):
        np.testing.assert_array_equal(got[i], clip[i // 2])
    for i in range(1, len(got), 2):
        assert _psnr(got[i], ref[i]) >= PIPE_DB, i


def test_multiply_frame_rate(weights, clip):
    _, pt, _ = weights
    frames = clip[:3]
    twice = list(pt_video.double_frame_rate(frames, pt, "adacof", **CPU))
    four = list(pt_video.multiply_frame_rate(frames, pt, "adacof", factor=4, **CPU))
    assert len(four) == 4 * len(frames) - 3
    for i, f in enumerate(twice):
        np.testing.assert_array_equal(four[2 * i], f)
    with pytest.raises(ValueError, match="power of two"):
        list(pt_video.multiply_frame_rate(frames, pt, "adacof", factor=3, **CPU))


@pytest.mark.parametrize("method,stream", [("fusion", True), ("fusion", False), ("adacof", True)])
def test_one_frame_clip_yields_the_frame(weights, method, stream):
    _, pt, _ = weights
    frames = translation_video(1, 64, 64, step=1.0)
    out = list(pt_video.double_frame_rate(frames, pt, method, stream=stream, **CPU))
    assert len(out) == 1
    np.testing.assert_array_equal(out[0], frames[0])


def test_off_grid_stream_matches_per_pair(weights):
    """60x44 frames: the stream pads to the /8 grid and crops back, as the
    per-pair pipeline does."""
    _, pt, _ = weights
    frames = translation_video(3, 60, 44, step=1.5, seed=2)
    stream = list(pt_video.double_frame_rate(frames, pt, stream=True, stream_window=2, **CPU))
    per_pair = list(pt_video.double_frame_rate(frames, pt, **CPU))
    for s, p in zip(stream, per_pair):
        assert s.shape == (60, 44, 3)
        np.testing.assert_allclose(s, p, rtol=0, atol=FRAME_TOL)
