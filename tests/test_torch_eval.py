"""fmvfi_tpu_torch's evaluation harness against the JAX package on the CPU:
the metrics on seeded random images (1e-5 relative, 1e-6 absolute), the
synthetic sets bit-equal, `evaluate_frames` over arrays, iterators and uint8
frames, `evaluate_suite`'s per-set mean PSNR within 0.05 dB of JAX's for
the four methods with the same weights (the bundled AdaCoF and FusionNet
variant 2, a fixed-key flax PhaseNet carried across; the port at
max_offset=None, as JAX warps unclamped on the CPU), its cache, and the
uncertainty maps (1e-3; the artifact map in its two parts, see
test_generate_uncertainty_maps_matches_jax) and frames (>= 60 dB).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from fmvfi_tpu.eval import evaluate as jx_eval
from fmvfi_tpu.eval import metrics as jx_metrics
from fmvfi_tpu.eval import synth as jx_synth
from fmvfi_tpu.eval import uncertainty as jx_unc
from fmvfi_tpu.models import phase_net as jx_phase
from fmvfi_tpu.pipeline import interpolate as jx_pipe
from fmvfi_tpu_torch.eval import evaluate as pt_eval
from fmvfi_tpu_torch.eval import metrics as pt_metrics
from fmvfi_tpu_torch.eval import synth as pt_synth
from fmvfi_tpu_torch.eval import uncertainty as pt_unc
from fmvfi_tpu_torch.models.adacof import AdaCoFNet
from fmvfi_tpu_torch.models.fusion_net import FusionNet, infer_variant
from fmvfi_tpu_torch.models.phase_net import PhaseNetCore
from fmvfi_tpu_torch.pipeline import interpolate as pt_pipe
from fmvfi_tpu_torch.pipeline.interpolate import FusionModels
from fmvfi_tpu_torch.utils import convert

PIPE_DB = 60.0
MAPS_TOL = 1e-3
SUITE_DB = 0.05
METHODS = ("fusion", "adacof", "phase", "baseline")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ADACOF_CKPT = os.path.join(ROOT, "checkpoints", "adacof_synth_demo.msgpack")
FUSION_CKPT = os.path.join(ROOT, "checkpoints", "fusion_synth_demo.msgpack")
CPU = dict(device="cpu")


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
def weights():
    """(JAX FusionWeights, port FusionModels) holding the same weights."""
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
    return jx, FusionModels(phase_net=phase, adacof=ada, fusion_net=fusion)


def _image_pairs():
    rng = np.random.default_rng(7)
    a = rng.uniform(0, 1, (3, 24, 20, 3)).astype(np.float32)
    b = rng.uniform(0, 1, (3, 24, 20, 3)).astype(np.float32)
    close = np.clip(a + rng.normal(0, 0.01, a.shape), 0, 1).astype(np.float32)
    return [(a, b), (a, close)]


@pytest.mark.parametrize("name", pt_eval.METRIC_NAMES)
def test_metric_matches_jax(name):
    """Each metric over a batch against the JAX metric vmapped over it, on
    unrelated and on close image pairs."""
    for a, b in _image_pairs():
        ref = jax.vmap(jx_metrics.all_metrics)(jnp.asarray(a), jnp.asarray(b))[name]
        got = pt_metrics.all_metrics(torch.from_numpy(a), torch.from_numpy(b))[name]
        assert got.shape == (3,)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
        one = pt_metrics.all_metrics(torch.from_numpy(a[0]), torch.from_numpy(b[0]))[name]
        assert one.shape == () and abs(float(one) - float(got[0])) <= 1e-6 + 1e-5 * abs(float(one))


def test_all_metrics_takes_an_lpips_fn():
    a, b = _image_pairs()[0]
    seen = []

    def fake_lpips(p, t):
        seen.append(p.shape)
        return torch.mean(torch.abs(p - t))

    m = pt_metrics.all_metrics(torch.from_numpy(a), torch.from_numpy(b), fake_lpips)
    assert seen == [(24, 20, 3)] * 3
    np.testing.assert_allclose(m["lpips_vgg"].numpy(), np.abs(a - b).mean(axis=(1, 2, 3)),
                               rtol=1e-6)


@pytest.mark.parametrize("name", list(jx_synth.benchmark_sets(16, 3)))
def test_benchmark_set_equals_jax(name):
    np.testing.assert_array_equal(pt_synth.benchmark_sets(64, 3)[name],
                                  jx_synth.benchmark_sets(64, 3)[name])


def test_translation_video_and_synthetic_sets_equal_jax():
    np.testing.assert_array_equal(pt_synth.translation_video(3, 40, 56, step=2.5, seed=3),
                                  jx_synth.translation_video(3, 40, 56, step=2.5, seed=3))
    ours = pt_eval.synthetic_sets(32, 3, seeds=(0, 1))
    ref = jx_eval.synthetic_sets(32, 3, seeds=(0, 1))
    assert list(ours) == list(ref) and len(ours) == 16
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])
    with pytest.raises(NotImplementedError):
        pt_eval.synthetic_sets(32, 3, include_photo=True)


def test_evaluate_frames_array_iterator_and_uint8_agree(weights):
    _, pt = weights
    frames = pt_synth.translation_video(5, 64, 64, step=2.0)
    a = pt_eval.evaluate_frames(frames, pt, "adacof", dim=64, **CPU)
    b = pt_eval.evaluate_frames(iter(list(frames)), pt, "adacof", dim=64, **CPU)
    assert set(a) == set(pt_eval.METRIC_NAMES) and a["psnr"].shape == (3,)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    u8 = np.clip(frames * 255.0 + 0.5, 0, 255).astype(np.uint8)
    c = pt_eval.evaluate_frames(u8, pt, "adacof", dim=64, **CPU)
    d = pt_eval.evaluate_frames(u8.astype(np.float32) / 255.0, pt, "adacof", dim=64, **CPU)
    for k in c:
        np.testing.assert_allclose(c[k], d[k], rtol=1e-6, atol=1e-6)


def test_evaluate_frames_max_num_and_batch_size(weights):
    _, pt = weights
    frames = pt_synth.translation_video(8, 48, 48, step=2.0)
    consumed = []

    def gen():
        for f in frames:
            consumed.append(1)
            yield f

    out = pt_eval.evaluate_frames(gen(), pt, "adacof", dim=48, max_num=2, **CPU)
    assert out["psnr"].shape == (2,) and len(consumed) == 4  # 2 triplets need 4 frames
    one = pt_eval.evaluate_frames(frames, pt, "adacof", dim=48, batch_size=1, return_preds=True,
                                  **CPU)
    two = pt_eval.evaluate_frames(frames, pt, "adacof", dim=48, batch_size=2, return_preds=True,
                                  **CPU)
    assert one["preds"].shape == (6, 48, 48, 3) and one["preds"].dtype == np.uint8
    for k in pt_eval.METRIC_NAMES:
        np.testing.assert_allclose(one[k], two[k], rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def suites(weights, tmp_path_factory):
    """The JAX and the port suites over synthetic_sets(64, 3), the four
    methods, with the port's output directory."""
    jx, pt = weights
    sets = pt_eval.synthetic_sets(64, 3)
    ref = jx_eval.evaluate_suite(jx, str(tmp_path_factory.mktemp("jax_suite")), sets=sets,
                                 methods=METHODS, dim=64, visualize=False, variant=2)
    out = str(tmp_path_factory.mktemp("torch_suite"))
    ours = pt_eval.evaluate_suite(pt, out, sets=sets, methods=METHODS, dim=64, **CPU)
    return ref, ours, out, sets


@pytest.mark.parametrize("method", METHODS)
def test_evaluate_suite_matches_jax(suites, method):
    ref, ours, _, sets = suites
    assert list(ours) == list(sets) and len(ours) == 8
    for name in sets:
        got, want = ours[name][method], ref[name][method]
        assert set(got) == set(want)
        assert np.isfinite(list(got.values())).all()
        assert abs(got["psnr"] - want["psnr"]) <= SUITE_DB, (name, got["psnr"], want["psnr"])


def test_evaluate_suite_cache_and_digest(suites, weights, monkeypatch):
    """A rerun reads every result from the cache (summary.json is rewritten
    with the same numbers), and other weights key other cache files."""
    _, ours, out, sets = suites
    _, pt = weights
    with open(os.path.join(out, "summary.json")) as f:
        assert json.load(f) == ours
    n_files = len([n for n in os.listdir(out) if n.endswith(".npz")])
    assert n_files == len(sets) * len(METHODS)

    def no_eval(*a, **k):
        raise AssertionError("evaluate_frames ran: the cache was not used")

    monkeypatch.setattr(pt_eval, "evaluate_frames", no_eval)
    assert pt_eval.evaluate_suite(pt, out, sets=sets, methods=METHODS, dim=64, **CPU) == ours

    other = AdaCoFNet(max_offset=None).eval()
    other.load_state_dict(pt.adacof.state_dict())
    with torch.no_grad():
        other.get_kernel.conv1.conv0.bias[0] += 1e-3
    moved = pt._replace(adacof=other)
    for m in ("adacof", "baseline", "fusion"):
        assert (pt_eval._method_cache_key(moved, m, 64, 10)
                != pt_eval._method_cache_key(pt, m, 64, 10)), m
    assert pt_eval._method_cache_key(moved, "phase", 64, 10) == \
        pt_eval._method_cache_key(pt, "phase", 64, 10)
    assert pt_eval._method_cache_key(pt, "fusion", 64, 10, "n3") != \
        pt_eval._method_cache_key(pt, "fusion", 64, 10)


def test_evaluate_triplets_matches_jax(weights):
    jx, pt = weights
    f1, gt, f2 = pt_synth.translation_triplet(48, 64, dx=2.0, dy=1.0, seed=1)
    g1, ggt, g2 = pt_synth.translation_triplet(40, 40, dx=1.0, dy=0.5, seed=2)
    tri = {"a": (f1, gt, f2), "b": (g1, ggt, g2), "c": (f1, None, f2)}
    ref = jx_eval.evaluate_triplets(tri, jx, "adacof")
    ours = pt_eval.evaluate_triplets(tri, pt, "adacof", **CPU)
    assert set(ours) == set(ref) == {"a", "b", "average"}
    for k in ours:
        assert abs(ours[k]["psnr"] - ref[k]["psnr"]) <= SUITE_DB, k
        np.testing.assert_allclose(ours[k]["ssim"], ref[k]["ssim"], rtol=1e-4)


def test_generate_uncertainty_maps_matches_jax(weights, monkeypatch):
    """Against JAX's generate_uncertainty_maps with its pipeline jitted for
    the bundled variant-2 head.  The frames are held at >= 60 dB, the phase
    and flow-variance maps at 1e-3.  The adacof artifact map is held in its
    two parts, as tests/test_torch_pipeline.py holds it at pyramid height
    10: on this scene its 50x50 histogram median turns float noise into up
    to 8.3e-3 at 94 of 4096 px against jitted JAX (1.04e-3 at 2 px against
    JAX run op by op; ROADMAP Queue 3, Q3-3), so the pre-median map is held
    against JAX's to 1e-5 and the two medians on one input to 1e-6."""
    jx, pt = weights
    jitted = jax.jit(lambda w, a, b: jx_pipe.fusion_interpolate(w, a, b, return_parts=True,
                                                                 variant=2))
    monkeypatch.setattr(jx_unc, "fusion_interpolate", lambda w, a, b, return_parts: jitted(w, a, b))
    f1, _, f2 = pt_synth.translation_triplet(64, 64, dx=2.0, dy=1.0, seed=5)
    ref = jx_unc.generate_uncertainty_maps(jx, f1, f2)
    ours = pt_unc.generate_uncertainty_maps(pt, f1, f2, **CPU)
    assert set(ours) == set(ref)
    for k in ("ada_uncertainty", "phase_uncertainty", "flow_variance"):
        assert ours[k].shape == (64, 64)
    for k in ("phase_uncertainty", "flow_variance"):
        np.testing.assert_allclose(ours[k], ref[k], rtol=0, atol=MAPS_TOL, err_msg=k)
    for k in ("phase_pred", "adacof_pred", "baseline", "fused"):
        assert ours[k].shape == (64, 64, 3)
        assert _psnr(ours[k], ref[k]) >= PIPE_DB, k

    fj = jx_pipe.make_filters(64, 64, jx_pipe.max_pyr_height(64, 64))
    ada, ph = (ref[k][None] for k in ("adacof_pred", "phase_pred"))
    seen = []  # the traced input of JAX's median, returned from the jit
    jx_median = jx_pipe.median_filter_fast
    monkeypatch.setattr(jx_pipe, "median_filter_fast",
                        lambda x, size: seen.append(x) or jx_median(x, size=size))
    ref_diff = np.asarray(jax.jit(
        lambda a, p: (jx_pipe._fusion_uncertainty_impl(fj, a, p), seen[-1])[1]
    )(jnp.asarray(ada), jnp.asarray(ph)))
    to = lambda a: torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))
    ft = pt_pipe.make_filters(64, 64, pt_pipe.max_pyr_height(64, 64))
    ours_diff = pt_pipe.adacof_freq_diff(to(ada), to(ph), ft)
    np.testing.assert_allclose(ours_diff.numpy(), ref_diff, rtol=0, atol=1e-5)
    ref_med = np.asarray(jx_median(jnp.asarray(ref_diff), size=50))
    ours_med = pt_pipe.median_filter_fast(torch.from_numpy(ref_diff.copy()), size=50)
    np.testing.assert_allclose(ours_med.numpy(), ref_med, rtol=0, atol=1e-6)


def test_file_and_plot_options_raise(weights, tmp_path):
    """The options that write PNGs or plots need cv2 or matplotlib, which the
    card's machine lacks."""
    _, pt = weights
    f = np.zeros((16, 16, 3), np.float32)
    with pytest.raises(NotImplementedError):
        pt_eval.evaluate_suite(pt, str(tmp_path), sets={}, visualize=True, **CPU)
    with pytest.raises(NotImplementedError):
        pt_eval.evaluate_triplets({"a": (f, f, f)}, pt, output_dir=str(tmp_path), **CPU)
    with pytest.raises(NotImplementedError):
        pt_unc.generate_uncertainty_maps(pt, f, f, out_dir=str(tmp_path), **CPU)
