"""The natural-photo sources and the photo sets of the port against matplotlib
and the JAX package on the CPU:

- the four sample files in fmvfi_tpu_torch/data/sample_data/ byte-equal to
  matplotlib's;
- eval/shade.py: the gist_earth LUT equal to matplotlib's colormap, and the
  shaded relief of both elevation maps bit-equal to LightSource.shade;
- photo_sources(), photo_video (64x80, 4 frames), natural_video in each
  regime, synthetic_sets(include_photo=True)["photo"] and
  MixedSynthStream(photo_frac 1.0 and 0.5) bit-equal to JAX's (the float
  frames are computed by the same float64 numpy operations on bit-equal
  inputs: the JPEG decode and the Lanczos resize are exact), and the
  statistics chip_smoke.py holds the card's host to within 1e-6 of JAX's
  sources;
- evaluate_suite on the photo set alone (dim 64, max_num 1, adacof and
  fusion) within 0.05 dB of JAX's per method, as tests/test_torch_eval.py
  holds the other sets.
"""

import hashlib
import os

import matplotlib
import numpy as np
import pytest
from matplotlib import cm
from matplotlib.colors import LightSource

import chip_smoke
from fmvfi_tpu.eval import evaluate as jx_eval
from fmvfi_tpu.eval import synth as jx_synth
from fmvfi_tpu.train import data as jx_data
from fmvfi_tpu_torch.eval import evaluate as pt_eval
from fmvfi_tpu_torch.eval import shade
from fmvfi_tpu_torch.eval import synth as pt_synth
from fmvfi_tpu_torch.train import data as pt_data
from test_torch_eval import one_torch_thread, weights  # noqa: F401 (fixtures)

MPL_DATA = os.path.join(os.path.dirname(matplotlib.__file__), "mpl-data", "sample_data")
SAMPLE_FILES = ("grace_hopper.jpg", "jacksboro_fault_dem.npz", "topobathy.npz", "s1045.ima.gz")
STATS_TOL = 1e-6
SUITE_DB = 0.05
REGIMES = {
    "translation": dict(dx=2.5, dy=-1.5),
    "rotation": dict(deg_per_frame=1.5),
    "zoom": dict(scale_per_frame=1.02),
    "occlusion": dict(fg_step=-3.0, dx=1.0),
    "gain": dict(dx=1.0, dy=0.5, gain_per_frame=0.9),
}


def _sha256(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.mark.parametrize("name", SAMPLE_FILES)
def test_sample_data_is_matplotlibs(name):
    ours = os.path.join(pt_synth.SAMPLE_DATA, name)
    assert _sha256(ours) == _sha256(os.path.join(MPL_DATA, name))
    with open(os.path.join(pt_synth.SAMPLE_DATA, "README")) as f:
        assert _sha256(ours) in f.read()


def test_gist_earth_lut_is_matplotlibs():
    want = matplotlib.colormaps["gist_earth"](np.arange(256))
    assert np.all(want[:, 3] == 1.0)
    np.testing.assert_array_equal(shade.GIST_EARTH, want[:, :3])


@pytest.mark.parametrize("name,key", [("jacksboro_fault_dem.npz", "elevation"),
                                      ("topobathy.npz", "topo")])
def test_shade_matches_matplotlib(name, key):
    with np.load(os.path.join(pt_synth.SAMPLE_DATA, name)) as dem:
        z = dem[key]
    want = LightSource(azdeg=315, altdeg=45).shade(
        np.asarray(z, np.float64), cmap=cm.gist_earth, vert_exag=0.1, blend_mode="soft")
    got = shade.shade(z)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(want[..., :3], np.float32))


def test_photo_sources_match_jax_and_the_smokes_statistics():
    ours, ref = pt_synth.photo_sources(), jx_synth.photo_sources()
    assert len(ours) == len(ref) == len(chip_smoke.PHOTO_SOURCE_STATS) == 7
    assert pt_synth.photo_sources() is ours  # cached
    for o, r, (shape, total, pixels) in zip(ours, ref, chip_smoke.PHOTO_SOURCE_STATS):
        assert o.dtype == r.dtype == np.float32 and o.shape == r.shape == shape
        np.testing.assert_array_equal(o, r)
        h, w = shape[:2]
        assert abs(float(np.sum(r, dtype=np.float64)) / total - 1.0) <= STATS_TOL
        got = np.stack([r[0, 0], r[h // 2, w // 2], r[h - 1, w - 1]]).astype(np.float64)
        np.testing.assert_allclose(got, pixels, rtol=0, atol=STATS_TOL)


def test_a_missing_sample_file_raises(tmp_path, monkeypatch):
    """JAX skips an unreadable source; the port's files are in the
    repository, so one missing raises rather than shrinking the pool."""
    for name in SAMPLE_FILES[:-1]:
        os.symlink(os.path.join(pt_synth.SAMPLE_DATA, name), tmp_path / name)
    monkeypatch.setattr(pt_synth, "SAMPLE_DATA", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="s1045"):
        pt_synth._load_photo_sources()


def test_photo_video_matches_jax():
    np.testing.assert_array_equal(pt_synth.photo_video(4, 64, 80),
                                  jx_synth.photo_video(4, 64, 80))
    np.testing.assert_array_equal(pt_synth.photo_video(3, 40, 32, step=-2.0, seed=4),
                                  jx_synth.photo_video(3, 40, 32, step=-2.0, seed=4))


@pytest.mark.parametrize("regime", list(REGIMES))
def test_natural_video_matches_jax(regime):
    for seed in (0, 5):
        ours = pt_synth.natural_video(4, 64, 80, seed=seed, **REGIMES[regime])
        ref = jx_synth.natural_video(4, 64, 80, seed=seed, **REGIMES[regime])
        assert ours.dtype == np.float32 and ours.shape == (4, 64, 80, 3)
        np.testing.assert_array_equal(ours, ref)


def test_synthetic_sets_photo_matches_jax():
    ours = pt_eval.synthetic_sets(64, 4, include_photo=True, seeds=(0, 1))
    ref = jx_eval.synthetic_sets(64, 4, include_photo=True, seeds=(0, 1))
    assert list(ours) == list(ref) and "photo@s1" in ours
    for k in ("photo@s0", "photo@s1"):
        np.testing.assert_array_equal(ours[k], ref[k])
    np.testing.assert_array_equal(pt_eval.synthetic_sets(64, 4, include_photo=True)["photo"],
                                  ref["photo@s0"])


@pytest.mark.parametrize("photo_frac", [1.0, 0.5])
def test_mixed_synth_stream_photo_matches_jax(photo_frac):
    ours = pt_data.MixedSynthStream(n=6, h=64, w=80, workers=2, photo_frac=photo_frac)
    ref = jx_data.MixedSynthStream(n=6, h=64, w=80, workers=2, photo_frac=photo_frac)
    for i in range(6):
        assert ours.load_u8(i).dtype == np.uint8 and ours.load_u8(i).shape == (3, 64, 80, 3)
        np.testing.assert_array_equal(ours.load_u8(i), ref.load_u8(i))


def test_evaluate_suite_on_the_photo_set_matches_jax(weights, tmp_path):  # noqa: F811
    jx, pt = weights
    sets = {"photo": pt_eval.synthetic_sets(64, 3, include_photo=True)["photo"]}
    methods = ("adacof", "fusion")
    ref = jx_eval.evaluate_suite(jx, str(tmp_path / "jax"), sets=sets, methods=methods, dim=64,
                                 max_num=1, visualize=False, variant=2)
    ours = pt_eval.evaluate_suite(pt, str(tmp_path / "torch"), sets=sets, methods=methods,
                                  dim=64, max_num=1, device="cpu")
    for m in methods:
        got, want = ours["photo"][m], ref["photo"][m]
        assert set(got) == set(want) and np.isfinite(list(got.values())).all()
        assert abs(got["psnr"] - want["psnr"]) <= SUITE_DB, (m, got["psnr"], want["psnr"])
