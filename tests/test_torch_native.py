"""fmvfi_tpu_torch.native (the C++ triplet augmentation) and
batch_iterator's native path against the JAX package's on the CPU.

The port's library and JAX's are built from the same source with the same
flags, so their outputs are held bit for bit; the numpy path within 1e-6
(x * (1 / 255) in float32 against x / 255).  A seed gives the port's
native batches that JAX's native batch_iterator gives.  The tests skip,
inside a fixture, where no g++ is on PATH.
"""

import shutil

import numpy as np
import pytest

from fmvfi_tpu import native as jx_native
from fmvfi_tpu.train import data as jx_data
from fmvfi_tpu_torch import _build
from fmvfi_tpu_torch import native as pt_native
from fmvfi_tpu_torch.train import data as pt_data

NUMPY_TOL = 1e-6


@pytest.fixture
def toolchain():
    if shutil.which("g++") is None:
        pytest.skip("no g++ on PATH: the native library cannot be built")
    assert pt_native.available() and jx_native.available()


def test_augment_batch_and_u8_to_f32_match_jax_bit_for_bit(toolchain):
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (5, 3, 20, 23, 3), dtype=np.uint8)
    params = np.array([[0, 0, 0, 0, 0], [4, 7, 1, 0, 0], [1, 2, 0, 1, 1], [4, 0, 1, 1, 1],
                       [2, 7, 0, 0, 1]], np.int32)
    ours = pt_native.augment_batch(frames, 16, params)
    ref = jx_native.augment_batch(frames, 16, params)
    for o, r in zip(ours, ref):
        assert o.dtype == np.float32 and o.shape == (5, 16, 16, 3)
        np.testing.assert_array_equal(o, r)
    # the numpy augmentation of each item with the same draws
    for i, (y, x, hf, vf, ts) in enumerate(params):
        f0, f1, f2 = (frames[i, t, y:y + 16, x:x + 16].astype(np.float32) / 255.0
                      for t in range(3))
        if hf:
            f0, f1, f2 = (f[:, ::-1] for f in (f0, f1, f2))
        if vf:
            f0, f1, f2 = (f[::-1] for f in (f0, f1, f2))
        if ts:
            f0, f2 = f2, f0
        for o, f in zip(ours, (f0, f1, f2)):
            assert float(np.abs(o[i] - f).max()) <= NUMPY_TOL
    x = rng.integers(0, 256, (7, 9, 3), dtype=np.uint8)
    np.testing.assert_array_equal(pt_native.u8_to_f32(x), jx_native.u8_to_f32(x))
    assert float(np.abs(pt_native.u8_to_f32(x) - x.astype(np.float32) / 255.0).max()) <= NUMPY_TOL


def test_augment_batch_rejects_crops_outside_the_frames(toolchain):
    frames = np.zeros((1, 3, 8, 8, 3), np.uint8)
    with pytest.raises(ValueError, match="leave 8x8"):
        pt_native.augment_batch(frames, 4, np.array([[5, 0, 0, 0, 0]]))
    with pytest.raises(ValueError, match=r"\(B, 3, H, W, 3\)"):
        pt_native.augment_batch(frames[:, :2], 4, np.zeros((1, 5)))


def test_native_batches_match_jax_and_the_numpy_path(toolchain):
    """A MixedSynthStream over two epochs (shuffled): the port's native
    batches equal JAX's native ones bit for bit and the numpy path's within
    1e-6, and each batch counts on its path."""
    ours_ds = pt_data.MixedSynthStream(n=5, h=40, w=44, workers=2)
    ref_ds = jx_data.MixedSynthStream(n=5, h=40, w=44, workers=2)
    pt_data.paths.clear()
    native = list(pt_data.batch_iterator(ours_ds, 2, seed=7, crop=32, epochs=2, use_native=True))
    assert pt_data.paths == {"native": 4}
    ref = list(jx_data.batch_iterator(ref_ds, 2, seed=7, crop=32, epochs=2, use_native=True))
    auto = list(pt_data.batch_iterator(ours_ds, 2, seed=7, crop=32, epochs=2))
    plain = list(pt_data.batch_iterator(ours_ds, 2, seed=7, crop=32, epochs=2, use_native=False))
    assert pt_data.paths == {"native": 8, "numpy": 4}
    assert len(native) == len(ref) == len(plain) == 4
    for n, r, a, p in zip(native, ref, auto, plain):
        for bn, br, ba, bp in zip(n, r, a, p):
            assert bn.shape == (2, 32, 32, 3)
            np.testing.assert_array_equal(bn, br)
            np.testing.assert_array_equal(bn, ba)
            assert float(np.abs(bn - bp).max()) <= NUMPY_TOL


def test_unshuffled_batches_match_jax(toolchain):
    ours = pt_data.batch_iterator(pt_data.SyntheticTriplets(n=4, h=36, w=36), 2, seed=1, crop=32,
                                  epochs=1, shuffle=False, prefetch=1)
    ref = jx_data.batch_iterator(jx_data.SyntheticTriplets(n=4, h=36, w=36), 2, seed=1, crop=32,
                                 epochs=1, shuffle=False, prefetch=1, use_native=False)
    for o, r in zip(ours, ref, strict=True):
        for a, b in zip(o, r):
            np.testing.assert_array_equal(a, b)


def test_native_request_raises_when_the_library_does_not_build(monkeypatch):
    """use_native=True raises with the reason; None takes the numpy path."""
    def broken():
        raise RuntimeError("the native augmentation library is unavailable: g++ not found")

    monkeypatch.setattr(pt_native, "library", broken)
    ds = pt_data.MixedSynthStream(n=2, h=36, w=36, workers=1)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        next(pt_data.batch_iterator(ds, 1, crop=32, use_native=True))
    pt_data.paths.clear()
    it = pt_data.batch_iterator(ds, 1, crop=32, epochs=1)
    assert len(list(it)) == 2 and pt_data.paths == {"numpy": 2}


def test_native_library_is_keyed_by_its_source(tmp_path, monkeypatch):
    path = pt_native.library_path()
    assert path.parent == _build.BUILD_DIR and path.name.startswith("libfmvfi_native_")
    src = tmp_path / "augment.cpp"
    src.write_text(pt_native.SOURCE.read_text() + "\n// changed\n")
    monkeypatch.setattr(pt_native, "SOURCE", src)
    assert pt_native.library_path() != path
