"""fmvfi_tpu_torch ops against the JAX package on the CPU.

Inputs are numpy arrays from a seed, fed to both.  Tolerances: 2e-5 absolute
for the elementwise and gather ops (float32 with sums in another order),
1e-4 for the pyramid (FFTs of another library), whose bands are compared as
complex amp * e^{i phase}: the raw phase wraps at +-pi where the amplitude
is ~0.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fmvfi_tpu.ops import adacof as jx_adacof
from fmvfi_tpu.ops import color as jx_color
from fmvfi_tpu.ops import decomp as jx_decomp
from fmvfi_tpu.ops import filters as jx_filters
from fmvfi_tpu.ops import pyramid as jx_pyr
from fmvfi_tpu.ops import resize as jx_resize
from fmvfi_tpu.ops.adacof_pallas import adacof_warp_pallas
from fmvfi_tpu_torch.ops import adacof as pt_adacof
from fmvfi_tpu_torch.ops import adacof_cuda
from fmvfi_tpu_torch.ops import color as pt_color
from fmvfi_tpu_torch.ops import decomp as pt_decomp
from fmvfi_tpu_torch.ops import filters as pt_filters
from fmvfi_tpu_torch.ops import pyramid as pt_pyr
from fmvfi_tpu_torch.ops import resize as pt_resize

OPS_TOL = 2e-5
PYR_TOL = 1e-4


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.numpy(), 1, -1)


def _close(ours, ref, tol):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), rtol=0, atol=tol)


# ------------------------------------------------------------------ color


def test_rgb_to_lab_and_back_match_jax():
    rng = np.random.default_rng(0)
    rgb = rng.uniform(0, 1, (2, 12, 10, 3)).astype(np.float32)
    rgb[0, 0, :4] = np.array([0.0, 1e-4, 0.03, 1.0])[:, None]  # both sides of the gamma knee
    lab_ref = np.asarray(jx_color.rgb_to_lab(jnp.asarray(rgb)))
    lab = pt_color.rgb_to_lab(_nchw(rgb))
    _close(_nhwc(lab), lab_ref, OPS_TOL)
    _close(
        _nhwc(pt_color.lab_to_rgb(_nchw(lab_ref))),
        jx_color.lab_to_rgb(jnp.asarray(lab_ref)),
        OPS_TOL,
    )


# ----------------------------------------------------------------- resize


@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("out_hw", [(16, 20), (11, 13), (4, 5)])
def test_resize_bilinear_matches_jax(align, out_hw):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 8, 10, 3)).astype(np.float32)
    ref = jx_resize.resize_bilinear(jnp.asarray(x), out_hw, align_corners=align)
    ours = pt_resize.resize_bilinear(_nchw(x), out_hw, align_corners=align)
    _close(_nhwc(ours), ref, OPS_TOL)


def test_pools_and_upsample_match_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 8, 10, 4)).astype(np.float32)
    xj, xt = jnp.asarray(x), _nchw(x)
    _close(_nhwc(pt_resize.avg_pool2(xt)), jx_resize.avg_pool2(xj), OPS_TOL)
    _close(_nhwc(pt_resize.max_pool2(xt)), jx_resize.max_pool2(xj), OPS_TOL)
    for align in (False, True):
        _close(
            _nhwc(pt_resize.upsample2x(xt, align_corners=align)),
            jx_resize.upsample2x(xj, align_corners=align),
            OPS_TOL,
        )


# ------------------------------------------------------------- plain warp


def _warp_case(seed, h, w, f, d, off, b=1, c=3):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (b, h + (f - 1) * d, w + (f - 1) * d, c)).astype(np.float32)
    wgt = rng.uniform(0, 1, (b, h, w, f * f)).astype(np.float32)
    a = rng.uniform(-off, off, (b, h, w, f * f)).astype(np.float32)
    be = rng.uniform(-off, off, (b, h, w, f * f)).astype(np.float32)
    return x, wgt, a, be


def _fields(*fs):
    return [torch.from_numpy(np.ascontiguousarray(np.moveaxis(f, -1, 1))) for f in fs]


@pytest.mark.parametrize("f,d", [(5, 1), (5, 2), (11, 1), (11, 2)])
@pytest.mark.parametrize("max_offset", [48, None])
def test_plain_warp_matches_jax_warp(f, d, max_offset):
    """Against fmvfi_tpu.ops.adacof.adacof_warp on offsets clipped to
    +-max_offset (unclipped for None), offsets to +-60."""
    x, wgt, a, be = _warp_case(3, 9, 13, f, d, 60.0, b=2)
    ac, bc = (a, be) if max_offset is None else (
        np.clip(a, -max_offset, max_offset), np.clip(be, -max_offset, max_offset))
    ref = jx_adacof.adacof_warp(*map(jnp.asarray, (x, wgt, ac, bc)), d)
    ours = pt_adacof.adacof_warp(_nchw(x), *_fields(wgt, a, be), d, max_offset)
    _close(_nhwc(ours), ref, OPS_TOL)


@pytest.mark.parametrize("f,d", [(5, 1), (5, 2), (11, 1), (11, 2)])
def test_plain_warp_matches_pallas_kernel(f, d):
    """Against the Pallas kernel K1 replaces, in interpret mode (as
    tests/test_adacof_pallas.py runs it), offsets to +-60 clamped at 48."""
    x, wgt, a, be = _warp_case(4, 8, 40, f, d, 60.0)
    ref = adacof_warp_pallas(*map(jnp.asarray, (x, wgt, a, be)), d, 48, interpret=True)
    ours = pt_adacof.adacof_warp(_nchw(x), *_fields(wgt, a, be), d, 48)
    _close(_nhwc(ours), ref, OPS_TOL)


def test_k1_wrapper_takes_the_plain_version_on_cpu():
    x, wgt, a, be = _warp_case(5, 7, 11, 5, 1, 60.0)
    args = (_nchw(x), *_fields(wgt, a, be), 1, 48)
    before = adacof_cuda.launches
    torch.testing.assert_close(adacof_cuda.adacof_warp(*args), pt_adacof.adacof_warp(*args),
                               rtol=0, atol=0)
    assert adacof_cuda.launches == before  # no kernel launched for CPU tensors
    with pytest.raises(ValueError):
        pt_adacof.adacof_warp(args[0][:, :, 1:], *args[1:])  # not padded by (F-1)*d


def test_pad_replicate_and_flow_stats_match_jax():
    x, wgt, a, be = _warp_case(6, 6, 7, 5, 1, 5.0)
    _close(_nhwc(pt_adacof.pad_replicate(_nchw(x), 2)),
           jx_adacof.pad_replicate(jnp.asarray(x), 2), 0)
    mean, var = pt_adacof.flow_stats(*_fields(wgt, a, be))
    mean_ref, var_ref = jx_adacof.flow_stats(*map(jnp.asarray, (wgt, a, be)))
    _close(_nhwc(mean), mean_ref, OPS_TOL)
    _close(_nhwc(var), var_ref, 1e-4 * max(1.0, float(np.abs(var_ref).max())))


# ---------------------------------------------------------------- pyramid


def _bands_close(ours, ref, tol):
    """Decomp bands as complex amp * e^{i phase}, plus high and low."""
    _close(ours.high.numpy(), ref.high, tol)
    _close(ours.low.numpy(), ref.low, tol)
    assert len(ours.phase) == len(ref.phase)
    for pa, aa, pb, ab in zip(ours.phase, ours.amplitude, ref.phase, ref.amplitude):
        za = aa.numpy() * np.exp(1j * pa.numpy())
        zb = np.asarray(ab) * np.exp(1j * np.asarray(pb))
        _close(np.abs(za - zb), np.zeros(za.shape), tol)


@pytest.mark.parametrize("h,w", [(64, 64), (48, 80)])
def test_make_filters_equals_jax(h, w):
    height = jx_pyr.max_pyr_height(h, w)
    assert pt_pyr.max_pyr_height(h, w) == height
    ref = jx_pyr.make_filters(h, w, height)
    ours = pt_pyr.make_filters(h, w, height)
    for name in ("crops", "level_shapes", "low_shape", "in_shape"):
        assert tuple(getattr(ours, name)) == tuple(getattr(ref, name))
    np.testing.assert_array_equal(ours.hi0.numpy(), ref.hi0)
    np.testing.assert_array_equal(ours.lo0.numpy(), ref.lo0)
    for key in ("band_masks", "synth_masks", "lo_masks"):
        for a, b in zip(getattr(ours, key), getattr(ref, key)):
            np.testing.assert_array_equal(a.numpy(), b)
    assert pt_pyr.make_filters(h, w, height) is ours  # cached per shape


@pytest.mark.parametrize("h,w", [(64, 64), (48, 80)])
def test_decompose_reconstruct_match_jax(h, w):
    rng = np.random.default_rng(7)
    img = rng.uniform(0, 1, (3, h, w)).astype(np.float32)
    height = jx_pyr.max_pyr_height(h, w)
    fj, ft = jx_pyr.make_filters(h, w, height), pt_pyr.make_filters(h, w, height)
    ref = jax.jit(jx_pyr.decompose)(jnp.asarray(img), fj)
    ours = pt_pyr.decompose(torch.from_numpy(img), ft)
    _bands_close(ours, ref, PYR_TOL)
    _close(pt_pyr.reconstruct(ours, ft).numpy(), jax.jit(jx_pyr.reconstruct)(ref, fj), PYR_TOL)
    _close(pt_pyr.reconstruct(ours, ft).numpy(), img, PYR_TOL)  # tight frame
    _close(pt_pyr.finest_recon_mask(ft).numpy(), jx_pyr.finest_recon_mask(fj), PYR_TOL)

    start = height - 2 - 3
    ref_c = jax.jit(jx_pyr.decompose_coarse, static_argnums=2)(jnp.asarray(img), fj, start)
    ours_c = pt_pyr.decompose_coarse(torch.from_numpy(img), ft, start)
    _bands_close(ours_c, ref_c, PYR_TOL)
    _close(
        pt_pyr.reconstruct_coarse(ours_c, ft, start).numpy(),
        jax.jit(jx_pyr.reconstruct_coarse, static_argnums=2)(ref_c, fj, start),
        PYR_TOL,
    )
    _close(pt_pyr.coarse_window_mask(ft, start).numpy(),
           jx_pyr.coarse_window_mask(fj, start), 0)


def test_concat_for_net_and_split_match_jax():
    rng = np.random.default_rng(8)
    img = rng.uniform(0, 1, (4, 32, 32)).astype(np.float32)
    height = jx_pyr.max_pyr_height(32, 32)
    ref = jax.jit(jx_pyr.decompose)(jnp.asarray(img), jx_pyr.make_filters(32, 32, height))
    ours = pt_pyr.decompose(torch.from_numpy(img), pt_pyr.make_filters(32, 32, height))
    low_r, ph_r, amp_r = jx_decomp.concat_for_net(jx_decomp.split_frames(ref, 2))
    low, ph, amp = pt_decomp.concat_for_net(pt_decomp.split_frames(ours, 2))
    _close(_nhwc(low), low_r, PYR_TOL)
    for a, b in zip(amp, amp_r):
        _close(_nhwc(a), b, PYR_TOL)
    assert [tuple(p.shape) for p in ph] == [
        (p.shape[0], p.shape[3], p.shape[1], p.shape[2]) for p in ph_r
    ]
    both = pt_decomp.concat_frames(pt_decomp.split_frames(ours, 2))
    for a, b in zip(both.phase, ours.phase):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- filters


@pytest.mark.parametrize("n,before,after", [(7, 3, 2), (5, 0, 4), (4, 9, 6)])
def test_pad_symmetric_matches_numpy(n, before, after):
    x = np.arange(2 * n, dtype=np.float32).reshape(2, n)
    ours = pt_filters.pad_symmetric(torch.from_numpy(x), before, after, -1).numpy()
    np.testing.assert_array_equal(ours, np.pad(x, [(0, 0), (before, after)], mode="symmetric"))


@pytest.mark.parametrize("sigma", [1.5, 5.0])
def test_gaussian_blur_matches_jax(sigma):
    rng = np.random.default_rng(9)
    img = rng.uniform(0, 1, (2, 30, 44)).astype(np.float32)
    _close(pt_filters.gaussian_blur(torch.from_numpy(img), sigma).numpy(),
           jax.jit(jx_filters.gaussian_blur, static_argnums=1)(jnp.asarray(img), sigma), OPS_TOL)


def test_median_filters_match_jax():
    rng = np.random.default_rng(10)
    img = rng.uniform(0, 1, (2, 40, 36)).astype(np.float32)
    img[1] *= 0.1  # a second value range: bins are per image
    _close(pt_filters.median_filter(torch.from_numpy(img), 9, 256).numpy(),
           jax.jit(jx_filters.median_filter, static_argnums=(1, 2))(jnp.asarray(img), 9, 256),
           OPS_TOL)
    _close(pt_filters.median_filter_fast(torch.from_numpy(img), 20).numpy(),
           jax.jit(jx_filters.median_filter_fast, static_argnums=1)(jnp.asarray(img), 20),
           OPS_TOL)


def test_k1_wrapper_refuses_tensors_off_cpu_and_cuda():
    x, wgt, a, be = _warp_case(5, 7, 11, 5, 1, 6.0)
    args = [t.to("meta") for t in (_nchw(x), *_fields(wgt, a, be))]
    with pytest.raises(ValueError, match="CUDA"):
        adacof_cuda.adacof_warp(*args, 1, 48)
