"""fmvfi_tpu_torch.parallel.spatial on the CPU: height-sharded serving on a
4-process gloo group (tests/torch_spatial_worker.py, each rank a subprocess
with one torch thread and a timeout of its own) against the port's
single-process functions and the JAX package's on its 8-device CPU mesh
(tests/conftest.py).

Tolerances:
- the halo warp, forward and field gradients: bit-equal to the port's
  single-process clamped warp (the same arithmetic per pixel), within 2e-5
  of JAX's adacof_warp_tm_sharded (tests/test_parallel.py's bound for the
  JAX warp against its own single device is bit-equality; the two
  frameworks' float32 warps differ by summation order);
- each halo-aware layer against the whole-frame layer: bit-equal, but the
  float32 upsamples and the 3x3 convolutions, held at 1e-6 of the largest
  entry: F.interpolate rounds by its input's shape (its vectorised loops;
  it may also fuse multiply-adds, which the align_corners=True band
  version does not), and the band's and the frame's convolutions may take
  different algorithms (1.4e-7 and 0 measured); a band upsampled as an
  image of its own misses by over 1e-2;
- AdaCoFNet under the mesh 2e-5 of JAX's single device model (as
  tests/test_parallel.py), the port's single process 2e-5;
- the pipelines 5e-4 of JAX's single-device pipeline (the bound of
  tests/test_parallel.py's 2-D fusion test) and 1e-4 of the port's
  single-process output.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
from flax import serialization

import torch_spatial_worker as worker
from fmvfi_tpu.models import adacof as jx_adacof
from fmvfi_tpu.ops.adacof import pad_replicate as jx_pad_replicate
from fmvfi_tpu.ops.adacof_pallas import adacof_warp_fast_tm
from fmvfi_tpu.parallel import mesh as jx_mesh
from fmvfi_tpu.parallel import spatial as jx_spatial
from fmvfi_tpu.pipeline import interpolate as jx_pipe
from fmvfi_tpu_torch.models.adacof import AdaCoFNet
from fmvfi_tpu_torch.models.conv import Conv2d
from fmvfi_tpu_torch.ops.adacof import pad_replicate
from fmvfi_tpu_torch.ops.adacof_cuda import adacof_warp
from fmvfi_tpu_torch.parallel import distributed, spatial
from fmvfi_tpu_torch.parallel.mesh import make_mesh
from fmvfi_tpu_torch.pipeline import interpolate as pt_pipe
from fmvfi_tpu_torch.utils import convert

WARP_JAX_TOL = 2e-5
LAYER_TOL = 1e-6  # of the largest entry, where the layer is not bit-equal
NOT_BIT_EQUAL = ("up_false", "up_true", "up_true_s8", "conv3", "tapconv")
ADACOF_TOL = 2e-5
PIPE_JAX_TOL, PIPE_PORT_TOL = 5e-4, 1e-4
WORKER_TIMEOUT = 180  # seconds, per rank
WORLD = 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _restore(path):
    with open(path, "rb") as f:
        return serialization.msgpack_restore(f.read())


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(path of the seeded AdaCoF and PhaseNet state dicts the workers load,
    the port's pipeline models and seeded AdaCoF, the JAX trees)."""
    torch.manual_seed(0)
    seeded = AdaCoFNet()
    from fmvfi_tpu_torch.models.phase_net import PhaseNetCore

    phase = PhaseNetCore().init_params(torch.Generator().manual_seed(0))
    path = tmp_path_factory.mktemp("w") / "weights.pt"
    torch.save({"adacof": seeded.state_dict(), "phase": phase.state_dict()}, path)
    models, seeded = worker.models(path)
    jx = jx_pipe.FusionWeights(
        phase_net=convert.phase_net_to_flax(models.phase_net.state_dict()),
        adacof=_restore(os.path.join(ROOT, "checkpoints", "adacof_synth_demo.msgpack")),
        fusion_net=_restore(os.path.join(ROOT, "checkpoints", "fusion_synth_demo.msgpack")))
    return path, models, seeded, jx, convert.adacof_to_flax(seeded.state_dict())


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(weights, tmp_path_factory):
    """Each rank's blocks (npz) and report (json) from the 4 workers."""
    out = tmp_path_factory.mktemp("spatial")
    coord = f"localhost:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    script = os.path.join(ROOT, "tests", "torch_spatial_worker.py")
    procs = [subprocess.Popen([sys.executable, script, coord, str(r), str(WORLD),
                               str(out / str(r)), str(weights[0])],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and "RESULT" in log, f"rank {r}:\n{log[-3000:]}"
    return ([dict(np.load(out / f"{r}.npz")) for r in range(WORLD)],
            [json.loads((out / f"{r}.json").read_text()) for r in range(WORLD)])


def _assemble(arrays, name, shape, layout="nchw"):
    """The whole tensor from every rank's block of it (a block kept by
    several ranks must be equal on each)."""
    whole = np.full(shape, np.nan, np.float32)
    for a in arrays:
        blk, (b0, r0) = a[name], a[name + "@index"]
        idx = (slice(b0, b0 + blk.shape[0]),)
        rows = slice(r0, r0 + blk.shape[1 if layout == "nhwc" else 2])
        idx += (rows,) if layout == "nhwc" else (slice(None), rows)
        seen = whole[idx]
        assert np.isnan(seen).all() or np.array_equal(seen, blk), name
        whole[idx] = blk
    assert not np.isnan(whole).any(), name
    return whole


def _gap(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


@pytest.mark.parametrize("name,jax_shape,r", [("warp_r12", (4, 2), 12), ("warp_r5", (2, 4), 5)])
def test_halo_warp_matches_single_process_and_jax(ranks, name, jax_shape, r):
    arrays, _ = ranks
    x, wgt, a, b = worker.warp_inputs()
    got = {k: _assemble(arrays, f"{name}{k}", a.shape if k else x.shape)
           for k in ("", "_dw", "_da", "_db")}
    kp = (worker.F_TAPS - 1) // 2
    fields = [torch.from_numpy(t).requires_grad_() for t in (wgt, a, b)]
    ref = adacof_warp(pad_replicate(torch.from_numpy(x), kp), *fields, 1, r)
    (ref**2).sum().backward()
    np.testing.assert_array_equal(got[""], ref.detach().numpy())
    for k, f in zip(("_dw", "_da", "_db"), fields):
        np.testing.assert_array_equal(got[k], f.grad.numpy())

    mesh = jx_mesh.make_mesh(8, ("data", "spatial"), jax_shape)
    tm = lambda t: jnp.asarray(np.moveaxis(t, 1, 0))  # (B, F2, H, W) -> tap-major
    xj = jnp.asarray(np.moveaxis(x, 1, -1))
    warp = lambda *f: jx_spatial.adacof_warp_tm_sharded(xj, *f, 1, mesh, max_offset=r)
    out, grads = jax.jit(lambda *f: (warp(*f), jax.grad(lambda *g: jnp.sum(warp(*g) ** 2),
                                                        argnums=(0, 1, 2))(*f)))(
        tm(wgt), tm(a), tm(b))
    assert _gap(got[""], np.moveaxis(np.asarray(out), -1, 1)) <= WARP_JAX_TOL
    for k, g in zip(("_dw", "_da", "_db"), grads):
        assert _gap(got[k], np.moveaxis(np.asarray(g), 0, 1)) <= WARP_JAX_TOL, k
    # the JAX sharded warp is its single-device warp (tests/test_parallel.py)
    single = adacof_warp_fast_tm(jx_pad_replicate(xj, kp), tm(wgt), tm(a), tm(b), 1, max_offset=r)
    assert _gap(got[""], np.moveaxis(np.asarray(single), -1, 1)) <= WARP_JAX_TOL


@pytest.mark.parametrize("layer", list(worker.layers()) + ["up_true_as_image"])
def test_halo_aware_layers_on_bands_match_the_whole_frame(ranks, layer):
    """Each layer on the unequal bands (24, 16, 16, 8) of a 64-row frame over
    4 processes against the same layer on the whole frame; the band of an
    align_corners=True upsample taken as an image of its own is far off."""
    arrays, _ = ranks
    x = torch.from_numpy(worker.layer_input())
    fns = worker.layers()
    with torch.no_grad():
        whole = fns["up_true" if layer == "up_true_as_image" else layer](x).numpy()
    got = _assemble(arrays, "layer_" + layer, whole.shape)
    gap = _gap(got, whole) / float(np.abs(whole).max())
    print(f"{layer}: {gap:.3g} of the largest entry")
    if layer == "up_true_as_image":
        assert gap > 1e-2
    elif layer in NOT_BIT_EQUAL:
        assert gap <= LAYER_TOL
    else:
        np.testing.assert_array_equal(got, whole)


def test_sharded_max_offset_routes_as_jax():
    """The port's routing of the warp against the JAX model's on every case
    of a table: frame heights, batches, mesh shapes, clamps and kernels."""
    meshes = {s: jx_mesh.make_mesh(8, ("data", "spatial"), s)
              for s in ((4, 2), (2, 4), (1, 8), (8, 1))}
    # (max_offset, F, dilation): clamps under the fit, at it (39 px), and a
    # fit under 24 px (no clamp)
    for r, k, d in ((24, 5, 1), (48, 5, 1), (12, 5, 2), (48, 11, 1), (48, 7, 8), (48, 9, 10)):
        ours = AdaCoFNet(kernel_size=k, dilation=d, max_offset=r)
        for h in (64, 96, 128, 192, 1088):
            for b2 in (2, 4, 8):
                for shape, mesh in meshes.items():
                    want = jx_adacof.AdaCoFNet(kernel_size=k, dilation=d, max_offset=r,
                                               spatial_mesh=mesh)._sharded_max_offset(h, b2)
                    got = ours._sharded_max_offset(h, b2, shape[1], shape[0])
                    assert got == want, (h, b2, shape, r, k, d)
    assert AdaCoFNet(max_offset=24)._sharded_max_offset(64, 8, 2, 4) == 24  # the halo route
    assert AdaCoFNet()._sharded_max_offset(64, 8, 2, 4) == 0  # 48 px: the gathered one


@pytest.mark.parametrize("r,route,clamp", [(24, "adacof_warp_tm_sharded", 24),
                                           (48, "adacof_warp_gathered", None)])
def test_adacof_under_the_mesh_matches_single_device(ranks, weights, r, route, clamp):
    """AdaCoFNet on the (2, 2) mesh's bands of a 64x32 batch of 4: 32-row
    bands host the halo of max_offset 24 (the halo warp, clamped 24) but
    not 48's (the gathered frame's warp, unclamped, as JAX's gather
    warp)."""
    arrays, reports = ranks
    _, _, seeded, _, jx_tree = weights
    f1, f2 = worker.frames(64, 32, 4, seed=5)
    got = _assemble(arrays, f"adacof_r{r}", f1.shape, "nhwc")
    assert all(rep[f"adacof_r{r}_routes"] == {route: [clamp]} for rep in reports)
    ref = jax.jit(lambda v, a, b: jx_adacof.AdaCoFNet(kernel_size=5).apply(v, a, b).blended)(
        jx_tree, jnp.asarray(f1), jnp.asarray(f2))
    assert _gap(got, ref) <= ADACOF_TOL
    seeded.max_offset = clamp
    try:
        with torch.no_grad():
            ours = seeded(torch.from_numpy(f1).permute(0, 3, 1, 2),
                          torch.from_numpy(f2).permute(0, 3, 1, 2)).blended.permute(0, 2, 3, 1)
    finally:
        seeded.max_offset = 48
    assert _gap(got, ours.numpy()) <= ADACOF_TOL
    if r == 24:  # spatial_apply of the same model over the spatial axis alone
        np.testing.assert_array_equal(_assemble(arrays, "spatial_apply", f1[:2].shape, "nhwc"),
                                      arrays[0]["spatial_apply_gathered"])
        assert _gap(arrays[0]["spatial_apply_gathered"], ours[:2].numpy()) <= ADACOF_TOL


@pytest.mark.parametrize("name,h,w,b,seed,clamp", [("fusion64", 64, 64, 4, 7, None),
                                                   ("fusion75", 75, 44, 2, 9, 24)])
def test_fusion_interpolate_spatial_mesh_matches_single_device(ranks, weights, name, h, w, b,
                                                               seed, clamp):
    """fusion_interpolate(spatial_mesh=) on (data 2 x spatial 2): at 64x64
    the bands cannot host the 48 px halo (the gathered, unclamped warp, as
    JAX's on the CPU); at 75x44 with max_offset 24 the bands (32, 48),
    (32, 64) after the /32 pad, take the halo warp, the pads on the last
    band.  Every rank gets the whole result."""
    arrays, reports = ranks
    _, models, _, jx, _ = weights
    f1, f2 = worker.frames(h, w, b, seed)
    outs = [a[name] for a in arrays]
    assert all(np.array_equal(o, outs[0]) for o in outs) and outs[0].shape == f1.shape
    ref, ref_parts = jax.jit(lambda a, c: jx_pipe.fusion_interpolate(
        jx, a, c, variant=2, return_parts=True))(jnp.asarray(f1), jnp.asarray(f2))
    models.adacof.max_offset = clamp
    try:
        ours, parts = pt_pipe.fusion_interpolate(models, f1, f2, return_parts=True, device="cpu")
    finally:
        models.adacof.max_offset = 48
    gaps = (_gap(outs[0], ref), _gap(outs[0], ours.numpy()))
    print(f"{name}: {gaps[0]:.3g} from JAX, {gaps[1]:.3g} from the port's single process")
    assert gaps[0] <= PIPE_JAX_TOL and gaps[1] <= PIPE_PORT_TOL
    if name == "fusion64":
        assert reports[0]["exchanged"]["halo"] > 0 and reports[0]["exchanged"]["gather"] > 0
        for k in ("phase", "adacof", "baseline"):
            got = arrays[0][f"{name}_{k}"]
            assert _gap(got, ref_parts[k]) <= PIPE_JAX_TOL, k
            assert _gap(got, parts[k].numpy()) <= PIPE_PORT_TOL, k
        # the maps' 50x50 histogram median moves by a bin at float noise (Q3-3)
        assert _gap(arrays[0][f"{name}_maps"], parts["maps"].numpy()) <= 1e-3


def test_phase_interpolate_spatial_mesh_matches_single_device(ranks, weights):
    arrays, _ = ranks
    _, models, _, jx, _ = weights
    f1, f2 = worker.frames(64, 64, 4, seed=11)
    ref = jax.jit(lambda a, b: jx_pipe.phase_interpolate(jx.phase_net, a, b))(
        jnp.asarray(f1), jnp.asarray(f2))
    ours = pt_pipe.phase_interpolate(models.phase_net, f1, f2, device="cpu")
    for a in arrays:
        assert _gap(a["phase64"], ref) <= PIPE_JAX_TOL
        assert _gap(a["phase64"], ours.numpy()) <= PIPE_PORT_TOL


@pytest.fixture(scope="module")
def group():
    """A 1-process gloo group for this module's in-process checks."""
    distributed.initialize(backend="gloo")
    yield
    dist.destroy_process_group()


def test_raises(ranks, weights, group):
    """A band shorter than the warp's halo, seq_chunk, a height that cannot
    be split, a mesh without the axes: each raises ValueError."""
    _, reports = ranks
    _, models, _, _, _ = weights
    assert "below the halo of 15 rows" in reports[0]["raised"]["short_band"]
    assert "at least 64" in reports[0]["raised"]["height"]
    x, wgt, a, b = (torch.from_numpy(t) for t in worker.warp_inputs())
    with spatial.running(spatial.Bands(None, 0, (8,) * 4)), pytest.raises(ValueError, match="halo"):
        spatial.adacof_warp_tm_sharded(x[:, :, :8], wgt[:, :, :8], a[:, :, :8], b[:, :, :8], 1,
                                       max_offset=12)
    mesh = make_mesh(1, ("data", "spatial"), (1, 1))
    f = np.zeros((2, 32, 32, 3), np.float32)
    with pytest.raises(ValueError, match="seq_chunk"):
        pt_pipe.fusion_interpolate(models, f, f, device="cpu", spatial_mesh=mesh, seq_chunk=1)
    with pytest.raises(ValueError, match="at least 32"):
        pt_pipe.fusion_interpolate(models, f[:, :16], f[:, :16], device="cpu", spatial_mesh=mesh)
    with pytest.raises(ValueError, match="spatial_mesh"):
        pt_pipe.fusion_interpolate(models, f, f, device="cpu", spatial_mesh=make_mesh())
    with pytest.raises(NotImplementedError, match="20b"):
        with spatial.running(spatial.Bands(None, 0, (16, 16))):
            Conv2d(6, 4, 3, padding=1)(torch.zeros(1, 6, 16, 8, requires_grad=True))


def test_one_process_mesh_is_the_single_device_pipeline(ranks, weights, group):
    """On a (1, 1) mesh fusion_spatial_apply is fusion_interpolate, bit for
    bit; the placements are the pipeline's blocks, on this mesh and on the
    (2, 2) mesh of the ranks."""
    _, models, _, _, _ = weights
    mesh = make_mesh(1, ("data", "spatial"), (1, 1))
    f1, f2 = worker.frames(48, 40, 1, seed=3)
    res = spatial.fusion_spatial_apply(models, mesh, device="cpu")(f1, f2)
    assert res.batch == slice(0, 1) and res.rows == slice(0, 48)
    np.testing.assert_array_equal(res.gather().numpy(),
                                  pt_pipe.fusion_interpolate(models, f1, f2, device="cpu").numpy())
    assert spatial.data_spatial_sharding(mesh, 1, 48) == (res.batch, res.rows)
    assert spatial.spatial_image_sharding(mesh, 48, "spatial") == (slice(None), res.rows)
    assert all(all(r["placements"]) for r in ranks[1])
    assert spatial.split_rows(1088, 2) == (544, 544)
    assert spatial.split_rows(80, 2) == (32, 48) and spatial.split_rows(192, 4) == (64, 64, 32, 32)
