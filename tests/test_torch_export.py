"""fmvfi_tpu_torch.utils.export: the port's counterparts of
tests/test_export.py, on the CPU at 64x64, with the bundled AdaCoF, a
fixed-key flax PhaseNet and a fresh flax FusionNet (variant 0, 3 maps)
carried to torch by utils/convert.py.

- adacof and phase artifacts, saved and loaded back, against the port's
  live pipeline within 2e-5 and JAX's within 1e-4 (fusion's ("cpu",)
  artifact, made by `cli export`, is test_torch_export_cli.py's);
- off-grid 60x44 fusion (the filter bank at the /8-padded size);
- loading from bytes;
- a ("cpu", "cuda") artifact carries the `fmvfi::adacof_warp_fwd` node and
  answers on the CPU; a ("cuda",) artifact is refused on the CPU, and a
  CUDA load without a card raises;
- `cli export` with --batch and two platforms.

The exports are made once per module: tracing the plain warp's 25-tap
loop dominates the file's time.  Artifacts of ~90 MB (AdaCoF's weights)
are deleted once loaded.
"""

import io
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from fmvfi_tpu.models import fusion_net as jx_fusion
from fmvfi_tpu.models import phase_net as jx_phase
from fmvfi_tpu.pipeline import interpolate as jx_pipe
from fmvfi_tpu_torch import cli as pt_cli
from fmvfi_tpu_torch.models.adacof import AdaCoFNet
from fmvfi_tpu_torch.models.fusion_net import FusionNet
from fmvfi_tpu_torch.models.phase_net import PhaseNetCore
from fmvfi_tpu_torch.pipeline import interpolate as pt_pipe
from fmvfi_tpu_torch.utils import convert
from fmvfi_tpu_torch.utils.export import export_pipeline, load_exported, save_exported

H = W = 64
LIVE_TOL = 2e-5  # the artifact against the same pipeline run live
JAX_TOL = 1e-4  # adacof and phase against JAX's live pipeline
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ADACOF_CKPT = os.path.join(ROOT, "checkpoints", "adacof_synth_demo.msgpack")
WARP_OP = "fmvfi.adacof_warp_fwd.default"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """PyTorch's CPU ops in one thread: the suite runs in several processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def weights():
    """(JAX FusionWeights, port FusionModels) with the same weights."""
    with open(ADACOF_CKPT, "rb") as f:
        ada_tree = serialization.msgpack_restore(f.read())
    low = jnp.zeros((1, 4, 4, 2))
    lev = [jnp.zeros((1, 4, 4, 8))] * 7
    phase_tree = jax.tree.map(np.asarray, jax.jit(
        lambda k: jx_phase.PhaseNetCore(num_img=2).init(k, low, lev, lev))(jax.random.key(0)))
    z = jnp.zeros((1, 16, 16, 3))
    fusion_tree = jax.tree.map(np.asarray, jax.jit(
        lambda k: jx_fusion.FusionNet(uncertainty_maps=3).init(
            k, z, z, z, jnp.zeros((1, 16, 16, 6)), jnp.zeros((1, 16, 16, 3)), 0))(
        jax.random.key(0)))
    jx = jx_pipe.FusionWeights(phase_net=phase_tree, adacof=ada_tree, fusion_net=fusion_tree)
    phase = PhaseNetCore().eval()
    phase.load_state_dict(convert.phase_net_from_flax(phase_tree))
    ada = AdaCoFNet().eval()
    ada.load_state_dict(convert.adacof_from_flax(ada_tree))
    fusion = FusionNet().eval()
    fusion.load_state_dict(convert.fusion_net_from_flax(fusion_tree))
    return jx, pt_pipe.FusionModels(phase, ada, fusion)


@pytest.fixture(scope="module")
def frames():
    r = np.random.default_rng(3)
    return r.random((1, H, W, 3), dtype=np.float32), r.random((1, H, W, 3), dtype=np.float32)


@pytest.fixture(scope="module")
def loaded(weights, tmp_path_factory):
    """method -> a ("cpu",) artifact saved with save_exported and loaded
    back from its file (loading deserializes every node: done once)."""
    _, pt = weights
    d = tmp_path_factory.mktemp("saved")
    out = {}
    for method in ("adacof", "phase"):
        path = d / f"{method}.pt2"
        save_exported(str(path), export_pipeline(pt, H, W, method, platforms=("cpu",)))
        out[method] = load_exported(str(path), device="cpu")
        path.unlink()
    return out


def _live(pt, method, f1, f2):
    if method == "adacof":
        return pt_pipe.adacof_interpolate(pt.adacof, f1, f2, device="cpu")
    if method == "phase":
        return pt_pipe.phase_interpolate(pt.phase_net, f1, f2, device="cpu")
    return pt_pipe.fusion_interpolate(pt, f1, f2, device="cpu")


def _targets(program):
    """The operators a program calls, its subgraphs' included."""
    return {str(n.target) for m in program.graph_module.modules()
            if isinstance(m, torch.fx.GraphModule) for n in m.graph.nodes
            if n.op == "call_function"}


@pytest.mark.parametrize("method", ["adacof", "phase"])
def test_export_roundtrip_matches_live(weights, frames, loaded, method):
    _, pt = weights
    f1, f2 = frames
    fn = loaded[method]
    assert fn.meta["method"] == method and (fn.meta["h"], fn.meta["w"]) == (H, W)
    assert fn.meta["batch"] == 1 and fn.meta["platforms"] == ["cpu"] and fn.meta["version"] == 1
    got = fn(f1, f2)
    assert got.shape == (1, H, W, 3) and got.device.type == "cpu"
    want = _live(pt, method, f1, f2)
    torch.testing.assert_close(got, want, rtol=0, atol=LIVE_TOL)


@pytest.mark.parametrize("method", ["adacof", "phase"])
def test_export_matches_jax_live_pipeline(weights, frames, loaded, method):
    jx, _ = weights
    f1, f2 = frames
    got = loaded[method](f1, f2).numpy()
    a, b = jnp.asarray(f1), jnp.asarray(f2)
    if method == "adacof":
        want = jax.jit(lambda x, y: jx_pipe.adacof_interpolate(jx.adacof, x, y))(a, b)
    else:
        want = jax.jit(lambda x, y: jx_pipe.phase_interpolate(jx.phase_net, x, y))(a, b)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=JAX_TOL)


def test_export_fusion_off_grid(weights):
    """Off-/8 sizes export too: fusion_interpolate reflect-pads internally,
    so the export builds its filter bank at the padded size.  Exported for
    (cpu, cuda): the warp is the operator, whose CPU kernel is the plain
    warp."""
    _, pt = weights
    h, w = 60, 44
    r = np.random.default_rng(9)
    f1 = r.random((1, h, w, 3), dtype=np.float32)
    f2 = r.random((1, h, w, 3), dtype=np.float32)
    fn = load_exported(export_pipeline(pt, h, w, "fusion", platforms=("cpu", "cuda")),
                       device="cpu")
    got = fn(f1, f2)
    assert got.shape == (1, h, w, 3)
    torch.testing.assert_close(got, pt_pipe.fusion_interpolate(pt, f1, f2, device="cpu"),
                               rtol=0, atol=LIVE_TOL)


def test_export_bytes_loadable(weights, frames, loaded):
    _, pt = weights
    f1, f2 = frames
    # raw bytes, no file; phase: the smallest artifact (no AdaCoF weights)
    fn = load_exported(export_pipeline(pt, H, W, "phase", platforms=("cpu",)), device="cpu")
    out = fn(f1, f2)
    assert torch.isfinite(out).all() and fn.meta == loaded["phase"].meta
    torch.testing.assert_close(out, loaded["phase"](f1, f2), rtol=0, atol=0)


def test_multi_platform_artifact_carries_the_warp_operator(weights, frames, monkeypatch):
    """(cpu, cuda) and (cuda,) artifacts trace the warp as the registered
    operator; built on this CPU host, the first answers on the CPU through
    the operator's CPU kernel, the second is refused there, and a CUDA load
    without a card raises."""
    _, pt = weights
    f1, f2 = frames
    both = export_pipeline(pt, H, W, "adacof", platforms=("cuda", "cpu"))
    fn = load_exported(both, device="cpu")
    assert WARP_OP in _targets(fn.program)
    assert fn.meta["platforms"] == ["cpu", "cuda"]
    torch.testing.assert_close(fn(f1, f2), _live(pt, "adacof", f1, f2), rtol=0, atol=LIVE_TOL)
    cuda_only = export_pipeline(pt, H, W, "adacof", platforms=("cuda",))
    assert WARP_OP in _targets(torch.export.load(io.BytesIO(cuda_only)))
    with pytest.raises(ValueError, match="exported for"):
        load_exported(cuda_only, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_exported(both, device="cuda")


def test_export_checks_its_arguments(weights):
    _, pt = weights
    with pytest.raises(ValueError, match="platforms"):
        export_pipeline(pt, H, W, "adacof", platforms=("tpu",))
    with pytest.raises(ValueError, match="unknown method"):
        export_pipeline(pt, H, W, "baseline")
    with pytest.raises(ValueError, match="needs"):
        export_pipeline(pt._replace(phase_net=None), H, W, "phase")
    with pytest.raises(ValueError, match="variant"):
        export_pipeline(pt, H, W, "fusion", variant=2)
    with pytest.raises(ValueError, match="AdaCoF has F 5"):
        export_pipeline(pt, H, W, "adacof", kernel_size=11)


def test_cli_export_takes_batch_and_platforms(tmp_path, capsys):
    """`cli export --batch 2 --platforms cpu,cuda` of adacof (the bundled
    weights): one line naming the file, an artifact at that batch and size
    that answers on the CPU."""
    out = tmp_path / "a.pt2"
    pt_cli.main(["export", "--method", "adacof", "--size", "32x48", "--batch", "2",
                 "--platforms", "cpu,cuda", "--device", "cpu", "--out", str(out)])
    assert f"exported adacof 2x32x48 -> {out}" in capsys.readouterr().out
    fn = load_exported(str(out), device="cpu")
    out.unlink()
    assert (fn.meta["batch"], fn.meta["h"], fn.meta["w"]) == (2, 32, 48)
    assert fn.meta["platforms"] == ["cpu", "cuda"] and WARP_OP in _targets(fn.program)
    f = np.random.default_rng(4).random((2, 32, 48, 3), dtype=np.float32)
    assert fn(f, f[::-1].copy()).shape == (2, 32, 48, 3)
