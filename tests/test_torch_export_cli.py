"""`cli export` of fusion for the CPU: the port's counterpart of
tests/test_export.py's fusion cases, at 64x64 on test_torch_export.py's
weights (the PhaseNet in phase_net.pt's layout and the FusionNet written as
.msgpack by the port, as the command reads them).

- the command writes a ("cpu",) artifact and one line naming it; the
  artifact holds every weight and the filter bank as its state;
- loaded back, it answers within 2e-5 of the port's live pipeline and at
  >= 60 dB of JAX's (ROADMAP Q3-3: the artifact map's histogram median
  turns float noise at a bin edge into a jump, so no element-wise bound
  holds for fusion);
- it is aten operators only: a process with torch and numpy, started
  outside the repository with fmvfi_tpu_torch unimportable, loads it with
  torch.export.load and answers within 2e-5 of the live pipeline.

That process starts as soon as the file is written and runs beside the
in-process cases (deserializing the ~6900 nodes of a program with three plain
warps takes seconds on each side).
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmvfi_tpu.pipeline import interpolate as jx_pipe
from fmvfi_tpu_torch import cli as pt_cli
from fmvfi_tpu_torch.pipeline import interpolate as pt_pipe
from fmvfi_tpu_torch.utils import convert
from fmvfi_tpu_torch.utils.checkpoint import save_msgpack
from fmvfi_tpu_torch.utils.export import load_exported
from test_torch_export import H, LIVE_TOL, W, frames, one_torch_thread, weights  # noqa: F401

JAX_DB = 60.0  # fusion against JAX's live pipeline
_PHASE_KEYS = {"conv1": "feature_map.0", "bn": "feature_map.1", "conv2": "feature_map.3",
               "pred": "prediction_map.0"}

_BARE = """
import json, sys
sys.modules["fmvfi_tpu_torch"] = None  # any import of the package raises ImportError
sys.modules["fmvfi_tpu"] = None
import numpy as np
import torch
torch.set_num_threads(1)  # as the test process: the same CPU sums
extra = {{"meta.json": ""}}
program = torch.export.load({path!r}, extra_files=extra)
d = np.load({frames!r})
with torch.no_grad():
    out = program.module()(torch.from_numpy(d["f1"]), torch.from_numpy(d["f2"]))
np.save({out!r}, out.numpy())
leaked = sorted(n for n in sys.modules if n.split(".")[0] in ("fmvfi_tpu_torch", "fmvfi_tpu")
                and sys.modules[n])
print(json.dumps(dict(meta=json.loads(extra["meta.json"]), leaked=leaked)))
"""


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else -10.0 * np.log10(mse)


@pytest.fixture(scope="module")
def exported(weights, frames, tmp_path_factory):
    """`cli export --method fusion --platforms cpu` on the port's weights:
    (directory, artifact path, what the command printed, the process that
    loads the artifact without the package, already started)."""
    _, pt = weights
    d = tmp_path_factory.mktemp("export")
    sd = pt.phase_net.state_dict()
    torch.save({f"layers.{k.split('.')[1]}.{_PHASE_KEYS[k.split('.')[2]]}.{k.split('.')[3]}": v
                for k, v in sd.items() if not k.endswith("num_batches_tracked")},
               d / "phase_net.pt")
    save_msgpack(str(d / "fusion.msgpack"), convert.fusion_net_to_flax(pt.fusion_net.state_dict()))
    out = d / "fusion.pt2"
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        pt_cli.main(["export", "--method", "fusion", "--size", f"{H}x{W}", "--platforms", "cpu",
                     "--device", "cpu", "--out", str(out), "--phase_checkpoint",
                     str(d / "phase_net.pt"), "--fusion_checkpoint", str(d / "fusion.msgpack")])
    np.savez(d / "frames.npz", f1=frames[0], f2=frames[1])
    bare = d / "bare"
    bare.mkdir()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = _BARE.format(path=str(out), frames=str(d / "frames.npz"), out=str(d / "out.npy"))
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=bare, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        yield d, out, said.getvalue(), proc
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()
        out.unlink()


@pytest.fixture(scope="module")
def loaded(exported):
    return load_exported(str(exported[1]), device="cpu")


def _live(pt, f1, f2):
    return pt_pipe.fusion_interpolate(pt, f1, f2, device="cpu")


def test_cli_export_writes_a_file_that_loads(exported, weights, frames, loaded):
    """`cli export` as JAX's: weights through _load_weights (the bundled
    AdaCoF, the FusionNet's variant and maps from its .msgpack), the
    artifact at --out, one line naming it; the artifact answers as the live
    pipeline on the same weights."""
    _, pt = weights
    _, out, said, _ = exported
    assert f"exported fusion 1x{H}x{W} -> {out}" in said
    fn = loaded
    assert fn.meta == dict(method="fusion", batch=1, h=H, w=W, platforms=["cpu"],
                           n_args=fn.meta["n_args"], version=1)
    # the program's state: every parameter and buffer of the three networks
    # (BN statistics included) and the 2 + 3 x 6 tensors of the filter bank
    n_state = sum(len(m.state_dict()) - sum(k.endswith("num_batches_tracked")
                                            for k in m.state_dict()) for m in pt)
    assert fn.meta["n_args"] >= n_state + 2
    assert len(fn.program.state_dict) + len(fn.program.constants) == fn.meta["n_args"]
    f1, f2 = frames
    got = fn(f1, f2)
    assert got.shape == (1, H, W, 3) and got.device.type == "cpu"
    torch.testing.assert_close(got, _live(pt, f1, f2), rtol=0, atol=LIVE_TOL)


def test_fusion_artifact_matches_jax_live_pipeline(weights, frames, loaded):
    jx, _ = weights
    f1, f2 = frames
    got = loaded(f1, f2).numpy()
    want = np.asarray(jax.jit(lambda x, y: jx_pipe.fusion_interpolate(jx, x, y))(
        jnp.asarray(f1), jnp.asarray(f2)))
    db = _psnr(got, want)
    print(f"fusion artifact against JAX's live pipeline: {db:.2f} dB, "
          f"max abs {np.abs(got - want).max():.3g}")
    assert db >= JAX_DB


def test_cpu_artifact_answers_without_the_package(exported, weights, frames, loaded):
    """The ("cpu",) fusion artifact of `cli export` is aten operators only:
    a process with torch and numpy, started outside the repository with
    fmvfi_tpu_torch unimportable, loads it with torch.export.load and
    answers within 2e-5 of the live pipeline."""
    _, pt = weights
    d, _, _, proc = exported
    f1, f2 = frames
    assert not any(str(n.target).startswith("fmvfi")
                   for m in loaded.program.graph_module.modules()
                   if isinstance(m, torch.fx.GraphModule) for n in m.graph.nodes
                   if n.op == "call_function")
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr[-4000:]
    res = json.loads(stdout.strip().splitlines()[-1])
    assert res["leaked"] == [] and res["meta"]["platforms"] == ["cpu"]
    got = torch.from_numpy(np.load(d / "out.npy"))
    torch.testing.assert_close(got, _live(pt, f1, f2), rtol=0, atol=LIVE_TOL)
