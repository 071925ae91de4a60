"""fmvfi_tpu_torch stands alone: the machine that serves it on a CUDA card has
PyTorch, numpy and scipy but no jax, flax, msgpack, cv2 or matplotlib, and
the port must not reach into fmvfi_tpu.  Also: its msgpack reader decodes
the bundled checkpoints exactly as msgpack + flax do, the bundled AdaCoF
scores the golden number through it, and the kernel build is keyed by its
sources.
"""

import ast
import json
import os
import shutil
import subprocess
import sys

import msgpack
import numpy as np
import pytest
from flax import serialization

from fmvfi_tpu_torch import _build
from fmvfi_tpu_torch.utils import msgpack_io

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(ROOT, "fmvfi_tpu_torch")
CKPTS = [
    os.path.join(ROOT, "checkpoints", "adacof_synth_demo.msgpack"),
    os.path.join(ROOT, "checkpoints", "fusion_synth_demo.msgpack"),
]
FORBIDDEN = (
    "jax", "jaxlib", "flax", "optax", "orbax", "msgpack", "fmvfi_tpu", "cv2", "matplotlib",
)
GOLDEN_DB, GOLDEN_TOL = 42.967, 0.05  # tests/test_golden.py, bundled AdaCoF
# the video and evaluation modules: imported by the isolated run below and
# held by the static import check
NEW_MODULES = ("pipeline.video", "eval.metrics", "eval.evaluate", "eval.uncertainty")

_ISOLATED = f"""
import importlib, json, pkgutil, sys
for name in {FORBIDDEN!r}:
    sys.modules[name] = None  # any import of these raises ImportError
import numpy as np
import fmvfi_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(fmvfi_tpu_torch.__path__, "fmvfi_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
from fmvfi_tpu_torch.eval.synth import translation_triplet
from fmvfi_tpu_torch.models.adacof import AdaCoFNet
from fmvfi_tpu_torch.models.fusion_net import FusionNet, infer_variant
from fmvfi_tpu_torch.pipeline.interpolate import adacof_interpolate
from fmvfi_tpu_torch.utils.convert import load_adacof_weights, load_fusion_weights
ada = AdaCoFNet().eval()
ada.load_state_dict(load_adacof_weights({CKPTS[0]!r}), strict=True)
fsd = load_fusion_weights({CKPTS[1]!r})
FusionNet(variant=infer_variant(fsd)).load_state_dict(fsd, strict=True)
f1, mid, f2 = translation_triplet(128, 128, dx=2.0, dy=1.0, seed=0)
pred = adacof_interpolate(ada, f1[None], f2[None], device="cpu")[0].numpy()
psnr = -10 * np.log10(np.mean((pred.astype(np.float64) - mid) ** 2))
leaked = sorted(n for n in sys.modules if n.split(".")[0] in {FORBIDDEN!r} and sys.modules[n])
print(json.dumps(dict(modules=mods, psnr=float(psnr), leaked=leaked)))
"""


def test_port_runs_without_jax_flax_msgpack_or_fmvfi_tpu():
    """Every module imports, both checkpoints load strictly, and the bundled
    AdaCoF gives the golden 42.967 dB on the CPU (plain warp, 48 px clamp)
    with jax, flax, msgpack and fmvfi_tpu unimportable."""
    proc = subprocess.run(
        [sys.executable, "-c", _ISOLATED], cwd=ROOT, capture_output=True, text=True,
        timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    for m in ("pipeline.interpolate", "ops.adacof_cuda", *NEW_MODULES):
        assert "fmvfi_tpu_torch." + m in res["modules"], m
    assert res["leaked"] == []
    assert abs(res["psnr"] - GOLDEN_DB) < GOLDEN_TOL, res["psnr"]


_TRAIN_ISOLATED = f"""
import json, sys, tempfile
for name in {FORBIDDEN!r}:
    sys.modules[name] = None  # any import of these raises ImportError
import torch
from fmvfi_tpu_torch.ops import adacof_cuda
from fmvfi_tpu_torch.train.data import SyntheticTriplets, batch_iterator
from fmvfi_tpu_torch.train.loop import fit
from fmvfi_tpu_torch.train.trainer import make_adacof_trainer
from fmvfi_tpu_torch.utils.checkpoint import Checkpointer
state, step = make_adacof_trainer(device="cpu")
with tempfile.TemporaryDirectory() as out:
    batches = batch_iterator(SyntheticTriplets(n=4, h=40, w=40), 2, crop=32)
    state = fit(state, step, batches, out, epochs=1, steps_per_epoch=2, log_every=1)
    latest = Checkpointer(out + "/checkpoint").latest()
w = torch.rand(1, 9, 6, 6, requires_grad=True)
adacof_cuda.AdaCoFWarp.apply(torch.rand(1, 3, 8, 8), w, torch.zeros_like(w), torch.zeros_like(w), 1, 4).sum().backward()
leaked = sorted(n for n in sys.modules if n.split(".")[0] in {FORBIDDEN!r} and sys.modules[n])
print(json.dumps(dict(step=state.step, latest=latest, grad=float(w.grad.abs().sum()), leaked=leaked)))
"""


def test_training_runs_without_jax_flax_optax_or_fmvfi_tpu():
    """The training slice (trainer, K3, data, fit, checkpoints) imports and
    runs two steps on the CPU with the reference's libraries blocked."""
    proc = subprocess.run(
        [sys.executable, "-c", _TRAIN_ISOLATED], cwd=ROOT, capture_output=True, text=True,
        timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["step"] == 2 and res["latest"] == 2 and res["grad"] > 0
    assert res["leaked"] == []


_REGIMES_ISOLATED = f"""
import json, sys, tempfile
for name in {FORBIDDEN!r}:
    sys.modules[name] = None  # any import of these raises ImportError
import numpy as np
import torch
torch.set_num_threads(1)
from fmvfi_tpu_torch.models.adacof import AdaCoFNet
from fmvfi_tpu_torch.models.phase_net import PhaseNetCore
from fmvfi_tpu_torch.train.data import MixedSynthStream, SyntheticTriplets, batch_iterator
from fmvfi_tpu_torch.train.loop import fit
from fmvfi_tpu_torch.train.trainer import make_fusion_trainer, make_phase_trainer
from fmvfi_tpu_torch.utils.convert import load_adacof_weights
ada = AdaCoFNet()
ada.load_state_dict(load_adacof_weights({CKPTS[0]!r}))
state, step, eval_fn, make_step = make_phase_trainer(32, 32, mode="fusion", adacof=ada, device="cpu")
with tempfile.TemporaryDirectory() as out:
    batches = batch_iterator(SyntheticTriplets(n=2, h=40, w=40, mixed=True), 1, crop=32)
    state = fit(state, step, batches, out, epochs=1, steps_per_epoch=2, log_every=1,
                make_step=make_step, m_init=3, m_update=1)
phase = PhaseNetCore().init_params(torch.Generator().manual_seed(0))
fstate, fstep = make_fusion_trainer(phase, ada, variant=2, device="cpu")
f1, mid, f2 = (np.stack([x]) for x in MixedSynthStream(n=1, h=32, w=32, workers=1).load(0))
fstate, m = fstep(fstate, (f1, mid, f2))
leaked = sorted(n for n in sys.modules if n.split(".")[0] in {FORBIDDEN!r} and sys.modules[n])
print(json.dumps(dict(phase_step=state.step, fusion_step=fstate.step, loss=float(m["loss"]),
                      leaked=leaked)))
"""


def test_phase_and_fusion_training_run_without_jax_flax_optax_or_fmvfi_tpu():
    """The phase trainer (fusion mode, through fit's m-schedule) and the
    fusion trainer take their steps on the CPU on the mixed diets with the
    reference's libraries blocked."""
    proc = subprocess.run(
        [sys.executable, "-c", _REGIMES_ISOLATED], cwd=ROOT, capture_output=True, text=True,
        timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["phase_step"] == 2 and res["fusion_step"] == 1 and np.isfinite(res["loss"])
    assert res["leaked"] == []


_SERVE_ISOLATED = f"""
import json, sys, tempfile
for name in {FORBIDDEN!r}:
    sys.modules[name] = None  # any import of these raises ImportError
import numpy as np
import torch
torch.set_num_threads(1)  # small work; spinning thread pools across test processes cost more
from fmvfi_tpu_torch.eval.evaluate import evaluate_suite, synthetic_sets
from fmvfi_tpu_torch.eval.synth import translation_video
from fmvfi_tpu_torch.models.adacof import AdaCoFNet
from fmvfi_tpu_torch.models.fusion_net import FusionNet, infer_variant
from fmvfi_tpu_torch.models.phase_net import PhaseNetCore
from fmvfi_tpu_torch.pipeline.interpolate import FusionModels
from fmvfi_tpu_torch.pipeline.video import double_frame_rate
from fmvfi_tpu_torch.utils.convert import load_adacof_weights, load_fusion_weights
ada = AdaCoFNet().eval()
ada.load_state_dict(load_adacof_weights({CKPTS[0]!r}))
fsd = load_fusion_weights({CKPTS[1]!r})
fusion = FusionNet(variant=infer_variant(fsd)).eval()
fusion.load_state_dict(fsd)
phase = PhaseNetCore().init_params(torch.Generator().manual_seed(0)).eval()
models = FusionModels(phase_net=phase, adacof=ada, fusion_net=fusion)
frames = translation_video(3, 32, 32, step=1.0)
out = list(double_frame_rate(frames, models, stream=True, stream_window=2, device="cpu"))
sets = {{k: v for k, v in synthetic_sets(32, 3).items() if k == "translation"}}
with tempfile.TemporaryDirectory() as d:
    summary = evaluate_suite(models, d, sets=sets, methods=("fusion", "baseline"), dim=32,
                             device="cpu")
leaked = sorted(n for n in sys.modules if n.split(".")[0] in {FORBIDDEN!r} and sys.modules[n])
print(json.dumps(dict(n_out=len(out), finite=bool(np.isfinite(np.stack(out)).all()),
                      psnr=[summary["translation"][m]["psnr"] for m in ("fusion", "baseline")],
                      leaked=leaked)))
"""


def test_video_and_eval_run_without_jax_flax_msgpack_cv2_or_matplotlib():
    """The stream path of double_frame_rate and evaluate_suite run on the CPU
    with the reference's libraries, cv2 and matplotlib blocked."""
    proc = subprocess.run(
        [sys.executable, "-c", _SERVE_ISOLATED], cwd=ROOT, capture_output=True, text=True,
        timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["n_out"] == 5 and res["finite"]
    assert all(np.isfinite(res["psnr"])), res["psnr"]
    assert res["leaked"] == []


def _py_files():
    files = [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "tools", "torch_train_profile.py")]
    for d, _, names in os.walk(PACKAGE):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_static_check_covers_the_video_and_eval_modules():
    files = {os.path.relpath(p, PACKAGE) for p in _py_files()}
    for m in NEW_MODULES:
        assert m.replace(".", os.sep) + ".py" in files, m


@pytest.mark.parametrize("path", _py_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_forbidden_imports(path):
    """Static check, lazy imports inside functions included."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    assert not names & set(FORBIDDEN), sorted(names & set(FORBIDDEN))


@pytest.mark.parametrize("path", CKPTS, ids=os.path.basename)
def test_msgpack_reader_matches_flax(path):
    with open(path, "rb") as f:
        data = f.read()
    ref = serialization.msgpack_restore(data)
    ours = msgpack_io.loads(data)

    def leaves(t, pre=()):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from leaves(v, pre + (k,))
            else:
                yield pre + (k,), v

    a, b = list(leaves(ref)), list(leaves(ours))
    assert [k for k, _ in a] == [k for k, _ in b]
    for (k, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize(
    "obj",
    [{"a": None}, {"a": True}, {1: 2}, {"a": np.array([1j], np.complex64)}],
    ids=["nil", "bool", "int-key", "complex-ext"],
)
def test_msgpack_reader_rejects_what_flax_files_never_hold(obj):
    if isinstance(obj.get("a"), np.ndarray):
        data = serialization.msgpack_serialize(obj)
    else:
        data = msgpack.packb(obj)
    with pytest.raises(msgpack_io.MsgpackError):
        msgpack_io.loads(data)


def test_msgpack_reader_scalar_types():
    obj = {"i": [0, 127, -1, -32, 200, -200, 70000, -70000, 2**40, -(2**40)],
           "f": [0.5, 1e300], "s": "x" * 40, "b": b"\x00" * 300,
           "m": {str(i): i for i in range(20)}}
    assert msgpack_io.loads(msgpack.packb(obj, use_bin_type=True)) == obj
    with pytest.raises(msgpack_io.MsgpackError):
        msgpack_io.loads(msgpack.packb(obj)[:-1])


def test_kernel_library_is_keyed_by_its_sources(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, src)
    monkeypatch.setattr(_build, "CSRC_DIR", src)
    first = _build._library_path()
    assert first == _build._library_path()
    assert first.parent == _build.BUILD_DIR
    cu = src / "adacof_warp.cu"
    cu.write_text(cu.read_text() + "\n// changed\n")
    assert _build._library_path() != first


def test_kernel_library_is_keyed_by_its_flags():
    """A diagnostic build (extra nvcc flags) gets a library of its own."""
    plain = _build._library_path()
    assert _build._library_path(()) == plain
    form1 = _build._library_path(("-DADACOF_DIAG_FORM=1",))
    assert form1 != plain and form1 != _build._library_path(("-DADACOF_DIAG_FORM=2",))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "build").exists()


_FAKE_NVCC = """#!{python}
import os, sys, time
args = sys.argv[1:]
with open({log!r}, "a") as f:
    f.write(f"start {{time.time()}} {{' '.join(args)}}\\n")
if "-c" in args:
    time.sleep(0.5)
open(args[args.index("-o") + 1], "w").write("built")
with open({log!r}, "a") as f:
    f.write(f"end {{time.time()}} {{' '.join(args)}}\\n")
"""


def test_build_compiles_each_source_in_parallel_then_links(monkeypatch, tmp_path):
    """One nvcc per csrc/*.cu, all started together, then one link into
    the library (a stand-in nvcc records its calls)."""
    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable, log=str(log)))
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: str(nvcc))
    path = _build.build()
    assert path.read_text() == "built" and path.parent == tmp_path / "build"
    assert os.listdir(tmp_path / "build") == [path.name]  # no temporaries left
    calls = [line.split(" ", 2) for line in log.read_text().splitlines()]
    compiles = [c for c in calls if " -c " in f" {c[2]} "]
    sources = [str(p) for p in _build._sources()]
    assert len(sources) >= 2 and "adacof_warp_bwd.cu" in " ".join(sources)
    assert sorted(c[2].split()[-1] for c in compiles if c[0] == "start") == sorted(sources)
    starts = [float(c[1]) for c in compiles if c[0] == "start"]
    ends = [float(c[1]) for c in compiles if c[0] == "end"]
    assert max(starts) < min(ends)  # every compile started before any ended
    link = [c for c in calls if c[0] == "start" and "-shared" in c[2]]
    assert len(link) == 1 and float(link[0][1]) >= max(ends)
    assert _build.build() == path  # a second build finds the library
