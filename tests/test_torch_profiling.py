"""fmvfi_tpu_torch.utils.profiling and the training probes of
fmvfi_tpu_torch.train.loop, on the CPU, against the JAX package where it
has the same function.

- `timed` and `stage_timer` accumulate positive times, `timed` chaining
  its iterations (each fed the last output);
- `checked` raises FloatingPointError naming the leaf on a NaN or Inf
  output, where JAX's `checked` raises on the same input (a NaN from log
  of a negative number, an Inf from a division by zero), and passes finite
  outputs through unchanged;
- `trace` writes a Chrome trace file;
- `PsnrProbe.from_middlebury` on a 3-scene Middlebury-other layout with the
  bundled AdaCoF scores within 0.05 dB of JAX's probe on the same files,
  and `fit` logs it as probe_psnr after each epoch;
- `fit(image_probe=..., image_every=N)` writes <out_dir>/result/step_<N>.png
  every N steps, quantized as JAX's fit writes it.
"""

import json
import os

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fmvfi_tpu.pipeline import interpolate as jx_pipe
from fmvfi_tpu.train import loop as jx_loop
from fmvfi_tpu.utils import profiling as jx_profiling
from fmvfi_tpu_torch.eval.synth import translation_triplet
from fmvfi_tpu_torch.models.adacof import AdaCoFNet
from fmvfi_tpu_torch.pipeline.interpolate import adacof_interpolate
from fmvfi_tpu_torch.train.data import SyntheticTriplets, batch_iterator
from fmvfi_tpu_torch.train.loop import PsnrProbe, fit
from fmvfi_tpu_torch.train.trainer import make_adacof_trainer
from fmvfi_tpu_torch.utils import convert, profiling
from fmvfi_tpu_torch.utils.imageio import imread

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ADACOF_CKPT = os.path.join(ROOT, "checkpoints", "adacof_synth_demo.msgpack")
PROBE_DB = 0.05


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """PyTorch's CPU ops in one thread: the suite runs in several processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_timed_chains_its_iterations_and_times_them():
    seen = []

    def step(x):
        seen.append(float(x[0]))
        return x + 1.0

    s = profiling.timed(step, torch.zeros(4), iters=5, warmup=2)
    assert s > 0 and seen == [0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    assert profiling.timed(lambda t: (t[0] * 2.0, t[1]), (torch.ones(3), "tag"), iters=2) > 0


def test_stage_timer_accumulates_per_stage():
    x = torch.ones(1000)
    with profiling.stage_timer() as t:
        x = x * 2.0
        t.stage("a", block_on=x)
        x = x.sum()
        t.stage("b", block_on={"out": [x]})
        t.stage("a")
    assert set(t.times) == {"a", "b"} and all(v > 0 for v in t.times.values())


@pytest.mark.parametrize("case", ["log_negative", "divide_by_zero"])
def test_checked_raises_where_jax_does(case):
    """The same non-finite output on both sides: JAX's checkify raises, and
    so does the port's `checked`, naming the leaf."""
    x = np.array([-1.0, 2.0], np.float32) if case == "log_negative" else np.ones(2, np.float32)
    if case == "log_negative":
        jx_fn, pt_fn = (lambda v: {"y": jnp.log(v)}), (lambda v: {"y": torch.log(v)})
    else:
        jx_fn, pt_fn = (lambda v: (v, v / 0.0)), (lambda v: (v, v / 0.0))
    with pytest.raises(Exception, match="nan generated|division by zero"):
        jx_profiling.checked(jx_fn)(jnp.asarray(x))
    kind, leaf = ("NaN", "['y']") if case == "log_negative" else ("Inf", "[1]")
    with pytest.raises(FloatingPointError, match=rf"{kind} in \{leaf}"):
        profiling.checked(pt_fn)(torch.from_numpy(x))


def test_checked_passes_finite_outputs_through():
    out = profiling.checked(lambda v: (v * 2, {"n": 3, "i": torch.arange(3)}))(torch.ones(2))
    assert torch.equal(out[0], torch.full((2,), 2.0)) and out[1]["n"] == 3


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(tmp_path / "trace" / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)
    assert any("matmul" in e.key for e in prof.key_averages())


@pytest.fixture(scope="module")
def middlebury(tmp_path_factory):
    """A 3-scene Middlebury-other layout of 48x64 PNGs."""
    d = tmp_path_factory.mktemp("mb")
    for k, scene in enumerate(("Dimetrodon", "Grove", "Venus")):
        for sub, name, f in zip(("in", "gt", "in"), ("frame10.png", "frame10i11.png",
                                                      "frame11.png"),
                                translation_triplet(48, 64, dx=1.0 + k, dy=-1.0, seed=20 + k)):
            os.makedirs(d / sub / scene, exist_ok=True)
            u8 = (np.clip(f, 0, 1) * 255 + 0.5).astype(np.uint8)
            cv2.imwrite(str(d / sub / scene / name), cv2.cvtColor(u8, cv2.COLOR_RGB2BGR))
    return d


@pytest.fixture(scope="module")
def bundled():
    m = AdaCoFNet().eval()
    m.load_state_dict(convert.load_adacof_weights(ADACOF_CKPT))
    return m


def test_psnr_probe_matches_jax(middlebury, bundled):
    from flax import serialization

    with open(ADACOF_CKPT, "rb") as f:
        tree = serialization.msgpack_restore(f.read())
    jx_interp = jax.jit(lambda a, b: jx_pipe.adacof_interpolate(tree, a, b))
    jx_probe = jx_loop.PsnrProbe.from_middlebury(
        str(middlebury / "in"), str(middlebury / "gt"), lambda state, a, b: jx_interp(a, b))
    probe = PsnrProbe.from_middlebury(
        str(middlebury / "in"), str(middlebury / "gt"),
        lambda state, a, b: adacof_interpolate(state, a, b, device="cpu"))
    assert len(probe.triplets) == len(jx_probe.triplets) == 3
    for ours, ref in zip(probe.triplets, jx_probe.triplets):
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)
    got, want = probe(bundled), jx_probe(None)
    print(f"probe PSNR: port {got:.4f} dB, JAX {want:.4f} dB")
    assert np.isfinite(got) and abs(got - want) <= PROBE_DB


def test_fit_logs_the_probe_and_writes_the_image_probe(tmp_path, middlebury):
    state, step = make_adacof_trainer(device="cpu", h=32, w=32)
    probe = PsnrProbe.from_middlebury(
        str(middlebury / "in"), str(middlebury / "gt"),
        lambda st, a, b: adacof_interpolate(st.model.eval(), a, b, device="cpu"))
    f1, _, f2 = translation_triplet(32, 32, dx=2.0, dy=1.0, seed=3)
    renders = {}

    def image_probe(st):
        img = adacof_interpolate(st.model.eval(), f1[None], f2[None], device="cpu")[0]
        st.model.train()
        renders[st.step] = img.numpy()
        return img

    batches = batch_iterator(SyntheticTriplets(n=4, h=40, w=40), 1, crop=32)
    try:
        state = fit(state, step, batches, str(tmp_path), epochs=2, steps_per_epoch=2,
                    log_every=1, probe=probe, image_probe=image_probe, image_every=2)
    finally:
        batches.close()
    assert state.step == 4
    assert sorted(os.listdir(tmp_path / "result")) == ["step_000002.png", "step_000004.png"]
    for s, img in renders.items():
        want = (img * 255).clip(0, 255).astype(np.uint8)  # JAX's fit: truncated, not rounded
        np.testing.assert_array_equal(imread(str(tmp_path / "result" / f"step_{s:06d}.png")),
                                      want)
    with open(tmp_path / "train_metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    probes = [r for r in recs if "probe_psnr" in r]
    assert [(r["step"], r["epoch"]) for r in probes] == [(2, 0), (4, 1)]
    assert all(np.isfinite(r["probe_psnr"]) for r in probes)
