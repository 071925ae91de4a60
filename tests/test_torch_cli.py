"""fmvfi_tpu_torch.cli against fmvfi_tpu.cli on the CPU (`--device cpu`),
on the same PNG files (written with cv2) and the same weights: the bundled
AdaCoF and FusionNet and a seeded PhaseNet saved in phase_net.pt's layout.

- `_load_weights` loads only what the method needs (as
  tests/test_r3_fixes.py holds for JAX);
- config.json equals the one JAX's `train` writes for the same arguments,
  and the config helpers agree;
- the registry builds each family and reaches make_model by dotted path;
- `interpolate` (adacof, phase, fusion with its three side outputs) and
  `video` (per pair, --batch 2, --stream, --factor 4, all fusion; per pair
  on a directory of JPEG frames): every
  pixel of every PNG within 1 LSB of JAX's (JAX truncates x * 255, so a
  float gap of ~1e-6 can flip a pixel), with the share that differs
  printed; `--output_frame out.jpg` byte-equal to cv2.imwrite of the
  pixels of the .png output;
- `evaluate` on a middlebury: layout and on the synthetic sets at --dim 64
  --max_num 2: per-scene and per-set PSNR within 0.05 dB of JAX's, and
  results.png (1320x440), the panels and the AVIs written as JAX writes
  them;
- `train` in each regime, 2 steps on a Vimeo90k layout at --crop 64:
  finite losses, a checkpoint, config.json (trainer parity is held in
  tests/test_torch_train*.py);
- what the port does not run yet raises (video files), what it runs since
  the JPEG reader and the photo sets (`evaluate --test_sets
  synthetic+photo`, `interpolate` on JPEG frames) runs, and no card without
  --device cpu exits with an error.

The JAX commands run once, in one process, so that they share their
compilations (the per-pair fusion at 1x64x64 serves interpolate, video and
the middlebury evaluation; the 2-pair batch serves video --batch 2 and the
synthetic evaluation).
"""

import json
import os
import sys
from types import SimpleNamespace

import cv2
import numpy as np
import pytest
import torch

from fmvfi_tpu import cli as jx_cli
from fmvfi_tpu.eval.evaluate import synthetic_sets as jx_synthetic_sets
from fmvfi_tpu.eval.synth import translation_triplet, translation_video
from fmvfi_tpu.utils import config as jx_config
from fmvfi_tpu_torch import cli as pt_cli
from fmvfi_tpu_torch.models import registry
from fmvfi_tpu_torch.models.adacof import AdaCoFNet
from fmvfi_tpu_torch.models.discriminator import Discriminator
from fmvfi_tpu_torch.models.fusion_net import FusionNet
from fmvfi_tpu_torch.models.phase_net import PhaseNetCore
from fmvfi_tpu_torch.utils import config as pt_config
from test_torch_convert import reference_phase_sd

LSB = 1
EVAL_DB = 0.05
SIZE = 64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """PyTorch's CPU ops in one thread: the suite runs in several processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _write(path, rgb_float):
    os.makedirs(os.path.dirname(str(path)), exist_ok=True)
    u8 = (np.clip(rgb_float, 0, 1) * 255 + 0.5).astype(np.uint8)
    cv2.imwrite(str(path), cv2.cvtColor(u8, cv2.COLOR_RGB2BGR))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A frame pair, a 4-frame clip (as PNGs and as JPEGs), a 2-scene middlebury layout, a
    4-triplet Vimeo90k layout (72x80) and a seeded phase_net.pt."""
    d = tmp_path_factory.mktemp("inputs")
    f1, _, f2 = translation_triplet(SIZE, SIZE, dx=2.0, dy=1.0, seed=0)
    _write(d / "a.png", f1)
    _write(d / "b.png", f2)
    for i, f in enumerate(translation_video(4, SIZE, SIZE, step=2.0, seed=3)):
        _write(d / "clip" / f"f{i}.png", f)
        _write(d / "clip_jpg" / f"f{i}.jpg", f)
    for k, scene in enumerate(("Dimetrodon", "Venus")):
        a, mid, b = translation_triplet(SIZE, SIZE, dx=1.0 + k, dy=-1.0, seed=10 + k)
        _write(d / "mb" / "other" / scene / "frame10.png", a)
        _write(d / "mb" / "other" / scene / "frame11.png", b)
        _write(d / "mb" / "gt" / scene / "frame10i11.png", mid)
    for k in range(4):
        for i, f in enumerate(translation_triplet(72, 80, dx=2.0, dy=k - 1.0, seed=20 + k)):
            _write(d / "vimeo" / "sequences" / "00001" / f"{k:04d}" / f"im{i + 1}.png", f)
    torch.save(reference_phase_sd(seed=0), d / "phase_net.pt")
    return d


def _commands(d, out):
    """name -> the argument list of each command compared with JAX; makes
    the directories that `interpolate` writes into (cv2.imwrite, JAX's
    writer, fails quietly where there is none)."""
    for m in ("adacof", "phase", "fusion"):
        os.makedirs(f"{out}/interp_{m}", exist_ok=True)
    ph = ["--phase_checkpoint", str(d / "phase_net.pt")]
    pair = ["--first_frame", str(d / "a.png"), "--second_frame", str(d / "b.png")]
    sides = [f"--output_{k}" for k in ("phase", "adacof", "baseline")]
    cmds = {
        f"interpolate_{m}": ["interpolate", *pair, "--output_frame", f"{out}/interp_{m}/out.png",
                             "--method", m, *ph] for m in ("adacof", "phase")
    }
    cmds["interpolate_fusion"] = [
        "interpolate", *pair, "--output_frame", f"{out}/interp_fusion/out.png", *ph,
        *[a for k in sides for a in (k, f"{out}/interp_fusion/{k[9:]}.png")]]
    for name, extra in (("per_pair", []), ("factor4", ["--factor", "4"]),
                        ("batch2", ["--batch", "2"]), ("stream", ["--stream"])):
        cmds[f"video_{name}"] = ["video", "--input", str(d / "clip"), "--output_dir",
                                 f"{out}/video_{name}", *ph, *extra]
    cmds["video_jpeg"] = ["video", "--input", str(d / "clip_jpg"), "--output_dir",
                          f"{out}/video_jpeg", *ph]
    mb = f"middlebury:{d / 'mb' / 'other'}:{d / 'mb' / 'gt'}"
    for name, sets in (("middlebury", mb), ("synthetic", "synthetic")):
        cmds[f"evaluate_{name}"] = ["evaluate", "--test_sets", sets, "--out_dir",
                                    f"{out}/eval_{name}", "--dim", str(SIZE), "--max_num", "2",
                                    *ph]
    return cmds


@pytest.fixture(scope="module")
def jax_out(inputs):
    """Every compared command through JAX's CLI, once."""
    out = inputs / "jax"
    for argv in _commands(inputs, out).values():
        jx_cli.main(argv)
    return out


def _run_port(inputs, name):
    out = inputs / "port"
    pt_cli.main(_commands(inputs, out)[name] + ["--device", "cpu"])
    return out


def _within_lsb(ours_path, ref_path):
    a = cv2.imread(str(ours_path), cv2.IMREAD_UNCHANGED).astype(np.int16)
    b = cv2.imread(str(ref_path), cv2.IMREAD_UNCHANGED).astype(np.int16)
    assert a.shape == b.shape
    diff = np.abs(a - b)
    print(f"{os.path.basename(os.path.dirname(ours_path))}/{os.path.basename(ours_path)}: "
          f"{100.0 * float((diff > 0).mean()):.4f} % of pixels differ, max {int(diff.max())} LSB")
    assert int(diff.max()) <= LSB


def test_load_weights_loads_only_what_the_method_needs(monkeypatch):
    """tests/test_r3_fixes.py::test_load_weights_method_gated for the port:
    phase-only use touches no AdaCoF or FusionNet loader, adacof-only no
    PhaseNet loader, a method list everything it needs."""
    calls = []

    def loader(tag, module):
        return lambda *a, **k: calls.append(tag) or module().state_dict()

    monkeypatch.setattr("fmvfi_tpu_torch.utils.convert.load_adacof_weights",
                        loader("ada", AdaCoFNet))
    monkeypatch.setattr("fmvfi_tpu_torch.utils.convert.load_fusion_weights",
                        loader("fus", FusionNet))
    monkeypatch.setattr("fmvfi_tpu_torch.utils.convert.phase_net_from_torch",
                        loader("pha", PhaseNetCore))

    def make_args(**kw):
        return SimpleNamespace(**{**dict(
            adacof_checkpoint="x.msgpack", fusion_checkpoint="fusion_net.pt",
            phase_checkpoint="phase_net.pt", kernel_size=5, dilation=1, fusion_variant=-1,
            fusion_maps=-1, device="cpu"), **kw})

    def kinds(w):
        return tuple(None if m is None else type(m).__name__ for m in w)

    w = pt_cli._load_weights(make_args(method="phase"))
    assert kinds(w) == ("PhaseNetCore", None, None) and calls == ["pha"]
    calls.clear()
    w = pt_cli._load_weights(make_args(method="adacof"))
    assert kinds(w) == (None, "AdaCoFNet", None) and calls == ["ada"]
    calls.clear()
    args = make_args(methods="fusion,phase,adacof", method="fusion")
    w = pt_cli._load_weights(args)
    assert kinds(w) == ("PhaseNetCore", "AdaCoFNet", "FusionNet")
    assert sorted(calls) == ["ada", "fus", "pha"]
    assert (args.fusion_variant, args.fusion_maps) == (0, 3)
    assert all(not m.training for m in w)
    calls.clear()  # baseline = spectral split of phase+adacof, no FusionNet
    w = pt_cli._load_weights(make_args(method="baseline"))
    assert kinds(w) == ("PhaseNetCore", "AdaCoFNet", None)
    # the reference's file names pick the head: 'phase' -> variant 1, 'nouncertainty' -> 0 maps
    for name, want in (("fusion_net_phase.pt", (1, 3)), ("fusion_net_nouncertainty.pt", (0, 0))):
        args = make_args(method="adacof", fusion_checkpoint=name)
        pt_cli._load_weights(args)
        assert (args.fusion_variant, args.fusion_maps) == want


def test_config_helpers_match_jax(tmp_path):
    argv = ["--adacof.kernel_size", "11", "--train.lr", "0.5", "--eval.test_sets", "a,b"]
    cfgs = []
    for mod in (jx_config, pt_config):
        parser = __import__("argparse").ArgumentParser()
        mod.add_to_parser(parser)
        cfg = mod.from_args(parser.parse_args(argv))
        mod.save(cfg, str(tmp_path / mod.__name__ / "config.json"))
        assert mod.load(str(tmp_path / mod.__name__ / "config.json")) == cfg
        cfgs.append((tmp_path / mod.__name__ / "config.json").read_text())
    assert cfgs[0] == cfgs[1] and '"kernel_size": 11' in cfgs[1]


def test_registry_builds_each_family_and_a_dotted_path(tmp_path, monkeypatch):
    assert isinstance(registry.get_model("adacof", kernel_size=5), AdaCoFNet)
    phase = registry.get_model("phase_net", num_img=3)
    assert isinstance(phase, PhaseNetCore) and phase.num_img == 3
    fusion = registry.get_model("fusion_net", uncertainty_maps=0)
    assert isinstance(fusion, FusionNet) and fusion.uncertainty_maps == 0
    assert isinstance(registry.get_model("discriminator", gan_type="WGAN"), Discriminator)
    pkg = tmp_path / "user_models"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "net.py").write_text("def make_model(**kw):\n    return ('made', kw)\n")
    (pkg / "bare.py").write_text("")
    monkeypatch.syspath_prepend(str(tmp_path))
    assert registry.get_model("user_models.net", kernel_size=7) == ("made", {"kernel_size": 7})
    with pytest.raises(AttributeError):
        registry.get_model("user_models.bare")
    with pytest.raises(KeyError):
        registry.get_model("nope")
    with pytest.raises(ValueError):
        registry.get_model("phase_net", nbands=6)


@pytest.mark.parametrize("method", ["adacof", "phase", "fusion"])
def test_interpolate_matches_jax_cli(inputs, jax_out, method):
    out = _run_port(inputs, f"interpolate_{method}")
    names = sorted(os.listdir(jax_out / f"interp_{method}"))
    assert names == (["adacof.png", "baseline.png", "out.png", "phase.png"]
                     if method == "fusion" else ["out.png"])
    assert sorted(os.listdir(out / f"interp_{method}")) == names
    for n in names:
        _within_lsb(out / f"interp_{method}" / n, jax_out / f"interp_{method}" / n)


def test_interpolate_writes_the_format_its_extension_names(inputs, tmp_path):
    """--output_frame out.jpg writes what cv2.imwrite writes of the same
    pixels (JAX's writer: a JPEG at quality 95), not a PNG."""
    pair = ["--first_frame", str(inputs / "a.png"), "--second_frame", str(inputs / "b.png"),
            "--method", "adacof", "--device", "cpu"]
    for ext in ("png", "jpg"):
        pt_cli.main(["interpolate", *pair, "--output_frame", str(tmp_path / f"out.{ext}")])
    assert cv2.imwrite(str(tmp_path / "ref.jpg"), cv2.imread(str(tmp_path / "out.png")))
    assert (tmp_path / "out.jpg").read_bytes() == (tmp_path / "ref.jpg").read_bytes()
    with pytest.raises(NotImplementedError, match="bmp"):
        pt_cli.main(["interpolate", *pair, "--output_frame", str(tmp_path / "out.bmp")])


@pytest.mark.parametrize("mode,n_out", [("per_pair", 7), ("factor4", 13), ("batch2", 7),
                                        ("stream", 7)])
def test_video_matches_jax_cli(inputs, jax_out, mode, n_out):
    out = _run_port(inputs, f"video_{mode}")
    names = sorted(os.listdir(jax_out / f"video_{mode}"))
    assert names == [f"{i:05d}.png" for i in range(n_out)]
    assert sorted(os.listdir(out / f"video_{mode}")) == names
    for n in names:
        _within_lsb(out / f"video_{mode}" / n, jax_out / f"video_{mode}" / n)
    # the originals come back as they went in
    step = (n_out - 1) // 3
    for i, src in enumerate(sorted(os.listdir(inputs / "clip"))):
        np.testing.assert_array_equal(cv2.imread(str(out / f"video_{mode}" / names[step * i])),
                                      cv2.imread(str(inputs / "clip" / src)))


def test_video_on_jpeg_frames_matches_jax_cli(inputs, jax_out):
    """Per pair on the clip written as JPEGs: the frames decode as cv2
    decodes them, so every PNG is within 1 LSB of JAX's and the originals
    come back as cv2 reads the JPEGs."""
    out = _run_port(inputs, "video_jpeg")
    names = sorted(os.listdir(jax_out / "video_jpeg"))
    assert names == [f"{i:05d}.png" for i in range(7)]
    assert sorted(os.listdir(out / "video_jpeg")) == names
    for n in names:
        _within_lsb(out / "video_jpeg" / n, jax_out / "video_jpeg" / n)
    for i, src in enumerate(sorted(os.listdir(inputs / "clip_jpg"))):
        np.testing.assert_array_equal(cv2.imread(str(out / "video_jpeg" / names[2 * i])),
                                      cv2.imread(str(inputs / "clip_jpg" / src)))


def test_evaluate_middlebury_matches_jax_cli(inputs, jax_out):
    out = _run_port(inputs, "evaluate_middlebury")
    name = "result_middlebury_fusion.json"
    ours = json.loads((out / "eval_middlebury" / name).read_text())
    ref = json.loads((jax_out / "eval_middlebury" / name).read_text())
    assert list(ours) == list(ref) == ["Dimetrodon", "Venus", "average"]
    for scene in ref:
        assert abs(ours[scene]["psnr"] - ref[scene]["psnr"]) <= EVAL_DB, scene
    for scene in ("Dimetrodon", "Venus"):
        _within_lsb(out / "eval_middlebury" / "middlebury_fusion" / scene / "output.png",
                    jax_out / "eval_middlebury" / "middlebury_fusion" / scene / "output.png")


def test_evaluate_synthetic_matches_jax_cli(inputs, jax_out):
    out = _run_port(inputs, "evaluate_synthetic")
    chart = cv2.imread(str(out / "eval_synthetic" / "results.png"))
    ref_chart = cv2.imread(str(jax_out / "eval_synthetic" / "results.png"))
    assert chart.shape == ref_chart.shape == (440, 1320, 3)  # psnr and ssim
    for d in (out, jax_out):
        names = os.listdir(d / "eval_synthetic")
        assert "translation.avi" in names and "panels_translation" in names
    ours = json.loads((out / "eval_synthetic" / "summary.json").read_text())
    ref = json.loads((jax_out / "eval_synthetic" / "summary.json").read_text())
    assert sorted(ours) == sorted(ref) and len(ref) == 8
    for k in ref:
        assert abs(ours[k]["fusion"]["psnr"] - ref[k]["fusion"]["psnr"]) <= EVAL_DB, k


def _seeded_vgg16(path):
    """A torchvision-format vgg16 `features.*` state dict from seed 0."""
    gen = torch.Generator().manual_seed(0)
    sd, idx, cin = {}, 0, 3
    for v in [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512]:
        if v == "M":
            idx += 1
            continue
        sd[f"features.{idx}.weight"] = torch.randn(v, cin, 3, 3, generator=gen) * (
            2.0 / (9 * cin)) ** 0.5
        sd[f"features.{idx}.bias"] = torch.zeros(v)
        cin, idx = v, idx + 2
    torch.save(sd, path)
    return str(path)


TRAIN_CASES = {
    "adacof": ["--regime", "adacof"],
    "adacof_vgg_gan": ["--regime", "adacof", "--loss",
                       "1*Charb+0.01*g_Spatial+0.005*g_Occlusion+0.01*VGG+0.005*T_WGAN_GP"],
    "phase": ["--regime", "phase"],
    "phase_fusion_m": ["--regime", "phase", "--mode", "fusion", "--model_variant", "1",
                       "--m", "3", "--m_update", "1"],
    "phase_high_level": ["--regime", "phase", "--high_level"],
    "fusion": ["--regime", "fusion"],
}


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_train_runs_each_regime(inputs, monkeypatch, case):
    """Two steps through fit on the Vimeo90k layout: finite losses, a
    checkpoint at step 2, config.json as JAX's train writes it.  Each
    regime, the adacof one also with the VGG and T_WGAN_GP terms, the phase
    one also in mode fusion with the m schedule and with high_level."""
    regime = TRAIN_CASES[case][1]
    from fmvfi_tpu_torch.train import loop

    losses = []
    real_fit = loop.fit

    def recording(step_fn):
        def step(s, b):
            s, m = step_fn(s, b)
            losses.append(float(m["loss"]))
            return s, m
        return step

    def recording_fit(state, step_fn, batches, out_dir, make_step=None, **kw):
        if make_step is not None:  # the m schedule builds the steps fit runs
            kw["make_step"] = lambda m: recording(make_step(m))
        return real_fit(state, recording(step_fn), batches, out_dir, **kw)

    monkeypatch.setattr(loop, "fit", recording_fit)
    out = inputs / "train" / case
    if "VGG" in " ".join(TRAIN_CASES[case]):
        TRAIN_CASES[case] += ["--vgg_checkpoint", _seeded_vgg16(inputs / "vgg16.pth")]
    argv = ["train", *TRAIN_CASES[case], "--data_dir", str(inputs / "vimeo"), "--out_dir",
            str(out), "--epochs", "1", "--steps_per_epoch", "2", "--batch_size", "2",
            "--crop", str(SIZE), "--phase_checkpoint", str(inputs / "phase_net.pt"),
            # the defaults differ (JAX's point into the reference's checkout); with
            # the demo AdaCoF, a name ending in fusion_net.pt selects the demo FusionNet
            "--fusion_checkpoint", str(inputs / "fusion_net.pt")]
    pt_cli.main(argv + ["--device", "cpu"])
    assert len(losses) == 2 and np.isfinite(losses).all(), losses
    assert sorted(os.listdir(out / "checkpoint")) and (out / "config.json").exists()

    # JAX's train writes config.json before it builds anything it trains
    # with; its trainer and loop are stood in for (their parity is held
    # elsewhere)
    import fmvfi_tpu.train.data as jx_data
    import fmvfi_tpu.train.loop as jx_loop
    import fmvfi_tpu.train.trainer as jx_trainer

    state = SimpleNamespace(step=0)
    monkeypatch.setattr(jx_trainer, "make_adacof_trainer", lambda *a, **k: (state, None))
    monkeypatch.setattr(jx_trainer, "make_phase_trainer", lambda *a, **k: (state, None, None, None))
    monkeypatch.setattr(jx_trainer, "make_fusion_trainer", lambda *a, **k: (state, None))
    monkeypatch.setattr(jx_cli, "_load_weights", lambda *a, **k: SimpleNamespace(
        phase_net=None, adacof=None))
    monkeypatch.setattr(jx_data, "batch_iterator", lambda *a, **k: iter(()))
    monkeypatch.setattr(jx_loop, "fit", lambda state, *a, **k: state)
    jax_dir = inputs / "train_jax" / case
    jx_cli.main([a if a != str(out) else str(jax_dir) for a in argv])
    ours = json.loads((out / "config.json").read_text())
    ref = json.loads((jax_dir / "config.json").read_text())
    ours["train"]["out_dir"] = ref["train"]["out_dir"]
    assert ours == ref


def test_what_is_not_ported_raises(inputs, tmp_path, monkeypatch, capsys):
    pair = ["--first_frame", str(inputs / "a.png"), "--second_frame", str(inputs / "b.png")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:  # no card, no --device cpu
        pt_cli.main(["interpolate", *pair, "--output_frame", str(tmp_path / "o.png")])
    assert e.value.code == 2 and "--device cpu" in capsys.readouterr().err
    cpu = ["--device", "cpu"]
    with pytest.raises(NotImplementedError, match="item 18.4"):
        pt_cli.main(["video", "--input", str(tmp_path / "clip.mp4"), "--output_dir",
                     str(tmp_path), *cpu])
    # since the photo sets and the JPEG reader: the photo set evaluates, under
    # JAX's set keys, and a pair of JPEG frames interpolates
    pt_cli.main(["evaluate", "--test_sets", "synthetic+photo", "--out_dir",
                 str(tmp_path / "eval"), "--dim", str(SIZE), "--max_num", "1", "--methods",
                 "adacof", *cpu])
    summary = json.loads((tmp_path / "eval" / "summary.json").read_text())
    assert list(summary) == list(jx_synthetic_sets(16, 3, include_photo=True))
    assert np.isfinite(summary["photo"]["adacof"]["psnr"])
    for name in ("a", "b"):
        cv2.imwrite(str(tmp_path / f"{name}.jpg"), cv2.imread(str(inputs / f"{name}.png")))
    pt_cli.main(["interpolate", "--first_frame", str(tmp_path / "a.jpg"), "--second_frame",
                 str(tmp_path / "b.jpg"), "--output_frame", str(tmp_path / "mid.png"),
                 "--method", "adacof", *cpu])
    assert cv2.imread(str(tmp_path / "mid.png")).shape == (SIZE, SIZE, 3)
    capsys.readouterr()
    with pytest.raises(SystemExit):  # a file that is no image
        pt_cli.main(["interpolate", "--first_frame", str(inputs / "phase_net.pt"),
                     "--second_frame", str(inputs / "b.png"), *cpu])
    assert "cannot read image" in capsys.readouterr().err
    assert pt_cli.main([]) == 1 and pt_cli.main(["bench"]) == 1
    assert sys.modules["fmvfi_tpu_torch.cli"] is pt_cli
