"""The port's file readers and writers against the JAX package's (cv2) on
the CPU, bit for bit: the five test-set adapters and load_test_set (the
layouts of tests/test_datasets.py), Vimeo90kTriplets, the frame-directory
readers and load_set, all on PNGs written with cv2; and the PNGs that
write_frame_dir, evaluate_triplets(output_dir=...) and
generate_uncertainty_maps(out_dir=...) write, decoded, against JAX's for
the same frames (JAX's x * 255 truncation included).  The readers'
`/ 255` in float32 must match too, so every float array is compared with
array_equal.
"""

import os
import shutil
from types import SimpleNamespace

import cv2
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fmvfi_tpu.eval import datasets as jx_ds
from fmvfi_tpu.eval import evaluate as jx_eval
from fmvfi_tpu.eval import uncertainty as jx_unc
from fmvfi_tpu.pipeline import video as jx_video
from fmvfi_tpu.pipeline.interpolate import FusionWeights
from fmvfi_tpu.train import data as jx_data
from fmvfi_tpu_torch.eval import datasets as pt_ds
from fmvfi_tpu_torch.eval import evaluate as pt_eval
from fmvfi_tpu_torch.eval import uncertainty as pt_unc
from fmvfi_tpu_torch.pipeline import video as pt_video
from fmvfi_tpu_torch.pipeline.interpolate import FusionModels
from fmvfi_tpu_torch.train import data as pt_data


@pytest.fixture(autouse=True)
def toolchain():
    if shutil.which("g++") is None:
        pytest.skip("no g++ on PATH: the port's PNG codec cannot be built")


def _write(path, img):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    cv2.imwrite(str(path), cv2.cvtColor((img * 255).astype(np.uint8), cv2.COLOR_RGB2BGR))


def _img(seed, h=32, w=48):
    return np.random.default_rng(seed).uniform(0, 1, (h, w, 3)).astype(np.float32)


def _decoded(path):
    return cv2.imread(str(path), cv2.IMREAD_UNCHANGED)


def _same_tree(ours, ref):
    """Equal dicts of (f1, gt, f2) triplets, arrays bit-equal (gt may be None)."""
    assert list(ours) == list(ref)
    for k in ref:
        for a, b in zip(ours[k], ref[k], strict=True):
            if b is None:
                assert a is None
            else:
                assert a.dtype == b.dtype == np.float32
                np.testing.assert_array_equal(a, b)


@pytest.fixture
def layouts(tmp_path):
    """Each adapter's directory layout, as tests/test_datasets.py writes it."""
    inp, gt = tmp_path / "other", tmp_path / "other-gt"
    for k, scene in enumerate(("Beanbags", "Urban2")):
        _write(inp / scene / "frame10.png", _img(1 + k))
        _write(inp / scene / "frame11.png", _img(2 + k))
        _write(gt / scene / "frame10i11.png", _img(3 + k))
    ev = tmp_path / "eval"
    _write(ev / "input" / "Backyard" / "frame10.png", _img(4))
    _write(ev / "input" / "Backyard" / "frame11.png", _img(5))
    ucf = tmp_path / "ucf"
    for scene in ("1", "2"):
        for i in range(3):
            _write(ucf / scene / f"frame{i}.png", _img(10 * int(scene) + i, 24, 40))
    vimeo = tmp_path / "vimeo_interp_test"
    os.makedirs(vimeo)
    (vimeo / "tri_testlist.txt").write_text("00001/0389\n00001/0402\n")
    for t, s in (("00001/0389", 20), ("00001/0402", 30)):
        for i in (1, 2, 3):
            _write(vimeo / "target" / t / f"im{i}.png", _img(s + i))
    return dict(inp=str(inp), gt=str(gt), ev=str(ev), ucf=str(ucf), vimeo=str(vimeo))


def test_adapters_and_load_test_set_match_jax(layouts):
    L = layouts
    _same_tree(pt_ds.middlebury_other(L["inp"], L["gt"]), jx_ds.middlebury_other(L["inp"], L["gt"]))
    _same_tree(pt_ds.davis(L["inp"], L["gt"]), jx_ds.davis(L["inp"], L["gt"]))
    _same_tree(pt_ds.middlebury_eval(L["ev"]), jx_ds.middlebury_eval(L["ev"]))
    _same_tree(pt_ds.ucf101(L["ucf"]), jx_ds.ucf101(L["ucf"]))
    for n in (None, 1):
        _same_tree(pt_ds.vimeo_interp_test(L["vimeo"], max_num=n),
                   jx_ds.vimeo_interp_test(L["vimeo"], max_num=n))
    for spec in (f"middlebury:{L['inp']}:{L['gt']}", f"davis:{L['inp']}:{L['gt']}",
                 f"middlebury_eval:{L['ev']}", f"ucf101:{L['ucf']}", f"vimeo:{L['vimeo']}"):
        _same_tree(pt_ds.load_test_set(spec, max_num=1), jx_ds.load_test_set(spec, max_num=1))
    with pytest.raises(ValueError, match="unknown test-set adapter"):
        pt_ds.load_test_set("kitti:/nowhere")


def test_vimeo90k_triplets_match_jax(tmp_path):
    root = tmp_path / "vimeo_triplet"
    for seq, clips in (("00001", ("0001", "0002")), ("00002", ("0007",))):
        for c, clip in enumerate(clips):
            for i in (1, 2, 3):
                _write(root / "sequences" / seq / clip / f"im{i}.png", _img(100 * c + i, 20, 28))
    (root / "sequences" / "readme.txt").write_text("not a sequence")
    ours, ref = pt_data.Vimeo90kTriplets(str(root)), jx_data.Vimeo90kTriplets(str(root))
    assert ours.triplets == ref.triplets and len(ours) == 3
    for i in range(len(ref)):
        u8 = ours.load_u8(i)
        assert u8.dtype == np.uint8 and u8.shape == (3, 20, 28, 3)
        np.testing.assert_array_equal(u8, ref.load_u8(i))
        for a, b in zip(ours.load(i), ref.load(i), strict=True):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    os.makedirs(tmp_path / "empty" / "sequences")
    with pytest.raises(ValueError, match="no triplets"):
        pt_data.Vimeo90kTriplets(str(tmp_path / "empty"))


def test_frame_dir_readers_and_load_set_match_jax(tmp_path):
    d = tmp_path / "frames"
    for i in (2, 0, 1, 10):
        _write(d / f"f{i:02d}.png", _img(50 + i, 16, 24))
    (d / "notes.txt").write_text("ignored")
    ref = jx_video.read_frame_dir(str(d))
    got = pt_video.read_frame_dir(str(d))
    assert got.dtype == np.float32 and got.shape == (4, 16, 24, 3)
    np.testing.assert_array_equal(got, ref)
    for a, b in zip(pt_video.iter_frame_dir(str(d)), jx_video.iter_frame_dir(str(d)), strict=True):
        assert a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pt_eval.load_set(str(d)), jx_eval.load_set(str(d)))
    ours, theirs = pt_eval.load_set(str(d), stream=True), jx_eval.load_set(str(d), stream=True)
    for _ in range(2):  # a fresh iterator per call
        np.testing.assert_array_equal(np.stack(list(ours())), np.stack(list(theirs())))
    with pytest.raises(ValueError, match="no frames"):
        pt_video.read_frame_dir(str(tmp_path))
    avc1 = _avc1_mp4(tmp_path / "clip.mp4")  # a codec the card's machine has no decoder for
    for fn in (pt_video.read_video_frames, pt_eval.load_set):
        with pytest.raises(NotImplementedError, match="'avc1'.*video decoder"):
            fn(avc1)
    with pytest.raises(NotImplementedError, match="'avc1'.*video decoder"):
        list(pt_eval.load_set(avc1, stream=True)())


def test_write_frame_dir_writes_what_jax_writes(tmp_path):
    """Frames x / 255 in float32 (which x * 255 turns back into x exactly)
    and random floats in and outside [0, 1], which JAX's writer truncates
    where rounding would differ."""
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (3, 12, 20, 3), dtype=np.uint8)
    frames = list(u8.astype(np.float32) / 255.0)
    frames.append(rng.uniform(-0.2, 1.2, (12, 20, 3)).astype(np.float32))
    np.testing.assert_array_equal(pt_video.quantize(frames[0]), u8[0])
    rounded = np.round(np.clip(frames[3], 0, 1) * 255).astype(np.uint8)
    assert (pt_video.quantize(frames[3]) != rounded).any()  # the truncation is exercised
    pt_video.write_frame_dir(str(tmp_path / "ours"), frames)
    jx_video.write_frame_dir(str(tmp_path / "jax"), frames)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "ours")) == names == [f"{i:05d}.png" for i in range(4)]
    for n in names:
        np.testing.assert_array_equal(_decoded(tmp_path / "ours" / n), _decoded(tmp_path / "jax" / n))


def _fixed_pred(a, b):
    """A prediction both sides compute exactly alike from the inputs."""
    return np.clip(0.25 * np.asarray(a, np.float32) + 0.75 * np.asarray(b, np.float32), 0, 1)


def test_evaluate_triplets_writes_what_jax_writes(tmp_path, layouts, monkeypatch):
    """The same predictions on both sides (a fixed blend of the inputs),
    so that the written PNGs and the scores hold the port's writer and
    bookkeeping, not its models."""
    monkeypatch.setattr(jx_eval, "_interp_fn", lambda *a, **k: (
        lambda x, y: jnp.asarray(_fixed_pred(x, y))))
    monkeypatch.setattr(pt_eval, "_interp_fn", lambda *a, **k: (
        lambda x, y: torch.from_numpy(_fixed_pred(x, y))))
    for spec in (f"middlebury:{layouts['inp']}:{layouts['gt']}", f"middlebury_eval:{layouts['ev']}"):
        ref = jx_eval.evaluate_triplets(jx_ds.load_test_set(spec), FusionWeights(None, None, None),
                                        "adacof", output_dir=str(tmp_path / "jax"))
        got = pt_eval.evaluate_triplets(pt_ds.load_test_set(spec), FusionModels(None, None, None),
                                        "adacof", output_dir=str(tmp_path / "ours"), device="cpu")
        assert list(got) == list(ref)
        for scene, row in ref.items():
            for k, v in row.items():
                assert got[scene][k] == pytest.approx(v, rel=1e-5, abs=1e-6), (scene, k)
    scenes = sorted(os.listdir(tmp_path / "jax"))
    assert scenes == ["Backyard", "Beanbags", "Urban2"]
    assert sorted(os.listdir(tmp_path / "ours")) == scenes
    for s in scenes:
        np.testing.assert_array_equal(_decoded(tmp_path / "ours" / s / "output.png"),
                                      _decoded(tmp_path / "jax" / s / "output.png"))


def test_generate_uncertainty_maps_writes_what_jax_writes(tmp_path, monkeypatch):
    """The same maps and frames on both sides (fusion_interpolate replaced
    by fixed arrays): grey maps and RGB frames, clipped and truncated."""
    rng = np.random.default_rng(1)
    final = rng.uniform(-0.1, 1.1, (1, 10, 14, 3)).astype(np.float32)
    parts = {k: rng.uniform(-0.1, 1.1, (1, 10, 14, 3)).astype(np.float32)
             for k in ("maps", "phase", "adacof", "baseline")}
    monkeypatch.setattr(jx_unc, "fusion_interpolate", lambda *a, **k: (final, parts))
    monkeypatch.setattr(pt_unc, "fusion_interpolate", lambda *a, **k: (
        torch.from_numpy(final), {k: torch.from_numpy(v) for k, v in parts.items()}))
    f = np.zeros((10, 14, 3), np.float32)
    ref = jx_unc.generate_uncertainty_maps(None, f, f, out_dir=str(tmp_path / "jax"), prefix="s")
    models = FusionModels(None, None, SimpleNamespace(uncertainty_maps=3))
    got = pt_unc.generate_uncertainty_maps(models, f, f, out_dir=str(tmp_path / "ours"),
                                           prefix="s", device="cpu")
    assert list(got) == list(ref)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert len(names) == 7 and sorted(os.listdir(tmp_path / "ours")) == names
    for n in names:
        a, b = _decoded(tmp_path / "ours" / n), _decoded(tmp_path / "jax" / n)
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# utils/datasets.py: the download and bootstrap helpers (no network: file://)


def test_dataset_urls_and_download_match_jax(tmp_path):
    from fmvfi_tpu.utils import datasets as jx_boot
    from fmvfi_tpu_torch.utils import datasets as pt_boot

    assert pt_boot.DATASET_URLS == jx_boot.DATASET_URLS
    src = tmp_path / "archive.bin"
    src.write_bytes(np.random.default_rng(0).bytes(3000))
    dest = tmp_path / "a" / "b" / "copy.bin"
    assert pt_boot.download(src.as_uri(), str(dest), chunk=1024) == str(dest)
    assert dest.read_bytes() == src.read_bytes()
    missing = (tmp_path / "missing.zip").as_uri()
    with pytest.raises(ConnectionError) as ours:
        pt_boot.download(missing, str(tmp_path / "x.zip"))
    with pytest.raises(ConnectionError) as ref:
        jx_boot.download(missing, str(tmp_path / "x.zip"))
    assert str(ours.value) == str(ref.value)


def test_extract_writes_what_jax_writes(tmp_path):
    import zipfile

    from fmvfi_tpu.utils import datasets as jx_boot
    from fmvfi_tpu_torch.utils import datasets as pt_boot

    archive = tmp_path / "set.zip"
    with zipfile.ZipFile(archive, "w") as z:
        z.writestr("seq/0001/im1.png", b"one")
        z.writestr("seq/0001/im2.png", b"two")
        z.writestr("list.txt", "0001\n")
    outs = [tmp_path / "ours", tmp_path / "jax"]
    assert pt_boot.extract(str(archive), str(outs[0])) == str(outs[0])
    jx_boot.extract(str(archive), str(outs[1]))
    trees = [sorted((str(p.relative_to(o)), p.read_bytes()) for p in o.rglob("*") if p.is_file())
             for o in outs]
    assert trees[0] == trees[1] and len(trees[0]) == 3


def test_bootstrap_refuses_lfs_pointers_and_video_conversion_raises(tmp_path):
    from fmvfi_tpu.utils import datasets as jx_boot
    from fmvfi_tpu_torch.utils import datasets as pt_boot

    pointers = tmp_path / "pointers"
    pointers.mkdir()
    (pointers / "Clip1.mp4").write_text("version https://git-lfs.github.com/spec/v1\n")
    with pytest.raises(ValueError, match="git-LFS pointer") as ours:
        pt_boot.bootstrap_testset(str(pointers), str(tmp_path / "out"))
    with pytest.raises(ValueError) as ref:
        jx_boot.bootstrap_testset(str(pointers), str(tmp_path / "out"))
    assert str(ours.value) == str(ref.value)
    frames = tmp_path / "frames"
    frames.mkdir()
    assert pt_boot.videos_to_images(str(frames), str(tmp_path / "o")) == {}
    clips = tmp_path / "clips"
    clips.mkdir()
    _avc1_mp4(clips / "Clip1.mp4")  # an H.264 track: no decoder on the card's machine
    _avc_mkv(tmp_path / "avc.mkv")
    for call in (lambda: pt_boot.bootstrap_testset(str(clips), str(tmp_path / "o")),
                 lambda: pt_boot.videos_to_images(str(clips), str(tmp_path / "o")),
                 lambda: pt_boot.video_to_images(str(clips / "Clip1.mp4"), str(tmp_path / "o")),
                 lambda: pt_boot.video_to_images(str(tmp_path / "avc.mkv"), str(tmp_path / "o"))):
        with pytest.raises(NotImplementedError, match="item 18.4"):
            call()


def _avc_mkv(path):
    """The committed cv2 mp4v .mkv fixture with its CodecID made V_MPEG4/ISO/AVC."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "inputs",
                       "mp4v_cv2_96x72.mkv")
    with open(src, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data.replace(b"V_MPEG4/ISO/ASP", b"V_MPEG4/ISO/AVC"))


def _avc1_mp4(path):
    """The committed cv2 mp4v fixture with its sample entry renamed avc1."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "inputs",
                       "mp4v_96x72.mp4")
    with open(src, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data.replace(b"mp4v", b"avc1", 1))
    return str(path)
