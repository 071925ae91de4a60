"""Motion-JPEG AVI files through the port against the JAX package on the CPU.

JAX reads video through cv2.VideoCapture, whose backend here is FFmpeg
(asserted): FFmpeg's mjpeg decoder and swscale's conversion, not libjpeg.
The port's readers (pipeline/video.py over utils/avi.py and
native/mjpeg.cpp) must return JAX's frames bit for bit:
- `read_video_frames` and `iter_video_frames`, with and without `resize=`,
  on AVIs of cv2.imencode'd frames handed to the port's MjpgWriter (its
  encoder patched: no writer option exists for this) at 4:2:0,
  4:2:2, 4:4:4 and grey, at odd sizes, sizes not multiples of 16 and even
  ones (each of swscale's conversion routes), a frame without a DHT
  segment (the AVI1 convention), restart intervals; on AVIs written by
  cv2.VideoWriter(..., "MJPG", ...); on container variants FFmpeg reads
  (JUNK chunks, LIST 'rec ', no idx1, '00db' chunks);
- `load_set`, whole and stream=True, and `video_to_images` (its default
  1280x720 resize, none, and JPEG frames);
- `interpolate_video_file` on a 3-frame 64x64 clip of a translation (the
  AdaCoF offsets far under 48), adacof and fusion, with the bundled AdaCoF,
  a seeded PhaseNet and a seeded variant-0 FusionNet (JAX's default): each
  frame >= 60 dB against JAX's.
An H.264 mp4, or an AVI whose codec is none of Motion-JPEG, MPEG-4 Part
2 and VP9, raises NotImplementedError naming item 18.4.  The committed AVI fixtures of
tests/data/inputs/ (tools/make_input_fixtures.py) must decode to the
digests chip_smoke.py pins for the card's host (INPUT_PINS), which must be
those of JAX's frames.
"""

import hashlib
import importlib.util
import os
import shutil
import struct

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

import chip_smoke
from fmvfi_tpu.eval import evaluate as jx_eval
from fmvfi_tpu.models import fusion_net as jx_fusion
from fmvfi_tpu.models import phase_net as jx_phase
from fmvfi_tpu.pipeline import interpolate as jx_pipe
from fmvfi_tpu.pipeline import video as jx_video
from fmvfi_tpu.utils import datasets as jx_data
from fmvfi_tpu_torch import native
from fmvfi_tpu_torch.eval import evaluate as pt_eval
from fmvfi_tpu_torch.eval.synth import translation_video
from fmvfi_tpu_torch.models.adacof import AdaCoFNet
from fmvfi_tpu_torch.models.fusion_net import FusionNet
from fmvfi_tpu_torch.models.phase_net import PhaseNetCore
from fmvfi_tpu_torch.pipeline import interpolate as pt_pipe
from fmvfi_tpu_torch.pipeline import video as pt_video
from fmvfi_tpu_torch.utils import avi, convert
from fmvfi_tpu_torch.utils import datasets as pt_data

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "make_input_fixtures", os.path.join(ROOT, "tools", "make_input_fixtures.py"))
TOOL = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(TOOL)
ADACOF_CKPT = os.path.join(ROOT, "checkpoints", "adacof_synth_demo.msgpack")
PIPE_DB = 60.0
SAMPLINGS = {
    "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
    "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
    "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
    "grey": None,
}
# (h, w): odd and odd (bicubic chroma), odd and even (the MMX and C rows),
# even (the unscaled SIMD converter), none of them multiples of 16 but one
SIZES = [(21, 37), (31, 64), (45, 62), (90, 126), (48, 64), (17, 9), (1, 1), (3, 2)]
RESIZE = (33, 47)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """PyTorch's CPU ops in one thread while this module runs (the suite runs
    in several worker processes; their thread pools would oversubscribe the
    cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def toolchain():
    if shutil.which("g++") is None:
        pytest.skip("no g++ on PATH: the native decoders cannot be built")
    assert native.available()


def _frames_bytes(rng, h, w, sampling, n=2, restart=0, quality=None):
    out = []
    for _ in range(n):
        img = rng.integers(0, 256, (h, w, 3), np.uint8)
        if min(h, w) > 3:
            img = cv2.GaussianBlur(img, (0, 0), float(rng.uniform(0.7, 2.5)))
        if SAMPLINGS[sampling] is None:
            img = img[..., 0]
        params = [cv2.IMWRITE_JPEG_QUALITY, quality or int(rng.integers(20, 100)),
                  cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
        if SAMPLINGS[sampling] is not None:
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLINGS[sampling]]
        out.append(cv2.imencode(".jpg", img, params)[1].tobytes())
    return out


def write_mjpg(path, jpegs, w, h):
    """An AVI of the given JPEG files, written by MjpgWriter (its encoder
    patched to hand them over: tools/make_input_fixtures.py's mjpg_avi)."""
    TOOL.mjpg_avi(str(path), jpegs, w, h)
    return str(path)


def _same_as_jax(path, resize=None):
    ours = pt_video.read_video_frames(path, resize)
    theirs = jx_video.read_video_frames(path, resize)
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(ours, theirs, err_msg=f"{path} resize={resize}")
    for a, b in zip(pt_video.iter_video_frames(path, resize),
                    jx_video.iter_video_frames(path, resize), strict=True):
        assert a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)


def test_the_oracle_is_ffmpeg(toolchain, tmp_path):
    path = write_mjpg(tmp_path / "a.avi", _frames_bytes(np.random.default_rng(0), 16, 16, "420"),
                      16, 16)
    cap = cv2.VideoCapture(path)
    assert cap.isOpened() and cap.getBackendName() == "FFMPEG"
    cap.release()


@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
def test_mjpgwriter_avis_match_jax(toolchain, tmp_path, sampling):
    rng = np.random.default_rng(sorted(SAMPLINGS).index(sampling))
    for h, w in SIZES:
        path = write_mjpg(tmp_path / f"{sampling}_{h}x{w}.avi",
                          _frames_bytes(rng, h, w, sampling, restart=int(rng.integers(0, 3))),
                          w, h)
        _same_as_jax(path)
        _same_as_jax(path, RESIZE)


def test_frames_without_dht_and_the_writers_own(toolchain, tmp_path):
    """AVI1 frames (no DHT: Annex K.3's tables), also decoded as still
    images against cv2.imdecode, and MjpgWriter's own frames
    (native/jpeg_enc.cpp, quality 95)."""
    jpegs = _frames_bytes(np.random.default_rng(5), 40, 56, "420", n=3, quality=80)
    stripped = []
    for data in jpegs:  # cv2 codes with the standard tables: drop its DHT segments
        while b"\xff\xc4" in data[:data.index(b"\xff\xda")]:
            at = data.index(b"\xff\xc4")
            data = data[:at] + data[at + 2 + struct.unpack(">H", data[at + 2:at + 4])[0]:]
        stripped.append(data)
    assert all(b"\xff\xc4" not in d[:d.index(b"\xff\xda")] for d in stripped)
    _same_as_jax(write_mjpg(tmp_path / "avi1.avi", stripped, 56, 40))
    for data in stripped:  # as still images too, where libjpeg-turbo supplies the tables
        want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]
        np.testing.assert_array_equal(native.jpeg_decode(data), want)
    clip = (translation_video(3, 50, 66, step=2.0, seed=1) * 255).astype(np.uint8)
    with avi.MjpgWriter(tmp_path / "own.avi", 66, 50, fps=10) as writer:
        for frame in clip:
            writer.write(frame)
    _same_as_jax(str(tmp_path / "own.avi"))


def test_cv2_videowriter_avis_match_jax(toolchain, tmp_path):
    rng = np.random.default_rng(7)
    for w, h in [(64, 48), (100, 70), (37, 21), (130, 94)]:
        path = str(tmp_path / f"cv2_{w}x{h}.avi")
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10, (w, h))
        for _ in range(3):
            writer.write(cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), np.uint8), (0, 0), 2.0))
        writer.release()
        _same_as_jax(path)
        _same_as_jax(path, RESIZE)
    np.testing.assert_array_equal(pt_eval.load_set(path), jx_eval.load_set(path))
    np.testing.assert_array_equal(pt_eval.load_set(path, resize=RESIZE),
                                  jx_eval.load_set(path, resize=RESIZE))
    ours, theirs = pt_eval.load_set(path, stream=True), jx_eval.load_set(path, stream=True)
    for _ in range(2):  # a fresh iterator per call
        np.testing.assert_array_equal(np.stack(list(ours())), np.stack(list(theirs())))


def _rewrite(data: bytes, kind: str) -> bytes:
    """The AVI with its movi list rebuilt: JUNK chunks between the frames,
    each frame in a LIST 'rec ', or tagged '00db'; the idx1 index dropped."""
    movi = next((pos, size) for tag, k, pos, size in avi.chunks(data) if k == b"movi")
    frames = [data[pos:pos + size] for tag, _, pos, size in avi.chunks(data) if tag == b"00dc"]
    body = b"movi"
    for frame in frames:
        if kind == "junk":
            body += avi._chunk(b"JUNK", bytes(13))
        chunk = avi._chunk(b"00db" if kind == "db" else b"00dc", frame)
        body += avi._list(b"rec ", chunk) if kind == "rec" else chunk
    riff = data[12:movi[0] - 8] + b"LIST" + struct.pack("<I", len(body)) + body
    return b"RIFF" + struct.pack("<I", 4 + len(riff)) + b"AVI " + riff


@pytest.mark.parametrize("kind", ["junk", "rec", "db", "noidx"])
def test_container_variants(toolchain, tmp_path, kind):
    h, w = 30, 44
    path = write_mjpg(tmp_path / "base.avi",
                      _frames_bytes(np.random.default_rng(9), h, w, "422", n=3),
                      w, h)
    (tmp_path / f"{kind}.avi").write_bytes(_rewrite((tmp_path / "base.avi").read_bytes(), kind))
    variant = str(tmp_path / f"{kind}.avi")
    assert len(avi.read(variant).frames) == 3 and avi.read(variant).index == []
    np.testing.assert_array_equal(pt_video.read_video_frames(variant),
                                  pt_video.read_video_frames(path))
    _same_as_jax(variant)


def test_video_to_images_matches_jax(toolchain, tmp_path):
    h, w = 37, 50
    path = write_mjpg(tmp_path / "clip.avi", _frames_bytes(np.random.default_rng(11), h, w, "420"),
                      w, h)
    for kw in ({}, {"resize": None}, {"resize": (64, 36), "ext": "jpg"}):
        ours, theirs = tmp_path / f"pt{len(kw)}", tmp_path / f"jx{len(kw)}"
        assert pt_data.video_to_images(path, str(ours), **kw) == \
            jx_data.video_to_images(path, str(theirs), **kw) == 2
        assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs))
        for name in os.listdir(ours):
            np.testing.assert_array_equal(cv2.imread(str(ours / name)),
                                          cv2.imread(str(theirs / name)))
            if name.endswith(".jpg"):  # the JPEG writer is byte-equal to cv2's
                assert (ours / name).read_bytes() == (theirs / name).read_bytes()
    assert cv2.imread(str(tmp_path / "pt0" / "00000.png")).shape == (720, 1280, 3)
    clips = tmp_path / "clips"
    clips.mkdir()
    shutil.copy(path, clips / "a.avi")
    assert pt_data.videos_to_images(str(clips), str(tmp_path / "all")) == \
        jx_data.videos_to_images(str(clips), str(tmp_path / "alljx")) == {"a": 2}
    assert pt_data.bootstrap_testset(str(clips), str(tmp_path / "boot")) == {"a": 2}


def test_what_is_not_read_raises(toolchain, tmp_path):
    """An H.264 mp4 (the mp4v fixture's track renamed avc1) and an AVI of
    another codec raise NotImplementedError naming item 18.4; JPEG bytes
    under an XVID tag decode to no frame in FFmpeg's mpeg4 decoder, so the
    port gives JAX's ValueError, as for a missing file."""
    with open(os.path.join(ROOT, chip_smoke.INPUTS_DIR, "mp4v_96x72.mp4"), "rb") as f:
        (tmp_path / "clip.mp4").write_bytes(f.read().replace(b"mp4v", b"avc1", 1))
    clip = str(tmp_path / "clip.mp4")
    for call in (lambda: pt_video.read_video_frames(clip),
                 lambda: list(pt_video.iter_video_frames(clip)),
                 lambda: list(pt_eval.load_set(clip, stream=True)()),
                 lambda: pt_data.video_to_images(clip, str(tmp_path / "o"))):
        with pytest.raises(NotImplementedError, match="'avc1'.*item 18.4"):
            call()
    path = write_mjpg(tmp_path / "x.avi", _frames_bytes(np.random.default_rng(1), 8, 8, "420"),
                      8, 8)
    data = bytearray((tmp_path / "x.avi").read_bytes())
    strf = data.index(b"strf") + 8
    data[strf + 16:strf + 20] = b"H264"
    (tmp_path / "h264.avi").write_bytes(bytes(data))
    with pytest.raises(NotImplementedError, match="h264.avi.*H264.*item 18.4"):
        pt_video.read_video_frames(str(tmp_path / "h264.avi"))
    data[strf + 16:strf + 20] = b"XVID"
    (tmp_path / "xvid.avi").write_bytes(bytes(data))
    for fn in (pt_video.read_video_frames, jx_video.read_video_frames):
        with pytest.raises(ValueError, match="no frames decoded"):
            fn(str(tmp_path / "xvid.avi"))
        with pytest.raises(ValueError, match="no frames decoded"):
            fn(str(tmp_path / "missing.avi"))
    assert len(pt_video.read_video_frames(path)) == 2


@pytest.fixture(scope="module")
def weights():
    """(JAX FusionWeights, port FusionModels): the bundled AdaCoF, a
    fixed-key PhaseNet and a fixed-key variant-0 FusionNet with 3 maps."""
    with open(ADACOF_CKPT, "rb") as f:
        ada_tree = serialization.msgpack_restore(f.read())
    low, lev = jnp.zeros((1, 4, 4, 2)), [jnp.zeros((1, 4, 4, 8))] * 7
    phase_tree = jax.tree.map(np.asarray, jax.jit(
        lambda k: jx_phase.PhaseNetCore(num_img=2).init(k, low, lev, lev))(jax.random.key(0)))
    z = jnp.zeros((1, 16, 16, 3))
    fusion_tree = jax.tree.map(np.asarray, jax.jit(
        lambda k: jx_fusion.FusionNet(uncertainty_maps=3).init(
            k, z, z, z, jnp.zeros((1, 16, 16, 6)), jnp.zeros((1, 16, 16, 3)), 0))(
        jax.random.key(1)))
    jx = jx_pipe.FusionWeights(phase_net=phase_tree, adacof=ada_tree, fusion_net=fusion_tree)
    phase = PhaseNetCore().eval()
    phase.load_state_dict(convert.phase_net_from_flax(phase_tree))
    ada = AdaCoFNet().eval()
    ada.load_state_dict(convert.adacof_from_flax(ada_tree))
    fusion = FusionNet().eval()
    fusion.load_state_dict(convert.fusion_net_from_flax(fusion_tree))
    return jx, pt_pipe.FusionModels(phase, ada, fusion)


def _psnr(a, b):
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)) / 255.0 ** 2
    return float("inf") if mse == 0 else -10.0 * np.log10(mse)


@pytest.mark.parametrize("method", ["adacof", "fusion"])
def test_interpolate_video_file_matches_jax(toolchain, tmp_path, weights, method):
    jx, pt = weights
    clip = (translation_video(3, 64, 64, step=2.0, seed=0) * 255).astype(np.uint8)
    with avi.MjpgWriter(tmp_path / "clip.avi", 64, 64, fps=10) as writer:
        for frame in clip:
            writer.write(frame)
    src = str(tmp_path / "clip.avi")
    n = pt_video.interpolate_video_file(src, str(tmp_path / "pt"), pt, method, device="cpu")
    assert n == jx_video.interpolate_video_file(src, str(tmp_path / "jx"), jx, method) == 5
    for i in range(5):
        ours = cv2.imread(str(tmp_path / "pt" / f"{i:05d}.png"))
        theirs = cv2.imread(str(tmp_path / "jx" / f"{i:05d}.png"))
        if i % 2 == 0:  # the decoded originals, quantized alike
            np.testing.assert_array_equal(ours, theirs)
        assert _psnr(ours, theirs) >= PIPE_DB, (method, i, _psnr(ours, theirs))


def test_committed_fixtures_match_the_smokes_pins(toolchain):
    names = [n for n in chip_smoke.INPUT_PINS
             if n.endswith(".avi") and not n.startswith(("mp4v_", "vp9_", "vp8_", "mpeg1_",
                                                         "mpeg2_", "lossless_", "h263_", "flv1_",
                                                         "mp42_", "mp43_", "div3_", "msmpeg4"))]
    # (the MJPG AVIs)
    assert len(names) == 4
    for name in names:
        contract, digest = chip_smoke.INPUT_PINS[name]
        path = os.path.join(ROOT, chip_smoke.INPUTS_DIR, name)
        assert contract == "video"
        want = (jx_video.read_video_frames(path) * 255).round().astype(np.uint8)
        got = np.stack(list(pt_video.iter_video_frames(path)))
        assert hashlib.sha256(want.tobytes()).hexdigest() == digest, name
        assert hashlib.sha256(got.tobytes()).hexdigest() == digest, name
