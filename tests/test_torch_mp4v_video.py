"""MPEG-4 Part 2 (mp4v) video files through the port against cv2 and JAX on
the CPU.

JAX reads video through cv2.VideoCapture, whose backend here is FFmpeg:
its mpeg4 decoder into yuv420p, and swscale's conversion to BGR24 with the
chroma sited left (AVCHROMA_LOC_LEFT, which OpenCV hands to swscale).  The
port (pipeline/video.py over utils/mp4.py, utils/avi.py and
native/mpeg4.cpp) must return cv2's frames bit for bit:
- on every committed mp4v fixture of tests/data/inputs/ (cv2's .mp4, .mov
  and FMP4 .avi; the port encoder's odd-sized .avi and its .avi of 4MV,
  DQUANT, AC prediction and DC-as-TCOEF), whose digests chip_smoke.py pins
  for the card's host;
- on a seeded sweep of cv2-written clips (sizes 2-130 asked of cv2, which
  crops them to even sides; 12-17 frames of a texture sliding past the
  frame's edges; .mp4, .m4v, .mov and .avi, FourCCs mp4v, XVID, FMP4 and
  DIVX) and of clips the port's encoder writes at any size, with each of
  its coding options;
- through JAX's read_video_frames and video_to_images (1280x720 PNGs), and
  `cli video` on an mp4 matching the per-pair path.
images_to_video writes files cv2 reads with the right count, fps and size,
whose frames cv2 and the port decode alike, equal to the encoder's own
reconstruction, within 1 dB below JAX's file of the same frames.  What the
port cannot decode as cv2 does raises NotImplementedError naming it and
item 18.4: an avc1 track, a B-VOP, an interlaced VOL, a non-trivial edit
list, Xvid's user data, an H.264 track in Matroska; .mkv is written, WebM
refused.
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

import chip_smoke
from fmvfi_tpu.pipeline import video as jx_video
from fmvfi_tpu.utils import datasets as jx_data
from fmvfi_tpu_torch import cli as pt_cli
from fmvfi_tpu_torch import native
from fmvfi_tpu_torch.models.adacof import AdaCoFNet
from fmvfi_tpu_torch.pipeline.interpolate import FusionModels
from fmvfi_tpu_torch.pipeline import video as pt_video
from fmvfi_tpu_torch.utils import avi, mp4
from fmvfi_tpu_torch.utils import datasets as pt_data
from fmvfi_tpu_torch.utils.convert import load_adacof_weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUTS = os.path.join(ROOT, chip_smoke.INPUTS_DIR)
MP4V_FIXTURES = sorted(n for n in chip_smoke.INPUT_PINS if n.startswith("mp4v_"))
_spec = importlib.util.spec_from_file_location(
    "make_input_fixtures", os.path.join(ROOT, "tools", "make_input_fixtures.py"))
TOOL = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(TOOL)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def toolchain():
    if shutil.which("g++") is None:
        pytest.skip("no g++ on PATH: the native decoders cannot be built")
    assert native.available()


def cv2_frames(path):
    """cv2.VideoCapture's frames, RGB."""
    cap = cv2.VideoCapture(path)
    assert cap.getBackendName() == "FFMPEG"
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame[..., ::-1])
    cap.release()
    return frames


def assert_as_cv2(path, n=None):
    ours = list(pt_video.iter_video_frames(path))
    theirs = cv2_frames(path)
    assert len(ours) == len(theirs) and (n is None or len(ours) == n), (path, len(ours),
                                                                        len(theirs))
    for i, (a, b) in enumerate(zip(ours, theirs)):
        assert a.dtype == np.uint8 and a.shape == b.shape, (path, i, a.shape, b.shape)
        if not np.array_equal(a, b):
            raise AssertionError(f"{path} frame {i}: {int(np.abs(a.astype(int) - b).max())} "
                                 f"levels off at {int((a != b).any(-1).sum())} pixels")
    return ours


def sliding(rng, n, h, w, speed, cut=None):
    """n BGR frames of a texture moving `speed` pixels a frame past the
    frame's edges (a scene cut from frame `cut` on)."""
    scene = cv2.GaussianBlur(rng.integers(0, 256, (h + 64, w + 64, 3), np.uint8), (0, 0),
                             float(rng.uniform(0.7, 3.0)))
    v = rng.uniform(-speed, speed, 2)
    out = []
    for i in range(n):
        m = np.float32([[1, 0, 32 + v[0] * i], [0, 1, 32 + v[1] * i]])
        f = cv2.warpAffine(scene, m, (w, h), borderMode=cv2.BORDER_REPLICATE)
        out.append(255 - f[::-1] if cut is not None and i >= cut else f)
    return out


def cv2_write(path, fourcc, frames, fps=30):
    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), fps, (w, h))
    assert writer.isOpened()
    for f in frames:
        writer.write(np.ascontiguousarray(f))
    writer.release()


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


@pytest.mark.parametrize("name", MP4V_FIXTURES)
def test_fixture_decodes_as_cv2_and_to_its_pin(toolchain, name):
    path = os.path.join(INPUTS, name)
    ours = assert_as_cv2(path)
    contract, digest = chip_smoke.INPUT_PINS[name]
    assert contract == "video"
    assert hashlib.sha256(np.stack(ours).tobytes()).hexdigest() == digest


def test_fixtures_cover_the_stream_features(toolchain):
    """The cv2 fixtures hold P-VOPs of both rounding types after I-VOPs, the
    port's hold 4MV / DQUANT / AC prediction paths (read from the stream's
    own headers as the decoder parses them)."""
    track = mp4.open_video(os.path.join(INPUTS, "mp4v_96x72.mp4"))
    assert (track.width, track.height, len(track.sizes), track.fps) == (96, 72, 15, 30.0)
    assert track.keyframes == [1, 13] and track.rotation == 0
    dec = native.Mpeg4Decoder(track.config)
    kinds = []
    for sample in mp4.iter_samples(track):
        dec.decode(sample)
        kinds.append((dec.vop_type, dec.rounding))
    assert [k for k, _ in kinds] == list("IPPPPPPPPPPPIPP")
    assert {r for k, r in kinds if k == "P"} == {0, 1}
    stream = avi.open_video(os.path.join(INPUTS, "mp4v_fmp4_64x46.avi"))
    assert stream.codec == "mpeg4" and stream.strf["compression"] == b"FMP4"


SWEEP = [  # (seed, container, FourCC)
    (0, "mp4", "mp4v"), (1, "m4v", "mp4v"), (2, "mov", "mp4v"), (3, "avi", "mp4v"),
    (4, "avi", "XVID"), (5, "avi", "FMP4"), (6, "avi", "DIVX"), (7, "mp4", "mp4v"),
]


@pytest.mark.parametrize("seed,ext,fourcc", SWEEP)
def test_cv2_written_clips_decode_as_cv2(toolchain, tmp_path, seed, ext, fourcc):
    rng = np.random.default_rng(100 + seed)
    for k in range(3):
        w, h = (int(v) for v in rng.integers(2, 131, 2))
        n = int(rng.integers(12, 18))
        speed = float(rng.choice([1.0, 4.0, 12.0, 30.0]))
        cut = int(rng.integers(3, n)) if k == 2 else None
        path = str(tmp_path / f"c{k}.{ext}")
        cv2_write(path, fourcc, sliding(rng, n, h, w, speed, cut))
        frames = assert_as_cv2(path, n)
        assert frames[0].shape == (h & ~1, w & ~1, 3)  # OpenCV's writer crops to even sides


@pytest.mark.parametrize("options", [0, 1, 2, 4, 8, 15])
def test_port_encoded_clips_decode_as_cv2(toolchain, tmp_path, options):
    """Any size (odd sides take swscale's filtering routes), both containers,
    each encoder option: the decoder's 4MV, DQUANT, AC prediction (with its
    quantiser rescaling) and DC-as-TCOEF paths, against cv2."""
    rng = np.random.default_rng(options)
    for k, ext in enumerate(("avi", "mp4", "mov")):
        w, h = (int(v) for v in rng.integers(1, 100, 2))
        path = str(tmp_path / f"p{k}.{ext}")
        frames = sliding(rng, 13, h, w, 6.0, cut=9 if k == 1 else None)
        writer = (avi.Mpeg4AviWriter if ext == "avi" else mp4.Mp4Writer)(
            path, w, h, 30, quant=int(rng.integers(2, 12)), gop=int(rng.integers(4, 13)),
            options=options)
        with writer:
            for f in frames:
                writer.write(np.ascontiguousarray(f[..., ::-1]))
        assert_as_cv2(path, 13)


def test_rotation_as_cv2(toolchain, tmp_path):
    """tkhd's display matrix: cv2 turns the frames (CAP_PROP_ORIENTATION_AUTO)
    by 90, 180 or 270 degrees and leaves other angles alone."""
    src = os.path.join(INPUTS, "mp4v_96x72.mp4")
    data = open(src, "rb").read()
    at = data.index(b"tkhd") + 4 + 4 + 20 + 16  # the box body, version/flags, times, reserved
    for deg, (a, b, c, d) in {90: (0, 1, -1, 0), 180: (-1, 0, 0, -1), 270: (0, -1, 1, 0),
                              45: (1, 1, -1, 1)}.items():
        path = str(tmp_path / f"r{deg}.mp4")
        m = struct.pack(">9i", a << 16, b << 16, 0, c << 16, d << 16, 0, 0, 0, 1 << 30)
        with open(path, "wb") as f:
            f.write(data[:at] + m + data[at + 36:])
        assert mp4.open_video(path).rotation == deg
        assert assert_as_cv2(path, 15)[0].shape == ((96, 72, 3) if deg in (90, 270)
                                                     else (72, 96, 3))


def test_jax_readers_equal_the_ports(toolchain, tmp_path):
    path = os.path.join(INPUTS, "mp4v_94x70.mov")
    np.testing.assert_array_equal(pt_video.read_video_frames(path),
                                  jx_video.read_video_frames(path))
    np.testing.assert_array_equal(pt_video.read_video_frames(path, (33, 47)),
                                  jx_video.read_video_frames(path, (33, 47)))
    ours, theirs = tmp_path / "pt", tmp_path / "jx"
    assert pt_data.video_to_images(path, str(ours)) == jx_data.video_to_images(path, str(theirs))
    names = sorted(os.listdir(theirs))
    assert sorted(os.listdir(ours)) == names and len(names) == 13
    for name in names:
        a, b = cv2.imread(str(ours / name)), cv2.imread(str(theirs / name))
        assert a.shape == (720, 1280, 3)
        np.testing.assert_array_equal(a, b)
    clips = tmp_path / "clips"
    clips.mkdir()
    for name in ("mp4v_96x72.mp4", "mp4v_94x70.mov", "mp4v_fmp4_64x46.avi"):
        shutil.copy(os.path.join(INPUTS, name), clips / name)
    assert pt_data.videos_to_images(str(clips), str(tmp_path / "all"), resize=None) == \
        jx_data.videos_to_images(str(clips), str(tmp_path / "alljx"), resize=None) == \
        {"mp4v_96x72": 15, "mp4v_94x70": 13, "mp4v_fmp4_64x46": 13}


@pytest.mark.parametrize("ext", ["mp4", "m4v", "mov", "avi"])
def test_images_to_video(toolchain, tmp_path, ext):
    rng = np.random.default_rng(7)
    frames_dir = tmp_path / "frames"
    frames_dir.mkdir()
    src = sliding(rng, 14, 71, 95, 3.0)  # BGR; the writers crop to 94x70
    for i, f in enumerate(src):
        cv2.imwrite(str(frames_dir / f"{i:03d}.{'png' if i % 3 else 'jpg'}"), f)
    (frames_dir / "notes.txt").write_text("ignored")
    ours, theirs = str(tmp_path / f"ours.{ext}"), str(tmp_path / f"jax.{ext}")
    assert pt_data.images_to_video(str(frames_dir), ours) == ours
    jx_data.images_to_video(str(frames_dir), theirs)
    for path in (ours, theirs):
        cap = cv2.VideoCapture(path)
        assert (cap.get(cv2.CAP_PROP_FRAME_COUNT), cap.get(cv2.CAP_PROP_FPS),
                cap.get(cv2.CAP_PROP_FRAME_WIDTH), cap.get(cv2.CAP_PROP_FRAME_HEIGHT)) == \
            (14, 30, 94, 70)
        cap.release()
    decoded = assert_as_cv2(ours, 14)
    # the encoder's own reconstruction is what any decoder returns
    pixels = [cv2.imread(str(frames_dir / n))[:70, :94, ::-1]
              for n in sorted(os.listdir(frames_dir)) if not n.endswith(".txt")]
    enc = native.Mpeg4Encoder(94, 70, 30, mp4.QUANT, mp4.GOP, in_band=ext == "avi")
    for f, got in zip(pixels, decoded):
        enc.encode(np.ascontiguousarray(f))
        np.testing.assert_array_equal(enc.reconstruction(), got)
    ours_db = np.mean([_psnr(a, b) for a, b in zip(decoded, pixels)])
    jax_db = np.mean([_psnr(a, b) for a, b in zip(cv2_frames(theirs), pixels)])
    print(f"{ext}: port {ours_db:.2f} dB, {os.path.getsize(ours)} bytes; "
          f"JAX (cv2) {jax_db:.2f} dB, {os.path.getsize(theirs)} bytes")
    assert ours_db >= jax_db - 1.0, (ours_db, jax_db)


def test_images_to_video_refuses_what_it_cannot_write(toolchain, tmp_path):
    """No frames, and WebM (which holds no mp4v: cv2's writer opens nothing
    there) raise ValueError; a .mkv is written (utils/mkv.py)."""
    (tmp_path / "none").mkdir()
    with pytest.raises(ValueError, match="no frames"):
        pt_data.images_to_video(str(tmp_path / "none"), str(tmp_path / "v.mp4"))
    cv2.imwrite(str(tmp_path / "a.png"), np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(ValueError, match="WebM"):
        pt_data.images_to_video(str(tmp_path), str(tmp_path / "v.webm"))
    assert not (tmp_path / "v.webm").exists()
    assert len(assert_as_cv2(pt_data.images_to_video(str(tmp_path), str(tmp_path / "v.mkv")))) == 1


def _forged(tmp_path, name, edit):
    """A copy of a fixture with edit(bytes) -> bytes applied."""
    data = open(os.path.join(INPUTS, "mp4v_96x72.mp4"), "rb").read()
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(edit(data))
    return path


def _vop_type_to_b(data):
    """The second sample's VOP coded as a B-VOP (vop_coding_type 2)."""
    first = data.index(b"\x00\x00\x01\xb6")
    at = data.index(b"\x00\x00\x01\xb6", first + 4) + 4
    return data[:at] + bytes([(data[at] & 0x3F) | 0x80]) + data[at + 1:]


def _interlaced_vol(data):
    """The esds VOL's interlaced flag set (bit 76 after its start code in
    FFmpeg's and the port's VOL layout)."""
    at = data.index(b"\x00\x00\x01\x20") + 4
    buf = bytearray(data)
    buf[at + 76 // 8] |= 0x80 >> (76 % 8)
    return bytes(buf)


def _edit_from(data):
    """The edit list's media time moved to 512 (the track starting later)."""
    at = data.index(b"elst") + 4 + 4 + 4 + 4  # version/flags, count, segment duration
    return data[:at] + struct.pack(">i", 512) + data[at + 4:]


@pytest.mark.parametrize("forge,what", [
    (lambda d: d.replace(b"mp4v", b"avc1", 1), "'avc1' video track"),
    (_vop_type_to_b, "B-VOP"),
    (_interlaced_vol, "interlaced"),
    (_edit_from, "non-trivial edit list"),
    (lambda d: d.replace(b"Lavc62.28.101", b"XviD0050\0\0\0\0\0", 1), "Xvid"),
])
def test_what_the_port_refuses(toolchain, tmp_path, forge, what):
    path = _forged(tmp_path, "forged.mp4", forge)
    with pytest.raises(NotImplementedError, match=f"{what}.*item 18.4|item 18.4.*{what}"):
        list(pt_video.iter_video_frames(path))


def test_containers_are_told_by_their_bytes(toolchain, tmp_path):
    """A file is read by its bytes, as FFmpeg probes it: an MP4 named .avi
    decodes; a Matroska file of an H.264 track raises NotImplementedError;
    a bare EBML magic (cv2 decodes no frames from it), bytes of no
    container and a missing file give JAX's ValueError."""
    shutil.copy(os.path.join(INPUTS, "mp4v_96x72.mp4"), tmp_path / "named.avi")
    assert len(assert_as_cv2(str(tmp_path / "named.avi"))) == 15
    mkv_bytes = open(os.path.join(INPUTS, "mp4v_cv2_96x72.mkv"), "rb").read()
    (tmp_path / "avc.mkv").write_bytes(mkv_bytes.replace(b"V_MPEG4/ISO/ASP", b"V_MPEG4/ISO/AVC"))
    with pytest.raises(NotImplementedError, match="V_MPEG4/ISO/AVC.*item 18.4"):
        pt_video.read_video_frames(str(tmp_path / "avc.mkv"))
    (tmp_path / "m.mkv").write_bytes(b"\x1a\x45\xdf\xa3" + bytes(60))
    (tmp_path / "zeros.mp4").write_bytes(bytes(4096))
    for path in (tmp_path / "m.mkv", tmp_path / "zeros.mp4", tmp_path / "missing.mp4"):
        with pytest.raises(ValueError, match="no frames decoded"):
            pt_video.read_video_frames(str(path))
        with pytest.raises(ValueError, match="no frames decoded"):
            jx_video.read_video_frames(str(path))


def test_moov_before_mdat_and_a_64_bit_mdat(toolchain, tmp_path):
    """The fixture rewritten as a "fast start" file (moov first, stco moved
    by its length) and with a 64-bit mdat size (the free box taken into
    its header, as FFmpeg's muxer does past 4 GiB) decodes as cv2."""
    data = open(os.path.join(INPUTS, "mp4v_96x72.mp4"), "rb").read()
    boxes = {}
    pos = 0
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        boxes[kind] = data[pos:pos + n]
        pos += n
    moov = bytearray(boxes[b"moov"])
    at = moov.index(b"stco") + 4 + 4 + 4  # version/flags, entry count
    first = struct.unpack(">I", moov[at:at + 4])[0]
    moov[at:at + 4] = struct.pack(">I", first + len(moov) - len(boxes[b"free"]))
    fast = boxes[b"ftyp"] + bytes(moov) + boxes[b"mdat"]
    (tmp_path / "fast.mp4").write_bytes(fast)
    mdat = boxes[b"mdat"]
    wide = boxes[b"ftyp"] + struct.pack(">I4sQ", 1, b"mdat", len(mdat) + 8) + mdat[8:] + boxes[b"moov"]
    (tmp_path / "wide.mp4").write_bytes(wide)
    want = assert_as_cv2(os.path.join(INPUTS, "mp4v_96x72.mp4"))
    for name in ("fast.mp4", "wide.mp4"):
        got = assert_as_cv2(str(tmp_path / name), 15)
        np.testing.assert_array_equal(np.stack(got), np.stack(want))


def test_not_coded_vop_gives_no_frame_as_in_cv2(toolchain, tmp_path):
    """A VOP with vop_coded 0 yields no frame in FFmpeg, so cv2 returns one
    frame fewer; the port's count and frames follow."""
    rng = np.random.default_rng(3)
    frames = sliding(rng, 3, 32, 48, 2.0)
    path = str(tmp_path / "nc.avi")
    nc = bytes.fromhex("000001b6") + int("01" + "0" + "1" + "00001" + "1" + "0" + "0111", 2
                                         ).to_bytes(2, "big")
    with avi.Mpeg4AviWriter(path, 48, 32, 30) as writer:
        writer.write(np.ascontiguousarray(frames[0][..., ::-1]))
        writer._chunk(nc, 0)
        writer.write(np.ascontiguousarray(frames[1][..., ::-1]))
    assert len(assert_as_cv2(path)) == 2


def test_mjpg_odd_width_height_7_as_cv2(toolchain, tmp_path):
    """Q3-7: a 4:2:0 Motion-JPEG frame of odd width and height 7 (chroma
    height 4: a 2-tap vertical chroma filter, which swscale sums with
    yuv2rgb_full_1, without the rounding term) decodes as cv2 decodes it."""
    rng = np.random.default_rng(5)
    for w in (13, 33, 111):
        jpegs = [cv2.imencode(".jpg", rng.integers(0, 256, (7, w, 3), np.uint8),
                              [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                               cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420])[1].tobytes()
                 for _ in range(2)]
        path = str(tmp_path / f"h7_{w}.avi")
        TOOL.mjpg_avi(path, jpegs, w, 7)
        assert len(assert_as_cv2(path)) == 2


def test_cli_video_on_an_mp4_matches_per_pair(toolchain, tmp_path):
    rng = np.random.default_rng(11)
    frames_dir = tmp_path / "frames"
    frames_dir.mkdir()
    for i, f in enumerate(sliding(rng, 3, 64, 64, 2.0)):
        cv2.imwrite(str(frames_dir / f"{i:02d}.png"), f)
    clip = str(tmp_path / "clip.mp4")
    pt_data.images_to_video(str(frames_dir), clip)
    out = tmp_path / "out"
    pt_cli.main(["video", "--input", clip, "--output_dir", str(out), "--method", "adacof",
                 "--device", "cpu"])
    ada = AdaCoFNet().eval()
    ada.load_state_dict(load_adacof_weights(os.path.join(ROOT, "checkpoints",
                                                         "adacof_synth_demo.msgpack")))
    frames = pt_video.read_video_frames(clip)
    want = [pt_video.quantize(f) for f in pt_video.double_frame_rate(
        frames, FusionModels(None, ada, None), "adacof", device="cpu")]
    names = sorted(os.listdir(out))
    assert len(names) == len(want) == 5
    for name, w in zip(names, want):
        np.testing.assert_array_equal(cv2.imread(str(out / name))[..., ::-1], w)
