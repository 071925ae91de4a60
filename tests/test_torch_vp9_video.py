"""VP9 video in WebM, Matroska, MP4 and AVI files through the port against
cv2 and JAX on the CPU.

JAX reads video through cv2.VideoCapture, whose backend here is FFmpeg:
its demuxers, its vp9 decoder (bit-exact to libvpx) into yuv420p, yuv422p,
yuv440p or yuv444p, and swscale's conversion to BGR24 with the matrix and
range the stream's colour config names.  The port (pipeline/video.py over
utils/mkv.py, mp4.py, avi.py and native/vp9.cpp) must return cv2's frames
bit for bit:
- on every committed VP9 fixture of tests/data/inputs/
  (tools/make_input_fixtures.py: cv2's VP90 in .webm, .mkv, .mp4 and .avi;
  libvpx clips coded through ctypes with hidden alt-ref frames in
  superframes and compound prediction, tile columns and tile rows,
  lossless coding, AQ modes 1-3 (segmentation, temporal segment maps),
  error-resilient coding, cpu-used 0, 5 and 8, profile 1 in 4:4:4, 4:2:2
  and 4:4:0, BT.709 at full range, BT.2020, SMPTE 240M; forged streams with
  loop filter sharpness 5, the bilinear filter and show_existing_frame
  packets; a Colour element on a VP9 track and a vpcC saying BT.709 at full
  range, which cv2 ignores), whose digests chip_smoke.py pins for the card's
  host, the fixtures together reaching every feature bit of Vp9Decoder.info;
- on 20 seeded clips coded by cv2's libvpx through ctypes (sizes 1-99,
  each sampling, two-pass alt-ref, lossless, AQ, error-resilient coding,
  cpu-used, colour config, frame-parallel or adaptive coding), muxed by the
  port's MkvMuxer, and on a superframe showing two frames;
- through JAX's read_video_frames, iter_video_frames and video_to_images on
  a VP9 file in each container, and `cli video --method fusion` on a 64x64
  WebM against JAX's `cli video` (>= 60 dB a frame, the originals exact).
What the port cannot decode as cv2 does raises NotImplementedError naming
item 18.4 (reference scaling, intra-only frames, the reserved and sRGB
colour spaces, at every bit depth); malformed streams raise ValueError.
Profiles 2 and 3 (10 and 12 bits): tests/test_torch_vp9_highbd.py.
"""

import hashlib
import importlib.util
import os

import cv2
import numpy as np
import pytest
import torch

import chip_smoke
from fmvfi_tpu import cli as jx_cli
from fmvfi_tpu.pipeline import video as jx_video
from fmvfi_tpu.utils import datasets as jx_data
from fmvfi_tpu_torch import cli as pt_cli
from fmvfi_tpu_torch import native
from fmvfi_tpu_torch.eval.synth import translation_video
from fmvfi_tpu_torch.pipeline import video as pt_video
from fmvfi_tpu_torch.utils import avi, mkv, mp4
from fmvfi_tpu_torch.utils import datasets as pt_data
from test_torch_convert import reference_phase_sd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUTS = os.path.join(ROOT, chip_smoke.INPUTS_DIR)
VP9_FIXTURES = sorted(n for n in chip_smoke.INPUT_PINS if n.startswith("vp9_"))
_spec = importlib.util.spec_from_file_location(
    "make_input_fixtures", os.path.join(ROOT, "tools", "make_input_fixtures.py"))
TOOL = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(TOOL)
PIPE_DB = 60.0
F = native.VP9_FEATURES


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def toolchain():
    if not native.available():
        pytest.skip("no g++ on PATH: the native decoders cannot be built")


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


def packets(path):
    """A VP9 file's packets, whatever its container."""
    if path.endswith((".webm", ".mkv")):
        return list(mkv.iter_samples(mkv.open_video(path)))
    if path.endswith(".mp4"):
        return list(mp4.iter_samples(mp4.open_video(path)))
    return list(avi.iter_frames(avi.open_video(path)))


def vp9_info(path):
    """(feature bits, {info key: set of values}) over a VP9 file's packets."""
    dec = native.Vp9Decoder()
    bits, seen = 0, {}
    for p in packets(path):
        dec.decode(p)
        bits |= dec.info["features"]
        for k, v in dec.info.items():
            seen.setdefault(k, set()).add(v)
    return bits, seen


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


@pytest.mark.parametrize("name", VP9_FIXTURES)
def test_fixture_decodes_as_cv2_and_to_its_pin(toolchain, name):
    path = os.path.join(INPUTS, name)
    ours = assert_as_cv2(path)
    contract, digest = chip_smoke.INPUT_PINS[name]
    assert contract == "video"
    assert hashlib.sha256(np.stack(ours).tobytes()).hexdigest() == digest


def test_fixtures_cover_every_feature_bit(toolchain):
    """The fixtures together reach every feature bit the decoder reports,
    and each reaches what it was made for (read from the frame headers as
    the decoder parses them)."""
    union, info = 0, {}
    for name in VP9_FIXTURES:
        info[name] = vp9_info(os.path.join(INPUTS, name))
        union |= info[name][0]
    assert [k for k, v in F.items() if not union & v] == []

    def has(name, *features):
        bits = info[name][0]
        missing = [f for f in features if not bits & F[f]]
        assert not missing, (name, missing)

    has("vp9_altref_45x37.webm", "superframe", "hidden", "compound", "golden_altref", "adapt",
        "prev_mvs")
    has("vp9_tilecols_520x40.webm", "tile_cols")
    has("vp9_tilerows_48x200.webm", "tile_rows")
    assert info["vp9_tilerows_48x200.webm"][1]["tile_rows_log2"] == {2}
    assert info["vp9_cv2_1080x1920.webm"][1]["tile_cols_log2"] == {2}
    has("vp9_lossless_33x17.webm", "lossless")
    for aq in ("vp9_aq1_47x35.webm", "vp9_aq2_56x40.webm", "vp9_aq3_64x48.webm"):
        has(aq, "segmentation", "seg_temporal", "seg_feature", "adapt")
    has("vp9_errres_40x24.webm", "error_resilient", "frame_parallel", "context_reset")
    has("vp9_sharpness5_48x40.webm", "sharpness")
    has("vp9_bilinear_44x36.webm", "bilinear")
    has("vp9_show_existing_42x30.webm", "show_existing")
    for name, ss in (("vp9_p1_444_45x37.webm", (0, 0)), ("vp9_p1_422_46x31.webm", (1, 0)),
                     ("vp9_p1_440_29x38.webm", (0, 1))):
        seen = info[name][1]
        assert seen["profile"] == {1} and (seen["ss_x"], seen["ss_y"]) == ({ss[0]}, {ss[1]})
    for name, cs, rng in (("vp9_bt709_full_47x35.webm", 2, 1), ("vp9_bt2020_40x30.webm", 5, 0),
                          ("vp9_smpte240_444_23x19.webm", 4, 0)):
        seen = info[name][1]
        assert (seen["color_space"], seen["color_range"]) == ({cs}, {rng}), name
    has("vp9_bt709_full_47x35.webm", "full_range")
    # the forged containers hold what they were forged with, and cv2 (and
    # the port) return the frames of the files they were forged from
    colour = open(os.path.join(INPUTS, "vp9_colour_96x72.webm"), "rb").read()
    assert b"\x55\xb0" in colour and mkv.open_video(
        os.path.join(INPUTS, "vp9_colour_96x72.webm")).codec_id == "V_VP9"
    vpcc = mp4.open_video(os.path.join(INPUTS, "vp9_vpcc_96x72.mp4"))
    assert vpcc.codec == b"vp09" and vpcc.config[4 + 2] & 1 and vpcc.config[4 + 5] == 1
    for forged, base in (("vp9_colour_96x72.webm", "vp9_cv2_96x72.webm"),
                         ("vp9_vpcc_96x72.mp4", "vp9_cv2_96x72.mp4")):
        assert chip_smoke.INPUT_PINS[forged] == chip_smoke.INPUT_PINS[base]
    assert avi.open_video(os.path.join(INPUTS, "vp9_cv2_30x28.avi")).codec == "vp9"


SWEEP = [  # (seed, encoder settings of its two clips)
    (0, dict()), (1, dict(fmt="444")), (2, dict(fmt="422")), (3, dict(fmt="440")),
    (4, dict(two_pass=True, lag=8)), (5, dict(lossless=1)),
    (6, dict(aq_mode=3, cbr=True, cpu_used=6)), (7, dict(error_resilient=True, kf_max_dist=4)),
    (8, dict(cpu_used=8, color_space=2, color_range=1)),
    (9, dict(cpu_used=0, aq_mode=1, color_space=5)),
]


@pytest.mark.parametrize("seed,settings", SWEEP)
def test_libvpx_clips_decode_as_cv2(toolchain, tmp_path, seed, settings):
    """Clips coded by cv2's libvpx at any size (odd sides take swscale's
    filtering routes) in each setting, frame-parallel or adaptive, muxed
    into WebM, against cv2."""
    rng = np.random.default_rng(900 + seed)
    for k in range(2):
        w, h = (int(v) for v in rng.integers(1, 100, 2))
        n = 10 if settings.get("two_pass") else 6
        frames = TOOL.sliding(rng, n, h, w, step=tuple(float(v) for v in rng.uniform(-6, 6, 2)))
        kw = dict(frame_parallel=int(rng.integers(0, 2)), **settings)
        kw["bitrate"] = int(rng.choice([40, 150, 600]))
        path = str(tmp_path / f"c{k}.webm")
        TOOL.vp9_webm(path, TOOL.vp9_encode(frames, **kw), w, h)
        assert assert_as_cv2(path, n)[0].shape == (h, w, 3)


def _superframe(frames):
    """Frames packed into one packet with a superframe index."""
    mag = 2
    marker = 0xC0 | ((mag - 1) << 3) | (len(frames) - 1)
    index = bytes([marker]) + b"".join(len(f).to_bytes(mag, "little") for f in frames)
    return b"".join(frames) + index + bytes([marker])


def test_a_superframe_of_two_shown_frames(toolchain, tmp_path):
    """FFmpeg splits a superframe and returns each frame it shows: two
    shown frames in one packet are two frames from cv2, and from the port."""
    rng = np.random.default_rng(5)
    frames = TOOL.sliding(rng, 6, 30, 38)
    pk = TOOL.vp9_encode(frames, bitrate=200)
    path = str(tmp_path / "two.webm")
    TOOL.vp9_webm(path, pk[:2] + [_superframe(pk[2:4])] + pk[4:], 38, 30)
    dec = native.Vp9Decoder()
    shown = []
    for p in packets(path):
        shown.append(len(dec.decode(p)))
        assert bool(dec.info["features"] & F["superframe"]) == (len(shown) == 3)
    assert shown == [1, 1, 2, 1, 1]
    assert_as_cv2(path, 6)


def test_jax_readers_equal_the_ports(toolchain, tmp_path):
    for name in ("vp9_cv2_96x72.webm", "vp9_cv2_44x36.mkv", "vp9_cv2_96x72.mp4",
                 "vp9_cv2_30x28.avi"):
        path = os.path.join(INPUTS, name)
        np.testing.assert_array_equal(pt_video.read_video_frames(path),
                                      jx_video.read_video_frames(path))
        np.testing.assert_array_equal(pt_video.read_video_frames(path, (33, 47)),
                                      jx_video.read_video_frames(path, (33, 47)))
        for a, b in zip(pt_video.iter_video_frames(path), jx_video.iter_video_frames(path)):
            np.testing.assert_array_equal(a, b)
    path = os.path.join(INPUTS, "vp9_p1_444_45x37.webm")
    ours, theirs = tmp_path / "pt", tmp_path / "jx"
    assert pt_data.video_to_images(path, str(ours), resize=(64, 48)) == \
        jx_data.video_to_images(path, str(theirs), resize=(64, 48)) == 8
    for name in sorted(os.listdir(theirs)):
        np.testing.assert_array_equal(cv2.imread(str(ours / name)), cv2.imread(str(theirs / name)))


def _forged(tmp_path, name, edit):
    """A copy of vp9_cv2_96x72.webm whose packets edit(list of bytes) changes."""
    src = os.path.join(INPUTS, "vp9_cv2_96x72.webm")
    path = str(tmp_path / name)
    TOOL.vp9_webm(path, edit(packets(src)), 96, 72)
    return path


def _clip(tmp_path, name, **kw):
    rng = np.random.default_rng(11)
    frames = TOOL.sliding(rng, 6, 36, 44)
    path = str(tmp_path / name)
    TOOL.vp9_webm(path, TOOL.vp9_encode(frames, **kw), 44, 36)
    return path


@pytest.mark.parametrize("name,make,what", [
    ("scaling10.webm", lambda t: _clip(t, "s10.webm", resize_at=(3, (30, 24)), bit_depth=10),
     "reference scaling"),
    ("srgb12.webm", lambda t: _clip(t, "rgb12.webm", fmt="444", color_space=7, bit_depth=12),
     "sRGB"),
    ("scaling.webm", lambda t: _clip(t, "s.webm", resize_at=(3, (30, 24))), "reference scaling"),
    ("intra_only.webm", lambda t: _forged(t, "io.webm", lambda pk: pk[:1] + [b"\x84\x80" + bytes(
        30)] + pk[1:]), "intra-only"),
    ("reserved.webm", lambda t: _clip(t, "r.webm", color_space=6), "reserved VP9 colour space"),
    ("srgb.webm", lambda t: _clip(t, "rgb.webm", fmt="444", color_space=7), "sRGB"),
])
def test_what_the_port_refuses(toolchain, tmp_path, name, make, what):
    path = make(tmp_path)
    with pytest.raises(NotImplementedError, match=f"{what}.*item 18.4"):
        list(pt_video.iter_video_frames(path))


def test_malformed_streams_raise_value_error(toolchain, tmp_path):
    pk = packets(os.path.join(INPUTS, "vp9_cv2_96x72.webm"))
    cases = [
        ("marker.webm", [b"\x02" + pk[0][1:]] + pk[1:], "frame marker"),
        ("sync.webm", [pk[0][:1] + b"\x00\x00\x00" + pk[0][4:]] + pk[1:], "sync code"),
        ("header.webm", [pk[0][:3]] + pk[1:], "past the frame's end"),
        ("inter_first.webm", pk[1:], "does not start with a key frame"),
        ("empty_ref.webm", [b"\x8b"] + pk, "show_existing_frame of an empty reference"),
        ("index.webm", [pk[0], pk[1] + bytes([0xC9, 0xFF, 0xFF, 0xFF, 0xFF, 0xC9])] + pk[2:],
         "superframe index past"),
    ]
    for name, data, what in cases:
        path = str(tmp_path / name)
        TOOL.vp9_webm(path, data, 96, 72)
        with pytest.raises(ValueError, match=f"frame \\d+: .*{what}"):
            list(pt_video.iter_video_frames(path))


def test_cli_video_fusion_on_a_webm_matches_jax(toolchain, tmp_path):
    """`cli video` (fusion: the bundled AdaCoF and FusionNet, a seeded
    PhaseNet) on a 3-frame 64x64 VP9 WebM against JAX's `cli video` through
    cv2 (one JAX compile): >= 60 dB a frame, the decoded originals exact."""
    clip = (translation_video(3, 64, 64, step=2.0, seed=0) * 255).astype(np.uint8)
    src = str(tmp_path / "clip.webm")
    TOOL.vp9_webm(src, TOOL.vp9_encode([np.ascontiguousarray(f[..., ::-1]) for f in clip],
                                       bitrate=2000), 64, 64)
    torch.save(reference_phase_sd(seed=0), tmp_path / "phase_net.pt")
    argv = ["video", "--input", src, "--method", "fusion", "--phase_checkpoint",
            str(tmp_path / "phase_net.pt")]
    jx_cli.main(argv + ["--output_dir", str(tmp_path / "jx")])
    pt_cli.main(argv + ["--output_dir", str(tmp_path / "pt"), "--device", "cpu"])
    names = sorted(os.listdir(tmp_path / "jx"))
    assert names == sorted(os.listdir(tmp_path / "pt")) and len(names) == 5
    decoded = cv2_frames(src)
    for i, name in enumerate(names):
        ours = cv2.imread(str(tmp_path / "pt" / name))
        theirs = cv2.imread(str(tmp_path / "jx" / name))
        if i % 2 == 0:  # the decoded originals
            np.testing.assert_array_equal(ours, theirs)
            np.testing.assert_array_equal(ours[..., ::-1], decoded[i // 2])
        assert _psnr(ours, theirs) >= PIPE_DB, (i, _psnr(ours, theirs))
