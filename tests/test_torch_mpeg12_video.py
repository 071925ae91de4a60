"""MPEG-1 and MPEG-2 video through the port against cv2 and JAX on the CPU.

JAX reads video through cv2.VideoCapture, whose backend here is FFmpeg:
its mpegts, mpeg (program stream), mpegvideo, avi, matroska and mov
demuxers, its mpeg1video / mpeg2video decoder into yuv420p, and swscale's
conversion to BGR24 (BT.601, or BT.709 where a sequence display extension
says so; MPEG-2's chroma sited left, MPEG-1's centred).  The port
(pipeline/video.py over utils/mpegts.py, avi.py, mkv.py, mp4.py and
native/mpeg12.cpp) must return cv2's frames bit for bit, in cv2's order
(B pictures at once, I and P pictures one picture late, the last at the
end of the stream):
- on every committed MPEG fixture of tests/data/inputs/
  (tools/make_input_fixtures.py: cv2's MPG2 and PIM1 writers in .mpg,
  .vob, .ts, .m2ts, .m1v / .m2v, .avi, .mkv, .mp4 and .mov; libavcodec
  clips coded through ctypes with MPEG-1 B pictures, alternate scan, table
  B.15, q_scale_type 1, intra DC precision 9-11, custom matrices and a
  quant matrix extension, field DCT and field motion, BT.709, quantiser
  changes and address escapes), whose digests chip_smoke.py pins for the
  card's host, the fixtures together reaching every feature bit of
  Mpeg12Decoder.info;
- on 12 seeded libavcodec clips of random sizes and settings;
- through JAX's read_video_frames, iter_video_frames and video_to_images,
  and `cli video --method fusion` on a 64x48 MPEG-2 transport stream
  against JAX's `cli video` (>= 60 dB a frame, the originals exact).
What the port cannot decode as cv2 does raises NotImplementedError naming
item 18.4h (field pictures, 4:2:2, D pictures, concealment vectors, an
interlaced picture, which cv2's conversion refuses) or 18.4 (H.264 in a
transport stream); malformed streams raise ValueError.
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
from fmvfi_tpu_torch.utils import datasets as pt_data
from fmvfi_tpu_torch.utils import mpegts
from test_torch_convert import reference_phase_sd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUTS = os.path.join(ROOT, chip_smoke.INPUTS_DIR)
MPEG_FIXTURES = sorted(n for n in chip_smoke.INPUT_PINS if n.startswith(("mpeg1_", "mpeg2_")))
_spec = importlib.util.spec_from_file_location(
    "make_input_fixtures", os.path.join(ROOT, "tools", "make_input_fixtures.py"))
TOOL = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(TOOL)
PIPE_DB = 60.0
F = native.MPEG12_FEATURES


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


def decoded(path):
    """(Mpeg12Decoder, [(picture type, frames let out)]) over an MPEG file's
    packets, then the flush's ("flush", frames)."""
    samples, (decode, flush), _, codec = pt_video._open(path)
    assert codec == "mpeg12"
    dec = decode.__self__
    out = []
    for p in samples:
        frames = decode(p)
        out.append((dec.info["picture"], frames))
    out.append(("flush", flush()))
    return dec, out


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


@pytest.mark.parametrize("name", MPEG_FIXTURES)
def test_fixture_decodes_as_cv2_and_to_its_pin(toolchain, name):
    path = os.path.join(INPUTS, name)
    ours = assert_as_cv2(path)
    contract, digest = chip_smoke.INPUT_PINS[name]
    assert contract == "video"
    assert hashlib.sha256(np.stack(ours).tobytes()).hexdigest() == digest
    np.testing.assert_array_equal(np.stack(ours).astype(np.float32) / 255.0,
                                  jx_video.read_video_frames(path))


def test_fixtures_cover_every_feature_bit(toolchain):
    """The fixtures together reach every feature bit the decoder reports,
    intra DC precisions 8-11, MPEG-1 and MPEG-2, and each clip made for a
    path reaches it."""
    union, dc_bits, versions, made_for = 0, set(), set(), {}
    want = {"mpeg1_bf_45x37.m1v": ["b_picture"],
            "mpeg2_scan_vlc_q_96x72.m2v": ["alternate_scan", "intra_vlc", "nonlinear_q"],
            "mpeg2_bt709_dc10_47x35.m2v": ["bt709"],
            "mpeg2_matrices_dc11_64x48.m2v": ["custom_intra", "custom_inter", "quant_ext"],
            "mpeg2_field_48x40.m2v": ["field_dct", "field_motion", "interlaced_seq"],
            "mpeg2_aq_95x71.m2v": ["quant_change"],
            "mpeg2_wide_720x48.m2v": ["mba_escape"]}
    for name in MPEG_FIXTURES:
        if "1080" in name:
            continue
        bits = 0
        samples, (decode, _), _, _ = pt_video._open(os.path.join(INPUTS, name))
        d = decode.__self__
        for p in samples:
            decode(p)
            bits |= d.info["features"]
            dc_bits.add(d.info["dc_bits"])
            versions.add(d.info["mpeg2"])
        union |= bits
        made_for[name] = bits
    missing = [k for k, v in F.items() if not union & v]
    assert not missing, missing
    assert dc_bits == {8, 9, 10, 11} and versions == {0, 1}
    for name, features in want.items():
        assert all(made_for[name] & F[f] for f in features), (name, features)


def test_display_order_and_the_flush(toolchain):
    """cv2's MPG2 writer codes B pictures: a B picture comes out at once, an I
    or P picture when the next reference arrives, the last one at the end of
    the stream; cv2's PIM1 (I and P) comes out one picture late."""
    _, out = decoded(os.path.join(INPUTS, "mpeg2_cv2_96x72.mpg"))
    types = "".join(t[0] for t, _ in out[:-1])
    assert types.startswith("IPBBPBB") and "flush" == out[-1][0]
    counts = [len(f) for _, f in out]
    assert counts[0] == 0 and all(c == 1 for c in counts[1:]), counts
    frames = [f for _, fs in out for f in fs]
    theirs = cv2_frames(os.path.join(INPUTS, "mpeg2_cv2_96x72.mpg"))
    assert len(frames) == len(theirs) == 15
    assert all(np.array_equal(a, b) for a, b in zip(frames, theirs))
    _, out = decoded(os.path.join(INPUTS, "mpeg1_cv2_44x36.m1v"))
    assert [len(f) for _, f in out] == [0] + [1] * 12


# 12 seeded clips coded by cv2's libavcodec: (seed, codec, settings)
SWEEP = [(seed, "mpeg1video" if seed % 3 == 0 else "mpeg2video", settings) for seed, settings in
         enumerate([{"bf": 0}, {"bf": 2}, {"bf": 1, "intra_vlc": 1}, {"bf": 2, "g": 5},
                    {"bf": 2, "dc": 3, "alternate_scan": 1}, {"bf": 2, "non_linear_quant": 1,
                                                              "qmax": 28},
                    {"bf": 0, "scplx_mask": 0.9}, {"bf": 2, "dc": 1, "intra_vlc": 1},
                    {"bf": 2, "flags": "+ildct+ilme"}, {"bf": 1, "g": 3},
                    {"bf": 2, "colorspace": "bt709", "color_primaries": "bt709",
                     "color_trc": "bt709"}, {"bf": 2, "b": "60k"}])]


@pytest.mark.parametrize("seed,codec,settings", SWEEP)
def test_libavcodec_clips_decode_as_cv2(toolchain, tmp_path, seed, codec, settings):
    rng = np.random.default_rng(100 + seed)
    h, w = int(rng.integers(1, 100)), int(rng.integers(1, 100))
    step = (float(rng.uniform(-5, 5)), float(rng.uniform(-5, 5)))
    mpeg1 = codec == "mpeg1video"
    settings = {k: v for k, v in settings.items()
                if not mpeg1 or k in ("bf", "g", "scplx_mask", "b")}
    es = b"".join(TOOL.mpeg12_encode(TOOL.yuv_scene(rng, 9, h, w, step=step), w, h, codec,
                                     options=settings))
    if not mpeg1:  # alternate scan and field coding make an interlaced sequence: cv2
        es = TOOL.forge_progressive(es)  # converts its pictures when they say progressive
    path = str(tmp_path / ("clip.m1v" if mpeg1 else "clip.m2v"))
    with open(path, "wb") as f:
        f.write(es)
    assert_as_cv2(path, 9)


def test_jax_readers_equal_the_ports(toolchain, tmp_path):
    for name in ("mpeg2_cv2_94x70.ts", "mpeg2_cv2_96x72.vob", "mpeg1_cv2_44x36.m1v",
                 "mpeg2_cv2_96x72.mov"):
        path = os.path.join(INPUTS, name)
        np.testing.assert_array_equal(pt_video.read_video_frames(path),
                                      jx_video.read_video_frames(path))
        np.testing.assert_array_equal(pt_video.read_video_frames(path, (33, 47)),
                                      jx_video.read_video_frames(path, (33, 47)))
        for a, b in zip(pt_video.iter_video_frames(path), jx_video.iter_video_frames(path)):
            np.testing.assert_array_equal(a, b)
    path = os.path.join(INPUTS, "mpeg2_cv2_96x72.m2ts")
    ours, theirs = tmp_path / "pt", tmp_path / "jx"
    assert pt_data.video_to_images(path, str(ours), resize=(64, 48)) == \
        jx_data.video_to_images(path, str(theirs), resize=(64, 48)) == 12
    for name in sorted(os.listdir(theirs)):
        np.testing.assert_array_equal(cv2.imread(str(ours / name)), cv2.imread(str(theirs / name)))


def _es(name="mpeg2_cv2_44x36.m2v"):
    with open(os.path.join(INPUTS, name), "rb") as f:
        return bytearray(f.read())


def _at(es, code, ext=None, nth=0):
    """The offset of the body (after 00 00 01 xx) of the nth chunk of `code`
    (an extension's id in `ext`)."""
    i, seen = -1, -1
    while True:
        i = es.index(bytes([0, 0, 1, code]), i + 1)
        if ext is None or es[i + 4] >> 4 == ext:
            seen += 1
            if seen == nth:
                return i + 4


def _field_picture(es):
    at = _at(es, 0xB5, ext=8, nth=1)  # the second picture's coding extension
    es[at + 2] = (es[at + 2] & ~3) | 1  # picture_structure: top field
    es[at + 4] &= 0x7F  # progressive_frame 0
    return es


def _chroma_422(es):
    at = _at(es, 0xB5, ext=1)
    es[at + 1] = (es[at + 1] & ~0x06) | (2 << 1)
    return es


def _d_picture(es):
    at = _at(es, 0x00, nth=1)
    es[at + 1] = (es[at + 1] & ~0x38) | (4 << 3)
    return es


def _concealment(es):
    at = _at(es, 0xB5, ext=8)
    es[at + 3] |= 0x20
    return es


def _interlaced(tmp_path):
    rng = np.random.default_rng(3)
    es = b"".join(TOOL.mpeg12_encode(TOOL.yuv_scene(rng, 4, 32, 48), 48, 32,
                                     options={"bf": 0, "flags": "+ildct+ilme"}))
    return bytearray(es)


def _h264_in_ts(data):
    at = data.index(b"\x02\xe1\x00")  # the PMT's video entry: stream type 2, PID 0x100
    data[at] = 0x1B
    return data


@pytest.mark.parametrize("name,make,what,item", [
    ("field.m2v", lambda t: _field_picture(_es()), "picture_structure 1", "18.4h"),
    ("422.m2v", lambda t: _chroma_422(_es()), "4:2:2", "18.4h"),
    ("d.m1v", lambda t: _d_picture(_es("mpeg1_cv2_44x36.m1v")), "D picture", "18.4h"),
    ("cmv.m2v", lambda t: _concealment(_es()), "concealment motion vectors", "18.4h"),
    ("interlaced.m2v", _interlaced, "interlaced MPEG-2 picture", "18.4h"),
    ("h264.ts", lambda t: _h264_in_ts(_es("mpeg2_cv2_94x70.ts")), "H.264", "18.4"),
])
def test_what_the_port_refuses(toolchain, tmp_path, name, make, what, item):
    path = tmp_path / name
    path.write_bytes(bytes(make(tmp_path)))
    with pytest.raises(NotImplementedError, match=f"{what}.*item {item}"):
        list(pt_video.iter_video_frames(str(path)))


def _ts_packets(data):
    """The offsets of the video PID's packets of a 188-byte transport stream."""
    return [i for i in range(0, len(data), 188) if (data[i + 1] & 0x1F) << 8 | data[i + 2] == 0x100]


def test_malformed_streams_raise_value_error(toolchain, tmp_path):
    ts = _es("mpeg2_cv2_94x70.ts")
    video = _ts_packets(ts)
    cc = bytearray(ts)
    cc[video[5] + 3] ^= 0x05  # a continuity counter jump
    no_start = bytearray(ts)
    first = next(i for i in video if ts[i + 1] & 0x40 and ts[i + 3] & 0x10)
    body = first + 4 + (1 + ts[first + 4] if ts[first + 3] & 0x20 else 0)
    no_start[body:body + 3] = b"\x11\x22\x33"
    es = _es()
    cut = bytes(es[:_at(es, 0x00, nth=2) + 40])  # the third picture cut inside its slices
    junk = bytearray(es)
    slice_at = _at(es, 0x01, nth=3)
    junk[slice_at + 2:slice_at + 12] = b"\xff" * 10
    ps = _es("mpeg2_cv2_96x72.mpg")
    pack = bytes(ps[:8])  # a pack header cut short
    cases = [("cc.ts", cc, "continuity counter"), ("start.ts", no_start, "start code"),
             ("cut.m2v", cut, "frame \\d+: "), ("junk.m2v", junk, "frame \\d+: "),
             ("pack.mpg", pack, "pack header cut short|no video")]
    for name, data, what in cases:
        path = tmp_path / name
        path.write_bytes(bytes(data))
        with pytest.raises(ValueError, match=what):
            list(pt_video.iter_video_frames(str(path)))
    with pytest.raises(ValueError, match="no frames decoded"):
        pt_video.read_video_frames(str(tmp_path / "missing.ts"))
    # a decoder that failed part way raises again on the next picture rather
    # than predicting from a picture it did not finish
    dec = native.Mpeg12Decoder()
    packets = [bytes(es[a:b]) for a, b in mpegts.split_mpeg12(bytes(es))]
    dec.decode(packets[0])
    with pytest.raises(ValueError):
        dec.decode(packets[1][:len(packets[1]) // 2])


def test_cli_video_fusion_on_a_ts_matches_jax(toolchain, tmp_path):
    """`cli video` (fusion: the bundled AdaCoF and FusionNet, a seeded
    PhaseNet) on a 3-frame 64x48 MPEG-2 transport stream that cv2's MPG2
    writer codes, against JAX's `cli video` through cv2 (one JAX compile):
    >= 60 dB a frame, the decoded originals exact."""
    clip = (translation_video(3, 48, 64, step=2.0, seed=0) * 255).astype(np.uint8)
    src = str(tmp_path / "clip.ts")
    TOOL.cv2_video(src, "MPG2", [np.ascontiguousarray(f[..., ::-1]) for f in clip], fps=25)
    torch.save(reference_phase_sd(seed=0), tmp_path / "phase_net.pt")
    argv = ["video", "--input", src, "--method", "fusion", "--phase_checkpoint",
            str(tmp_path / "phase_net.pt")]
    jx_cli.main(argv + ["--output_dir", str(tmp_path / "jx")])
    pt_cli.main(argv + ["--output_dir", str(tmp_path / "pt"), "--device", "cpu"])
    names = sorted(os.listdir(tmp_path / "jx"))
    assert names == sorted(os.listdir(tmp_path / "pt")) and len(names) == 5
    decoded_frames = cv2_frames(src)
    for i, name in enumerate(names):
        ours = cv2.imread(str(tmp_path / "pt" / name))
        theirs = cv2.imread(str(tmp_path / "jx" / name))
        if i % 2 == 0:  # the decoded originals
            np.testing.assert_array_equal(ours, theirs)
            np.testing.assert_array_equal(ours[..., ::-1], decoded_frames[i // 2])
        assert _psnr(ours, theirs) >= PIPE_DB, (i, _psnr(ours, theirs))
