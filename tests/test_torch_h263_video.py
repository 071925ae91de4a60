"""H.263 and Sorenson Spark video (and utils/flv.py) through the port
against cv2 and JAX on the CPU.

cv2.VideoCapture decodes them with FFmpeg's h263 and flv decoders and
converts the frames to BGR24 with swscale.  The port (native/h263.cpp on
h263_common.h's mpegvideo core; utils/avi.py, utils/mp4.py and the FLV
demuxer utils/flv.py) must return cv2's frames bit for bit:
- on every committed fixture (tools/make_input_fixtures.py group h263:
  cv2.VideoWriter's H263 in AVI, 3GP and MOV, U263, FLV1 in FLV and AVI at
  even and cropped odd sides; libavcodec clips with OBMC, 4MV, GOB headers,
  DQUANT, quantisers 1-31 and pixel noise; forged Annex D, PEI, Sorenson
  format 0 (H.263's escape) and disposable pictures, and sizes of 45x37;
  the smoke's 352x288 AVI and 1080p FLV), against cv2 and the pins
  chip_smoke.py holds for the card's host;
- on seeded libavcodec clips of random sizes and settings (8 of each
  codec), against cv2;
- through JAX's read_video_frames, iter_video_frames and video_to_images,
  one fixture per container.
mp4v streams with short-header (H.263) pictures read as cv2 reads them:
FFmpeg 8's mpeg4 decoder fails such a packet and cv2 stops there.  What the
port refuses raises NotImplementedError naming ROADMAP item 18.4i (H.263+,
Intel H.263) or 18.4 (VP6 and H.264 in FLV); malformed files raise
ValueError.
"""

import hashlib
import importlib.util
import os
import struct

import cv2
import numpy as np
import pytest

import chip_smoke
from fmvfi_tpu.pipeline import video as jx_video
from fmvfi_tpu.utils import datasets as jx_data
from fmvfi_tpu_torch import native
from fmvfi_tpu_torch.pipeline import video as pt_video
from fmvfi_tpu_torch.utils import avi, datasets as pt_data, flv, mp4
from test_torch_vp9_video import assert_as_cv2, cv2_frames

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUTS = os.path.join(ROOT, chip_smoke.INPUTS_DIR)
FIXTURES = sorted(n for n in chip_smoke.INPUT_PINS if n.startswith(("h263_", "flv1_", "mp4v_short")))
_spec = importlib.util.spec_from_file_location(
    "make_input_fixtures", os.path.join(ROOT, "tools", "make_input_fixtures.py"))
TOOL = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(TOOL)
F = native.H263_FEATURES
# the sizes baseline H.263 codes (its source formats 1-5; the 16CIF one too
# large for a unit test)
H263_SIZES = ((128, 96), (176, 144), (352, 288), (704, 576))


@pytest.fixture
def toolchain():
    if not native.available():
        pytest.skip("no g++ on PATH: the native decoders cannot be built")


def packets(path):
    """(codec variant, packets) of an H.263 or Sorenson file."""
    if path.endswith(".flv"):
        return "flv1", list(flv.iter_frames(flv.open_video(path)))
    if path.endswith((".3gp", ".mov", ".mp4")):
        return "h263", list(mp4.iter_samples(mp4.open_video(path)))
    stream = avi.open_video(path)
    return stream.codec, list(avi.iter_frames(stream))


def features(path):
    variant, data = packets(path)
    dec = native.H263Decoder(variant)
    bits = 0
    for p in data:
        dec.decode(p)
        bits |= dec.features
    return bits


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_decodes_as_cv2_and_its_pin(toolchain, name):
    path = os.path.join(INPUTS, name)
    ours = assert_as_cv2(path)
    contract, digest = chip_smoke.INPUT_PINS[name]
    assert contract == "video"
    assert hashlib.sha256(np.stack(ours).tobytes()).hexdigest() == digest


def test_fixtures_are_what_they_were_made_for(toolchain):
    """The fixtures reach every feature bit h263.cpp reports but H.263's
    -128 escape (FFmpeg's h263 encoder keeps levels within 127), and each
    libavcodec or forged fixture the feature it was made for."""
    bits = 0
    for name in FIXTURES:
        if name.startswith("mp4v_"):
            continue
        b = features(os.path.join(INPUTS, name))
        bits |= b
        want = {"obmc": ["obmc"], "mv4": ["four_mv"], "gob": ["gob"], "dquant": ["dquant"],
                "annexd": ["long_vectors"], "pei": ["pei"], "disposable": ["disposable"],
                "format0": ["escape"], "still": ["skipped", "intra_in_p"]}
        for key, names in want.items():
            if f"_{key}_" in name:
                assert all(b & F[f] for f in names), (name, key)
    assert [k for k, v in F.items() if not bits & v] == ["escape_long"]
    first = packets(os.path.join(INPUTS, chip_smoke.INPUTS_FLV))[1][0]
    assert TOOL.Bitstream(first).get(17 + 5 + 8, 3) == 1  # the 1080p FLV's 16-bit size fields


def test_mp4v_short_header_pictures_end_the_stream_as_in_cv2(toolchain):
    """FFmpeg 8's mpeg4 decoder fails a packet without a VOP (a short video
    header picture; headers alone) and cv2 reads no further: the VOPs before
    it, or JAX's no-frames ValueError."""
    path = os.path.join(INPUTS, "mp4v_shortheader_176x144.avi")
    assert len(assert_as_cv2(path, 2)) == 2
    only = os.path.join(INPUTS, TOOL.H263_NO_FRAMES[0])
    assert cv2_frames(only) == []
    for reader in (pt_video.read_video_frames, jx_video.read_video_frames):
        with pytest.raises(ValueError, match="no frames decoded"):
            reader(only)
    dec = native.Mpeg4Decoder()
    with pytest.raises(native.EndOfStream, match="short video header"):
        dec.decode(list(avi.iter_frames(avi.open_video(only)))[1])


@pytest.mark.parametrize("codec", ["h263", "flv"])
def test_libavcodec_clips_decode_as_cv2(toolchain, tmp_path, codec):
    """8 seeded clips of random sizes and settings: H.263 at its source
    formats with OBMC, 4MV, GOB headers, DQUANT and quantisers 1-31; Sorenson
    at sizes 1-200 (8- and 16-bit size fields) and quantisers 1-31."""
    rng = np.random.default_rng(9100 + len(codec))
    for k in range(8):
        if codec == "h263":
            w, h = H263_SIZES[int(rng.integers(0, 3 if k < 6 else 4))]
        else:
            w, h = (int(v) for v in rng.integers(1, 201, 2))
            if k == 7:
                w, h = 264, 40  # a 16-bit size field
        q = int(rng.integers(1, 32))
        options = {"qmin": q, "qmax": q}
        if codec == "h263":
            if rng.integers(0, 2):
                options["obmc"] = 1
            if rng.integers(0, 2):
                options["flags"] = "+mv4"
            if rng.integers(0, 2):
                options["ps"] = int(rng.integers(100, 1000))
            if rng.integers(0, 2):
                del options["qmax"]
                options["scplx_mask"] = 0.3
        scene = TOOL.yuv_scene(rng, 4, h, w, step=tuple(float(v) for v in rng.uniform(-6, 6, 2)))
        data = TOOL.mpeg12_encode(scene, w, h, codec, options=options)
        if codec == "flv":
            path = str(tmp_path / f"c{k}.flv")
            TOOL.flv_file(path, data, [True] + [False] * (len(data) - 1))
        else:
            path = str(tmp_path / f"c{k}.avi")
            with TOOL.PacketAvi(path, w, h, b"H263", 15) as mux:
                for i, p in enumerate(data):
                    mux.write_packet(p, i == 0)
        assert assert_as_cv2(path, 4)[0].shape == (h, w, 3), (codec, k, options)


def test_jax_readers_equal_the_ports(toolchain, tmp_path):
    for name in ("h263_cv2_176x144.avi", "h263_cv2_128x96.3gp", "h263_cv2_176x144.mov",
                 "flv1_cv2_64x48.flv", "flv1_cv2_64x48.avi"):
        path = os.path.join(INPUTS, name)
        np.testing.assert_array_equal(pt_video.read_video_frames(path),
                                      jx_video.read_video_frames(path))
        np.testing.assert_array_equal(pt_video.read_video_frames(path, (33, 47)),
                                      jx_video.read_video_frames(path, (33, 47)))
        for a, b in zip(pt_video.iter_video_frames(path), jx_video.iter_video_frames(path)):
            np.testing.assert_array_equal(a, b)
    path = os.path.join(INPUTS, "flv1_45x37.flv")
    ours, theirs = tmp_path / "pt", tmp_path / "jx"
    assert pt_data.video_to_images(path, str(ours), resize=(64, 48)) == \
        jx_data.video_to_images(path, str(theirs), resize=(64, 48)) == 3
    for name in sorted(os.listdir(theirs)):
        np.testing.assert_array_equal(cv2.imread(str(ours / name)), cv2.imread(str(theirs / name)))


def _flv_with_codec(tmp_path, codec_id):
    """flv1_cv2_64x48.flv with every video tag's codec id rewritten."""
    data = bytearray(open(os.path.join(INPUTS, "flv1_cv2_64x48.flv"), "rb").read())
    pos = struct.unpack(">I", data[5:9])[0] + 4
    while pos + 11 <= len(data):
        n = int.from_bytes(data[pos + 1:pos + 4], "big")
        if data[pos] & 0x1F == 9:
            data[pos + 11] = (data[pos + 11] & 0xF0) | codec_id
        pos += 11 + n + 4
    path = str(tmp_path / f"codec{codec_id}.flv")
    open(path, "wb").write(bytes(data))
    return path


@pytest.mark.parametrize("codec_id,what", [(4, "VP6"), (5, "VP6 with alpha"), (7, "H.264"),
                                           (3, "screen video")])
def test_other_flv_codecs_name_item_18_4(toolchain, tmp_path, codec_id, what):
    with pytest.raises(NotImplementedError, match=f"{what} video in FLV.*item 18.4:"):
        pt_video.read_video_frames(_flv_with_codec(tmp_path, codec_id))


def test_h263_plus_and_intel_h263_name_item_18_4i(toolchain, tmp_path):
    scene = TOOL.yuv_scene(np.random.default_rng(5), 2, 96, 128)
    path = str(tmp_path / "h263p.avi")
    with TOOL.PacketAvi(path, 128, 96, b"H263", 15) as mux:
        for p in TOOL.mpeg12_encode(scene, 128, 96, "h263p", options={"qmin": 4, "qmax": 4}):
            mux.write_packet(p, True)
    with pytest.raises(NotImplementedError, match="H.263\\+ picture.*item 18.4i"):
        pt_video.read_video_frames(path)
    data = open(os.path.join(INPUTS, "h263_cv2_176x144.avi"), "rb").read()
    (tmp_path / "i263.avi").write_bytes(data.replace(b"H263", b"I263"))
    with pytest.raises(NotImplementedError, match="Intel H.263.*item 18.4i"):
        pt_video.read_video_frames(str(tmp_path / "i263.avi"))


def test_malformed_files_raise_value_error(toolchain, tmp_path):
    """A cut FLV, a wrong PreviousTagSize, an FLV without video, pictures of
    random bytes, a Sorenson picture whose format field is 2 and one cut
    short: ValueError, never a crash."""
    data = open(os.path.join(INPUTS, "flv1_cv2_64x48.flv"), "rb").read()
    cases = {"cut.flv": data[:len(data) - 100], "prev.flv": data[:-1] + b"\x07",
             "novideo.flv": data[:13]}
    for name, body in cases.items():
        (tmp_path / name).write_bytes(body)
        with pytest.raises(ValueError):
            pt_video.read_video_frames(str(tmp_path / name))
    rng = np.random.default_rng(3)
    for variant in ("h263", "flv1"):
        for _ in range(20):
            dec = native.H263Decoder(variant)
            try:
                dec.decode(rng.integers(0, 256, int(rng.integers(1, 400)), np.uint8).tobytes())
            except (ValueError, NotImplementedError):
                pass
    first = packets(os.path.join(INPUTS, "flv1_cv2_64x48.flv"))[1][0]
    bad = TOOL.Bitstream(first)
    bad.set(17, 5, 2)
    with pytest.raises(ValueError, match="format 2"):
        native.H263Decoder("flv1").decode(bad.bytes())
    with pytest.raises(ValueError):
        native.H263Decoder("flv1").decode(first[:len(first) // 2])
