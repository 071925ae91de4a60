"""MS-MPEG4 v2 and v3 ("DivX ;-)") AVIs through the port against cv2 and
JAX on the CPU.

cv2.VideoCapture decodes them with FFmpeg's msmpeg4v2 and msmpeg4 decoders
at the AVI's size and converts the frames to BGR24 with swscale.  The port
(native/msmpeg4.cpp on h263_common.h's mpegvideo core, its tables read off
cv2's libavcodec) must return cv2's frames bit for bit:
- on every committed fixture (tools/make_input_fixtures.py group h263:
  cv2.VideoWriter's MP42, MP43 and DIV3 at even and cropped odd sides, a
  still scene that cuts to another; libavcodec clips at quantisers 1, 8
  and 31, black and white blocks (DC escapes) still and moving (x86's
  inexact unrounded half-pel averages), forged slice codes, flipflop
  rounding off, an extension FFmpeg ignores, a DIV3 AVI that says 45x37,
  a synthetic stream of DC table 0, MV table 0 and AC prediction;
  the smoke's 1080p MP43 AVI), against cv2 and the pins chip_smoke.py holds
  for the card's host;
- on seeded libavcodec clips of random sizes and quantisers (8 of each
  version), against cv2;
- through JAX's read_video_frames, iter_video_frames and video_to_images.
MS-MPEG4 v1, WMV1 and WMV2 raise NotImplementedError naming ROADMAP item
18.4i; malformed pictures raise ValueError.
"""

import hashlib
import importlib.util
import os

import cv2
import numpy as np
import pytest

import chip_smoke
from fmvfi_tpu.pipeline import video as jx_video
from fmvfi_tpu.utils import datasets as jx_data
from fmvfi_tpu_torch import native
from fmvfi_tpu_torch.pipeline import video as pt_video
from fmvfi_tpu_torch.utils import avi, datasets as pt_data
from test_torch_vp9_video import assert_as_cv2

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUTS = os.path.join(ROOT, chip_smoke.INPUTS_DIR)
FIXTURES = sorted(n for n in chip_smoke.INPUT_PINS if n.startswith(("mp42_", "mp43_", "div3_",
                                                                      "msmpeg4")))
_spec = importlib.util.spec_from_file_location(
    "make_input_fixtures", os.path.join(ROOT, "tools", "make_input_fixtures.py"))
TOOL = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(TOOL)
F = native.MSMPEG4_FEATURES


@pytest.fixture
def toolchain():
    if not native.available():
        pytest.skip("no g++ on PATH: the native decoders cannot be built")


def decoder_of(path):
    stream = avi.open_video(path)
    version = avi.MSMPEG4_FOURCCS[stream.strf["compression"].upper()]
    return (native.Msmpeg4Decoder(version, (stream.strf["width"], stream.strf["height"])),
            list(avi.iter_frames(stream)))


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_decodes_as_cv2_and_its_pin(toolchain, name):
    path = os.path.join(INPUTS, name)
    ours = assert_as_cv2(path)
    contract, digest = chip_smoke.INPUT_PINS[name]
    assert contract == "video"
    assert hashlib.sha256(np.stack(ours).tobytes()).hexdigest() == digest


def test_fixtures_are_what_they_were_made_for(toolchain):
    """The fixtures reach every feature bit msmpeg4.cpp reports, v2 and v3
    each the ones of its syntax, and each libavcodec, forged or synthetic
    fixture the feature it was made for (AC prediction, DC table 0 and MV
    table 0 only in the synthetic stream: FFmpeg's encoder writes none)."""
    bits = {2: 0, 3: 0}
    for name in FIXTURES:
        dec, data = decoder_of(os.path.join(INPUTS, name))
        b = 0
        for p in data:
            dec.decode(p)
            b |= dec.features
        version = 2 if name.startswith(("mp42", "msmpeg4v2")) else 3
        bits[version] |= b
        want = {"slices": ["slices"], "blocks": ["dc_escape"] if version == 3 else [],
                "still": ["skipped"]}
        for key, names in want.items():
            if f"_{key}_" in name:
                assert all(b & F[f] for f in names), (name, key)
        if "noflipflop" in name:
            assert not b & F["flipflop"]
        if "tables0" in name:
            assert b & F["ac_pred"] and b & F["mv_escape"]
            assert not b & (F["dc_table1"] | F["mv_table1"] | F["rl_table1"] | F["rl_table2"])
    missing = {v: [k for k, f in F.items() if not bits[v] & f] for v in bits}
    assert missing[3] == []
    assert missing[2] == ["ac_pred", "dc_escape", "flipflop", "mv_escape", "rl_table1",
                          "rl_table2", "dc_table1", "mv_table1"]


@pytest.mark.parametrize("version", [2, 3])
def test_libavcodec_clips_decode_as_cv2(toolchain, tmp_path, version):
    """8 seeded clips per version at random sizes 1-200 (even, as the AVI
    carries them, and odd) and quantisers 1-31, with still stretches."""
    rng = np.random.default_rng(9300 + version)
    codec, tag = ("msmpeg4v2", b"MP42") if version == 2 else ("msmpeg4", b"MP43")
    for k in range(8):
        w, h = (int(v) for v in rng.integers(2, 201, 2))
        q = int(rng.integers(1, 32))
        scene = TOOL.yuv_scene(rng, 5, h, w, step=tuple(float(v) for v in rng.uniform(-6, 6, 2)))
        if k % 3 == 0:
            scene[2] = scene[1]
        data = TOOL.mpeg12_encode(scene, w, h, codec, options={"qmin": q, "qmax": q,
                                                               "g": int(rng.integers(2, 6))})
        path = str(tmp_path / f"c{k}.avi")
        with TOOL.PacketAvi(path, w, h, tag, 15) as mux:
            for i, p in enumerate(data):
                mux.write_packet(p, i == 0)
        assert assert_as_cv2(path, 5)[0].shape == (h, w, 3), (version, k, w, h, q)


def test_jax_readers_equal_the_ports(toolchain, tmp_path):
    for name in ("mp42_cv2_64x48.avi", "mp43_cv2_44x36.avi", "div3_cv2_80x64.avi"):
        path = os.path.join(INPUTS, name)
        np.testing.assert_array_equal(pt_video.read_video_frames(path),
                                      jx_video.read_video_frames(path))
        np.testing.assert_array_equal(pt_video.read_video_frames(path, (33, 47)),
                                      jx_video.read_video_frames(path, (33, 47)))
        for a, b in zip(pt_video.iter_video_frames(path), jx_video.iter_video_frames(path)):
            np.testing.assert_array_equal(a, b)
    path = os.path.join(INPUTS, "msmpeg4v3_45x37.avi")
    ours, theirs = tmp_path / "pt", tmp_path / "jx"
    assert pt_data.video_to_images(path, str(ours), resize=(64, 48)) == \
        jx_data.video_to_images(path, str(theirs), resize=(64, 48)) == 3
    for name in sorted(os.listdir(theirs)):
        np.testing.assert_array_equal(cv2.imread(str(ours / name)), cv2.imread(str(theirs / name)))


@pytest.mark.parametrize("fourcc,what", [(b"MPG4", "MS-MPEG4 v1"), (b"MP41", "MS-MPEG4 v1"),
                                         (b"WMV1", "WMV1"), (b"WMV2", "WMV2")])
def test_the_familys_other_decoders_name_item_18_4i(toolchain, tmp_path, fourcc, what):
    data = open(os.path.join(INPUTS, "mp43_cv2_64x48.avi"), "rb").read()
    (tmp_path / "other.avi").write_bytes(data.replace(b"MP43", fourcc))
    with pytest.raises(NotImplementedError, match=f"{what} video.*item 18.4i"):
        pt_video.read_video_frames(str(tmp_path / "other.avi"))


def test_malformed_pictures_raise_value_error(toolchain):
    """A slice code below 0x17, more slices than rows, a picture of type 3, a
    picture too short for its macroblocks, one cut short, a P picture first,
    random bytes: ValueError (NotImplementedError for the P picture, which
    FFmpeg predicts from a grey frame), never a crash."""
    dec, data = decoder_of(os.path.join(INPUTS, "mp43_cv2_64x48.avi"))
    first = data[0]
    for slices, match in ((0, "slice code"), (30, "more slices than rows")):
        b = TOOL.Bitstream(first)
        b.set(7, 5, 0x16 + slices if slices else 0x10)
        with pytest.raises(ValueError, match=match):
            decoder_of(os.path.join(INPUTS, "mp43_cv2_64x48.avi"))[0].decode(b.bytes())
    b = TOOL.Bitstream(first)
    b.set(0, 2, 3)
    with pytest.raises(ValueError, match="type 4"):
        dec.decode(b.bytes())
    with pytest.raises(ValueError, match="too short"):
        native.Msmpeg4Decoder(3, (1920, 1080)).decode(first[:16])
    with pytest.raises(ValueError):
        dec.decode(first[:len(first) // 2])
    with pytest.raises(NotImplementedError, match="P picture before any I picture"):
        decoder_of(os.path.join(INPUTS, "mp43_cv2_64x48.avi"))[0].decode(data[1])
    rng = np.random.default_rng(4)
    for version in (2, 3):
        for _ in range(20):
            d = native.Msmpeg4Decoder(version, (int(rng.integers(1, 80)), int(rng.integers(1, 80))))
            try:
                d.decode(rng.integers(0, 256, int(rng.integers(1, 300)), np.uint8).tobytes())
            except (ValueError, NotImplementedError):
                pass
    with pytest.raises(ValueError):
        native.Msmpeg4Decoder(3, (0, 48))
    with pytest.raises(ValueError, match="no MS-MPEG4 version 1"):
        native.Msmpeg4Decoder(1, (64, 48))
