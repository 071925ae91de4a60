"""The containers and inputs the port reads since its MPEG-1/2 slice, and
those it refuses, against cv2 and JAX on the CPU.

- IVF files of VP8 and VP9, VP8 in AVI, Motion-JPEG in MOV (`jpeg`) and in
  MP4 (an `mp4v` entry of object type 0x6C) and MPEG-4 Part 2 in a
  transport stream, all as cv2.VideoWriter writes them
  (tools/make_input_fixtures.py), decode bit-equal to cv2.VideoCapture and
  to the digests chip_smoke.py pins, and equal to JAX's readers.
- Every container is told by its bytes, as FFmpeg probes it: a transport
  stream of 188- or 192-byte packets, a program stream, a raw MPEG video
  stream and an IVF file decode whatever their names.
- What cv2 reads and the port does not yet (ROADMAP Q3-8): a lone BMP,
  TIFF or PNM image or a numbered sequence of them as a video raises
  NotImplementedError naming item 18.4k (lone PNGs, JPEGs, WebPs and GIFs
  and sequences of PNGs read as JAX reads them), and PFM, JPEG 2000, Sun
  raster and Radiance HDR files through imread name item 18.11 (PNG, JPEG,
  BMP, TIFF, PNM, WebP and GIF read as cv2.imread reads them): never "no
  frames decoded" or "not a PNG file".
- Every refusal of the readers lists what the port reads from one table
  (utils/formats.py) and names its item.
"""

import hashlib
import os
import shutil
import struct

import cv2
import numpy as np
import pytest

import chip_smoke
from fmvfi_tpu.pipeline import video as jx_video
from fmvfi_tpu_torch import native
from fmvfi_tpu_torch.pipeline import video as pt_video
from fmvfi_tpu_torch.utils import formats, imageio, ivf, mpegts
from test_torch_mpeg12_video import assert_as_cv2

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUTS = os.path.join(ROOT, chip_smoke.INPUTS_DIR)
CONTAINER_FIXTURES = ("ivf_vp8_cv2_96x72.ivf", "ivf_vp9_cv2_96x72.ivf", "vp8_cv2_64x48.avi",
                      "mjpg_cv2_64x48.mov", "mjpg_cv2_64x48.mp4", "mp4v_cv2_96x72.ts")


@pytest.fixture
def toolchain():
    if not native.available():
        pytest.skip("no g++ on PATH: the native decoders cannot be built")


@pytest.mark.parametrize("name", CONTAINER_FIXTURES)
def test_fixture_decodes_as_cv2_and_to_its_pin(toolchain, name):
    path = os.path.join(INPUTS, name)
    ours = assert_as_cv2(path)
    contract, digest = chip_smoke.INPUT_PINS[name]
    assert contract == "video" and name in chip_smoke.INPUTS_MPEG_PINS
    assert hashlib.sha256(np.stack(ours).tobytes()).hexdigest() == digest
    np.testing.assert_array_equal(pt_video.read_video_frames(path),
                                  jx_video.read_video_frames(path))


def test_containers_are_told_by_their_bytes(toolchain, tmp_path):
    """Each file renamed .avi decodes as before: 188- and 192-byte transport
    stream packets, MPEG-1 and MPEG-2 pack headers, a raw stream, IVF."""
    want = {"mpeg2_cv2_94x70.ts": "ts", "mpeg2_cv2_96x72.m2ts": "ts",
            "mpeg1_cv2_96x72.mpg": "ps", "mpeg2_cv2_96x72.vob": "ps",
            "mpeg2_cv2_44x36.m2v": "es", "ivf_vp9_cv2_96x72.ivf": "ivf"}
    for name, container in want.items():
        assert pt_video._container(os.path.join(INPUTS, name)) == container
        shutil.copy(os.path.join(INPUTS, name), tmp_path / "named.avi")
        assert len(assert_as_cv2(str(tmp_path / "named.avi"))) == len(
            pt_video.read_video_frames(os.path.join(INPUTS, name)))
    with open(os.path.join(INPUTS, "mpeg2_cv2_96x72.m2ts"), "rb") as f:
        assert mpegts.ts_packet_size(f.read(960)) == 192
    with open(os.path.join(INPUTS, "mpeg1_cv2_96x72.mpg"), "rb") as f:
        assert f.read(5)[4] >> 4 == 2  # an MPEG-1 pack header
    with open(os.path.join(INPUTS, "mpeg2_cv2_96x72.vob"), "rb") as f:
        assert f.read(5)[4] >> 6 == 1  # an MPEG-2 pack header


def _images(tmp_path):
    """One file of each still format cv2.imread reads (JPEG 2000 by its
    signature: cv2 here writes none)."""
    img = np.random.default_rng(0).integers(0, 256, (12, 20, 3), np.uint8)
    paths = {}
    for ext in ("bmp", "tiff", "webp", "ppm", "ras", "pfm", "hdr", "gif", "png", "jpg"):
        path = str(tmp_path / f"x.{ext}")
        assert cv2.imwrite(path, img.astype(np.float32) / 255 if ext in ("pfm", "hdr") else img)
        paths[ext] = path
    (tmp_path / "x.jp2").write_bytes(b"\0\0\0\x0cjP  \r\n\x87\n" + bytes(40))
    paths["jp2"] = str(tmp_path / "x.jp2")
    return paths


def test_still_images_name_item_18_11(toolchain, tmp_path):
    """PNG, JPEG, BMP, TIFF, PNM, WebP and GIF files read as cv2.imread reads
    them; the formats still refused name item 18.11."""
    for ext, path in _images(tmp_path).items():
        if ext in ("png", "jpg", "bmp", "tiff", "ppm", "webp", "gif"):
            np.testing.assert_array_equal(imageio.imread(path), cv2.imread(path)[..., ::-1])
            continue
        assert ext == "jp2" or cv2.imread(path) is not None, ext
        with pytest.raises(NotImplementedError, match="image; the port reads PNG, JPEG.*TIFF, "
                                                      "WebP.*GIF images.*item 18.11") as e:
            imageio.imread(path)
        assert "not a PNG" not in str(e.value)


def test_images_and_sequences_as_video_name_item_18_4k(toolchain, tmp_path):
    """cv2.VideoCapture reads a lone image, a GIF and a printf pattern of
    frames as videos: the port reads lone PNGs, JPEGs, WebPs and GIFs and
    patterns of PNGs as JAX does, names item 18.4k for the other formats,
    an interlaced PNG (cv2's swscale converts no pixels of it) and a
    progressive JPEG, and a pattern that names no file is JAX's
    ValueError."""
    paths = _images(tmp_path)
    img = cv2.imread(paths["png"])
    for i in range(3):
        cv2.imwrite(str(tmp_path / f"{i:05d}.png"), img)
        cv2.imwrite(str(tmp_path / f"{i:05d}.bmp"), img)
    pattern = str(tmp_path / "%05d.png")
    for path in (paths["png"], paths["jpg"], paths["webp"], paths["gif"], pattern):
        np.testing.assert_array_equal(pt_video.read_video_frames(path),
                                      jx_video.read_video_frames(path))
    for path in (paths["bmp"], paths["tiff"], paths["ppm"], str(tmp_path / "%05d.bmp"), os.path.join(INPUTS, "adam7_rgb8_29x37.png"),
                 os.path.join(INPUTS, "progressive_420_61x77.jpg")):
        assert jx_video.read_video_frames(path).shape[0] >= 1, path
        with pytest.raises(NotImplementedError, match="item 18.4k") as e:
            pt_video.read_video_frames(path)
        assert "no frames decoded" not in str(e.value)
    for fn in (pt_video.read_video_frames, jx_video.read_video_frames):
        with pytest.raises(ValueError, match="no frames decoded"):
            fn(str(tmp_path / "none%03d.png"))


def _ivf_fourcc(data, fourcc):
    return data[:8] + fourcc + data[12:]


def _mp4_object_type(data, oti):
    at = data.index(b"esds") + 4 + 4  # past the full box header
    at = data.index(b"\x04", at)  # DecoderConfigDescriptor
    while data[at + 1] & 0x80:  # its size's continuation bytes
        at += 1
    return data[:at + 2] + bytes([oti]) + data[at + 3:]


@pytest.mark.parametrize("source,forge,what", [
    ("ivf_vp8_cv2_96x72.ivf", lambda d: _ivf_fourcc(d, b"AV01"), "FourCC 'AV01'"),
    ("mjpg_cv2_64x48.mp4", lambda d: _mp4_object_type(d, 0x21), "object type 0x21"),
    ("vp8_cv2_64x48.avi", lambda d: d.replace(b"VP80", b"VCR2"), "'VCR2'"),
    ("mjpg_cv2_64x48.mov", lambda d: d.replace(b"jpeg", b"mjpa", 1), "'mjpa'"),
])
def test_refusals_list_the_one_table(toolchain, tmp_path, source, forge, what):
    with open(os.path.join(INPUTS, source), "rb") as f:
        data = f.read()
    path = tmp_path / ("forged" + os.path.splitext(source)[1])
    path.write_bytes(forge(data))
    with pytest.raises(NotImplementedError, match=f"{what}.*item 18.4") as e:
        pt_video.read_video_frames(str(path))
    assert formats.reads() in str(e.value)


def test_malformed_ivf_raises_value_error(toolchain, tmp_path):
    with open(os.path.join(INPUTS, "ivf_vp8_cv2_96x72.ivf"), "rb") as f:
        data = f.read()
    first = struct.unpack("<I", data[32:36])[0]
    for name, blob, what in (("cut.ivf", data[:32 + 12 + first // 2], "cut short"),
                             ("header.ivf", data[:32 + 12 + first + 5], "header cut short")):
        (tmp_path / name).write_bytes(blob)
        with pytest.raises(ValueError, match=f"{name}.*{what}"):
            list(pt_video.iter_video_frames(str(tmp_path / name)))
    clip = ivf.open_video(os.path.join(INPUTS, "ivf_vp9_cv2_96x72.ivf"))
    assert (clip.codec, clip.width, clip.height) == ("vp9", 96, 72)
