"""The still images the port reads and writes since its stills slice,
against cv2 on the CPU (cv2 is what JAX's readers and writers call):

- every stills fixture of tests/data/inputs/ (tools/make_input_fixtures.py,
  group `stills`: BMP 1/4/8/16/24/32-bit, RLE4 / RLE8, top-down, V5 and
  OS/2 headers; PNM P1-P6, 16-bit, maxval below 255; TIFF none / LZW /
  deflate / PackBits / JPEG (YCbCr, RGB, grey, CMYK, with alpha),
  predictor 2, 1-16 bits, MinIsWhite, palettes, planar 2, tiles, RGBA,
  CMYK, MM and II; CMYK and RGB-coded JPEGs; a PNG
  and a JPEG with EXIF Orientation 6; lone PNGs and JPEGs and numbered
  sequences read as video) decodes bit-equal to cv2.imread (or to
  cv2.VideoCapture's stacked frames, and to JAX's read_video_frames) and to
  the digest chip_smoke.py pins;
- ROADMAP Q3-9: a PNG's eXIf Orientation 1-8 applied as cv2.imread applies
  it (53x37 read as 37x53 for 5-8), and not on the video route;
- imwrite's BMP, PNM and TIFF files byte-equal to cv2.imwrite's;
- a TIFF's Orientation 2-4 flips it, 5-8 raise ValueError (cv2 returns
  None), as do the bit depths cv2 refuses;
- sequences starting at 0-4 read as JAX reads them, one starting at 7 is
  JAX's ValueError;
- truncated and corrupted files raise ValueError naming the path.
"""

import hashlib
import importlib.util
import io
import os
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

import chip_smoke
from fmvfi_tpu.pipeline import video as jx_video
from fmvfi_tpu_torch import native
from fmvfi_tpu_torch.pipeline import video as pt_video
from fmvfi_tpu_torch.utils import image2, imageio, tiff

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUTS = os.path.join(ROOT, chip_smoke.INPUTS_DIR)
_spec = importlib.util.spec_from_file_location(
    "make_input_fixtures", os.path.join(ROOT, "tools", "make_input_fixtures.py"))
TOOL = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(TOOL)


@pytest.fixture
def toolchain():
    if not native.available():
        pytest.skip("no g++ on PATH: the native decoders cannot be built")


def _cv2_rgb(path):
    img = cv2.imread(str(path), cv2.IMREAD_COLOR)
    return None if img is None else img[..., ::-1]


@pytest.mark.parametrize("name", chip_smoke.INPUTS_STILL_PINS)
def test_fixture_decodes_as_cv2_and_to_its_pin(toolchain, name):
    contract, digest = chip_smoke.INPUT_PINS[name]
    path = os.path.join(INPUTS, name)
    if contract == "imread":
        ours = imageio.imread(path)
    else:
        ours = np.stack(list(pt_video.iter_video_frames(path)))
        np.testing.assert_array_equal(pt_video.read_video_frames(path),
                                      jx_video.read_video_frames(path))
    np.testing.assert_array_equal(ours, TOOL.pixels(INPUTS, name, contract))
    assert hashlib.sha256(np.ascontiguousarray(ours).tobytes()).hexdigest() == digest


def _exif_png(path, img, orientation):
    ex = Image.Exif()
    ex[274] = orientation
    Image.fromarray(img).save(path, exif=ex)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_png_exif_orientation_as_cv2(toolchain, tmp_path, orientation):
    """ROADMAP Q3-9: a 53x37 PNG with eXIf Orientation 5-8 reads 37 wide and
    53 tall, as cv2.imread turns it; FFmpeg's route leaves it as stored."""
    img = np.random.default_rng(orientation).integers(0, 256, (37, 53, 3), np.uint8)
    path = tmp_path / "o.png"
    _exif_png(path, img, orientation)
    ours = imageio.imread(path)
    assert ours.shape == ((53, 37, 3) if orientation >= 5 else (37, 53, 3))
    np.testing.assert_array_equal(ours, _cv2_rgb(path))
    assert imageio.read_raw(path).orientation == orientation
    np.testing.assert_array_equal(pt_video.read_video_frames(str(path)),
                                  jx_video.read_video_frames(str(path)))


WRITE_SHAPES = ((1, 1, 3), (5, 7, 3), (37, 53), (3, 2731, 3))


@pytest.mark.parametrize("ext", (".bmp", ".dib", ".ppm", ".pgm", ".pnm", ".tif", ".tiff"))
def test_imwrite_is_cv2s_bytes(toolchain, tmp_path, ext):
    """Each extension's bytes are cv2.imwrite's, RGB and grey; a TIFF row
    over 8192 bytes (one a strip, the LZW ratio check at work) too."""
    rng = np.random.default_rng(len(ext))
    for shape in WRITE_SHAPES:
        img = rng.integers(0, 256, shape, np.uint8)
        if len(shape) == 3 and shape[0] > 2:  # some runs for LZW to find
            img[:, : shape[1] // 2] = img[:1, : shape[1] // 2]
        path = tmp_path / f"w{ext}"
        bgr = img if img.ndim == 2 else np.ascontiguousarray(img[..., ::-1])
        ok, ref = cv2.imencode(ext, bgr)
        if (ext == ".ppm" and img.ndim == 2) or (ext == ".pgm" and img.ndim == 3):
            assert not cv2.imwrite(str(tmp_path / f"ref{ext}"), bgr)
            with pytest.raises(ValueError, match=ext):
                imageio.imwrite(path, img)
            continue
        imageio.imwrite(path, img)
        assert ok and path.read_bytes() == ref.tobytes(), (ext, shape)
        want = img if img.ndim == 3 else np.repeat(img[..., None], 3, axis=2)
        np.testing.assert_array_equal(imageio.imread(path), want)


def _tiff(orientation=None, bits=8, photometric=2, spp=3):
    tags = {256: (3, [6]), 257: (3, [4]), 258: (3, [bits] * spp), 259: (3, [1]),
            262: (3, [photometric]), 277: (3, [spp]), 278: (3, [4])}
    if orientation:
        tags[274] = (3, [orientation])
    px = np.random.default_rng(bits).integers(0, 256, 4 * ((6 * spp * bits + 7) // 8), np.uint8)
    return TOOL.tiff_file(tags, [px.tobytes()])


@pytest.mark.parametrize("orientation", range(1, 9))
def test_tiff_orientation_as_cv2(toolchain, tmp_path, orientation):
    path = tmp_path / "o.tif"
    path.write_bytes(_tiff(orientation))
    ref = _cv2_rgb(path)
    if orientation >= 5:
        assert ref is None
        with pytest.raises(ValueError, match=f"o.tif.*Orientation {orientation}"):
            imageio.imread(path)
    else:
        np.testing.assert_array_equal(imageio.imread(path), ref)


def test_what_cv2_refuses_or_the_port_lacks(toolchain, tmp_path):
    """2-bit grey and 4-bit grey TIFFs (cv2: None) raise ValueError; a
    YCbCr TIFF that is not JPEG-compressed, which cv2 reads, names item
    18.11 (a JPEG-compressed one reads: the fixtures)."""
    for bits in (2, 4):
        path = tmp_path / f"g{bits}.tif"
        path.write_bytes(_tiff(bits=bits, photometric=1, spp=1))
        assert _cv2_rgb(path) is None
        with pytest.raises(ValueError, match=f"g{bits}.tif"):
            imageio.imread(path)
    img = Image.fromarray(np.random.default_rng(0).integers(0, 256, (16, 16, 3), np.uint8))
    for name, kw in (("y.tif", dict()), ("y_lzw.tif", dict(compression="tiff_lzw"))):
        img.convert("YCbCr").save(tmp_path / name, **kw)
        assert _cv2_rgb(tmp_path / name) is not None
        with pytest.raises(NotImplementedError, match="YCbCr TIFF.*item 18.11"):
            imageio.imread(tmp_path / name)


@pytest.mark.parametrize("start", range(5))
def test_sequences_start_at_0_to_4(toolchain, tmp_path, start):
    rng = np.random.default_rng(start)
    for i in range(start, start + 2):
        cv2.imwrite(str(tmp_path / f"f{i:04d}.png"), rng.integers(0, 256, (6, 9, 3), np.uint8))
    cv2.imwrite(str(tmp_path / f"f{start + 3:04d}.png"), rng.integers(0, 256, (6, 9, 3), np.uint8))
    pattern = str(tmp_path / "f%04d.png")  # a gap after two frames: two frames read
    ours = pt_video.read_video_frames(pattern)
    assert ours.shape[0] == 2
    np.testing.assert_array_equal(ours, jx_video.read_video_frames(pattern))
    assert image2.frame_filename("a%%_%3d.png", 7) == "a%_007.png"
    assert image2.frame_filename("a%d_%d.png", 7) is None


def test_a_sequence_starting_at_7_is_jaxs_value_error(toolchain, tmp_path):
    for i in range(7, 10):
        cv2.imwrite(str(tmp_path / f"{i:03d}.png"), np.zeros((4, 4, 3), np.uint8))
    for fn in (pt_video.read_video_frames, jx_video.read_video_frames):
        with pytest.raises(ValueError, match="no frames decoded"):
            fn(str(tmp_path / "%03d.png"))


BROKEN = ("bmp_rle8_40x30.bmp", "bmp_rle4_40x30.bmp", "bmp_cv2_24_37x53.bmp",
          "pnm_p3_23x17.ppm", "pnm_cv2_p6_37x53.ppm", "tiff_lzw_29x31.tif",
          "tiff_packbits_29x31.tif", "tiff_deflate_29x31.tif", "tiff_planar2_29x31.tif",
          "jpeg_cmyk_29x31.jpg")


@pytest.mark.parametrize("name", BROKEN)
def test_truncated_and_corrupted_files_raise(toolchain, tmp_path, name):
    """Cut short: ValueError naming the path.  With bits of the pixel data
    flipped (BMP, PNM, TIFF): ValueError naming the path, or, where cv2
    reads through the corruption, cv2's pixels.  (A JPEG's corrupt entropy
    data is ROADMAP item 18.10's: libjpeg-turbo's warnings.)"""
    with open(os.path.join(INPUTS, name), "rb") as f:
        data = f.read()
    path = tmp_path / ("cut" + os.path.splitext(name)[1])
    path.write_bytes(data[: len(data) * 2 // 3])
    with pytest.raises(ValueError, match="cut"):
        imageio.imread(path)
    if name.endswith(".jpg"):
        return
    rng = np.random.default_rng(len(name))
    for k in range(20):
        bad = bytearray(data)
        for at in rng.integers(len(data) // 3, len(data), 4):
            bad[at] ^= 1 << int(rng.integers(8))
        path.write_bytes(bytes(bad))
        try:
            ours = imageio.imread(path)
        except ValueError as e:
            assert "cut" in str(e)
            continue
        np.testing.assert_array_equal(ours, _cv2_rgb(path), err_msg=f"{name} flip {k}")


def test_lzw_codec_round_trip_and_packbits(toolchain):
    """The LZW encoder's codes (past a full table and the ratio check)
    decode back; PackBits' runs and literals decode as PIL codes them."""
    rng = np.random.default_rng(0)
    data = np.repeat(rng.integers(0, 256, 40000, np.uint8), rng.integers(1, 4, 40000))
    codes = native.tiff_lzw_encode(data.tobytes())
    np.testing.assert_array_equal(native.tiff_decode(codes, "lzw", data.size), data)
    with pytest.raises(ValueError, match="ends before"):
        native.tiff_decode(codes[: len(codes) // 2], "lzw", data.size)
    img = np.kron(rng.integers(0, 256, (6, 5)), np.ones((1, 9), np.int64)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "TIFF", compression="packbits")
    assert tiff.decode(buf.getvalue())[..., 0].tolist() == img.tolist()
    # a BMP header cv2 reads no image from: a 16-bit BI_BITFIELDS with other masks
    bad = TOOL.bmp_file(2, 2, 16, bytes(8), comp=3, after=struct.pack("<3I", 1, 2, 4))
    with pytest.raises(ValueError, match="16-bit masks"):
        from fmvfi_tpu_torch.utils import bmp
        bmp.decode(bad)
