"""Progressive JPEGs through native/jpeg.cpp, against cv2 and PIL on the CPU.

`imageio.imread` must be bit-equal to cv2.imread (IMREAD_COLOR) + BGR2RGB,
and `imageio.read_jpeg` to PIL's Image.open, on:
- progressive files cv2 writes (IMWRITE_JPEG_PROGRESSIVE): 4:4:4, 4:2:2,
  4:2:0, 4:4:0, 4:1:1 and grey, seeded sizes 1-89 on each side, quality
  5-99, restart intervals 0-4;
- progressive files PIL writes (progressive=True, optimize=True: a Huffman
  table per scan);
- those files cut after each of their scans but the last, an EOI put back:
  a component's first coefficients are then short of bits, and
  libjpeg-turbo's block smoothing (on by default) estimates them from the
  DC values around each block, or replaces the DC itself while no AC scan
  has come; every cut of a colour and a grey file is checked, and a
  DC-only cut is checked to be smoothed (its 8x8 blocks not flat).
A progressive 12-bit file raises NotImplementedError naming its SOF.  The
committed progressive fixtures of tests/data/inputs/
(tools/make_input_fixtures.py) must decode to the digests chip_smoke.py
pins for the card's host (INPUT_PINS), which must be those of cv2's (or,
for the PIL file, PIL's) pixels.  The
decoder is C++ (fmvfi_tpu_torch.native): the tests skip, inside a fixture,
where no g++ is on PATH.  Needs no JAX.
"""

import hashlib
import importlib.util
import io
import os
import shutil

import cv2
import numpy as np
import pytest
from PIL import Image

import chip_smoke
from fmvfi_tpu_torch import native
from fmvfi_tpu_torch.utils import imageio

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "make_input_fixtures", os.path.join(ROOT, "tools", "make_input_fixtures.py"))
TOOL = importlib.util.module_from_spec(_spec)  # its scan cutter
_spec.loader.exec_module(TOOL)

SAMPLINGS = {
    "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
    "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
    "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
    "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
    "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
    "grey": None,
}


@pytest.fixture
def toolchain():
    if shutil.which("g++") is None:
        pytest.skip("no g++ on PATH: the native JPEG decoder cannot be built")
    assert native.available()


def cuts(data: bytes):
    """The file cut after each of its scans but the last, an EOI put back."""
    return [TOOL.cut_after(data, k) for k in range(1, len(TOOL.scan_ends(data)))]


def _image(rng, h, w, grey):
    img = rng.integers(0, 256, (h, w, 3), np.uint8)
    if min(h, w) > 3:
        img = cv2.GaussianBlur(img, (0, 0), float(rng.uniform(0.6, 3.0)))
    return img[..., 0] if grey else img


def _check(tmp_path, name, data):
    """imread against cv2.imread, read_jpeg against PIL, on the file's bytes."""
    path = tmp_path / name
    path.write_bytes(data)
    want = cv2.imread(str(path), cv2.IMREAD_COLOR)
    assert want is not None, name
    np.testing.assert_array_equal(imageio.imread(path), want[..., ::-1], err_msg=name)
    np.testing.assert_array_equal(imageio.read_jpeg(path),
                                  np.asarray(Image.open(path).convert("RGB")), err_msg=name)


@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
def test_cv2_progressive_files(toolchain, tmp_path, sampling):
    rng = np.random.default_rng(sorted(SAMPLINGS).index(sampling))
    for i in range(14):
        h, w = (int(v) for v in rng.integers(1, 90, 2))
        if i < 2:
            h, w = (1, 1) if i == 0 else (89, 89)
        quality, restart = int(rng.integers(5, 100)), int(rng.integers(0, 5))
        params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                  cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
        if SAMPLINGS[sampling] is not None:
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLINGS[sampling]]
        data = cv2.imencode(".jpg", _image(rng, h, w, sampling == "grey"), params)[1].tobytes()
        assert data[data.index(b"\xff\xc2") + 1] == 0xC2  # SOF2
        _check(tmp_path, f"{sampling}_{h}x{w}_q{quality}_r{restart}.jpg", data)
        for k, cut in enumerate(cuts(data)[int(rng.integers(0, 3))::3]):
            _check(tmp_path, f"{sampling}_{h}x{w}_q{quality}_r{restart}_cut{k}.jpg", cut)


@pytest.mark.parametrize("grey", [False, True])
def test_pil_progressive_optimized_files(toolchain, tmp_path, grey):
    rng = np.random.default_rng(20 + grey)
    for i in range(10):
        h, w = (int(v) for v in rng.integers(1, 90, 2))
        buf = io.BytesIO()
        quality = int(rng.integers(5, 100))
        Image.fromarray(_image(rng, h, w, grey)).save(buf, "JPEG", quality=quality,
                                                      progressive=True, optimize=True)
        data = buf.getvalue()
        _check(tmp_path, f"pil{i}.jpg", data)
        for k, cut in enumerate(cuts(data)):
            _check(tmp_path, f"pil{i}_cut{k}.jpg", cut)


@pytest.mark.parametrize("grey", [False, True])
def test_every_cut_smooths_as_libjpeg(toolchain, tmp_path, grey):
    """Each scan cut of a 4:2:0 (or grey) 61x77 file, bit-equal to cv2 and
    PIL.  The first cut holds DC values only: decoded without block
    smoothing its luma would be flat in every 8x8 block; smoothed, the
    blocks are shaded from their neighbours' DCs."""
    rng = np.random.default_rng(30 + grey)
    params = [cv2.IMWRITE_JPEG_QUALITY, 80, cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    data = cv2.imencode(".jpg", _image(rng, 61, 77, grey), params)[1].tobytes()
    pieces = cuts(data)
    assert len(pieces) == (5 if grey else 9)  # libjpeg's default scan scripts
    for k, cut in enumerate(pieces):
        _check(tmp_path, f"cut{k}.jpg", cut)
    luma = imageio.read_jpeg(tmp_path / "cut0.jpg")[:56, :72, 1].astype(int)
    blocks = luma.reshape(7, 8, 9, 8).transpose(0, 2, 1, 3).reshape(63, 64)
    assert (blocks.max(1) > blocks.min(1)).mean() > 0.5


def test_progressive_12bit_raises(toolchain, tmp_path):
    data = cv2.imencode(".jpg", np.zeros((16, 16, 3), np.uint8),
                        [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
    sof = data.index(b"\xff\xc2")
    (tmp_path / "p12.jpg").write_bytes(data[:sof + 4] + b"\x0c" + data[sof + 5:])
    with pytest.raises(NotImplementedError, match="p12.jpg.*SOF2 .*12-bit"):
        imageio.imread(tmp_path / "p12.jpg")


def test_committed_fixtures_match_the_smokes_pins(toolchain):
    names = [n for n in chip_smoke.INPUT_PINS
             if n.endswith(".jpg") and n not in chip_smoke.INPUTS_STILL_PINS]
    assert len(names) == 7
    for name in names:
        contract, digest = chip_smoke.INPUT_PINS[name]
        path = os.path.join(ROOT, chip_smoke.INPUTS_DIR, name)
        with open(path, "rb") as f:
            assert b"\xff\xc2" in f.read(), name  # SOF2
        if contract == "read_jpeg":
            want, got = np.asarray(Image.open(path).convert("RGB")), imageio.read_jpeg(path)
        else:
            want, got = cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1], imageio.imread(path)
        assert hashlib.sha256(np.ascontiguousarray(want).tobytes()).hexdigest() == digest, name
        assert hashlib.sha256(got.tobytes()).hexdigest() == digest, name
