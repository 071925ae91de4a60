"""Interlaced (Adam7) PNGs through fmvfi_tpu_torch.utils.imageio, against cv2.

`imread` must be bit-equal to cv2.imread (IMREAD_COLOR) + BGR2RGB on Adam7
PNGs written with zlib and struct (tools/make_input_fixtures.py's writer):
every colour type and bit depth of imageio._COLOR_TYPES, palettes and tRNS
chunks (which cv2 drops), each pass's rows filtered with the filter types
cycled 0-4, at sizes from 1x1 to
40x40, among them sizes whose passes are empty (an image narrower or
shorter than 8 pixels).  A pass cut short must raise.  The committed
Adam7 fixtures of tests/data/inputs/ (tools/make_input_fixtures.py) must
decode to the digests chip_smoke.py pins for the card's host (INPUT_PINS),
which must be those of cv2's pixels.  The row filters are
C++ (fmvfi_tpu_torch.native): the tests skip, inside a fixture, where no
g++ is on PATH.  Needs no JAX.
"""

import hashlib
import importlib.util
import os
import shutil
import struct
import zlib

import cv2
import numpy as np
import pytest

import chip_smoke
from fmvfi_tpu_torch import native
from fmvfi_tpu_torch.utils import imageio

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "make_input_fixtures", os.path.join(ROOT, "tools", "make_input_fixtures.py"))
TOOL = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(TOOL)

COMBOS = [(color, depth) for color, (_, depths) in sorted(imageio._COLOR_TYPES.items())
          for depth in depths]
SIZES = [(1, 1), (1, 9), (9, 1), (2, 3), (3, 5), (5, 2), (7, 7), (8, 8), (9, 9), (4, 13),
         (13, 4), (16, 17), (23, 31), (40, 40), (33, 40)]


@pytest.fixture
def toolchain():
    if shutil.which("g++") is None:
        pytest.skip("no g++ on PATH: the codec's native row filters cannot be built")
    assert native.available()


def _adam7(path, color, depth, h, w, seed):
    """Write seeded samples as an Adam7 PNG (tools/make_input_fixtures.py's
    writer; a PLTE for colour type 3, a tRNS where the type allows one);
    returns the file's bytes."""
    rng = np.random.default_rng(seed)
    spp = imageio._COLOR_TYPES[color][0]
    n_pal = int(rng.integers(1, (1 << depth) + 1)) if color == 3 else 0
    top = n_pal if color == 3 else 1 << depth
    samples = rng.integers(0, top, (h, w, spp))
    palette, trns = None, None
    if color == 3:
        palette = rng.integers(0, 256, (n_pal, 3))
        trns = rng.integers(0, 256, n_pal).astype(np.uint8).tobytes()
    elif color in (0, 2):
        trns = struct.pack(">" + "H" * spp, *rng.integers(0, top, spp))
    blob = TOOL.adam7_png(samples, color, depth, palette=palette, trns=trns)
    path.write_bytes(blob)
    return blob


@pytest.mark.parametrize("color,depth", COMBOS)
def test_adam7_matches_cv2(toolchain, tmp_path, color, depth):
    for i, (h, w) in enumerate(SIZES):
        path = tmp_path / f"c{color}d{depth}_{h}x{w}.png"
        _adam7(path, color, depth, h, w, seed=100 * color + depth + 1000 * i)
        want = cv2.imread(str(path), cv2.IMREAD_COLOR)
        assert want is not None, path
        got = imageio.imread(path)
        assert got.shape == (h, w, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want[..., ::-1], err_msg=str(path))


def test_adam7_passes_and_errors(toolchain, tmp_path):
    blob = _adam7(tmp_path / "a.png", 2, 8, 5, 3, seed=7)
    raw = imageio.read_raw(tmp_path / "a.png")
    # a 3-wide image: pass 2, whose first column is 4, holds no pixel
    assert [(p.x0, p.y0, p.dx, p.dy, p.width, p.rows.shape[0]) for p in raw.passes] == [
        (0, 0, 8, 8, 1, 1), (0, 4, 4, 8, 1, 1), (2, 0, 4, 4, 1, 2), (0, 2, 2, 4, 2, 1),
        (1, 0, 2, 2, 1, 3), (0, 1, 1, 2, 3, 2)]
    # the image data cut short: the last pass lacks its last row
    body = zlib.compress(zlib.decompress(b"".join(
        blob[p + 8:p + 8 + struct.unpack(">I", blob[p:p + 4])[0]]
        for p in [i - 4 for i in range(len(blob)) if blob[i:i + 4] == b"IDAT"]))[:-10])
    short = imageio.SIGNATURE + TOOL._chunk(b"IHDR", struct.pack(">IIBBBBB", 3, 5, 8, 2, 0, 0, 1)) \
        + TOOL._chunk(b"IDAT", body) + TOOL._chunk(b"IEND", b"")
    (tmp_path / "short.png").write_bytes(short)
    with pytest.raises(ValueError, match="short.png.*bytes of image data"):
        imageio.imread(tmp_path / "short.png")


def test_committed_fixtures_match_the_smokes_pins(toolchain):
    names = [n for n in chip_smoke.INPUT_PINS
             if n.endswith(".png") and n not in chip_smoke.INPUTS_STILL_PINS]
    assert len(names) == 7
    for name in names:
        contract, digest = chip_smoke.INPUT_PINS[name]
        path = os.path.join(ROOT, chip_smoke.INPUTS_DIR, name)
        assert contract == "imread" and imageio.read_raw(path).passes[0].dx == 8  # Adam7
        want = cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1]
        assert hashlib.sha256(np.ascontiguousarray(want).tobytes()).hexdigest() == digest, name
        assert hashlib.sha256(imageio.imread(path).tobytes()).hexdigest() == digest, name
