"""fmvfi_tpu_torch.utils.imageio, the port's PNG codec, against cv2 and PIL.

`imread` must be bit-equal to cv2.imread (IMREAD_COLOR) + BGR2RGB on PNGs
this file writes with its own small encoder: every colour type (0, 2, 3, 4,
6) at every allowed bit depth, the row filter cycled 0-4 row by row, the
image data split over several IDAT chunks, with ancillary chunks (gAMA,
tRNS) that cv2 ignores; and on PNGs written by cv2 and by PIL.  `imwrite`'s
files must read back bit-equal through cv2 and PIL.  The C++ row unfilter
must be bit-equal to its numpy oracle.  Broken and unsupported files must
raise.  The codec's row filters are C++ (fmvfi_tpu_torch.native): the tests
skip, inside a fixture, where no g++ is on PATH.  Needs no JAX.
"""

import shutil
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from fmvfi_tpu_torch import native
from fmvfi_tpu_torch.utils import imageio

# (colour type, bit depth): every combination the PNG specification allows
COMBOS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4),
          (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]
SPP = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


@pytest.fixture
def toolchain():
    if shutil.which("g++") is None:
        pytest.skip("no g++ on PATH: the codec's native row filters cannot be built")
    assert native.available()


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(
        ">I", zlib.crc32(body, zlib.crc32(ctype)))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_rows(rows: np.ndarray, bpp: int, types) -> bytes:
    """Row r filtered with types[r], from the spec's formulas on the raw
    bytes (the encoder's direction needs no recurrence)."""
    x = rows.astype(np.int32)
    out = []
    for r, t in enumerate(types):
        cur = x[r]
        prev = x[r - 1] if r else np.zeros_like(cur)
        a = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        pred = [np.zeros_like(cur), a, prev, (a + prev) >> 1, _paeth(a, prev, c)][t]
        out.append(bytes([t]) + ((cur - pred) & 255).astype(np.uint8).tobytes())
    return b"".join(out)


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """(H, W*spp) samples -> (H, rowbytes) bytes at `depth` bits."""
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(samples.shape[0], -1)
    if depth == 8:
        return samples.astype(np.uint8)
    bits = (samples[..., None] >> np.arange(depth - 1, -1, -1)) & 1
    return np.packbits(bits.reshape(samples.shape[0], -1).astype(np.uint8), axis=1)


def _encode(path, color, depth, h=7, w=13, seed=0, n_idat=3, interlace=0, extra=()):
    """A PNG of random samples, rows filtered 0, 1, 2, 3, 4, 0, ..., the
    deflate stream split over n_idat chunks."""
    rng = np.random.default_rng(seed)
    spp = SPP[color]
    top = 2 ** depth
    samples = rng.integers(0, top, (h, w * spp), dtype=np.int64)
    chunks = [_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace)),
              _chunk(b"gAMA", struct.pack(">I", 45455))]
    if color == 3:
        chunks.append(_chunk(b"PLTE", rng.integers(0, 256, (top, 3), dtype=np.uint8).tobytes()))
        chunks.append(_chunk(b"tRNS", bytes([0, 128])))
    chunks += list(extra)
    rows = _pack(samples, depth)
    z = zlib.compress(_filter_rows(rows, max(1, spp * depth // 8), [r % 5 for r in range(h)]))
    cuts = np.linspace(0, len(z), n_idat + 1).astype(int)
    chunks += [_chunk(b"IDAT", z[a:b]) for a, b in zip(cuts[:-1], cuts[1:])]
    chunks.append(_chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(imageio.SIGNATURE + b"".join(chunks))
    return path


def _cv2_rgb(path):
    return cv2.cvtColor(cv2.imread(str(path), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


@pytest.mark.parametrize("color,depth", COMBOS, ids=[f"type{c}-{d}bit" for c, d in COMBOS])
def test_imread_matches_cv2_on_every_colour_type_and_depth(toolchain, tmp_path, color, depth):
    """Grey replicated (1/2/4-bit scaled by 255/85/17), the palette looked
    up (tRNS ignored), alpha dropped, 16-bit reduced to the high byte: each
    rule as cv2 applies it, through all five row filters."""
    path = _encode(tmp_path / "x.png", color, depth)
    ours = imageio.imread(path)
    assert ours.dtype == np.uint8 and ours.shape == (7, 13, 3)
    np.testing.assert_array_equal(ours, _cv2_rgb(path))


def test_imread_matches_cv2_on_files_cv2_and_pil_write(toolchain, tmp_path):
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, (21, 34, 3), dtype=np.uint8)
    smooth = np.clip(np.cumsum(rng.integers(-3, 4, (21, 34, 3)), axis=1) + 128, 0, 255)
    files = []
    for name, img in (("rgb", rgb), ("smooth", smooth.astype(np.uint8))):
        cv2.imwrite(str(tmp_path / f"cv2_{name}.png"), img[..., ::-1])
        Image.fromarray(img, "RGB").save(tmp_path / f"pil_{name}.png")
        files += [f"cv2_{name}.png", f"pil_{name}.png"]
    cv2.imwrite(str(tmp_path / "cv2_grey.png"), rgb[..., 0])
    cv2.imwrite(str(tmp_path / "cv2_16.png"), rng.integers(0, 65536, (9, 11, 3), dtype=np.uint16))
    cv2.imwrite(str(tmp_path / "cv2_bgra.png"), rng.integers(0, 256, (9, 11, 4), dtype=np.uint8))
    cv2.imwrite(str(tmp_path / "cv2_best.png"), rgb, [cv2.IMWRITE_PNG_COMPRESSION, 9])
    files += ["cv2_grey.png", "cv2_16.png", "cv2_bgra.png", "cv2_best.png"]
    for mode in ("L", "LA", "RGBA", "P", "1", "I;16"):
        Image.fromarray(rgb).convert(mode).save(tmp_path / f"pil_{mode[0]}{len(mode)}.png")
        files.append(f"pil_{mode[0]}{len(mode)}.png")
    for name in files:
        np.testing.assert_array_equal(imageio.imread(tmp_path / name), _cv2_rgb(tmp_path / name),
                                      err_msg=name)


@pytest.mark.parametrize("shape", [(17, 23, 3), (17, 23), (1, 1, 3), (40, 1)])
def test_imwrite_reads_back_through_cv2_and_pil(toolchain, tmp_path, shape):
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    path = tmp_path / "w.png"
    imageio.imwrite(path, img)
    pil = np.asarray(Image.open(path))
    np.testing.assert_array_equal(pil, img)
    if img.ndim == 2:
        np.testing.assert_array_equal(cv2.imread(str(path), cv2.IMREAD_GRAYSCALE), img)
        img = np.repeat(img[..., None], 3, axis=2)
    np.testing.assert_array_equal(_cv2_rgb(path), img)
    np.testing.assert_array_equal(imageio.imread(path), img)


def test_imwrite_rejects_what_it_cannot_write(tmp_path):
    for bad in (np.zeros((4, 4, 3), np.float32), np.zeros((4, 4, 4), np.uint8),
                np.zeros((4,), np.uint8)):
        with pytest.raises(ValueError):
            imageio.imwrite(tmp_path / "bad.png", bad)


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_native_unfilter_matches_the_numpy_oracle(toolchain, bpp):
    """Random filtered bytes under random filter types; the C++ filter's
    output (its own row choice) unfilters back to the image on both."""
    rng = np.random.default_rng(bpp)
    rows, rowbytes = 9, bpp * 11
    data = rng.integers(0, 256, (rows, rowbytes + 1), dtype=np.uint8)
    data[:, 0] = rng.permutation(np.arange(rows) % 5)
    np.testing.assert_array_equal(native.png_unfilter(data, rows, rowbytes, bpp),
                                  imageio.unfilter_numpy(data, rows, rowbytes, bpp))
    img = np.clip(np.cumsum(rng.integers(-4, 5, (rows, rowbytes)), axis=1) + 100,
                  0, 255).astype(np.uint8)
    filtered = native.png_filter(img, bpp)
    assert filtered.shape == (rows, rowbytes + 1) and set(filtered[:, 0]) <= set(range(5))
    np.testing.assert_array_equal(native.png_unfilter(filtered, rows, rowbytes, bpp), img)
    np.testing.assert_array_equal(imageio.unfilter_numpy(filtered, rows, rowbytes, bpp), img)


def test_native_unfilter_rejects_a_bad_filter_type(toolchain):
    data = np.zeros((3, 5), np.uint8)
    data[1, 0] = 7
    with pytest.raises(ValueError, match="row 1 has filter type 7"):
        native.png_unfilter(data, 3, 4, 1)
    with pytest.raises(ValueError):
        imageio.unfilter_numpy(data, 3, 4, 1)


def test_broken_and_unsupported_files_raise(toolchain, tmp_path):
    good = _encode(tmp_path / "good.png", 2, 8).read_bytes()
    idat = good.index(b"IDAT")
    cases = {
        "crc.png": (good[: idat + 6] + bytes([good[idat + 6] ^ 1]) + good[idat + 7:], ValueError),
        "truncated.png": (good[: len(good) // 2], ValueError),
        "no_iend.png": (good[:-12], ValueError),
        "text.png": (b"not an image at all", ValueError),
    }
    for name, (data, exc) in cases.items():
        (tmp_path / name).write_bytes(data)
        with pytest.raises(exc, match=name):
            imageio.imread(tmp_path / name)
    _encode(tmp_path / "interlaced.png", 2, 8, interlace=1)
    with pytest.raises(NotImplementedError, match="interlaced"):
        imageio.imread(tmp_path / "interlaced.png")
    cv2.imwrite(str(tmp_path / "photo.jpg"), np.zeros((8, 8, 3), np.uint8))
    # a JPEG reads (tests/test_torch_jpeg.py holds the decoder against cv2); a
    # progressive one raises, naming the file
    np.testing.assert_array_equal(imageio.imread(tmp_path / "photo.jpg"),
                                  cv2.imread(str(tmp_path / "photo.jpg"))[..., ::-1])
    cv2.imwrite(str(tmp_path / "progressive.jpg"), np.zeros((8, 8, 3), np.uint8),
                [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(NotImplementedError, match="progressive.jpg"):
        imageio.imread(tmp_path / "progressive.jpg")
    # a row whose filter byte is not 0-4, behind valid CRCs
    bad = tmp_path / "filter.png"
    raw = bytes([7]) + bytes(3 * 4) + (bytes([0]) + bytes(3 * 4)) * 2
    bad.write_bytes(imageio.SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 3, 8, 2, 0,
                                                                    0, 0))
                    + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="filter type 7"):
        imageio.imread(bad)
