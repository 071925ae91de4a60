"""PNG and JPEG files as RGB uint8 arrays, without cv2 or PIL: the port's
counterpart of `cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)` and of
`cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))` (PNG and JPEG).

`imread` returns what cv2 (IMREAD_COLOR) returns, in RGB order, for every
non-interlaced PNG: grey is replicated to three channels (1, 2 and 4-bit
grey scaled to 0-255 by 255, 85 and 17), palette indices are looked up (an
index past the palette reads black), alpha and tRNS are dropped without
blending, and 16-bit samples keep their high byte.  `imwrite` picks the
format from the file's extension, as cv2.imwrite does: `.png` writes 8-bit
RGB or grey, each row with the filter libpng's heuristic picks, at zlib
level 1 (cv2's default); `.jpg`, `.jpeg` and `.jpe` write the baseline JPEG
of native/jpeg_enc.cpp, byte-equal to cv2's at the same quality (default
95, cv2's); any other extension raises NotImplementedError.

A JPEG file (`imread` dispatches on its magic bytes) is decoded by the
baseline decoder of native/jpeg.cpp, bit-equal to libjpeg-turbo with its
defaults (ISLOW IDCT, fancy upsampling), as cv2 decodes it: grey becomes
three equal channels, and the EXIF Orientation tag is applied (flips and
rotations), as cv2.imread applies it.  `read_jpeg(path, orient=False)`
leaves the orientation alone, as PIL's Image.open does.

The PNG row filters and the JPEG decoder and encoder run in the C++ library of
fmvfi_tpu_torch.native (built with g++ at first use); `imread` and `imwrite`
raise RuntimeError when it does not build.  `unfilter_numpy` is the row
filters' plain version, for the tests.  An interlaced PNG, or a progressive,
lossless, arithmetic-coded, 12-bit or CMYK JPEG, raises
NotImplementedError, any other file that is not a well-formed PNG or
baseline JPEG ValueError; each names the path.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import NamedTuple, Optional

import numpy as np

from .. import native

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_JPEG_MAGIC = b"\xff\xd8\xff"
# samples per pixel, and the bit depths allowed, of each colour type
_COLOR_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
                4: (2, (8, 16)), 6: (4, (8, 16))}
_GREY_SCALE = {1: 255, 2: 85, 4: 17, 8: 1}
ZLIB_LEVEL = 1


def _chunks(data: bytes, path: str):
    """(type, body) of each chunk after the signature, each CRC checked,
    up to IEND."""
    pos = len(SIGNATURE)
    while True:
        if pos + 8 > len(data):
            raise ValueError(f"{path}: truncated PNG (no IEND chunk)")
        length, ctype = struct.unpack(">I4s", data[pos : pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"{path}: truncated PNG ({ctype!r} chunk cut short)")
        body = data[pos + 8 : end]
        if zlib.crc32(body, zlib.crc32(ctype)) != struct.unpack(">I", data[end : end + 4])[0]:
            raise ValueError(f"{path}: bad CRC in the {ctype!r} chunk")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos = end + 4


def _parse(data: bytes, path: str):
    """The header fields, the palette (or None) and the joined IDAT bytes."""
    header, palette, idat = None, None, []
    for ctype, body in _chunks(data, path):
        if header is None and ctype != b"IHDR":
            raise ValueError(f"{path}: the first chunk is {ctype!r}, not IHDR")
        if ctype == b"IHDR":
            if header is not None or len(body) != 13:
                raise ValueError(f"{path}: a malformed IHDR chunk")
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            if len(body) % 3 or not 0 < len(body) <= 768:
                raise ValueError(f"{path}: a PLTE chunk of {len(body)} bytes")
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype != b"IEND" and ctype[:1].isupper():
            raise ValueError(f"{path}: unknown critical chunk {ctype!r}")
    if not idat:
        raise ValueError(f"{path}: no IDAT chunk")
    return header, palette, b"".join(idat)


class RawPNG(NamedTuple):
    """A PNG's header fields, its palette (or None) and its decompressed
    image data: (height, 1 + rowbytes) uint8, each row its filter type and
    its filtered bytes."""

    width: int
    height: int
    depth: int
    color: int
    palette: Optional[np.ndarray]
    rows: np.ndarray

    @property
    def bpp(self) -> int:
        """The filters' byte step: max(1, bits per pixel // 8)."""
        return max(1, _COLOR_TYPES[self.color][0] * self.depth // 8)


def read_raw(path) -> RawPNG:
    """The PNG file at `path` parsed, checked and inflated, its rows still
    filtered."""
    path = os.fspath(path)
    with open(path, "rb") as f:
        data = f.read()
    return _read_raw(data, path)


def _read_raw(data: bytes, path: str) -> RawPNG:
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    (width, height, depth, color, compression, filtering, interlace), palette, z = \
        _parse(data, path)
    if color not in _COLOR_TYPES or depth not in _COLOR_TYPES[color][1]:
        raise ValueError(f"{path}: colour type {color} with bit depth {depth}")
    if compression or filtering or interlace > 1 or not (width and height):
        raise ValueError(f"{path}: IHDR {width}x{height}, compression {compression}, "
                         f"filter method {filtering}, interlace {interlace}")
    if interlace:
        raise NotImplementedError(f"{path}: an interlaced (Adam7) PNG is not supported")
    if color == 3 and palette is None:
        raise ValueError(f"{path}: a palette image without a PLTE chunk")
    rowbytes = (width * _COLOR_TYPES[color][0] * depth + 7) // 8
    try:
        raw = zlib.decompress(z)
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt image data ({e})") from None
    need = height * (rowbytes + 1)
    if len(raw) < need:
        raise ValueError(f"{path}: {len(raw)} bytes of image data, {need} needed")
    rows = np.frombuffer(raw, np.uint8, need).reshape(height, rowbytes + 1)
    return RawPNG(width, height, depth, color, palette, rows)


def imread(path) -> np.ndarray:
    """The PNG or JPEG file at `path` as an (H, W, 3) uint8 RGB array (a
    JPEG turned upright by its EXIF Orientation tag, as cv2 reads it)."""
    path = os.fspath(path)
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(_JPEG_MAGIC):
        return _decode_jpeg(data, path, orient=True)
    raw = _read_raw(data, path)
    try:
        rows = native.png_unfilter(raw.rows, raw.height, raw.rows.shape[1] - 1, raw.bpp)
    except ValueError as e:
        raise ValueError(f"{os.fspath(path)}: {e}") from None
    return _to_rgb(rows, raw.width, raw.depth, raw.color, raw.palette)


def read_jpeg(path, orient: bool = False) -> np.ndarray:
    """The JPEG file at `path` as an (H, W, 3) uint8 RGB array, as PIL's
    Image.open decodes it (the EXIF orientation not applied), or with
    orient=True as cv2.imread does (`imread`)."""
    path = os.fspath(path)
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_JPEG_MAGIC):
        raise ValueError(f"{path}: not a JPEG file")
    return _decode_jpeg(data, path, orient)


def _decode_jpeg(data: bytes, path: str, orient: bool) -> np.ndarray:
    try:
        img = native.jpeg_decode(data)
    except (ValueError, NotImplementedError) as e:
        raise type(e)(f"{path}: {e}") from None
    if orient:
        img = _ORIENT.get(exif_orientation(data), lambda a: a)(img)
    return np.ascontiguousarray(img)


# EXIF Orientation -> the transform that makes the image upright, as cv2
# applies it (flip(1) mirrors columns, flip(0) rows, transpose swaps axes)
_ORIENT = {
    2: lambda a: a[:, ::-1],
    3: lambda a: a[::-1, ::-1],
    4: lambda a: a[::-1],
    5: lambda a: a.transpose(1, 0, 2),
    6: lambda a: a.transpose(1, 0, 2)[:, ::-1],
    7: lambda a: a.transpose(1, 0, 2)[::-1, ::-1],
    8: lambda a: a.transpose(1, 0, 2)[::-1],
}


def exif_orientation(data: bytes) -> int:
    """The Orientation tag (0x0112) of IFD0 in a JPEG's first APP1 Exif
    segment, or 1 when there is none or it does not parse."""
    pos = 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker == 0xFF:  # a fill byte
            pos += 1
            continue
        if marker in (0xD9, 0xDA) or 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xCC):
            return 1  # EOI, SOS or SOF: the APPn segments come before
        (length,) = struct.unpack(">H", data[pos + 2 : pos + 4])
        body = data[pos + 4 : pos + 2 + length]
        if marker == 0xE1 and body.startswith(b"Exif\0\0"):
            return _tiff_orientation(body[6:])
        pos += 2 + length
    return 1


def _tiff_orientation(tiff: bytes) -> int:
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if tiff[:2] == b"II" else ">"
    (ifd,) = struct.unpack(e + "I", tiff[4:8])
    if ifd + 2 > len(tiff):
        return 1
    (count,) = struct.unpack(e + "H", tiff[ifd : ifd + 2])
    for i in range(count):
        entry = tiff[ifd + 2 + 12 * i : ifd + 14 + 12 * i]
        if len(entry) < 12:
            return 1
        tag, typ, n = struct.unpack(e + "HHI", entry[:8])
        if tag == 0x0112 and typ == 3 and n >= 1:
            value = struct.unpack(e + "H", entry[8:10])[0]
            return value if 1 <= value <= 8 else 1
    return 1


def _to_rgb(rows: np.ndarray, width: int, depth: int, color: int, palette) -> np.ndarray:
    """Unfiltered (H, rowbytes) bytes -> (H, W, 3) uint8 RGB, as cv2 reads
    them: samples to 8 bits, palette looked up, grey replicated, alpha
    dropped."""
    h = rows.shape[0]
    spp = _COLOR_TYPES[color][0]
    if depth == 16:
        samples = rows.reshape(h, width * spp, 2)[..., 0]  # the high byte
    elif depth == 8:
        samples = rows
    else:  # 1, 2 or 4 bits, one sample per pixel, packed from the high bit
        bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        samples = (bits * weights).sum(-1, dtype=np.uint8)[:, :width]
    samples = samples.reshape(h, width, spp)
    if color == 3:
        table = np.zeros((256, 3), np.uint8)
        table[: len(palette)] = palette
        return table[samples[..., 0]]
    if color in (0, 4):
        grey = samples[..., 0] * np.uint8(_GREY_SCALE.get(depth, 1))
        return np.repeat(grey[..., None], 3, axis=2)
    return np.ascontiguousarray(samples[..., :3])


JPEG_EXTENSIONS = (".jpg", ".jpeg", ".jpe")
JPEG_QUALITY = 95  # cv2's IMWRITE_JPEG_QUALITY default


def imwrite(path, image: np.ndarray, quality: int = JPEG_QUALITY) -> None:
    """Write an (H, W, 3) RGB or (H, W) grey uint8 array in the format its
    extension names (case-insensitive, as cv2): an 8-bit PNG for `.png`, a
    baseline JPEG at `quality` (1-100) for `.jpg`, `.jpeg` and `.jpe`.  Any
    other extension raises NotImplementedError."""
    path = os.fspath(path)
    ext = os.path.splitext(path)[1].lower()
    if ext != ".png" and ext not in JPEG_EXTENSIONS:
        raise NotImplementedError(f"{path}: imwrite writes .png, .jpg, .jpeg and .jpe files, "
                                  f"not {ext or 'a file without an extension'}")
    image = np.asarray(image)
    if image.dtype != np.uint8 or not (image.ndim == 2 or (image.ndim == 3
                                                           and image.shape[2] == 3)):
        raise ValueError(f"imwrite takes (H, W, 3) or (H, W) uint8, got {image.shape} "
                         f"{image.dtype}")
    if ext in JPEG_EXTENSIONS:
        data = native.jpeg_encode(image, quality)
        with open(path, "wb") as f:
            f.write(data)
        return
    h, w = image.shape[:2]
    spp = 1 if image.ndim == 2 else 3
    filtered = native.png_filter(image.reshape(h, w * spp), spp)
    header = struct.pack(">IIBBBBB", w, h, 8, 0 if spp == 1 else 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(SIGNATURE)
        for ctype, body in ((b"IHDR", header),
                            (b"IDAT", zlib.compress(filtered.tobytes(), ZLIB_LEVEL)),
                            (b"IEND", b"")):
            f.write(struct.pack(">I", len(body)) + ctype + body
                    + struct.pack(">I", zlib.crc32(body, zlib.crc32(ctype))))


def unfilter_numpy(data: np.ndarray, rows: int, rowbytes: int, bpp: int) -> np.ndarray:
    """The plain version of native.png_unfilter, for the tests: the row
    filters undone in numpy one anti-diagonal of bpp-byte cells at a time
    (a cell depends on the cell to its left and the two above, which lie on
    earlier diagonals)."""
    buf = np.asarray(data, np.uint8).reshape(rows, rowbytes + 1)
    ftype = buf[:, 0].astype(np.int32)
    if (ftype > 4).any():
        raise ValueError(f"filter types {sorted(set(ftype[ftype > 4].tolist()))}, not 0-4")
    cols = rowbytes // bpp
    filt = buf[:, 1:].reshape(rows, cols, bpp).astype(np.int32)
    out = np.zeros((rows + 1, cols + 1, bpp), np.int32)  # a row of zeros above, a column left
    for d in range(rows + cols - 1):
        r = np.arange(max(0, d - cols + 1), min(rows, d + 1))
        x = d - r
        a, b, c = out[r + 1, x], out[r, x + 1], out[r, x]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        t = ftype[r][:, None]
        pred = np.select([t == 1, t == 2, t == 3, t == 4], [a, b, (a + b) >> 1, paeth], 0)
        out[r + 1, x + 1] = (filt[r, x] + pred) & 255
    return out[1:, 1:].reshape(rows, rowbytes).astype(np.uint8)
