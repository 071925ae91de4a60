"""Still images as RGB uint8 arrays, without cv2 or PIL: the port's
counterpart of `cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)` and of
`cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))`.

`imread` tells the format by the file's first bytes, as cv2's findDecoder
does, and returns what cv2 (IMREAD_COLOR) returns, in RGB order, for PNG,
JPEG, BMP (utils/bmp.py), PNM P1-P6 (utils/pnm.py), TIFF
(utils/tiff.py), WebP (utils/webp.py: lossy, lossless, with alpha, the
first frame of an animation, turned by its EXIF Orientation) and GIF
(utils/gif.py: the first image, transparent pixels in the background
colour) files.

A PNG, interlaced (Adam7: each pass unfiltered on its own, its pixels put
in place) or not: grey is replicated to three channels (1, 2 and 4-bit grey
scaled to 0-255 by 255, 85 and 17), palette indices are looked up (an index
past the palette reads black), alpha and tRNS are dropped without blending,
16-bit samples keep their high byte, and the Orientation of an eXIf chunk
(before or after the image data) is applied, as cv2 applies it.  A JPEG,
baseline or progressive, is decoded by native/jpeg.cpp, bit-equal to
libjpeg-turbo with its defaults (ISLOW IDCT, fancy upsampling, block
smoothing of a progressive file whose scans leave coefficients short), as
cv2 decodes it: grey becomes three equal channels, RGB-coded files are
copied, CMYK files go through OpenCV's own CMYK step, and the EXIF
Orientation tag is applied (flips and rotations).  `read_jpeg(path,
orient=False)` and `read_raw` leave the orientation alone, as PIL's
Image.open and FFmpeg do.

`imwrite` picks the format from the file's extension, as cv2.imwrite does:
`.png` writes 8-bit RGB or grey, each row with the filter libpng's
heuristic picks, at zlib level 1 (cv2's default); `.jpg`, `.jpeg` and
`.jpe` the baseline JPEG of native/jpeg_enc.cpp, byte-equal to cv2's at the
same quality (default 95, cv2's); `.bmp` and `.dib`, `.ppm`, `.pgm` and
`.pnm`, and `.tif` and `.tiff` the bytes cv2.imwrite writes (utils/bmp.py,
pnm.py, tiff.py); `.webp` a lossless WebP (utils/webp.py: the pixels cv2
writes, not its bytes); any other extension raises NotImplementedError
(`.gif` too: cv2 writes it through its own lossy quantiser, ROADMAP item
18.11).

The PNG row filters, the JPEG decoder and encoder, BMP's run-length data and
TIFF's LZW and PackBits run in the C++ library of fmvfi_tpu_torch.native
(built with g++ at first use); `imread` and `imwrite` raise RuntimeError
when it does not build.  `unfilter_numpy` is the row filters' plain
version, for the tests.  The formats cv2.imread decodes and the port does
not yet (`STILL_FORMATS`: PFM, PAM, JPEG 2000, Sun raster, Radiance
HDR), a lossless, arithmetic-coded, hierarchical, 12-bit or YCCK
JPEG, and a YCbCr TIFF that is not JPEG-compressed raise NotImplementedError naming
ROADMAP item 18.11; any other file that is not a well-formed image raises
ValueError (a JPEG cut short too, which cv2 would decode in part, and the
files cv2.imread returns None for); each names the path.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import NamedTuple, Optional, Tuple

import numpy as np

from .. import native
from . import bmp, formats, gif, pnm, tiff, webp

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
    """The header fields, the palette (or None), the joined IDAT bytes and
    the first eXIf chunk's body (b"" when there is none)."""
    header, palette, idat, exif = None, None, [], b""
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
        elif ctype == b"eXIf":
            exif = exif or body
        elif ctype != b"IEND" and ctype[:1].isupper():
            raise ValueError(f"{path}: unknown critical chunk {ctype!r}")
    if not idat:
        raise ValueError(f"{path}: no IDAT chunk")
    return header, palette, b"".join(idat), exif


# Adam7: each pass's first column and row and its steps across and down
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


class Pass(NamedTuple):
    """One pass of a PNG's image data: the pixels (y0 + i dy, x0 + j dx),
    `width` of them a row, as (rows, 1 + rowbytes) uint8, each row its
    filter type and its filtered bytes.  A non-interlaced image is one pass
    (0, 0, 1, 1)."""

    x0: int
    y0: int
    dx: int
    dy: int
    width: int
    rows: np.ndarray


class RawPNG(NamedTuple):
    """A PNG's header fields, its palette (or None), its decompressed image
    data as passes (one, or Adam7's seven less those that hold no pixel: an
    image narrower or shorter than 8 has empty passes) and the Orientation
    its eXIf chunk gives (1 without one)."""

    width: int
    height: int
    depth: int
    color: int
    palette: Optional[np.ndarray]
    passes: Tuple[Pass, ...]
    orientation: int = 1

    @property
    def bpp(self) -> int:
        """The filters' byte step: max(1, bits per pixel // 8)."""
        return max(1, _COLOR_TYPES[self.color][0] * self.depth // 8)

    @property
    def rows(self) -> np.ndarray:
        """The first pass's filtered rows: the whole image's when it is not
        interlaced."""
        return self.passes[0].rows


def read_raw(path) -> RawPNG:
    """The PNG file at `path` parsed, checked and inflated, its rows still
    filtered."""
    path = os.fspath(path)
    with open(path, "rb") as f:
        data = f.read()
    return read_raw_bytes(data, path)


def read_raw_bytes(data: bytes, path: str) -> RawPNG:
    """A PNG file's bytes parsed, checked and inflated (read_raw's work)."""
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    (width, height, depth, color, compression, filtering, interlace), palette, z, exif = \
        _parse(data, path)
    if color not in _COLOR_TYPES or depth not in _COLOR_TYPES[color][1]:
        raise ValueError(f"{path}: colour type {color} with bit depth {depth}")
    if compression or filtering or interlace > 1 or not (width and height):
        raise ValueError(f"{path}: IHDR {width}x{height}, compression {compression}, "
                         f"filter method {filtering}, interlace {interlace}")
    if color == 3 and palette is None:
        raise ValueError(f"{path}: a palette image without a PLTE chunk")
    spp = _COLOR_TYPES[color][0]
    layout = []  # (x0, y0, dx, dy, width, height, rowbytes) of each non-empty pass
    for x0, y0, dx, dy in ADAM7 if interlace else ((0, 0, 1, 1),):
        pw, ph = max(0, -(-(width - x0) // dx)), max(0, -(-(height - y0) // dy))
        if pw and ph:
            layout.append((x0, y0, dx, dy, pw, ph, (pw * spp * depth + 7) // 8))
    try:
        raw = zlib.decompress(z)
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt image data ({e})") from None
    need = sum(ph * (rowbytes + 1) for *_, ph, rowbytes in layout)
    if len(raw) < need:
        raise ValueError(f"{path}: {len(raw)} bytes of image data, {need} needed")
    passes, pos = [], 0
    for x0, y0, dx, dy, pw, ph, rowbytes in layout:
        rows = np.frombuffer(raw, np.uint8, ph * (rowbytes + 1), pos).reshape(ph, rowbytes + 1)
        passes.append(Pass(x0, y0, dx, dy, pw, rows))
        pos += rows.size
    return RawPNG(width, height, depth, color, palette, tuple(passes), _tiff_orientation(exif))


# the still images cv2.imread decodes and the port does not yet (item 18.11),
# told by their first bytes
STILL_FORMATS = ((b"\0\0\0\x0cjP  \r\n\x87\n", "JPEG 2000"), (b"\xffO\xffQ", "JPEG 2000"),
                 (b"\x59\xa6\x6a\x95", "Sun raster"), (b"#?RADIANCE", "Radiance HDR"),
                 (b"#?RGBE", "Radiance HDR"))
_TIFF_MAGIC = (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+")


def still_format(data: bytes) -> Optional[str]:
    """The name of a still-image format that cv2.imread decodes and the
    port does not, when the bytes begin with one, else None."""
    for magic, name in STILL_FORMATS:
        if data.startswith(magic):
            return name
    if len(data) >= 3 and data[0:1] == b"P" and data[2:3] in b" \t\r\n":
        if data[1:2] == b"7":
            return "PAM"
        if data[1:2] in b"Ff":
            return "PFM"
    return None


def image_format(data: bytes) -> Optional[str]:
    """The name of the still-image format the bytes begin with ("PNG",
    "JPEG", "BMP", "PNM", "TIFF", "WebP", "GIF" or one of `still_format`'s),
    else None."""
    if data.startswith(SIGNATURE):
        return "PNG"
    if data.startswith(_JPEG_MAGIC):
        return "JPEG"
    if data.startswith(bmp.MAGIC):
        return "BMP"
    if pnm.is_pnm(data):
        return "PNM"
    if data[:4] in _TIFF_MAGIC:
        return "TIFF"
    if webp.is_webp(data):
        return "WebP"
    if gif.is_gif(data):
        return "GIF"
    return still_format(data)


def imread(path) -> np.ndarray:
    """The image file at `path` as an (H, W, 3) uint8 RGB array, as
    cv2.imread reads it: PNG, JPEG and WebP (turned upright by their EXIF
    Orientation), BMP, PNM (P1-P6), TIFF and GIF (the first image).  The
    other formats cv2.imread decodes (PFM, PAM, JPEG 2000, Sun raster,
    Radiance HDR) raise NotImplementedError naming ROADMAP item 18.11."""
    path = os.fspath(path)
    with open(path, "rb") as f:
        data = f.read()
    kind = image_format(data)
    if kind == "JPEG":
        return _decode_jpeg(data, path, orient=True)
    if kind in ("BMP", "PNM", "TIFF"):
        try:
            return {"BMP": bmp.decode, "PNM": pnm.decode, "TIFF": tiff.decode}[kind](data)
        except tiff.Unsupported as e:
            raise formats.unsupported(path, e.what, "18.11") from None
        except ValueError as e:
            raise ValueError(f"{path}: {kind}: {e}") from None
    if kind in ("WebP", "GIF"):
        try:
            if kind == "GIF":
                return gif.decode(data)
            img, exif = webp.decode(data)
        except ValueError as e:
            raise ValueError(f"{path}: {kind}: {e}") from None
        return np.ascontiguousarray(_ORIENT.get(_tiff_orientation(exif), lambda a: a)(img))
    if kind not in (None, "PNG"):
        raise formats.unsupported(path, f"a {kind} image", "18.11")
    return decode_png(data, path, orient=True)


def decode_png(data: bytes, path: str, orient: bool = True) -> np.ndarray:
    """A PNG file's bytes as cv2.imread reads them (orient=True: the
    eXIf chunk's Orientation applied), or with orient=False as FFmpeg's PNG
    decoder hands its pixels on, upright as stored."""
    raw = read_raw_bytes(data, path)
    out = np.empty((raw.height, raw.width, 3), np.uint8)
    for p in raw.passes:  # each pass unfiltered on its own, its pixels put in place
        out[p.y0 :: p.dy, p.x0 :: p.dx] = _to_rgb(unfilter(p, raw.bpp, path), p.width,
                                                  raw.depth, raw.color, raw.palette)
    if orient and raw.orientation in _ORIENT:
        out = np.ascontiguousarray(_ORIENT[raw.orientation](out))
    return out


def unfilter(p: Pass, bpp: int, path: str) -> np.ndarray:
    """A pass's rows with the row filters undone (native/png.cpp)."""
    try:
        return native.png_unfilter(p.rows, p.rows.shape[0], p.rows.shape[1] - 1, bpp)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


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


BMP_EXTENSIONS = (".bmp", ".dib")
TIFF_EXTENSIONS = (".tif", ".tiff")
WRITES = ((".png",) + JPEG_EXTENSIONS + BMP_EXTENSIONS + tuple(pnm.EXTENSIONS) + TIFF_EXTENSIONS
          + (".webp",))


def imwrite(path, image: np.ndarray, quality: int = JPEG_QUALITY) -> None:
    """Write an (H, W, 3) RGB or (H, W) grey uint8 array in the format its
    extension names (case-insensitive, as cv2): an 8-bit PNG for `.png`, a
    baseline JPEG at `quality` (1-100) for `.jpg`, `.jpeg` and `.jpe`, and
    cv2's own bytes for `.bmp` / `.dib`, `.ppm` / `.pgm` / `.pnm` and `.tif` /
    `.tiff`, and a lossless WebP for `.webp` (cv2.imread reads back the
    pixels written).  Any other extension raises NotImplementedError (`.gif`
    naming ROADMAP item 18.11); a grey image to `.ppm`, or a colour one to
    `.pgm`, ValueError (cv2 writes neither)."""
    path = os.fspath(path)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".gif":
        raise NotImplementedError(f"{path}: imwrite does not write GIFs yet: cv2.imwrite "
                                  "quantises the image to a palette of its own, lossily (ROADMAP "
                                  "Queue 1, item 18.11)")
    if ext not in WRITES:
        raise NotImplementedError(f"{path}: imwrite writes {', '.join(WRITES)} files, not "
                                  f"{ext or 'a file without an extension'}")
    image = np.asarray(image)
    if image.dtype != np.uint8 or not (image.ndim == 2 or (image.ndim == 3
                                                           and image.shape[2] == 3)):
        raise ValueError(f"imwrite takes (H, W, 3) or (H, W) uint8, got {image.shape} "
                         f"{image.dtype}")
    image = np.ascontiguousarray(image)
    if ext in JPEG_EXTENSIONS:
        data = native.jpeg_encode(image, quality)
    elif ext in BMP_EXTENSIONS:
        data = bmp.encode(image)
    elif ext in pnm.EXTENSIONS:
        data = pnm.encode(image, ext)
    elif ext in TIFF_EXTENSIONS:
        data = tiff.encode(image)
    elif ext == ".webp":
        data = webp.encode(image)
    else:
        data = encode_png(image)
    with open(path, "wb") as f:
        f.write(data)


def encode_png(image: np.ndarray) -> bytes:
    """An (H, W, 3) RGB or (H, W) grey uint8 image as the PNG cv2 writes."""
    h, w = image.shape[:2]
    spp = 1 if image.ndim == 2 else 3
    filtered = native.png_filter(image.reshape(h, w * spp), spp)
    header = struct.pack(">IIBBBBB", w, h, 8, 0 if spp == 1 else 2, 0, 0, 0)
    out = [SIGNATURE]
    for ctype, body in ((b"IHDR", header), (b"IDAT", zlib.compress(filtered.tobytes(), ZLIB_LEVEL)),
                        (b"IEND", b"")):
        out.append(struct.pack(">I", len(body)) + ctype + body
                   + struct.pack(">I", zlib.crc32(body, zlib.crc32(ctype))))
    return b"".join(out)


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
