"""TIFF files as cv2 reads and writes them, without cv2, PIL or libtiff.

`decode` returns what `cv2.imread(path)` returns (in RGB order) for the
first image (IFD) of a TIFF file.  cv2 hands an 8-bit read to libtiff's
RGBA interface (tif_getimage.c, libtiff 4.7), and this module repeats it:

- byte orders II and MM; strips or tiles; planar configurations 1
  (contiguous) and 2 (one plane a sample); FillOrder 2;
- compressions none, LZW and PackBits (native/tiff.cpp), deflate (8 and
  32946, the standard library's zlib) and JPEG (7: each strip, after the
  JPEGTables, through native/jpeg.cpp as libtiff has libjpeg decode it,
  its components as they decode, a YCbCr image converted to RGB);
  predictor 2 (horizontal differencing) on 8- and 16-bit samples, each
  row of a strip or tile on its own;
- MinIsBlack and MinIsWhite at 1, 8 and 16 bits: 1-bit samples to 0 and
  255, 16-bit samples to their high byte, MinIsWhite inverted; grey with
  alpha keeps the grey;
- RGB at 8 and 16 bits: 16-bit samples to round(v / 257); unassociated
  alpha (ExtraSamples 2) premultiplies the colour, (v * a + 127) // 255,
  before the alpha is dropped; four samples without ExtraSamples count as
  associated alpha (kept as they are); a plane-separate grey image reads
  its grey plane through the RGB path (no inversion, 16 bits rounded);
- Palette at 1, 4 and 8 bits: a colormap whose entries all lie below
  256 is taken as 8-bit, else each entry's high byte;
- CMYK (Separated, InkSet 1) at 8 bits: k = 255 - K, each channel
  k * (255 - C) // 255;
- Orientation 2-4 flips the image as cv2 applies an EXIF orientation;
  5-8 raise ValueError (cv2.imread returns None for them).

YCbCr files that are not JPEG-compressed, the other compressions cv2's
libtiff decodes (CCITT, old-style JPEG, NeXT, ThunderScan, Pixar log, SGI
log), the Lab and log photometric interpretations, BigTIFF and signed
samples raise NotImplementedError naming ROADMAP item 18.11; what cv2
reads no pixels of (2-bit samples, 4-bit ones outside a palette image,
10- to 64-bit ones, 1-bit samples interleaved with others, a missing
colormap, a tag of the wrong type, count or value, corrupt or truncated
strip data) raises ValueError.

`encode` writes what `cv2.imwrite(path.tif)` writes of an 8-bit RGB or grey
image, byte for byte: LZW with predictor 2, as many rows a strip as fit in
8192 bytes (at least one), and libtiff's directory (its tags, value types
and the order of the values stored after it).
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np

from .. import native

MAX_PIXELS = 1 << 30  # cv2's CV_IO_MAX_IMAGE_PIXELS
# (tag type -> struct code) for the integer types libtiff reads as numbers
_TYPES = {1: "B", 3: "H", 4: "I", 6: "b", 7: "B", 8: "h", 9: "i", 16: "Q"}
_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8, 13: 4}
# the other compressions cv2's libtiff decodes
_COMPRESSION_NAMES = {2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4", 6: "old-style JPEG",
                      32766: "NeXT", 32809: "ThunderScan", 32909: "Pixar log",
                      34676: "SGI log", 34677: "SGI log 24"}
_ORIENT = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1]}
# the tags this module reads, which must hold integers, and those of one value
_READ = {256, 257, 258, 259, 262, 266, 273, 274, 277, 278, 279, 284, 317, 320, 322, 323, 324, 325,
         332, 338, 339}  # (JPEGTables, 347, is read as bytes)
_SINGLE = {256, 257, 259, 262, 266, 274, 277, 278, 284, 317, 322, 323, 332}
# the values libtiff's _TIFFVSetField takes for the enumerated tags
_VALUES = {266: (1, 2), 274: range(1, 9), 284: (1, 2), 317: (1, 2, 3), 338: (0, 1, 2),
           339: range(1, 7)}


class Unsupported(Exception):
    """A TIFF that cv2 reads and this module does not; `what` names it."""

    def __init__(self, what: str):
        super().__init__(what)
        self.what = what


def _ifd(data: bytes) -> Tuple[str, Dict[int, tuple]]:
    """The byte order and the first IFD's {tag: values}."""
    if len(data) < 8:
        raise ValueError("a TIFF file shorter than its header")
    e = "<" if data[:2] == b"II" else ">"
    (version,) = struct.unpack(e + "H", data[2:4])
    if version == 43:
        raise Unsupported("a BigTIFF file")
    (off,) = struct.unpack(e + "I", data[4:8])
    if off < 8 or off + 2 > len(data):
        raise ValueError(f"the first IFD at {off}, outside the file")
    (n,) = struct.unpack(e + "H", data[off : off + 2])
    if off + 2 + 12 * n > len(data):
        raise ValueError("an IFD cut short")
    tags = {}
    for i in range(n):
        at = off + 2 + 12 * i
        tag, typ, count = struct.unpack(e + "HHI", data[at : at + 8])
        if tag in _READ and (typ not in (1, 3, 4) or (tag in _SINGLE and count != 1)):
            raise ValueError(f"tag {tag} of type {typ} and count {count} (libtiff rejects it)")
        size = _SIZES.get(typ)
        if size is None:
            continue  # libtiff skips an entry of an unknown type
        nbytes = size * count
        if nbytes <= 4:
            raw = data[at + 8 : at + 8 + nbytes]
        else:
            (voff,) = struct.unpack(e + "I", data[at + 8 : at + 12])
            if voff + nbytes > len(data):
                raise ValueError(f"tag {tag}'s values lie past the end of the file")
            raw = data[voff : voff + nbytes]
        if typ in _TYPES:
            tags[tag] = struct.unpack(e + _TYPES[typ] * count, raw)
        elif typ == 2:
            tags[tag] = raw
        else:
            tags[tag] = (raw,)
    for tag, allowed in _VALUES.items():
        if any(v not in allowed for v in tags.get(tag, ())):
            raise ValueError(f"tag {tag} holds {tags[tag]} (libtiff rejects the value)")
    return e, tags


def _one(tags, tag, default=None):
    v = tags.get(tag)
    if v is None:
        if default is None:
            raise ValueError(f"no tag {tag}")
        return default
    return v[0]


def _strip_bytes(raw: bytes, compression: int, rows: int, rowbytes: int,
                 jpeg: Tuple[bytes, bool] = (b"", False)) -> np.ndarray:
    """One strip or tile decoded into rows * rowbytes bytes; `jpeg`: the
    JPEGTables tag's bytes and whether libjpeg converts YCbCr to RGB."""
    size = rows * rowbytes
    if compression == 7:
        tables, ycbcr = jpeg
        if raw[:2] != b"\xff\xd8":
            raise ValueError("a JPEG strip that does not start with SOI")
        if tables[:2] == b"\xff\xd8" and tables[-2:] == b"\xff\xd9":
            raw = tables[:-2] + raw[2:]  # the tables, then the strip's frame
        try:
            px = native.jpeg_decode_strip(raw, ycbcr)
        except NotImplementedError as ex:
            raise Unsupported(f"a JPEG-compressed TIFF whose strips are {ex}") from None
        if px.shape[1] * px.shape[2] != rowbytes or px.shape[0] < rows:
            raise ValueError(f"a {px.shape[1]}x{px.shape[0]} JPEG of {px.shape[2]} components "
                             f"in a strip of {rows} rows of {rowbytes} bytes")
        return px[:rows].reshape(-1)
    if compression == 1:
        if len(raw) < size:
            raise ValueError(f"{len(raw)} bytes of an uncompressed strip, {size} needed")
        return np.frombuffer(raw, np.uint8, size)
    if compression == 5:
        return native.tiff_decode(raw, "lzw", size)
    if compression == 32773:
        return native.tiff_decode(raw, "packbits", size)
    try:  # deflate (8, 32946): inflate until the strip is full, as libtiff does
        out = zlib.decompressobj().decompress(raw, size)
    except zlib.error as ex:
        raise ValueError(f"corrupt deflate data ({ex})") from None
    if len(out) < size:
        raise ValueError(f"deflate data of {len(out)} bytes, {size} needed")
    return np.frombuffer(out, np.uint8)


def _samples(block: np.ndarray, rows: int, width: int, spp: int, bits: int, e: str,
             predictor: int) -> np.ndarray:
    """A decoded strip or tile as (rows, width * spp) samples (uint8 or
    native uint16; 1-4 bit samples stay packed, (rows, rowbytes))."""
    if bits < 8:
        return block.reshape(rows, -1)
    if bits == 8:
        s = block.reshape(rows, width * spp)
    else:
        s = block.view(e + "u2").reshape(rows, width * spp).astype(np.uint16)
    if predictor == 2:  # each row's differences from the sample spp to its left, summed
        s = np.cumsum(s.reshape(rows, width, spp), axis=1, dtype=s.dtype)  # (wrapping)
        s = s.reshape(rows, width * spp)
    return s


def _planes(data: bytes, e: str, tags, width: int, height: int, spp: int, bits: int,
            separate: bool, ycbcr: bool = False) -> List[np.ndarray]:
    """The image's samples: one (height, width * spp) array (contiguous) or
    spp (height, width) arrays (separate); 1-4 bit samples packed a row."""
    compression = int(_one(tags, 259, 1))
    predictor = int(_one(tags, 317, 1))
    if predictor not in (1, 2) or (predictor == 2 and bits not in (8, 16)):
        raise ValueError(f"predictor {predictor} with {bits}-bit samples")
    fill_order = int(_one(tags, 266, 1))
    tiled = 322 in tags or 324 in tags
    if tiled:
        tw, th = int(_one(tags, 322)), int(_one(tags, 323))
        if tw <= 0 or th <= 0 or tw % 16 or th % 16:
            raise ValueError(f"{tw}x{th} tiles (libtiff needs multiples of 16)")
        if bits < 8:
            raise Unsupported(f"a tiled TIFF of {bits}-bit samples")
        offsets, counts = tags.get(324), tags.get(325)
    else:
        tw, th = width, min(int(_one(tags, 278, 0xFFFFFFFF)), height)
        if th <= 0:
            raise ValueError("RowsPerStrip 0")
        offsets, counts = tags.get(273), tags.get(279)
    if offsets is None or counts is None:
        raise ValueError("no strip or tile offsets and byte counts")
    n_planes = spp if separate else 1
    pspp = 1 if separate else spp
    across, down = -(-width // tw), -(-height // th)
    need = across * down * n_planes
    if len(offsets) < need or len(counts) < need:
        raise ValueError(f"{len(offsets)} strip or tile offsets, {need} needed")
    rowbytes = (tw * pspp * bits + 7) // 8
    dtype = np.uint16 if bits == 16 else np.uint8
    cols = width * pspp if bits >= 8 else (width * pspp * bits + 7) // 8
    out = [np.zeros((height, cols), dtype) for _ in range(n_planes)]
    i = 0
    for p in range(n_planes):
        strips = []  # a plane's strips, decoded, undone together (the predictor works by row)
        for ty in range(down):
            for tx in range(across):
                off, cnt = int(offsets[i]), int(counts[i])
                i += 1
                rows = th if tiled else min(th, height - ty * th)
                raw = data[off : off + cnt]
                if len(raw) < cnt:
                    raise ValueError(f"strip or tile {i - 1} lies past the end of the file")
                if fill_order == 2:
                    raw = _REVERSE[np.frombuffer(raw, np.uint8)].tobytes()
                block = _strip_bytes(raw, compression, rows, rowbytes,
                                     (bytes(tags.get(347, b"")), ycbcr))
                if not tiled:
                    strips.append(block)
                    continue
                s = _samples(block, rows, tw, pspp, bits, e, predictor)
                y0, keep = ty * th, min(rows, height - ty * th)
                x0, x1 = tx * tw * pspp, min(width, (tx + 1) * tw) * pspp
                out[p][y0 : y0 + keep, x0:x1] = s[:keep, : x1 - x0]
        if strips:
            out[p][:] = _samples(np.concatenate(strips), height, width, pspp, bits, e,
                                 predictor)[:, :cols]
    return out


_REVERSE = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _unpack(packed: np.ndarray, width: int, bits: int) -> np.ndarray:
    """(rows, rowbytes) packed samples -> (rows, width) values."""
    h = packed.shape[0]
    b = np.unpackbits(packed, axis=1)[:, : width * bits].reshape(h, width, bits)
    weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint8)
    return (b * weights).sum(-1, dtype=np.uint8)


def _b16to8(v: np.ndarray) -> np.ndarray:
    return ((v.astype(np.uint32) * 255 + 32767) // 65535).astype(np.uint8)


def _premultiply(v: np.ndarray, a: np.ndarray) -> np.ndarray:
    return ((v.astype(np.uint32) * a[..., None] + 127) // 255).astype(np.uint8)


def decode(data: bytes) -> np.ndarray:
    """The TIFF file's first image as an (H, W, 3) uint8 RGB array, as
    cv2.imread reads it.  Raises Unsupported (what cv2 reads and this module
    does not) or ValueError (what cv2 reads no image from)."""
    e, tags = _ifd(data)
    if 256 not in tags or 257 not in tags or 262 not in tags:
        raise ValueError("no ImageWidth, ImageLength or PhotometricInterpretation")
    width, height = int(_one(tags, 256)), int(_one(tags, 257))
    if width <= 0 or height <= 0 or width * height > MAX_PIXELS:
        raise ValueError(f"a {width}x{height} image")
    photometric = int(_one(tags, 262))
    bps = tags.get(258, (1,))
    if len(set(bps)) != 1:
        raise ValueError(f"BitsPerSample {bps}: different values a sample")
    bits = int(bps[0])
    spp = int(_one(tags, 277, 1))
    compression = int(_one(tags, 259, 1))
    if compression in _COMPRESSION_NAMES:
        raise Unsupported(f"a {_COMPRESSION_NAMES[compression]}-compressed TIFF")
    if compression not in (1, 5, 7, 8, 32773, 32946):
        raise ValueError(f"compression {compression} (cv2's libtiff decodes no such)")
    # libtiff has libjpeg turn a JPEG-compressed YCbCr image into RGB
    ycbcr = photometric == 6 and compression == 7 and int(_one(tags, 284, 1)) == 1
    if photometric == 6 and not ycbcr:
        raise Unsupported("a YCbCr TIFF (not JPEG-compressed)")
    if ycbcr:
        photometric = 2
    if compression == 7 and bits != 8:
        raise ValueError(f"a JPEG-compressed TIFF of {bits}-bit samples")
    if photometric in (8, 9, 10, 32844, 32845):  # the Lab and log forms libtiff converts
        raise Unsupported(f"a TIFF of photometric interpretation {photometric}")
    if photometric not in (0, 1, 2, 3, 5):
        raise ValueError(f"photometric interpretation {photometric} (libtiff's RGBA reader "
                         "takes none such)")
    fmt = int(_one(tags, 339, 1))
    if bits not in (1, 4, 8, 16) or (bits == 4 and photometric != 3):
        raise ValueError(f"{bits}-bit samples of photometric {photometric} (cv2 reads 1, 8 and "
                         "16 bits, and 4 in a palette image)")
    if fmt == 3:
        raise ValueError("floating-point samples")
    if fmt != 1:
        raise Unsupported(f"a TIFF of sample format {fmt}")
    orient = int(_one(tags, 274, 1))
    if orient not in (1, 2, 3, 4):
        raise ValueError(f"Orientation {orient} (cv2.imread returns None for 5-8)")
    extras = tags.get(338, ())
    alpha = 0
    if extras:
        if extras[0] == 0 and spp > 3:
            alpha = 1
        elif extras[0] in (1, 2):
            alpha = int(extras[0])
    if not extras and spp == 4 and photometric == 2:
        alpha, extras = 1, (1,)
    colors = spp - len(extras)
    separate = int(_one(tags, 284, 1)) == 2 and spp > 1
    if photometric in (0, 1, 3) and not separate and spp != 1 and bits < 8:
        raise ValueError(f"{bits}-bit samples interleaved {spp} to a pixel")
    if photometric == 2 and colors < 3:
        raise ValueError(f"an RGB image of {colors} colour samples")
    if photometric == 5 and (int(_one(tags, 332, 1)) != 1 or spp < 4 or bits != 8):
        raise ValueError(f"a Separated image: InkSet {_one(tags, 332, 1)}, {spp} samples of "
                         f"{bits} bits (libtiff's RGBA reader takes 8-bit CMYK)")
    if photometric == 3 and (320 not in tags or bits == 16):
        raise ValueError("a palette image without a colormap" if 320 not in tags
                         else "a 16-bit palette image")
    if separate and (bits < 8 or photometric == 3):
        raise ValueError(f"plane-separate {bits}-bit samples of photometric {photometric}")
    planes = _planes(data, e, tags, width, height, spp, bits, separate, ycbcr)
    if separate:
        return _orient(_separate(planes, photometric, bits, colors, alpha), orient)
    s = planes[0]
    if photometric in (0, 1):
        if bits < 8:
            v = _unpack(s, width, bits)
            grey = (v.astype(np.int32) * 255 // ((1 << bits) - 1)).astype(np.uint8)
        else:
            v = s.reshape(height, width, spp)[..., 0]
            grey = (v >> 8).astype(np.uint8) if bits == 16 else v
        if photometric == 0:
            grey = 255 - grey
        return _orient(np.repeat(grey[..., None], 3, axis=2), orient)
    if photometric == 3:
        idx = _unpack(s, width, bits) if bits < 8 else s.reshape(height, width, spp)[..., 0]
        cmap = np.asarray(tags[320], np.uint32)
        n = 1 << bits
        if cmap.size < 3 * n:
            raise ValueError(f"a colormap of {cmap.size} entries, {3 * n} needed")
        cmap = cmap[: 3 * n].reshape(3, n)
        if (cmap >= 256).any():
            cmap = cmap >> 8
        return _orient(cmap.T.astype(np.uint8)[idx], orient)
    px = s.reshape(height, width, spp)
    if photometric == 5:
        k = 255 - px[..., 3].astype(np.uint32)
        rgb = (k[..., None] * (255 - px[..., :3].astype(np.uint32)) // 255).astype(np.uint8)
        return _orient(rgb, orient)
    rgb = px[..., :3]
    if bits == 16:
        rgb = _b16to8(rgb)
        if alpha == 2:
            rgb = _premultiply(rgb, _b16to8(px[..., 3]))
    elif alpha == 2:
        rgb = _premultiply(rgb, px[..., 3])
    return _orient(np.ascontiguousarray(rgb), orient)


def _separate(planes, photometric: int, bits: int, colors: int, alpha: int) -> np.ndarray:
    """gtStripSeparate / gtTileSeparate: grey reads as three equal planes,
    through the RGB routines."""
    if photometric == 5:
        c, m, y, k = (p.astype(np.uint32) for p in planes[:4])
        kk = 255 - k
        return np.stack([kk * (255 - c) // 255, kk * (255 - m) // 255, kk * (255 - y) // 255],
                        -1).astype(np.uint8)
    rgb = np.stack(planes[:3] if colors >= 3 else [planes[0]] * 3, -1)
    a = planes[colors] if alpha and len(planes) > colors else None
    if bits == 16:
        rgb = _b16to8(rgb)
        a = None if a is None else _b16to8(a)
    if alpha == 2 and a is not None:
        rgb = _premultiply(rgb, a)
    return np.ascontiguousarray(rgb)


def _orient(img: np.ndarray, orient: int) -> np.ndarray:
    return np.ascontiguousarray(_ORIENT[orient](img)) if orient in _ORIENT else img


ROWS_PER_STRIP_BYTES = 8192  # cv2's strip size


def encode(image: np.ndarray) -> bytes:
    """An (H, W, 3) RGB or (H, W) grey uint8 image as the bytes
    cv2.imwrite writes to a .tif file."""
    h, w = image.shape[:2]
    ch = 1 if image.ndim == 2 else 3
    row = w * ch
    rps = max(1, min(h, ROWS_PER_STRIP_BYTES // row))
    px = image.reshape(h, w, ch)
    diff = np.empty_like(px)  # predictor 2: each sample less the one a pixel to its left
    diff[:, 0] = px[:, 0]
    diff[:, 1:] = px[:, 1:] - px[:, :-1]
    diff = diff.reshape(h, row)
    strips = [native.tiff_lzw_encode(diff[y : y + rps]) for y in range(0, h, rps)]
    offsets, pos = [], 8
    for s in strips:
        offsets.append(pos)
        pos += len(s)
    ifd = pos + (pos & 1)

    def short_or_long(v):
        return (3, [v]) if v <= 0xFFFF else (4, [v])

    many = len(strips) > 1
    # libtiff writes the byte counts as SHORT when a strip, uncompressed, is
    # under a tenth of 65535 bytes (its worst case for LZW is ten times that)
    counts_type = 3 if many and rps * row < 65535 // 10 else 4
    entries = {256: short_or_long(w), 257: short_or_long(h), 258: (3, [8] * ch), 259: (3, [5]),
               262: (3, [2 if ch == 3 else 1]), 273: (4, offsets), 277: (3, [ch]),
               278: short_or_long(rps), 279: (counts_type, [len(s) for s in strips]),
               284: (3, [1]), 317: (3, [2]), 339: (3, [1] * ch)}
    out_of_line_order = (258, 279, 273, 339)  # the order libtiff writes the values in
    extra_at = ifd + 2 + 12 * len(entries) + 4
    values, where = b"", {}
    for tag in out_of_line_order:
        typ, v = entries[tag]
        raw = struct.pack("<" + _TYPES[typ] * len(v), *v)
        if len(raw) > 4:
            where[tag] = extra_at + len(values)
            values += raw
    body = b""
    for tag in sorted(entries):
        typ, v = entries[tag]
        raw = struct.pack("<" + _TYPES[typ] * len(v), *v)
        body += struct.pack("<HHI", tag, typ, len(v))
        body += struct.pack("<I", where[tag]) if tag in where else raw.ljust(4, b"\0")
    return b"".join([b"II*\0", struct.pack("<I", ifd), *strips, b"\0" * (ifd - pos),
                     struct.pack("<H", len(entries)), body, b"\0\0\0\0", values])
