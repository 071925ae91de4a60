"""BMP files as cv2 reads and writes them (OpenCV's own codec,
grfmt_bmp.cpp), without cv2 or PIL.

`decode` returns what `cv2.imread(path)` returns, in RGB order:

- headers: BITMAPINFOHEADER and every longer one (V2-V5: 36 bytes or more)
  and the OS/2 BITMAPCOREHEADER (12 bytes, 3-byte palette entries);
- 1, 4 and 8 bits through the palette (its `clrused` entries, else 2^bits;
  an index past them reads black); 16 bits as 5-5-5 (BI_RGB, or
  BI_BITFIELDS with those masks) or 5-6-5 (BI_BITFIELDS), each field
  shifted up with zero low bits; 24 bits; 32 bits as B, G, R with the
  fourth byte dropped, or, under a V4 / V5 header with BI_BITFIELDS and
  nonzero red, green and blue masks, each channel (pixel & mask) >> shift;
- BI_RLE8 and BI_RLE4 (native/bmp.cpp: runs, absolute runs, end of line,
  end of bitmap and delta, skipped pixels filled with palette entry 0);
- bottom-up rows, or top-down for a negative height.

The 16-bit masks are read from the 12 bytes after the header, whatever its
size, as OpenCV reads them; other masks, other compressions (JPEG, PNG in
a BMP) and other bit counts make cv2 read no image, and raise ValueError,
as does data that ends early.

`encode` writes what `cv2.imwrite(path.bmp)` writes: a BITMAPINFOHEADER
file, bottom-up, rows padded to 4 bytes; 24-bit BGR, or for a grey image 8
bits with a 256-entry grey palette.
"""

from __future__ import annotations

import struct

import numpy as np

from .. import native

MAGIC = b"BM"
MAX_PIXELS = 1 << 30  # cv2's CV_IO_MAX_IMAGE_PIXELS
BI_RGB, BI_RLE8, BI_RLE4, BI_BITFIELDS = 0, 1, 2, 3
_MASKS_555 = (0x7C00, 0x3E0, 0x1F)
_MASKS_565 = (0xF800, 0x7E0, 0x1F)


def _u32(data: bytes, at: int) -> int:
    if at + 4 > len(data):
        raise ValueError("the file ends inside its header")
    return struct.unpack("<I", data[at : at + 4])[0]


def _i32(data: bytes, at: int) -> int:
    if at + 4 > len(data):
        raise ValueError("the file ends inside its header")
    return struct.unpack("<i", data[at : at + 4])[0]


def _shift(mask: int) -> int:
    return (mask & -mask).bit_length() - 1


def decode(data: bytes) -> np.ndarray:
    """The BMP file's bytes as an (H, W, 3) uint8 RGB array, as cv2.imread
    reads them; ValueError where cv2 reads no image."""
    offset, size = _u32(data, 10), _u32(data, 14)
    masks32 = None
    if size >= 36:
        width, height = _i32(data, 18), _i32(data, 22)
        bpp = _u32(data, 26) >> 16
        comp, clrused = _u32(data, 30), _u32(data, 46)
        if comp > BI_BITFIELDS:
            raise ValueError(f"compression {comp} (cv2 reads BI_RGB, BI_RLE8, BI_RLE4 and "
                             "BI_BITFIELDS)")
        pal_at, entry = 14 + size, 4
        if bpp == 32 and comp == BI_BITFIELDS and size >= 56:
            masks32 = [_u32(data, 54 + 4 * i) for i in range(3)]
        ok = width > 0 and height != 0 and (
            (bpp in (1, 4, 8, 16, 24, 32) and comp == BI_RGB)
            or (bpp in (16, 32) and comp == BI_BITFIELDS)
            or (bpp == 4 and comp == BI_RLE4) or (bpp == 8 and comp == BI_RLE8))
        if not ok:
            raise ValueError(f"{bpp} bits a pixel with compression {comp}, {width}x{height}")
        if bpp <= 8 and clrused > 256:
            raise ValueError(f"a palette of {clrused} entries")
        n_pal = (clrused or 1 << bpp) if bpp <= 8 else 0
        if bpp == 16:
            if comp == BI_BITFIELDS:
                masks = tuple(_u32(data, pal_at + 4 * i) for i in range(3))
                if masks not in (_MASKS_555, _MASKS_565):
                    raise ValueError(f"16-bit masks {[hex(m) for m in masks]} (cv2 reads 5-5-5 "
                                     "and 5-6-5)")
                bpp = 15 if masks == _MASKS_555 else 16
            else:
                bpp = 15
    elif size == 12:
        if len(data) < 26:
            raise ValueError("the file ends inside its header")
        width, height, _, bpp = struct.unpack("<HHHH", data[18:26])
        comp, pal_at, entry = BI_RGB, 26, 3
        if not (width > 0 and height != 0 and bpp in (1, 4, 8, 24, 32)):
            raise ValueError(f"an OS/2 header of {bpp} bits a pixel, {width}x{height}")
        n_pal = 1 << bpp if bpp <= 8 else 0
    else:
        raise ValueError(f"a {size}-byte bitmap header")
    bottom_up = height > 0
    height = abs(height)
    if width * height > MAX_PIXELS or width > 1 << 20 or height > 1 << 20:
        raise ValueError(f"a {width}x{height} image")
    palette = np.zeros((256, 3), np.uint8)
    if n_pal:
        raw = data[pal_at : pal_at + entry * n_pal]
        if len(raw) < entry * n_pal:
            raise ValueError("the file ends inside its palette")
        palette[:n_pal] = np.frombuffer(raw, np.uint8).reshape(n_pal, entry)[:, 2::-1]
    pixels = data[offset:] if offset <= len(data) else b""
    if comp in (BI_RLE8, BI_RLE4):
        rows = native.bmp_rle(pixels, bpp, width, height)
        rgb = palette[rows]
    else:
        pitch = ((width * (16 if bpp == 15 else bpp) + 7) // 8 + 3) & -4
        if len(pixels) < pitch * height:
            raise ValueError(f"{len(pixels)} bytes of pixels, {pitch * height} needed")
        rows = np.frombuffer(pixels, np.uint8, pitch * height).reshape(height, pitch)
        rgb = _rows(rows, width, bpp, palette, masks32)
    return np.ascontiguousarray(rgb[::-1] if bottom_up else rgb)


def _rows(rows: np.ndarray, width: int, bpp: int, palette: np.ndarray, masks32) -> np.ndarray:
    h = rows.shape[0]
    if bpp <= 8:
        bits = np.unpackbits(rows, axis=1)[:, : width * bpp].reshape(h, width, bpp)
        weights = (1 << np.arange(bpp - 1, -1, -1)).astype(np.uint8)
        return palette[(bits * weights).sum(-1, dtype=np.uint8)]
    if bpp in (15, 16):
        t = rows[:, : 2 * width].copy().view("<u2").astype(np.int32)
        b = t << 3
        g = (t >> 2) & ~7 if bpp == 15 else (t >> 3) & ~3
        r = (t >> 7) & ~7 if bpp == 15 else (t >> 8) & ~7
        return (np.stack([r, g, b], -1) & 255).astype(np.uint8)
    if bpp == 24:
        return rows[:, : 3 * width].reshape(h, width, 3)[..., ::-1]
    px = rows[:, : 4 * width].reshape(h, width, 4)
    if masks32 is not None and all(masks32):
        p = px.copy().view("<u4")[..., 0].astype(np.uint64)
        return np.stack([((p & m) >> _shift(m)) & 255 for m in masks32], -1).astype(np.uint8)
    return px[..., 2::-1]


def encode(image: np.ndarray) -> bytes:
    """An (H, W, 3) RGB or (H, W) grey uint8 image as the bytes
    cv2.imwrite writes to a .bmp file."""
    h, w = image.shape[:2]
    ch = 1 if image.ndim == 2 else 3
    step = (w * ch + 3) & -4
    palette = b"" if ch == 3 else np.repeat(np.arange(256, dtype=np.uint8), 4).reshape(256, 4)
    if ch == 1:
        palette[:, 3] = 0
        palette = palette.tobytes()
    header = 14 + 40 + len(palette)
    rows = np.zeros((h, step), np.uint8)
    rows[:, : w * ch] = (image if ch == 1 else image[..., ::-1]).reshape(h, w * ch)
    return b"".join([MAGIC, struct.pack("<IIIIiiHHIIIIII", step * h + header, 0, header, 40, w, h,
                                        1, 8 * ch, BI_RGB, 0, 0, 0, 0, 0),
                     palette, rows[::-1].tobytes()])
