"""Netpbm files (P1-P6) as cv2 reads and writes them (OpenCV's own codec,
grfmt_pxm.cpp), without cv2 or PIL.

`decode` returns what `cv2.imread(path)` returns, in RGB order:

- the header's numbers separated by whitespace and `#` comments (to the
  end of the line), the data starting one byte after the last number;
- P1 / P4 (bitmaps): 1 is black, 0 white; P1's digits need no space
  between them;
- P2 / P3 (plain): each number clamped to maxval, then scaled to 0-255 as
  v * 255 // maxval, or, when maxval is over 255, its high byte (v >> 8);
- P5 / P6 (raw): bytes as stored, whatever maxval below 256 says (a maxval
  of 100 is not stretched); 16-bit samples (maxval over 255, big-endian) to
  their high byte;
- grey is replicated to three channels.

A maxval of 0 or over 65535, a character that is no digit, space or
comment where a number is due, and data that ends early make cv2 read no
image, and raise ValueError.

`encode` writes what `cv2.imwrite` writes: binary P6 (RGB) for `.ppm`, P5
for `.pgm`, either by the image's channels for `.pnm`, with the header
"P6\\n<w> <h>\\n255\\n"; a grey image to `.ppm` or an RGB one to `.pgm`
raises ValueError, as cv2.imwrite refuses it.
"""

from __future__ import annotations

import numpy as np

MAX_PIXELS = 1 << 30  # cv2's CV_IO_MAX_IMAGE_PIXELS
_SPACE = b" \t\n\v\f\r"


def is_pnm(data: bytes) -> bool:
    """OpenCV's PxM signature: P1-P6 and a whitespace byte."""
    return len(data) >= 3 and data[:1] == b"P" and data[1:2] in b"123456" and data[2] in _SPACE


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise ValueError("the file ends early")
        self.pos += 1
        return self.data[self.pos - 1]

    def number(self, maxdigits: int = 0) -> int:
        """OpenCV's ReadNumber: skip spaces and comments, read digits (at
        most maxdigits when given), consuming the byte after them."""
        c = self.byte()
        while not 48 <= c <= 57:
            if c == 35:  # '#': to the end of the line
                while c not in (10, 13):
                    c = self.byte()
                c = self.byte()
            elif c in _SPACE:
                while c in _SPACE:
                    c = self.byte()
            else:
                raise ValueError(f"byte {c:#x} where a number is due")
        val = digits = 0
        while True:
            val = val * 10 + c - 48
            if val > 0x7FFFFFFF:
                raise ValueError("a number too large")
            digits += 1
            if maxdigits and digits >= maxdigits:
                break
            c = self.byte()
            if not 48 <= c <= 57:
                break
        return val


def decode(data: bytes) -> np.ndarray:
    """The PNM file's bytes as an (H, W, 3) uint8 RGB array, as cv2.imread
    reads them; ValueError where cv2 reads no image."""
    if not is_pnm(data):
        raise ValueError("not a PNM file")
    kind = data[1] - 48
    r = _Reader(data)
    r.pos = 2
    width, height = r.number(), r.number()
    maxval = r.number() if kind not in (1, 4) else 1
    if maxval > 65535 or not (width > 0 and height > 0 and maxval > 0):
        raise ValueError(f"a {width}x{height} image of maxval {maxval}")
    if width * height > MAX_PIXELS or width > 1 << 20 or height > 1 << 20:
        raise ValueError(f"a {width}x{height} image")
    ch = 3 if kind in (3, 6) else 1
    n = width * height * ch
    if kind == 1:
        vals = np.empty(n, np.uint8)
        for i in range(n):  # digits, one a pixel
            vals[i] = r.number(1) != 0
        grey = np.where(vals.reshape(height, width) != 0, 0, 255).astype(np.uint8)
    elif kind == 4:
        pitch = (width + 7) // 8
        raw = data[r.pos : r.pos + pitch * height]
        if len(raw) < pitch * height:
            raise ValueError(f"{len(raw)} bytes of pixels, {pitch * height} needed")
        bits = np.unpackbits(np.frombuffer(raw, np.uint8).reshape(height, pitch), axis=1)
        grey = np.where(bits[:, :width] != 0, 0, 255).astype(np.uint8)
    elif kind in (2, 3):
        vals = np.array([r.number() for _ in range(n)], np.int64).clip(0, maxval)
        if maxval > 255:
            out = (vals >> 8).astype(np.uint8)
        else:
            out = (vals * 255 // maxval).astype(np.uint8)
        grey = out.reshape(height, width, ch)
    else:
        size = n * (2 if maxval > 255 else 1)
        raw = data[r.pos : r.pos + size]
        if len(raw) < size:
            raise ValueError(f"{len(raw)} bytes of pixels, {size} needed")
        out = np.frombuffer(raw, np.uint8)
        if maxval > 255:
            out = out[::2]  # the high byte of each big-endian sample
        grey = out.reshape(height, width, ch)
    if grey.ndim == 2 or grey.shape[2] == 1:
        grey = grey.reshape(height, width)
        return np.repeat(grey[..., None], 3, axis=2)
    return np.ascontiguousarray(grey)


EXTENSIONS = {".ppm": 3, ".pgm": 1, ".pnm": 0}


def encode(image: np.ndarray, ext: str) -> bytes:
    """An (H, W, 3) RGB or (H, W) grey uint8 image as the bytes
    cv2.imwrite writes to a file of extension `ext` (.ppm, .pgm or .pnm)."""
    h, w = image.shape[:2]
    ch = 1 if image.ndim == 2 else 3
    want = EXTENSIONS[ext]
    if want and want != ch:
        raise ValueError(f"a {'grey' if ch == 1 else 'colour'} image to {ext} (cv2.imwrite "
                         f"writes {'colour' if want == 3 else 'grey'} images there)")
    return f"P{5 if ch == 1 else 6}\n{w} {h}\n255\n".encode() + np.ascontiguousarray(
        image).tobytes()
