"""WebP files as cv2 reads them (libwebp under cv2.imread, FFmpeg's webp
decoder under cv2.VideoCapture) and writes them (lossless), without cv2,
PIL or libwebp.

`parse` reads the RIFF container: a simple file (one `VP8 ` or `VP8L`
chunk) or an extended one (`VP8X`, then `ICCP`, `ANIM` / `ANMF` frames,
`ALPH`, the image chunk, `EXIF`, `XMP ` and unknown chunks, skipped).  A
file whose sizes do not hold together raises ValueError.

`decode` returns what `cv2.imread(path)` returns, in RGB order, with the
EXIF Orientation of an `EXIF` chunk (imageio applies it):
- a lossy image: its VP8 key frame (native/vp8.cpp in libwebp's mode: the
  planes FFmpeg's decoder also makes, but the last partition running on to
  the file's end, as cv2 hands libwebp the whole file, and a read past a
  partition's end a ValueError, as libwebp then returns no image) through
  libwebp's fancy upsampler and its YUV -> RGB conversion (native/webp.cpp);
- a lossless image: native/webp.cpp's VP8L decoder, alpha dropped;
- alpha (`ALPH`, or VP8L's own) is dropped, not blended, as cv2 does; an
  `ALPH` chunk is still checked as libwebp and FFmpeg decode it (its
  header, a raw plane's size, a VP8L-coded plane decoded), and a corrupt
  one raises ValueError, as both then return no picture;
- an animation: its first frame, at its offset on a black canvas;
- a canvas past cv2's limits (a side over 2**20, over 2**30 pixels) raises
  ValueError, as cv2.imread returns None.

`video_frame` returns what cv2.VideoCapture returns of a lone WebP given
as a video (FFmpeg's image2 demuxer and webp decoder): a lossy image
through vp8.cpp's swscale route (up to tens of levels from imread; the
bytes after the chunk readable past its end, as FFmpeg's are), a
lossless one as imread reads it but where FFmpeg's vp8l decoder departs
from libwebp on streams no encoder writes (native.vp8l_decode's ffmpeg);
no orientation either way; an animation raises ValueError, as cv2
decodes no frame of it.

`encode` writes a lossless VP8L file (native/webp.cpp's encoder), as
`cv2.imwrite(path.webp)` does with no parameters: the pixels read back are
the ones written, the bytes are not libwebp's.
"""

from __future__ import annotations

import struct
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from .. import native

MAGIC = b"RIFF"
MAX_SIDE = 16383  # libwebp's WEBP_MAX_DIMENSION
ANIMATION = 0x02  # a VP8X flag


class Frame(NamedTuple):
    """One image of a WebP file: its codec ("VP8" or "VP8L"), bitstream,
    `ALPH` chunk (or None), offset on the canvas, and the file's bytes from
    the bitstream on (FFmpeg's vp8 range decoder may read a byte past the
    chunk's end)."""

    codec: str
    bitstream: bytes
    alpha: Optional[bytes]
    x: int = 0
    y: int = 0
    rest: bytes = b""


class WebP(NamedTuple):
    width: int  # the canvas (VP8X's, else the image's)
    height: int
    frames: Tuple[Frame, ...]
    animated: bool
    exif: bytes


def is_webp(data: bytes) -> bool:
    return data[:4] == MAGIC and data[8:12] == b"WEBP"


def _chunks(data: bytes, start: int, end: int) -> List[Tuple[bytes, bytes, int]]:
    """(fourcc, body, the body's offset in `data`) of each chunk."""
    out, pos = [], start
    while pos < end:
        if pos + 8 > end:
            raise ValueError("a chunk header cut short")
        fourcc = data[pos : pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4 : pos + 8])
        if pos + 8 + size > end:
            raise ValueError(f"the {fourcc!r} chunk runs past the file ({size} bytes)")
        out.append((fourcc, data[pos + 8 : pos + 8 + size], pos + 8))
        pos += 8 + size + (size & 1)
    return out


def _u24(b: bytes) -> int:
    return b[0] | b[1] << 8 | b[2] << 16


def _image(chunks, data: bytes, where: str) -> Frame:
    """The frame of an image's chunks: an optional ALPH, then VP8 or VP8L."""
    alpha = None
    for fourcc, body, at in chunks:
        if fourcc == b"ALPH":
            alpha = body
        elif fourcc in (b"VP8 ", b"VP8L"):
            return Frame(fourcc.decode().strip(), body, alpha, rest=data[at:])
    raise ValueError(f"no VP8 or VP8L chunk in {where}")


def parse(data: bytes) -> WebP:
    if not is_webp(data) or len(data) < 20:
        raise ValueError("not a WebP file")
    (riff,) = struct.unpack("<I", data[4:8])
    if riff < 12 or riff + 8 > len(data):
        raise ValueError(f"a RIFF size of {riff} for a file of {len(data)} bytes")
    chunks = _chunks(data, 12, 8 + riff)
    first = chunks[0][0]
    if first in (b"VP8 ", b"VP8L"):
        frame = _image(chunks[:1], data, "the file")
        w, h = bitstream_size(frame)
        return WebP(w, h, (frame,), False, b"")
    if first != b"VP8X" or len(chunks[0][1]) < 10:
        raise ValueError(f"a WebP file starting with a {first!r} chunk")
    head = chunks[0][1]
    flags, w, h = head[0], _u24(head[4:7]) + 1, _u24(head[7:10]) + 1
    exif = next((body for fourcc, body, _ in chunks if fourcc == b"EXIF"), b"")
    if flags & ANIMATION:
        frames = []
        for fourcc, body, at in chunks:
            if fourcc != b"ANMF":
                continue
            if len(body) < 16:
                raise ValueError("an ANMF chunk cut short")
            frame = _image([(f, b, at + o) for f, b, o in _chunks(body, 16, len(body))], data,
                           "an ANMF chunk")
            frames.append(frame._replace(x=2 * _u24(body[0:3]), y=2 * _u24(body[3:6])))
            fw, fh = bitstream_size(frame)
            if (_u24(body[6:9]) + 1, _u24(body[9:12]) + 1) != (fw, fh) or (
                    frames[-1].x + fw > w or frames[-1].y + fh > h):
                raise ValueError(f"an animation frame of {fw}x{fh} at ({frames[-1].x}, "
                                 f"{frames[-1].y}) does not fit its {w}x{h} canvas")
        return WebP(w, h, tuple(frames), True, exif)
    frame = _image(chunks[1:], data, "the file")
    if bitstream_size(frame) != (w, h):
        raise ValueError(f"a {w}x{h} VP8X canvas around a {bitstream_size(frame)} image")
    return WebP(w, h, (frame,), False, exif)


def bitstream_size(frame: Frame) -> Tuple[int, int]:
    """(width, height) from a VP8 key frame's or a VP8L stream's header."""
    b = frame.bitstream
    if frame.codec == "VP8L":
        if len(b) < 5 or b[0] != 0x2F:
            raise ValueError("a VP8L chunk without its signature")
        bits = int.from_bytes(b[1:5], "little")
        return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1
    if len(b) < 10 or b[0] & 1 or b[3:6] != b"\x9d\x01\x2a":
        raise ValueError("a VP8 chunk that is not a key frame")
    w, h = struct.unpack("<HH", b[6:10])
    return w & 0x3FFF, h & 0x3FFF


def orientation_tiff(exif: bytes) -> bytes:
    """The TIFF structure of an EXIF chunk (an "Exif\\0\\0" prefix dropped)."""
    return exif[6:] if exif.startswith(b"Exif\0\0") else exif


def check_alpha(alpha: bytes, width: int, height: int) -> None:
    """ValueError unless an ALPH chunk decodes as libwebp's ALPHDecode
    would: its header's fields in range, a raw plane whole, a VP8L-coded
    one decoding to width x height."""
    if not alpha:
        raise ValueError("an empty ALPH chunk")
    method, pre, reserved = alpha[0] & 3, (alpha[0] >> 4) & 3, alpha[0] >> 6  # any filter 0-3
    if method > 1 or pre > 1 or reserved:
        raise ValueError(f"an ALPH header 0x{alpha[0]:02x}")
    if method == 0:
        if len(alpha) - 1 < width * height:
            raise ValueError(f"a raw ALPH plane of {len(alpha) - 1} bytes for {width}x{height}")
    else:
        native.vp8l_decode_image(alpha[1:], width, height)


def _lossy(bitstream: bytes, planes: bool, after: bytes = b"") -> np.ndarray:
    """planes: libwebp's decoding and conversion (imread), else FFmpeg's."""
    dec = native.Vp8Decoder(libwebp=planes)
    try:
        rgb = dec.decode(bitstream, after)
        if rgb is None or not dec.info["keyframe"]:
            raise ValueError("a VP8 chunk that shows no key frame")
        return native.webp_yuv_rgb(*dec.planes()) if planes else rgb
    except NotImplementedError as e:
        raise ValueError(f"VP8: {e}") from None
    finally:
        dec.close()


def _lossless(bitstream: bytes, ffmpeg: bool = False) -> np.ndarray:
    argb, _ = native.vp8l_decode(bitstream, ffmpeg)
    return np.ascontiguousarray(argb.view(np.uint8).reshape(*argb.shape, 4)[..., 2::-1])


def decode_frame(frame: Frame) -> np.ndarray:
    """One frame as libwebp gives it to cv2.imread, (h, w, 3) RGB: cv2
    hands libwebp the whole file, so a lossy frame's last partition runs
    on past its chunk to the file's end."""
    if frame.codec == "VP8L":
        return _lossless(frame.bitstream)
    img = _lossy(frame.bitstream, planes=True, after=frame.rest[len(frame.bitstream):])
    if frame.alpha is not None:
        check_alpha(frame.alpha, img.shape[1], img.shape[0])
    return img


def decode(data: bytes) -> Tuple[np.ndarray, bytes]:
    """(RGB pixels as cv2.imread reads them before the orientation, the
    EXIF chunk's TIFF structure)."""
    webp = parse(data)
    if not webp.frames:
        raise ValueError("an animation without frames")
    if webp.width > 1 << 20 or webp.height > 1 << 20 or webp.width * webp.height > 1 << 30:
        raise ValueError(f"a {webp.width}x{webp.height} WebP: past cv2's image size limits")
    frame = webp.frames[0]
    img = decode_frame(frame)
    if webp.animated:
        canvas = np.zeros((webp.height, webp.width, 3), np.uint8)
        canvas[frame.y : frame.y + img.shape[0], frame.x : frame.x + img.shape[1]] = img
        img = canvas
    return img, orientation_tiff(webp.exif)


def video_frame(data: bytes) -> np.ndarray:
    """A lone WebP as FFmpeg's webp decoder and swscale hand it to cv2."""
    webp = parse(data)
    if webp.animated:
        raise ValueError("an animated WebP: FFmpeg's webp decoder reads no frame of it")
    frame = webp.frames[0]
    if frame.codec == "VP8L":
        return _lossless(frame.bitstream, ffmpeg=True)
    img = _lossy(frame.bitstream, planes=False, after=frame.rest[len(frame.bitstream):])
    if frame.alpha is not None:
        check_alpha(frame.alpha, img.shape[1], img.shape[0])
    return img


def encode(image: np.ndarray) -> bytes:
    """An (H, W, 3) RGB or (H, W) grey uint8 image as a lossless WebP file."""
    if image.ndim == 2:
        image = np.repeat(image[..., None], 3, axis=2)
    h, w = image.shape[:2]
    if h > MAX_SIDE or w > MAX_SIDE:
        raise ValueError(f"a {w}x{h} image: WebP sides are at most {MAX_SIDE}")
    bitstream = native.vp8l_encode(image)
    chunk = b"VP8L" + struct.pack("<I", len(bitstream)) + bitstream + b"\0" * (len(bitstream) & 1)
    return MAGIC + struct.pack("<I", 4 + len(chunk)) + b"WEBP" + chunk
