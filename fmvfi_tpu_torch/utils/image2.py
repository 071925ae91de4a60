"""Lone images and numbered image sequences as cv2.VideoCapture reads them:
FFmpeg's image2 demuxer, its PNG, Motion-JPEG and WebP decoders, and
swscale's conversion to BGR24, without cv2 or FFmpeg.

- A path with one printf number (`%d`, `%05d`, `%5d`, read as `%05d`;
  `%%` a literal percent sign) and an image extension is a sequence: the
  first number is the first of 0-4 whose file exists, and the frames run
  until the first number whose file is missing (av_get_frame_filename,
  img2dec.c's find_image_range).  Its extension picks the decoder
  (ff_guess_image2_codec).
- Any other path is one file, its decoder told by its bytes.
- PNG frames (FFmpeg's png decoder) keep the pixels `imageio.imread` reads
  at 8 bits or fewer, whatever the colour type (swscale's conversion from
  rgb24, rgba, gray8, ya8, pal8 and monob to BGR24 is exact); 16-bit
  samples go through swscale's full path (native/png.cpp's
  fmvfi_png16_swscale), within one level of imread's high byte.  An
  interlaced (Adam7) PNG raises NotImplementedError: FFmpeg 8's swscale
  refuses to convert an interlaced frame, and cv2 returns a buffer it
  never wrote.
- JPEG frames go through native/mjpeg.cpp (FFmpeg's decoder and swscale's
  yuvj -> BGR24 routes), not libjpeg: they differ from imread by up to tens
  of levels.
- WebP frames go through FFmpeg's webp decoder (utils/webp.py's
  video_frame): a lossy one through vp8.cpp's swscale route, not libwebp's
  upsampler (up to tens of levels from imread), a lossless one as imread
  reads it.  An animated WebP is no frame (FFmpeg's decoder refuses it):
  ValueError "no frames decoded", as JAX's read_video_frames raises.
- A numbered sequence of GIFs is not FFmpeg's to read (it opens none):
  cv2 falls back to its own image backend, which reads each file's first
  image as cv2.imread does, alpha dropped (utils/gif.py's decode).  A lone
  GIF is a clip of its own (pipeline/video.py reads every image of it
  through utils/gif.py's frames, as FFmpeg's gif demuxer does).
- No EXIF orientation is applied (FFmpeg ignores it).

Sequences and lone files of the other formats image2 reads (BMP, TIFF,
PNM, ...) raise NotImplementedError naming ROADMAP item 18.4k: they need
FFmpeg's own decoders for them.
"""

from __future__ import annotations

import os
import re
from typing import Callable, Iterator, List, Optional

import numpy as np

from .. import native
from . import formats, gif, imageio, webp

# image2's extension table (img2.c's img_tags), the decoders the port has by
# name and the others by the format they name
EXTENSIONS = {"png": "png", "jpeg": "mjpeg", "jpg": "mjpeg", "jps": "mjpeg", "mpo": "mjpeg",
              "bmp": "BMP", "tiff": "TIFF", "tif": "TIFF", "dng": "TIFF", "pgm": "PNM",
              "ppm": "PNM", "pbm": "PNM", "pam": "PAM", "pfm": "PFM", "gif": "gif",
              "webp": "webp", "jp2": "JPEG 2000", "j2k": "JPEG 2000", "j2c": "JPEG 2000",
              "ras": "Sun raster", "sun": "Sun raster", "hdr": "Radiance HDR", "exr": "OpenEXR",
              "tga": "Targa", "dpx": "DPX", "sgi": "SGI", "qoi": "QOI", "pcx": "PCX",
              "xbm": "XBM", "xwd": "XWD", "jxl": "JPEG XL", "dds": "DDS"}
START_RANGE = 5  # find_image_range's start_index_range: first numbers 0-4
_NUMBER = re.compile(r"%(\d*)(.)")


def frame_filename(path: str, number: int) -> Optional[str]:
    """av_get_frame_filename: `path` with its one `%d` replaced by `number`
    (zero-padded to the width given), or None when `path` is no pattern
    (no `%d`, two, or a `%` before anything but digits, `d` and `%`)."""
    out, pos, found = [], 0, False
    for m in _NUMBER.finditer(path):
        out.append(path[pos : m.start()])
        width, c = m.group(1), m.group(2)
        if c == "%" and not width:
            out.append("%")
        elif c == "d" and not found:
            found = True
            out.append(f"{number:0{int(width or 0)}d}")
        else:
            return None
        pos = m.end()
    if "%" in path[pos:]:
        return None
    out.append(path[pos:])
    return "".join(out) if found else None


def is_sequence(path: str) -> bool:
    """Whether image2 reads `path` as a numbered sequence: a pattern with
    an image extension."""
    ext = os.path.splitext(path)[1][1:].lower()
    return ext in EXTENSIONS and frame_filename(path, 1) is not None


def sequence_paths(path: str) -> List[str]:
    """The files of a sequence's frames, in order (empty when none of the
    numbers 0-4 names a file)."""
    first = next((i for i in range(START_RANGE) if os.path.isfile(frame_filename(path, i))), None)
    if first is None:
        return []
    paths, i = [], first
    while os.path.isfile(frame_filename(path, i)):
        paths.append(frame_filename(path, i))
        i += 1
    return paths


def decoder(path: str, head: bytes) -> Callable[[bytes, str], np.ndarray]:
    """The frame decoder for a sequence `path` (by its extension) or a lone
    file whose bytes begin with `head`; NotImplementedError (item 18.4k)
    for a format whose FFmpeg decoder the port lacks."""
    if is_sequence(path):
        kind = EXTENSIONS[os.path.splitext(path)[1][1:].lower()]
    else:
        kind = {"PNG": "png", "JPEG": "mjpeg", "WebP": "webp"}.get(imageio.image_format(head),
                                                                   imageio.image_format(head))
    if kind == "png":
        return png_frame
    if kind == "mjpeg":
        return jpeg_frame
    if kind == "webp":
        return webp_frame
    if kind == "gif":
        return gif_frame
    what = "a numbered sequence of " + kind + " images" if is_sequence(path) else f"a {kind} image"
    raise formats.unsupported(path, what, "18.4k")


def iter_frames(path: str) -> Iterator[np.ndarray]:
    """The frames of a lone image or a sequence, (H, W, 3) uint8 RGB, as
    cv2.VideoCapture returns them; ValueError when there is none."""
    paths = sequence_paths(path) if is_sequence(path) else [path]
    if not paths:
        raise ValueError(f"no frames decoded from {path} (no file numbered 0-4)")
    with open(paths[0], "rb") as f:
        decode = decoder(path, f.read(16))
    for i, p in enumerate(paths):
        with open(p, "rb") as f:
            data = f.read()
        try:
            yield decode(data, p)
        except NoFrame as e:
            raise ValueError(f"no frames decoded from {path} ({e})") from None
        except NotImplementedError as e:
            raise NotImplementedError(f"{path}: frame {i}: {e} (ROADMAP Queue 1, item 18.4k: "
                                      "FFmpeg decodes it otherwise)") from None
        except ValueError as e:
            raise ValueError(f"{path}: frame {i}: {e}") from None


class NoFrame(ValueError):
    """A file FFmpeg's decoder returns no frame of."""


def webp_frame(data: bytes, path: str) -> np.ndarray:
    """A WebP file as FFmpeg's webp decoder and swscale hand it to cv2."""
    try:
        if webp.parse(data).animated:
            raise NoFrame(f"{path}: an animated WebP, which FFmpeg's webp decoder does not read")
        return webp.video_frame(data)
    except NoFrame:
        raise
    except ValueError as e:
        raise ValueError(f"{path}: WebP: {e}") from None


def gif_frame(data: bytes, path: str) -> np.ndarray:
    """A GIF of a numbered sequence as cv2's own image backend reads it:
    cv2.imread's first image."""
    try:
        return gif.decode(data)
    except ValueError as e:
        raise ValueError(f"{path}: GIF: {e}") from None


def jpeg_frame(data: bytes, path: str) -> np.ndarray:
    """A JPEG file as FFmpeg's mjpeg decoder and swscale hand it to cv2."""
    if not data.startswith(b"\xff\xd8\xff"):
        raise ValueError(f"{path}: not a JPEG file")
    return native.mjpeg_decode(data)


def png_frame(data: bytes, path: str) -> np.ndarray:
    """A PNG file as FFmpeg's png decoder and swscale hand it to cv2."""
    raw = imageio.read_raw_bytes(data, path)
    if raw.passes[0].dx != 1:
        raise NotImplementedError("an interlaced (Adam7) PNG: FFmpeg 8's swscale refuses to "
                                  "convert interlaced frames, and cv2 returns a buffer it never "
                                  "wrote")
    if raw.depth != 16:
        return imageio.decode_png(data, path, orient=False)
    spp = {0: 1, 2: 3, 4: 2, 6: 4}[raw.color]
    rows = imageio.unfilter(raw.passes[0], raw.bpp, path)
    return native.png16_swscale(rows.view(">u2").reshape(raw.height, raw.width, spp))
