"""GIF files as cv2 reads them, without cv2, PIL or FFmpeg: the first image
as `cv2.imread` returns it (OpenCV's own GIF decoder, grfmt_gif.cpp), and
every image as cv2.VideoCapture returns it (FFmpeg's gif demuxer and
decoder, then swscale's BGRA -> BGR24, which drops alpha).

`parse` reads GIF87a and GIF89a: the logical screen, the global colour
table, each image descriptor (its sub-rectangle, local colour table and
interlacing; native/gif.cpp decodes its LZW data), and the Graphic Control
Extension before it (transparent index, disposal; cv2 shows each image
once, whatever its delay); other extensions are skipped.  Anything else
before the trailer, or data that ends first, raises ValueError.

`decode` (cv2.imread): a canvas of the global table's background colour
(black without a global table), the first image's pixels drawn on it but
where its transparent index is, so a transparent pixel shows the
background colour; OpenCV keeps one colour table, the global one with a
local one read over its start, so a local table's index past its own
entries reads the global table's, and one past both is an error.  cv2 reads no image, and ValueError is raised, when the
background index is past the global table, the first image leaves the
screen, or its LZW data goes on after its last pixel (native/gif.cpp's
strict reading).

`frames` (cv2.VideoCapture), one frame per image, on one canvas kept from
image to image, but for images that FFmpeg's gif parser never splits off:
it starts a packet at an extension block, or at an image once any
extension has been seen, after the end of an image, and its decoder
decodes the first image of a packet; so a file without extension blocks
(a GIF87a among them) is one frame, and an image with no extension before
it in the file is dropped:
- the first image's canvas is filled with the background colour when the
  file has a global table and the image no transparent index, else with
  FFmpeg's transparent colour (alpha 0, RGB white): so cv2 shows white at
  the transparent pixels of a first frame, where imread shows the
  background colour;
- before each later image, the last image's disposal is carried out over
  that image's rectangle: 2 fills it with the background colour (with the
  transparent white when that image had a transparent index), 3 puts back
  what was under it; 0 and 1 leave it;
- each image's pixels are drawn but where its transparent index is (an
  index past a local table reads what an earlier, longer local table left
  there, as FFmpeg keeps one);
- an image taller than the screen is cut to its height, and one that runs
  past its right or bottom edge is clipped (its rows still decoded at
  their full width, the rows below the screen not at all, an interlaced
  one's passes laid over the rows kept), as FFmpeg does; one that starts
  off the screen raises ValueError, and one wider than the screen (or of
  no width or height) NotImplementedError (FFmpeg decodes it cut to the
  screen's width, and cv2 then returns fewer frames);
- the file may end, without its trailer, after a whole image, or go on
  with bytes that are no block: the images before are read, as FFmpeg
  reads them (cv2.imread then reads no image: ValueError).

Every image's data must hold all its pixels (a file cut short inside an
image raises ValueError, where cv2 would keep the rows it got).
"""

from __future__ import annotations

import struct
from typing import List, NamedTuple, Optional

import numpy as np

from .. import native

MAGICS = (b"GIF87a", b"GIF89a")
MAX_PIXELS = 1 << 30  # cv2's CV_IO_MAX_IMAGE_PIXELS
WHITE = np.array([255, 255, 255], np.uint8)  # FFmpeg's trans_color 0x00ffffff, alpha dropped
# rows of an interlaced image: each pass's first row and step
PASSES = ((0, 8), (4, 8), (2, 4), (1, 2))


class Image(NamedTuple):
    x: int
    y: int
    width: int
    height: int
    palette: Optional[np.ndarray]  # the local colour table, (2^n, 3), or None
    interlaced: bool
    min_code: int
    lzw: bytes  # the data sub-blocks joined
    transparent: int  # the GCE's transparent index, or -1
    disposal: int  # 0-3 (FFmpeg reads 4-7 as 0)
    after_extension: bool  # whether any extension block came before it in the file


class Gif(NamedTuple):
    width: int
    height: int
    palette: Optional[np.ndarray]  # the global colour table, (2^n, 3), or None
    background: int
    images: List[Image]


def is_gif(data: bytes) -> bool:
    return data[:6] in MAGICS


def _table(data: bytes, pos: int, flags: int):
    n = 2 << (flags & 7)
    if pos + 3 * n > len(data):
        raise ValueError("a colour table cut short")
    return np.frombuffer(data, np.uint8, 3 * n, pos).reshape(n, 3), pos + 3 * n


def _sub_blocks(data: bytes, pos: int):
    """The joined sub-blocks from `pos` and the position past their
    terminator."""
    out = []
    while True:
        if pos >= len(data):
            raise ValueError("data sub-blocks cut short")
        n = data[pos]
        if n == 0:
            return b"".join(out), pos + 1
        if pos + 1 + n > len(data):
            raise ValueError("a data sub-block cut short")
        out.append(data[pos + 1 : pos + 1 + n])
        pos += 1 + n


def parse(data: bytes, strict: bool = True) -> Gif:
    """The file's screen, tables and images.  strict=False (FFmpeg's
    reading) ends at the end of the data or at a block that is not an
    image, an extension or the trailer, keeping the images before it;
    strict=True (OpenCV's) raises ValueError there."""
    if not is_gif(data) or len(data) < 13:
        raise ValueError("not a GIF file")
    width, height, flags, background = struct.unpack("<HHBB", data[6:12])
    if not (width and height) or width * height > MAX_PIXELS:
        raise ValueError(f"a {width}x{height} logical screen")
    pos, palette = 13, None
    if flags & 0x80:
        palette, pos = _table(data, pos, flags)
    images: List[Image] = []
    transparent, disposal, extension = -1, 0, False
    while True:
        if pos >= len(data) and not strict:
            return Gif(width, height, palette, background, images)
        if pos >= len(data):
            raise ValueError("the file ends before its trailer")
        label = data[pos]
        pos += 1
        if label == 0x3B or (label not in (0x21, 0x2C) and not strict):  # the trailer
            return Gif(width, height, palette, background, images)
        if label == 0x21:  # an extension
            if pos >= len(data):
                raise ValueError("an extension cut short")
            kind = data[pos]
            body, pos = _sub_blocks(data, pos + 1)
            extension = True
            if kind == 0xF9 and len(body) >= 4:  # Graphic Control Extension
                gce = body[0]
                transparent = body[3] if gce & 1 else -1
                disposal = (gce >> 2) & 7
                disposal = disposal if disposal <= 3 else 0
            continue
        if label != 0x2C:
            raise ValueError(f"a block labelled 0x{label:02x}, not an image, an extension or the "
                             "trailer")
        if pos + 9 > len(data):
            raise ValueError("an image descriptor cut short")
        x, y, w, h, iflags = struct.unpack("<HHHHB", data[pos : pos + 9])
        pos += 9
        local = None
        if iflags & 0x80:
            local, pos = _table(data, pos, iflags)
        if pos >= len(data):
            raise ValueError("an image without its data")
        min_code = data[pos]
        lzw, pos = _sub_blocks(data, pos + 1)
        images.append(Image(x, y, w, h, local, bool(iflags & 0x40), min_code, lzw, transparent,
                            disposal, extension))
        transparent, disposal = -1, 0  # a GCE applies to one image


def _rows(img: Image, width: int, height: int, strict: bool = False) -> np.ndarray:
    """The image's first `height` rows of `width` palette indices, in place
    (an interlaced image's passes over those rows put back, as FFmpeg
    places them); strict: OpenCV's LZW reading (native.gif_lzw)."""
    idx = native.gif_lzw(img.lzw, img.min_code, width * height, strict).reshape(height, width)
    if not img.interlaced:
        return idx
    order = np.concatenate([np.arange(first, height, step) for first, step in PASSES])
    out = np.empty_like(idx)
    out[order] = idx
    return out


def _palette(table: np.ndarray) -> np.ndarray:
    """A colour table as 256 entries (those past it black)."""
    out = np.zeros((256, 3), np.uint8)
    out[: len(table)] = table
    return out


def _draw(region: np.ndarray, idx: np.ndarray, table: np.ndarray, transparent: int) -> None:
    """An image's colours over `region`, but where its transparent index is."""
    colours = np.take(table, idx, axis=0)
    if transparent < 0:
        region[...] = colours
    else:
        np.copyto(region, colours, where=(idx != transparent)[..., None])


def decode(data: bytes) -> np.ndarray:
    """The first image as cv2.imread reads it, (H, W, 3) uint8 RGB."""
    gif = parse(data)
    if not gif.images:
        raise ValueError("a GIF without an image")
    img = gif.images[0]
    if gif.palette is not None and gif.background >= len(gif.palette):
        raise ValueError(f"a background index {gif.background} past the {len(gif.palette)}-entry "
                         "global colour table")
    if not (img.width and img.height) or img.x + img.width > gif.width or (
            img.y + img.height > gif.height):
        raise ValueError(f"a {img.width}x{img.height} image at ({img.x}, {img.y}) off the "
                         f"{gif.width}x{gif.height} screen")
    if img.palette is None and gif.palette is None:
        raise ValueError("an image without a colour table")
    # OpenCV's one table: the global one, a local one read over its start;
    # an index past both is an error
    table = _palette(gif.palette if gif.palette is not None else np.zeros((0, 3), np.uint8))
    size = len(gif.palette) if gif.palette is not None else 0
    if img.palette is not None:
        table[: len(img.palette)] = img.palette
        size = max(size, len(img.palette))
    canvas = np.zeros((gif.height, gif.width, 3), np.uint8)
    if gif.palette is not None:
        canvas[:] = gif.palette[gif.background]
    idx = _rows(img, img.width, img.height, strict=True)
    if (idx[idx != img.transparent] >= size).any():
        raise ValueError(f"a colour index past the {size}-entry colour table")
    _draw(canvas[img.y : img.y + img.height, img.x : img.x + img.width], idx, table,
          img.transparent)
    return canvas


def frames(data: bytes) -> List[np.ndarray]:
    """Every image as cv2.VideoCapture reads it, each (H, W, 3) uint8 RGB."""
    gif = parse(data, strict=False)
    if not gif.images:
        raise ValueError("a GIF without an image")
    glob = _palette(gif.palette) if gif.palette is not None else None
    background = glob[gif.background] if glob is not None else np.zeros(3, np.uint8)
    canvas = np.empty((gif.height, gif.width, 3), np.uint8)
    out = []
    prev = None  # (disposal, rectangle, fill or saved pixels) of the last image
    local = np.zeros((256, 3), np.uint8)  # FFmpeg's one local table, entries kept between images
    for i, img in enumerate(gif.images):
        if i and not img.after_extension:
            continue  # in the packet of the image before it: never decoded
        if img.palette is not None:
            local[: len(img.palette)] = img.palette
            table = local
        elif glob is not None:
            table = glob
        else:
            raise ValueError(f"image {i} has no colour table")
        if i == 0:
            canvas[:] = background if img.transparent < 0 and glob is not None else WHITE
        if not (img.width and img.height) or img.width > gif.width:
            raise NotImplementedError(
                f"image {i} is {img.width}x{img.height} on a {gif.width}x{gif.height} screen: "
                "FFmpeg decodes it cut to the screen's width, and cv2 drops frames")
        w, h = img.width, min(img.height, gif.height)
        if img.x >= gif.width or img.y >= gif.height:
            raise ValueError(f"image {i} starts at ({img.x}, {img.y}), off the "
                             f"{gif.width}x{gif.height} screen")
        pw, ph = min(w, gif.width - img.x), min(h, gif.height - img.y)
        if prev is not None:
            kind, (px, py, pw0, ph0), saved = prev
            canvas[py : py + ph0, px : px + pw0] = saved  # a colour (2) or the pixels (3)
        prev = None
        rect = (img.x, img.y, pw, ph)
        if img.disposal == 2:
            prev = (2, rect, WHITE if img.transparent >= 0 else background)
        elif img.disposal == 3:
            prev = (3, rect, canvas[img.y : img.y + ph, img.x : img.x + pw].copy())
        _draw(canvas[img.y : img.y + ph, img.x : img.x + pw], _rows(img, w, ph)[:, :pw], table,
              img.transparent)
        out.append(canvas.copy())
    return out
