"""Motion-JPEG AVI files without cv2: a writer for eval/visualize.py's
panel videos and a chunk reader.

The writer produces a RIFF 1.0 `AVI ` file with one video stream, as
cv2.VideoWriter(path, fourcc "MJPG", fps, (w, h)) does:

    RIFF 'AVI '
      LIST 'hdrl'
        avih   MainAVIHeader: microseconds per frame, frame count, 1 stream,
               width, height, AVIF_HASINDEX
        LIST 'strl'
          strh  'vids' / 'MJPG', rate / scale = fps, length = frame count
          strf  BITMAPINFOHEADER, 24 bits, compression 'MJPG'
      LIST 'movi'
        00dc   one chunk per frame: a baseline JPEG (native/jpeg_enc.cpp),
               padded to even length
      idx1     one entry per frame: '00dc', AVIIF_KEYFRAME, the chunk's
               offset from the 'movi' tag and its length

Sizes and counts are patched in when the writer closes.  A file past RIFF
1.0's 1 GiB raises ValueError (there is no OpenDML extension).  `read`
returns the stream's header fields, the index and every frame's bytes.
"""

from __future__ import annotations

import os
import struct
from fractions import Fraction
from typing import Dict, List, NamedTuple, Tuple

import numpy as np

from .. import native

RIFF_LIMIT = 1 << 30  # RIFF 1.0: the whole file under 1 GiB
AVIF_HASINDEX = 0x10
AVIIF_KEYFRAME = 0x10
JPEG_QUALITY = 95  # cv2's MJPG default


class MjpgWriter:
    """Write (H, W, 3) uint8 RGB frames of one size to an MJPG AVI at `fps`
    (a context manager; `close()` finishes the file)."""

    def __init__(self, path, width: int, height: int, fps: float = 2):
        if width < 1 or height < 1 or fps <= 0:
            raise ValueError(f"an AVI of {width}x{height} at {fps} fps")
        self.path = os.fspath(path)
        self.width, self.height = int(width), int(height)
        self.rate = Fraction(fps).limit_denominator(1_000_000)
        self._index: List[Tuple[int, int]] = []  # (offset from 'movi', length)
        self._max_chunk = 0
        self._f = open(self.path, "wb")
        self._f.write(self._headers())
        self._movi_size_at = self._f.tell() - 8  # the movi LIST's size field
        self._movi_tag_at = self._f.tell() - 4

    def _headers(self) -> bytes:
        n = len(self._index)
        usec = int(round(1e6 / float(self.rate)))
        avih = struct.pack("<14I", usec, 0, 0, AVIF_HASINDEX, n, 0, 1, self._max_chunk,
                           self.width, self.height, 0, 0, 0, 0)
        strh = struct.pack("<4s4sIHHIIIIIIiI4h", b"vids", b"MJPG", 0, 0, 0, 0,
                           self.rate.denominator, self.rate.numerator, 0, n, self._max_chunk, -1,
                           0, 0, 0, self.width, self.height)
        strf = struct.pack("<IiiHH4sIiiII", 40, self.width, self.height, 1, 24, b"MJPG",
                           self.width * self.height * 3, 0, 0, 0, 0)
        strl = _list(b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf))
        hdrl = _list(b"hdrl", _chunk(b"avih", avih) + strl)
        movi_size = 4 + sum(8 + length + (length & 1) for _, length in self._index)
        riff = 4 + len(hdrl) + 8 + movi_size + 8 + 16 * n
        return (b"RIFF" + struct.pack("<I", riff) + b"AVI " + hdrl
                + b"LIST" + struct.pack("<I", movi_size) + b"movi")

    def write(self, frame: np.ndarray) -> None:
        """Append one (H, W, 3) uint8 RGB frame of the writer's size."""
        frame = np.asarray(frame)
        if frame.shape != (self.height, self.width, 3) or frame.dtype != np.uint8:
            raise ValueError(f"a frame of {frame.shape} {frame.dtype}, the video is "
                             f"({self.height}, {self.width}, 3) uint8")
        data = native.jpeg_encode(frame, JPEG_QUALITY)
        pos = self._f.tell()
        end = pos + 8 + len(data) + (len(data) & 1) + 8 + 16 * (len(self._index) + 1)
        if end > RIFF_LIMIT:
            raise ValueError(f"{self.path}: {end} bytes is past RIFF 1.0's {RIFF_LIMIT} "
                             "(no OpenDML support)")
        self._f.write(_chunk(b"00dc", data))
        self._index.append((pos - self._movi_tag_at, len(data)))
        self._max_chunk = max(self._max_chunk, len(data))

    def close(self) -> None:
        if self._f.closed:
            return
        idx = b"".join(struct.pack("<4sIII", b"00dc", AVIIF_KEYFRAME, off, length)
                       for off, length in self._index)
        self._f.write(_chunk(b"idx1", idx))
        self._f.seek(0)
        self._f.write(self._headers())  # same length, counts and sizes filled in
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _chunk(tag: bytes, body: bytes) -> bytes:
    return tag + struct.pack("<I", len(body)) + body + (b"\0" if len(body) & 1 else b"")


def _list(kind: bytes, body: bytes) -> bytes:
    return b"LIST" + struct.pack("<I", 4 + len(body)) + kind + body


def chunks(data: bytes, start: int = 0, end: int = None):
    """(tag, list type or None, body offset, body length) of each chunk in
    data[start:end], descending into LISTs (a LIST's entry comes before
    its children's)."""
    end = len(data) if end is None else end
    pos = start
    while pos + 8 <= end:
        tag = data[pos : pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4 : pos + 8])
        body = pos + 8
        if body + size > end:
            raise ValueError(f"a {tag!r} chunk of {size} bytes runs past its parent")
        if tag in (b"RIFF", b"LIST"):
            kind = data[body : body + 4]
            yield tag, kind, body, size
            yield from chunks(data, body + 4, body + size)
        else:
            yield tag, None, body, size
        pos = body + size + (size & 1)


class AviFile(NamedTuple):
    avih: Dict[str, int]
    strh: Dict[str, object]
    strf: Dict[str, object]
    index: List[Tuple[bytes, int, int, int]]  # (tag, flags, offset, length)
    frames: List[bytes]


def read(path) -> AviFile:
    """The headers, the idx1 index and the `00dc` frames of an AVI file."""
    with open(os.fspath(path), "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError(f"{os.fspath(path)}: not a RIFF AVI file")
    avih = strh = strf = None
    index, frames = [], []
    for tag, kind, pos, size in chunks(data):
        body = data[pos : pos + size]
        if tag == b"avih":
            keys = ("usec_per_frame", "max_bytes_per_sec", "padding", "flags", "total_frames",
                    "initial_frames", "streams", "buffer_size", "width", "height")
            avih = dict(zip(keys, struct.unpack("<10I", body[:40])))
        elif tag == b"strh":
            v = struct.unpack("<4s4sIHHIIIIIIiI4h", body[:56])
            strh = dict(type=v[0], handler=v[1], scale=v[6], rate=v[7], length=v[9],
                        frame=v[13:17])
        elif tag == b"strf":
            v = struct.unpack("<IiiHH4sI", body[:24])
            strf = dict(width=v[1], height=v[2], bit_count=v[4], compression=v[5])
        elif tag == b"idx1":
            index = [struct.unpack("<4sIII", body[i : i + 16]) for i in range(0, size, 16)]
        elif tag == b"00dc":
            frames.append(body)
    if avih is None or strh is None or strf is None:
        raise ValueError(f"{os.fspath(path)}: no avih/strh/strf header")
    return AviFile(avih, strh, strf, index, frames)
