"""IVF files (.ivf: what libvpx's tools and FFmpeg's ivf muxer write, and
cv2.VideoWriter for the FourCCs VP80 and VP90 into .ivf) without cv2: the
reader pipeline/video.py uses for them, as FFmpeg's ivf demuxer reads them.

A 32-byte header (`DKIF`, version, header size, FourCC, width, height,
time base, frame count), then each frame: a 4-byte little-endian size, an
8-byte timestamp and its bytes.  The FourCC names the decoder: `VP80`
(native/vp8.cpp) or `VP90` (native/vp9.cpp, whose packets may show no
frame or several); any other (`AV01`, ...) raises NotImplementedError
naming item 18.4.  The header's size field is not read (FFmpeg's demuxer
takes 32 bytes whatever it says); a file cut inside a frame's header or
data raises ValueError.
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, NamedTuple

from .formats import unsupported

MAGIC = b"DKIF"
CODECS = {b"VP80": "vp8", b"VP90": "vp9"}


class IvfFile(NamedTuple):
    path: str
    codec: str  # "vp8" or "vp9"
    fourcc: bytes
    width: int
    height: int


def open_video(path) -> IvfFile:
    """The header of the IVF file at `path`.  ValueError for a file that is
    not one; NotImplementedError for a codec the port does not decode."""
    path = os.fspath(path)
    with open(path, "rb") as f:
        head = f.read(32)
    if len(head) < 32 or head[:4] != MAGIC:
        raise ValueError(f"{path}: not an IVF file")
    fourcc, width, height = struct.unpack("<4sHH", head[8:16])
    codec = CODECS.get(fourcc.upper())
    if codec is None:
        raise unsupported(path, f"an IVF file of FourCC {fourcc.decode('latin-1')!r}")
    return IvfFile(path, codec, fourcc, width, height)


def iter_frames(ivf: IvfFile) -> Iterator[bytes]:
    """Each frame's bytes, in file order."""
    with open(ivf.path, "rb") as f:
        f.seek(32)
        while True:
            head = f.read(12)
            if not head:
                return
            if len(head) < 12:
                raise ValueError(f"{ivf.path}: a frame header cut short")
            size = struct.unpack("<I", head[:4])[0]
            data = f.read(size)
            if len(data) < size:
                raise ValueError(f"{ivf.path}: a frame of {size} bytes cut short at {len(data)}")
            yield data
