"""FLV files without cv2: the demuxer behind pipeline/video.py for Flash
video, as FFmpeg's flv demuxer (libavformat/flvdec.c) reads it for
cv2.VideoCapture.

    'FLV' version flags DataOffset      the header (FFmpeg's probe: version
                                        below 5, DataOffset past 8)
    PreviousTagSize0                    at DataOffset
    tag*: TagType (8 audio, 9 video, 18 script), DataSize (24 bits),
          Timestamp (24 + 8 bits), StreamID (24 bits), Data,
          PreviousTagSize (DataSize + 11)

A video tag's first byte holds its frame type (high nibble) and codec id
(low nibble); the rest is one packet.  Codec 2 is Sorenson Spark (FLV1,
native/h263.cpp), whose picture headers carry the size (the onMetaData
script tag is skipped, as the decoder overrides it in FFmpeg).  A frame of
type 5 (video info / command) holds no picture.  Other codecs (screen
video, VP6, VP6 with alpha, H.264, and the enhanced FLV's FourCC codecs)
raise NotImplementedError naming ROADMAP item 18.4; a malformed file
raises ValueError.
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, NamedTuple

from .formats import unsupported

MAGIC = b"FLV"
SORENSON = 2
CODECS = {1: "JPEG video", 2: "Sorenson Spark", 3: "screen video", 4: "VP6", 5: "VP6 with alpha",
          6: "screen video 2", 7: "H.264", 12: "HEVC", 13: "AV1"}
VIDEO, AUDIO, SCRIPT = 9, 8, 18
INFO_FRAME = 5  # a video info / command frame


def is_flv(head: bytes) -> bool:
    """FFmpeg's flv_probe: 'FLV', a version below 5, a zero byte, a data
    offset past 8."""
    return (len(head) >= 9 and head[:3] == MAGIC and head[3] < 5 and head[5] == 0
            and struct.unpack(">I", head[5:9])[0] > 8)


class Clip(NamedTuple):
    path: str
    data_offset: int


def _tags(path: str, f, start: int, size: int) -> Iterator[tuple]:
    """(type, payload offset, payload length) of each tag from `start`,
    PreviousTagSize checked."""
    pos = start
    while pos + 11 <= size:
        f.seek(pos)
        head = f.read(11)
        kind = head[0]
        n = int.from_bytes(head[1:4], "big")
        body = pos + 11
        if body + n + 4 > size:
            raise ValueError(f"{path}: an FLV tag of {n} bytes at {pos} runs past the file's end")
        f.seek(body + n)
        prev = struct.unpack(">I", f.read(4))[0]
        if prev not in (n + 11, n + 10):
            raise ValueError(f"{path}: an FLV tag at {pos} whose PreviousTagSize is {prev}, "
                             f"not {n + 11}")
        if kind & 0x20:
            raise unsupported(path, "an encrypted (filtered) FLV tag")
        yield kind & 0x1F, body, n
        pos = body + n + 4


def open_video(path) -> Clip:
    """The FLV file at `path`, checked to hold Sorenson Spark video.
    ValueError for a file that is not FLV or holds no video;
    NotImplementedError for video of another codec."""
    path = os.fspath(path)
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        head = f.read(9)
        if not is_flv(head):
            raise ValueError(f"{path}: not an FLV file")
        offset = struct.unpack(">I", head[5:9])[0]
        for kind, body, n in _tags(path, f, offset + 4, size):
            if kind != VIDEO or n == 0:
                continue
            f.seek(body)
            flags = f.read(1)[0]
            if flags & 0x80:
                raise unsupported(path, "an enhanced FLV video tag (a FourCC codec)")
            codec = flags & 0x0F
            if codec != SORENSON:
                raise unsupported(path, f"{CODECS.get(codec, f'codec {codec}')} video in FLV")
            return Clip(path, offset)
    raise ValueError(f"{path}: an FLV file with no video")


def iter_frames(clip: Clip) -> Iterator[bytes]:
    """Each video tag's packet (the bytes after its flags byte), in file
    order; info / command frames and empty tags skipped."""
    with open(clip.path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        for kind, body, n in _tags(clip.path, f, clip.data_offset + 4, size):
            if kind != VIDEO or n <= 1:
                continue
            f.seek(body)
            data = f.read(n)
            if data[0] >> 4 == INFO_FRAME:
                continue
            if data[0] & 0x0F != SORENSON:
                raise unsupported(clip.path, "an FLV file whose video codec changes")
            yield data[1:]
