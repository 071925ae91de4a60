"""AVI files without cv2: writers
for eval/visualize.py's panel videos (MJPG) and utils/datasets.py's
images_to_video (mp4v), and a reader for pipeline/video.py.

The writers produce a RIFF 1.0 `AVI ` file with one video stream, as
cv2.VideoWriter(path, fourcc, fps, (w, h)) does; for "MJPG":

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
1.0's 1 GiB raises ValueError (the writer has no OpenDML extension).
`Mpeg4AviWriter` writes the same layout with handler and compression
'mp4v', each chunk an MPEG-4 Part 2 VOP (native/mpeg4_enc.cpp; the
VOS / VO / VOL headers before each I-VOP, as FFmpeg writes them in AVI)
and only the I-VOPs flagged AVIIF_KEYFRAME.

The reader takes what cv2.VideoWriter(..., "MJPG", ...) writes (FFmpeg's
muxer: JUNK chunks, an INFO list, idx1) and what MjpgWriter writes, and
also 'rec ' lists, files without an index, '##db' chunks and OpenDML's
'AVIX' extensions: `open_video` parses the headers and picks the first
video stream, which must be Motion-JPEG, MPEG-4 Part 2, MPEG-1/2 (cv2's
PIM1 and MPG2 writers store PIM1 and mpg2), VP8 or VP9 (VP80, VP90: what
cv2.VideoWriter writes for those FourCCs), PNG (png, MPNG) or raw frames
of the tags cv2 writes and reads back (RGBA; GREY, Y800 and Y8, which
cv2's writer fills with 12-bit-a-pixel yuv420p packets and FFmpeg reads
as grey; I420, IYUV, YV12), told by the strf compression FourCC as
FFmpeg's demuxer picks the codec (NotImplementedError otherwise, naming
the FourCC and ROADMAP item 18.4, or 18.4g for raw frames the port does not
convert: BI_RGB, 'DIB ', packed YUV), `iter_frames` streams its
frames' bytes from the 'movi' lists in file order, and `read` returns the
headers, the idx1 index and every frame.  pipeline/video.py decodes the
frames with utils/formats.py's decoders, as cv2.VideoCapture decodes
them.
"""

from __future__ import annotations

import io
import os
import struct
from fractions import Fraction
from typing import Dict, Iterator, List, NamedTuple, Tuple

import numpy as np

from .. import native
from . import formats
from .formats import unsupported

RIFF_LIMIT = 1 << 30  # RIFF 1.0: the whole file under 1 GiB
AVIF_HASINDEX = 0x10
AVIIF_KEYFRAME = 0x10
JPEG_QUALITY = 95  # cv2's MJPG default


class MjpgWriter:
    """Write (H, W, 3) uint8 RGB frames of one size to an MJPG AVI at `fps`
    (a context manager; `close()` finishes the file)."""

    fourcc = b"MJPG"

    def __init__(self, path, width: int, height: int, fps: float = 2):
        if width < 1 or height < 1 or fps <= 0:
            raise ValueError(f"an AVI of {width}x{height} at {fps} fps")
        self.path = os.fspath(path)
        self.width, self.height = int(width), int(height)
        self.rate = Fraction(fps).limit_denominator(1_000_000)
        self._index: List[Tuple[int, int, int]] = []  # (offset from 'movi', length, flags)
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
        strh = struct.pack("<4s4sIHHIIIIIIiI4h", b"vids", self.fourcc, 0, 0, 0, 0,
                           self.rate.denominator, self.rate.numerator, 0, n, self._max_chunk, -1,
                           0, 0, 0, self.width, self.height)
        strf = struct.pack("<IiiHH4sIiiII", 40, self.width, self.height, 1, 24, self.fourcc,
                           self.width * self.height * 3, 0, 0, 0, 0)
        strl = _list(b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf))
        hdrl = _list(b"hdrl", _chunk(b"avih", avih) + strl)
        movi_size = 4 + sum(8 + length + (length & 1) for _, length, _ in self._index)
        riff = 4 + len(hdrl) + 8 + movi_size + 8 + 16 * n
        return (b"RIFF" + struct.pack("<I", riff) + b"AVI " + hdrl
                + b"LIST" + struct.pack("<I", movi_size) + b"movi")

    def write(self, frame: np.ndarray) -> None:
        """Append one (H, W, 3) uint8 RGB frame of the writer's size."""
        frame = np.asarray(frame)
        if frame.shape != (self.height, self.width, 3) or frame.dtype != np.uint8:
            raise ValueError(f"a frame of {frame.shape} {frame.dtype}, the video is "
                             f"({self.height}, {self.width}, 3) uint8")
        self._chunk(*self._encode(frame))

    def _encode(self, frame: np.ndarray) -> Tuple[bytes, int]:
        """The frame's chunk and its idx1 flags."""
        return native.jpeg_encode(frame, JPEG_QUALITY), AVIIF_KEYFRAME

    def _chunk(self, data: bytes, flags: int) -> None:
        pos = self._f.tell()
        end = pos + 8 + len(data) + (len(data) & 1) + 8 + 16 * (len(self._index) + 1)
        if end > RIFF_LIMIT:
            raise ValueError(f"{self.path}: {end} bytes is past RIFF 1.0's {RIFF_LIMIT} "
                             "(no OpenDML support)")
        self._f.write(_chunk(b"00dc", data))
        self._index.append((pos - self._movi_tag_at, len(data), flags))
        self._max_chunk = max(self._max_chunk, len(data))

    def close(self) -> None:
        if self._f.closed:
            return
        idx = b"".join(struct.pack("<4sIII", b"00dc", flags, off, length)
                       for off, length, flags in self._index)
        self._f.write(_chunk(b"idx1", idx))
        self._f.seek(0)
        self._f.write(self._headers())  # same length, counts and sizes filled in
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Mpeg4AviWriter(MjpgWriter):
    """Write (H, W, 3) uint8 RGB frames of one size to an AVI of MPEG-4
    Part 2 video ("mp4v", as cv2.VideoWriter writes it) at `fps`: an I-VOP
    every `gop` frames, P-VOPs between, a fixed vop_quant `quant`."""

    fourcc = b"mp4v"

    def __init__(self, path, width: int, height: int, fps: float = 30, quant: int = 3,
                 gop: int = 12, options: int = 0):
        self.encoder = native.Mpeg4Encoder(width, height, fps, quant, gop, in_band=True,
                                           options=options)
        self.gop = int(gop)
        super().__init__(path, width, height, fps)

    def _encode(self, frame: np.ndarray) -> Tuple[bytes, int]:
        key = len(self._index) % self.gop == 0
        return self.encoder.encode(frame), AVIIF_KEYFRAME if key else 0

    def close(self) -> None:
        super().close()
        self.encoder.close()


def _chunk(tag: bytes, body: bytes) -> bytes:
    return tag + struct.pack("<I", len(body)) + body + (b"\0" if len(body) & 1 else b"")


def _list(kind: bytes, body: bytes) -> bytes:
    return b"LIST" + struct.pack("<I", 4 + len(body)) + kind + body


MJPEG_FOURCCS = (b"MJPG", b"AVI1", b"JPEG")  # FourCCs FFmpeg reads as Motion-JPEG
# FourCCs FFmpeg reads as MPEG-4 Part 2 (upper-cased, as its decoder reads the tag)
MPEG4_FOURCCS = (b"MP4V", b"FMP4", b"XVID", b"DIVX", b"DX50")
# riff.c's FourCCs of mpeg1video and mpeg2video (upper-cased; cv2's PIM1 and
# MPG2 writers store PIM1 and mpg2); VCR2 and SLIF, whose streams FFmpeg
# decodes with workarounds, are not among them
MPEG12_FOURCCS = (b"MPG1", b"MPG2", b"PIM1", b"PIM2", b"MPEG", b"MP1V", b"MP2V", b"MPGV",
                  b"MMES", b"LMP2", b"EM2V", b"DVR ", b"\x01\x00\x00\x10", b"\x02\x00\x00\x10")
VP8_FOURCCS = (b"VP80",)
VP9_FOURCCS = (b"VP90",)  # what cv2.VideoWriter(..., "VP90", ...) stores
PNG_FOURCCS = (b"PNG ", b"MPNG", b"PNG1")  # riff.c's png tags (upper-cased)
# riff.c's tags of the H.263 family (upper-cased, as FFmpeg's second,
# case-blind pass matches them; read off cv2's libavformat): h263, flv1,
# msmpeg4v2 and msmpeg4v3 (cv2's H263 / U263, FLV1, MP42 and MP43 / DIV3
# writers); ZyGo is left out (FFmpeg's h263 decoder reads more of a 'ZYGO'
# picture)
H263_FOURCCS = (b"H263", b"X263", b"T263", b"L263", b"VX1K", b"M263", b"LSVM", b"U263", b"VSM4")
FLV1_FOURCCS = (b"FLV1", b"S263")
# (tag -> MS-MPEG4 version)
MSMPEG4_FOURCCS = {b"MP42": 2, b"DIV2": 2, b"MP43": 3, b"DIV3": 3, b"MPG3": 3, b"DIV5": 3,
                   b"DIV6": 3, b"DIV4": 3, b"DVX3": 3, b"AP41": 3, b"COL1": 3, b"COL0": 3}
# the family's other decoders: MS-MPEG4 v1, WMV1 / WMV2, Intel H.263 (18.4i)
H263_FAMILY_REFUSED = {b"MPG4": "MS-MPEG4 v1", b"MP41": "MS-MPEG4 v1", b"WMV1": "WMV1",
                       b"WMV2": "WMV2", b"GXVE": "WMV2", b"I263": "Intel H.263"}
CODECS = {**{f: "mjpeg" for f in MJPEG_FOURCCS}, **{f: "mpeg4" for f in MPEG4_FOURCCS},
          **{f: "mpeg12" for f in MPEG12_FOURCCS}, **{f: "vp8" for f in VP8_FOURCCS},
          **{f: "vp9" for f in VP9_FOURCCS}, **{f: "png" for f in PNG_FOURCCS},
          **{f: "h263" for f in H263_FOURCCS}, **{f: "flv1" for f in FLV1_FOURCCS},
          **{f: "msmpeg4" for f in MSMPEG4_FOURCCS}}
# raw frames the port does not convert (ROADMAP 18.4g): BI_RGB (0) and 'DIB '
# (bottom-up BGR rows), packed and other planar YUV, other RGB orders
RAW_REFUSED = (b"\0\0\0\0", b"DIB ", b"RGB ", b"RAW ", b"YUY2", b"UYVY", b"YVYU", b"Y422",
               b"UYNV", b"YV16", b"Y41P", b"YVU9", b"YUV9", b"BGRA", b"ABGR", b"ARGB", b"Y16 ")


def _walk(f, start: int, end: int):
    """(tag, list type or None, body offset, body length) of each chunk of
    the open file f between start and end, descending into RIFFs and LISTs
    (a list's entry comes before its children's).  Several top-level RIFFs
    (OpenDML's 'AVIX' extensions past 1 GiB) are walked in turn."""
    pos = start
    while pos + 8 <= end:
        f.seek(pos)
        tag, size = struct.unpack("<4sI", f.read(8))
        body = pos + 8
        if body + size > end:
            raise ValueError(f"a {tag!r} chunk of {size} bytes runs past its parent")
        if tag in (b"RIFF", b"LIST"):
            kind = f.read(4)
            yield tag, kind, body, size
            yield from _walk(f, body + 4, body + size)
        else:
            yield tag, None, body, size
        pos = body + size + (size & 1)


def chunks(data: bytes, start: int = 0, end: int = None):
    """_walk over bytes in memory: the chunks of data[start:end]."""
    return _walk(io.BytesIO(data), start, len(data) if end is None else end)


def _avih(body: bytes) -> Dict[str, int]:
    keys = ("usec_per_frame", "max_bytes_per_sec", "padding", "flags", "total_frames",
            "initial_frames", "streams", "buffer_size", "width", "height")
    return dict(zip(keys, struct.unpack("<10I", body[:40])))


def _strh(body: bytes) -> Dict[str, object]:
    v = struct.unpack("<4s4sIHHIIIIIIiI4h", body[:56].ljust(56, b"\0"))
    return dict(type=v[0], handler=v[1], scale=v[6], rate=v[7], length=v[9], frame=v[13:17])


def _strf(body: bytes) -> Dict[str, object]:
    v = struct.unpack("<IiiHH4sI", body[:24].ljust(24, b"\0"))
    return dict(width=v[1], height=v[2], bit_count=v[4], compression=v[5])


class VideoStream(NamedTuple):
    """An AVI file's first video stream: the file's main header, the
    stream's headers, its number (its frames are the '<nn>dc' and '<nn>db'
    chunks) and its codec ("mjpeg", "mpeg4", "mpeg12", "vp8", "vp9", "png",
    "rawvideo", "h263", "flv1" or "msmpeg4")."""

    path: str
    avih: Dict[str, int]
    strh: Dict[str, object]
    strf: Dict[str, object]
    number: int
    codec: str = "mjpeg"


def open_video(path) -> VideoStream:
    """The headers of the AVI file at `path` and its first video stream.
    ValueError for a file that is not a RIFF AVI or has no video stream;
    NotImplementedError for a stream of a codec the port does not decode."""
    path = os.fspath(path)
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        head = f.read(12)
        if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"AVI ":
            raise ValueError(f"{path}: not a RIFF AVI file")
        avih, streams = None, []
        for tag, kind, pos, n in _walk(f, 0, size):
            if kind == b"movi":
                break
            if tag in (b"avih", b"strh", b"strf"):
                f.seek(pos)
                body = f.read(n)
                if tag == b"avih":
                    avih = _avih(body)
                elif tag == b"strh":
                    streams.append([_strh(body), None])
                elif streams:
                    streams[-1][1] = _strf(body)
    if avih is None:
        raise ValueError(f"{path}: no avih header")
    for number, (strh, strf) in enumerate(streams):
        if strh["type"] != b"vids":
            continue
        if strf is None:
            raise ValueError(f"{path}: video stream {number} has no strf header")
        tag = strf["compression"]
        codec = CODECS.get(tag.upper())  # FFmpeg's choice: strh's handler is not read for it
        if codec is None and tag in formats.RAW_PIXEL_FORMATS:
            codec = "rawvideo"
            strf = dict(strf, height=abs(strf["height"]))  # never flipped (measured)
        if codec is None and tag.upper() in H263_FAMILY_REFUSED:
            raise unsupported(path, f"{H263_FAMILY_REFUSED[tag.upper()]} video (FourCC "
                                    f"{tag.decode('latin-1')!r})", "18.4i")
        if codec is None:
            raise unsupported(path, f"a video stream whose strf compression is "
                                    f"{tag.decode('latin-1')!r}",
                              "18.4g" if tag.upper() in RAW_REFUSED else "18.4")
        return VideoStream(path, avih, strh, strf, number, codec)
    raise ValueError(f"{path}: no video stream")


def iter_frames(stream: VideoStream) -> Iterator[bytes]:
    """The bytes of each frame of `stream`, in file order: its '<nn>dc' and
    '<nn>db' chunks in every 'movi' list (inside 'rec ' lists too, and in
    OpenDML's 'AVIX' extensions), empty chunks (dropped frames) skipped.
    The indexes (idx1, indx, ix<nn>) are not needed and not read."""
    tags = (b"%02ddc" % stream.number, b"%02ddb" % stream.number)
    with open(stream.path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        for tag, _, pos, n in _walk(f, 0, size):
            if tag in tags and n:
                f.seek(pos)
                yield f.read(n)


class AviFile(NamedTuple):
    avih: Dict[str, int]
    strh: Dict[str, object]
    strf: Dict[str, object]
    index: List[Tuple[bytes, int, int, int]]  # idx1: (tag, flags, offset, length)
    frames: List[bytes]


def read(path) -> AviFile:
    """The headers, the idx1 index and every frame's bytes of the first
    video stream of an AVI file (open_video and iter_frames)."""
    stream = open_video(path)
    index = []
    with open(stream.path, "rb") as f:
        for tag, _, pos, n in _walk(f, 0, os.fstat(f.fileno()).st_size):
            if tag == b"idx1":
                f.seek(pos)
                body = f.read(n)
                index = [struct.unpack("<4sIII", body[i : i + 16]) for i in range(0, n - 15, 16)]
    return AviFile(stream.avih, stream.strh, stream.strf, index, list(iter_frames(stream)))
