"""Matroska (.mkv) and WebM (.webm) files without cv2: a reader for
pipeline/video.py and a writer for utils/datasets.py::images_to_video.

The reader (`open_video`, `iter_samples`) walks the EBML elements as
FFmpeg's matroska demuxer does for such a file: the EBML header (DocType
`matroska` or `webm`), one Segment, its Info and Tracks, and the Clusters'
SimpleBlocks and BlockGroups' Blocks (Xiph, EBML and fixed lacing split into
frames), skipping CRC-32, Void, SeekHead, Cues, Tags, Chapters and
Attachments; a Segment or Cluster of unknown size (what a browser's
MediaRecorder writes) ends where the file or the next top-level element
begins.  The first video track is read, as OpenCV's FFmpeg backend picks
it; the blocks of other tracks (an interleaved audio track) are skipped.
Its CodecID names the decoder: `V_VP8` (native/vp8.cpp), `V_VP9`
(native/vp9.cpp), `V_MJPEG` (native/mjpeg.cpp), `V_MPEG4/ISO/ASP` with
its CodecPrivate VOL (native/mpeg4.cpp) and `V_MPEG1` / `V_MPEG2` with
their CodecPrivate sequence header (native/mpeg12.cpp), what
cv2.VideoWriter stores for the FourCCs VP80, VP90, MJPG, mp4v, XVID, PIM1
and MPG2.  What the port cannot decode
as cv2 does raises NotImplementedError naming it and ROADMAP item 18.4: any
other CodecID (`V_AV1`, `V_MPEG4/ISO/AVC`, `V_MPEGH/ISO/HEVC`, `V_THEORA`,
...), ContentEncodings (header stripping, compression, encryption), and an
mp4v track's Colour values that change cv2's conversion (a BT.709 or other
matrix, full range).  PixelCrop, the display size and a VP8, VP9 or
Motion-JPEG track's Colour leave cv2's frames as they are (a VP9 stream's
own colour config decides them), and the port's too.

The writer (`MkvWriter`) stores the port's MPEG-4 Part 2 packets
(native/mpeg4_enc.cpp) as cv2.VideoWriter(fourcc "mp4v")'s muxer (FFmpeg's)
stores them in a .mkv: DocType `matroska`, a SeekHead, Info (1 ms
timestamps), one TrackEntry (`V_MPEG4/ISO/ASP`, the encoder's VOS / VO /
VOL as CodecPrivate, DefaultDuration from the frame rate), a Cluster from
each I-VOP on, SimpleBlocks flagged key for I-VOPs, and Cues at each of
them; its `MkvMuxer` stores any codec's frames so.
"""

from __future__ import annotations

import mmap
import os
import struct
from typing import Iterator, List, NamedTuple, Optional, Tuple

import numpy as np

from .. import native
from .formats import unsupported
from .mp4 import GOP, QUANT

EBML = 0x1A45DFA3
SEGMENT = 0x18538067
CLUSTER = 0x1F43B675
TOP_LEVEL = {0x114D9B74, 0x1549A966, 0x1654AE6B, CLUSTER, 0x1C53BB6B, 0x1254C367, 0x1043A770,
             0x1941A469}  # SeekHead, Info, Tracks, Cluster, Cues, Tags, Chapters, Attachments
CODECS = {"V_VP8": "vp8", "V_VP9": "vp9", "V_MJPEG": "mjpeg", "V_MPEG4/ISO/ASP": "mpeg4",
          "V_MPEG1": "mpeg12", "V_MPEG2": "mpeg12"}
DOC_TYPES = (b"matroska", b"webm")
# The Colour values under which cv2 returns an mp4v track's frames as it
# does with no Colour element (measured on forged files): FFmpeg's mpeg4
# decoder passes the container's matrix and range on to OpenCV's
# conversion, so BT.709 or full range change the pixels.  cv2 ignores the
# chroma siting there (the decoder sets its own), Colour as a whole in VP8,
# VP9 and Motion-JPEG tracks, and PixelCrop and the display size in every
# track.
MPEG4_COLOUR = {
    0x55B1: ("MatrixCoefficients", (2, 5, 6)),  # unspecified, BT.470BG, BT.601
    0x55B9: ("Range", (0, 1)),  # unspecified, limited
}


def _vint(buf, pos: int, end: int, keep_marker: bool = False) -> Tuple[int, int, bool]:
    """(value, length, all ones) of the EBML variable-length integer at pos."""
    if pos >= end:
        raise ValueError("an EBML number past its parent's end")
    first = buf[pos]
    if not first:
        raise ValueError(f"an EBML number of more than 8 bytes at {pos}")
    n = 8 - first.bit_length() + 1
    if pos + n > end:
        raise ValueError("an EBML number past its parent's end")
    value = first if keep_marker else first & ((1 << (8 - n)) - 1)
    for b in buf[pos + 1:pos + n]:
        value = value << 8 | b
    ones = (first & ((1 << (8 - n)) - 1)) == (1 << (8 - n)) - 1 and all(
        b == 0xFF for b in buf[pos + 1:pos + n])
    return value, n, ones


def _elements(buf, start: int, end: int) -> Iterator[Tuple[int, int, int, bool]]:
    """(id, data offset, data end, unknown size) of each element in
    buf[start:end]; an element of unknown size runs to `end` and is the last."""
    pos = start
    while pos < end:
        eid, n, _ = _vint(buf, pos, end, keep_marker=True)
        size, m, unknown = _vint(buf, pos + n, end)
        data = pos + n + m
        if unknown:
            yield eid, data, end, True
            return
        stop = data + size
        if stop > end:
            raise ValueError(f"an element 0x{eid:X} of {size} bytes runs past its parent")
        yield eid, data, stop, False
        pos = stop


def _uint(buf, start: int, end: int) -> int:
    return int.from_bytes(buf[start:end], "big") if end > start else 0


def _children(buf, start: int, end: int) -> dict:
    """{id: (data offset, data end)} of the first of each child."""
    out = {}
    for eid, s, e, _ in _elements(buf, start, end):
        out.setdefault(eid, (s, e))
    return out


class Track(NamedTuple):
    """The first video track of a Matroska / WebM file."""

    path: str
    codec_id: str
    codec: str  # "vp8", "vp9", "mjpeg", "mpeg4" or "mpeg12"
    width: int
    height: int
    config: bytes  # CodecPrivate
    number: int
    default_duration: int  # ns a frame, 0 when the file gives none
    offsets: List[int]  # each frame's file offset, laced frames split
    sizes: List[int]
    keyframes: List[int]  # 0-based indices of the frames of key blocks

    @property
    def fps(self) -> float:
        return 1e9 / self.default_duration if self.default_duration else 0.0


def _track_entry(path: str, buf, start: int, end: int) -> Optional[dict]:
    c = _children(buf, start, end)
    if _uint(buf, *c.get(0x83, (0, 0))) != 1:  # TrackType: video
        return None
    codec_id = bytes(buf[slice(*c[0x86])]).rstrip(b"\0").decode("latin-1") if 0x86 in c else ""
    if 0x6D80 in c:
        raise unsupported(path, f"a {codec_id} track with ContentEncodings (header stripping, "
                                 "compression or encryption)")
    if codec_id not in CODECS:
        raise unsupported(path, f"a {codec_id or 'CodecID-less'} video track")
    if 0xE0 not in c or 0xD7 not in c:
        raise ValueError(f"{path}: a video track without its Video element or TrackNumber")
    video = _children(buf, *c[0xE0])
    if 0x55B0 in video and CODECS[codec_id] == "mpeg4":
        colour = _children(buf, *video[0x55B0])
        for eid, (name, ok) in MPEG4_COLOUR.items():
            if eid in colour and _uint(buf, *colour[eid]) not in ok:
                raise unsupported(path, f"an mp4v track with Colour {name} "
                                         f"{_uint(buf, *colour[eid])} (cv2 converts its frames "
                                         "otherwise)")
    return dict(codec_id=codec_id, codec=CODECS[codec_id], number=_uint(buf, *c[0xD7]),
                width=_uint(buf, *video.get(0xB0, (0, 0))),
                height=_uint(buf, *video.get(0xBA, (0, 0))),
                config=bytes(buf[slice(*c[0x63A2])]) if 0x63A2 in c else b"",
                default_duration=_uint(buf, *c.get(0x23E383, (0, 0))))


def _lace(buf, pos: int, end: int, flags: int) -> List[Tuple[int, int]]:
    """(offset, size) of each frame of a block's data buf[pos:end]."""
    lacing = flags & 0x06
    if not lacing:
        return [(pos, end - pos)]
    if pos >= end:
        raise ValueError("a laced block without its frame count")
    count = buf[pos] + 1
    pos += 1
    sizes = []
    if lacing == 0x02:  # Xiph
        for _ in range(count - 1):
            size = 0
            while True:
                if pos >= end:
                    raise ValueError("Xiph lace sizes past the block's end")
                b = buf[pos]
                pos += 1
                size += b
                if b != 255:
                    break
            sizes.append(size)
    elif lacing == 0x06:  # EBML: a size, then signed differences
        size, n, _ = _vint(buf, pos, end)
        pos += n
        sizes.append(size)
        for _ in range(count - 2):
            raw, n, _ = _vint(buf, pos, end)
            pos += n
            size += raw - ((1 << (7 * n - 1)) - 1)
            sizes.append(size)
    else:  # fixed
        if (end - pos) % count:
            raise ValueError(f"{end - pos} bytes do not split into {count} equal laced frames")
        sizes = [(end - pos) // count] * (count - 1)
    last = end - pos - sum(sizes)
    if last < 0 or any(s < 0 for s in sizes):
        raise ValueError("lace sizes past the block's end")
    frames = []
    for size in sizes + [last]:
        frames.append((pos, size))
        pos += size
    return frames


def _block(buf, start: int, end: int) -> Tuple[int, int, int]:
    """(track number, flags, frame data offset) of a (Simple)Block."""
    track, n, _ = _vint(buf, start, end)
    if start + n + 3 > end:
        raise ValueError("a block cut short")
    return track, buf[start + n + 2], start + n + 3


def open_video(path) -> Track:
    """The first video track of the Matroska / WebM file at `path`, with
    every frame's place.  ValueError for a file that is not one or has no
    video track; NotImplementedError for what the port cannot decode as cv2
    does."""
    path = os.fspath(path)
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        if not size:
            raise ValueError(f"{path}: an empty file")
        with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as buf:
            try:
                return _parse(path, buf, size)
            except (IndexError, struct.error) as e:
                raise ValueError(f"{path}: a malformed Matroska file ({e})") from None


def _parse(path: str, buf, size: int) -> Track:
    top = []  # the EBML header, then the Segment: a file cut short ends it early
    pos = 0
    while pos < size and len(top) < 2:
        eid, n, _ = _vint(buf, pos, size, keep_marker=True)
        length, m, unknown = _vint(buf, pos + n, size)
        data = pos + n + m
        top.append((eid, data, size if unknown else min(data + length, size)))
        pos = size if unknown else data + length
    if top[0][0] != EBML or top[0][2] > size:
        raise ValueError(f"{path}: no EBML header")
    header = _children(buf, top[0][1], top[0][2])
    doc = bytes(buf[slice(*header[0x4282])]).rstrip(b"\0") if 0x4282 in header else b"matroska"
    if doc not in DOC_TYPES:
        raise ValueError(f"{path}: an EBML file of DocType {doc!r}, not Matroska or WebM")
    segment = next(((s, e) for eid, s, e in top[1:] if eid == SEGMENT), None)
    if segment is None:
        raise ValueError(f"{path}: no Segment")
    track = None
    frames: List[Tuple[int, int]] = []
    keys: List[int] = []
    pos, end = segment
    while pos < end:
        eid, n, _ = _vint(buf, pos, end, keep_marker=True)
        if eid == EBML:  # a second Segment after one of unknown size
            break
        length, m, unknown = _vint(buf, pos + n, end)
        data = pos + n + m
        stop = end if unknown else data + length
        if stop > end:
            if eid != CLUSTER or end < size:
                raise ValueError(f"{path}: an element 0x{eid:X} of {length} bytes runs past its "
                                 "Segment")
            stop, unknown = end, True  # a file cut short: read the Cluster as far as it goes
        if eid == 0x1654AE6B and track is None:  # Tracks
            for tid, ts, te, _ in _elements(buf, data, stop):
                if tid == 0xAE:
                    track = _track_entry(path, buf, ts, te)
                    if track is not None:
                        break
        elif eid == CLUSTER:
            if track is None:
                raise ValueError(f"{path}: a Cluster before the Tracks")
            stop = _cluster(buf, data, stop, unknown, track["number"], frames, keys)
        elif unknown:
            raise ValueError(f"{path}: an element 0x{eid:X} of unknown size")
        pos = stop
    if track is None:
        raise ValueError(f"{path}: no video track")
    return Track(path=path, offsets=[o for o, _ in frames], sizes=[n for _, n in frames],
                 keyframes=keys, **track)


def _cluster(buf, start: int, end: int, unknown: bool, number: int,
             frames: List[Tuple[int, int]], keys: List[int]) -> int:
    """Append the frames of the track's blocks in a Cluster; returns where
    the Cluster ends (for one of unknown size, the next top-level element)."""
    pos = start
    while pos < end:
        eid, n, _ = _vint(buf, pos, end, keep_marker=True)
        if unknown and (eid in TOP_LEVEL or eid == EBML):
            return pos
        size, m, ones = _vint(buf, pos + n, end)
        data = pos + n + m
        stop = data + size
        if ones or stop > end:
            if unknown and stop > end and end == len(buf):
                return end  # a block cut short at the file's end: FFmpeg's demuxer stops there
            raise ValueError(f"an element 0x{eid:X} in a Cluster runs past it")
        if eid == 0xA3:  # SimpleBlock
            track, flags, at = _block(buf, data, stop)
            if track == number:
                if flags & 0x80:
                    keys.append(len(frames))
                frames.extend(_lace(buf, at, stop, flags))
        elif eid == 0xA0:  # BlockGroup: a Block, no ReferenceBlock for a key frame
            c = _children(buf, data, stop)
            if 0xA1 in c:
                track, flags, at = _block(buf, *c[0xA1])
                if track == number:
                    if 0xFB not in c:
                        keys.append(len(frames))
                    frames.extend(_lace(buf, at, c[0xA1][1], flags))
        pos = stop
    return end


def iter_samples(track: Track) -> Iterator[bytes]:
    """Each frame's bytes, in the file's order (decode order)."""
    with open(track.path, "rb") as f:
        for pos, n in zip(track.offsets, track.sizes):
            f.seek(pos)
            data = f.read(n)
            if len(data) != n:
                raise ValueError(f"{track.path}: a frame at {pos} runs past the file")
            yield data


def _id_bytes(eid: int) -> bytes:
    return eid.to_bytes((eid.bit_length() + 7) // 8, "big")


def _size(n: int, width: int = 0) -> bytes:
    """n as an EBML size, in `width` bytes (the least that hold it when 0)."""
    if not width:
        width = 1
        while n >= (1 << (7 * width)) - 1:
            width += 1
    return ((1 << (7 * width)) | n).to_bytes(width, "big")


def _el(eid: int, *parts: bytes) -> bytes:
    body = b"".join(parts)
    return _id_bytes(eid) + _size(len(body)) + body


def _uint_el(eid: int, v: int) -> bytes:
    return _el(eid, v.to_bytes(max(1, (v.bit_length() + 7) // 8), "big"))


class MkvMuxer:
    """Store coded frames of one video track in a Matroska (`doc_type`
    "matroska") or WebM ("webm") file at `fps`, as FFmpeg's muxer lays them
    out: a Cluster from each key frame on (or where a block's 16-bit time
    would overflow), each frame a SimpleBlock, Cues at the Clusters (a
    context manager; `close()` writes the Cues and SeekHead and fixes the
    sizes)."""

    SEEK_ROOM = 80  # bytes kept for the SeekHead (three entries)

    def __init__(self, path, codec_id: str, width: int, height: int, fps: float = 30,
                 config: bytes = b"", doc_type: str = "matroska"):
        self.path = os.fspath(path)
        self.width, self.height, self.fps = int(width), int(height), float(fps)
        self._n = 0
        self._cluster_at: Optional[int] = None  # file offset of the open Cluster's size
        self._cluster_ms = 0
        self._cues: List[Tuple[int, int]] = []  # (ms, Cluster offset in the Segment)
        self._f = open(self.path, "wb")
        self._f.write(_el(EBML, _uint_el(0x4286, 1), _uint_el(0x42F7, 1), _uint_el(0x42F2, 4),
                          _uint_el(0x42F3, 8), _el(0x4282, doc_type.encode()),
                          _uint_el(0x4287, 4 if doc_type == "matroska" else 2),
                          _uint_el(0x4285, 2)))
        self._f.write(_id_bytes(SEGMENT) + _size(0, 8))
        self._segment = self._f.tell()
        self._f.write(_el(0xEC, bytes(self.SEEK_ROOM - 2)))  # Void, replaced by the SeekHead
        self._info_at = self._f.tell() - self._segment
        self._f.write(self._info(0.0))
        self._tracks_at = self._f.tell() - self._segment
        video = _el(0xE0, _uint_el(0xB0, self.width), _uint_el(0xBA, self.height))
        self._f.write(_el(0x1654AE6B, _el(
            0xAE, _uint_el(0xD7, 1), _uint_el(0x73C5, 1), _uint_el(0x9C, 0), _el(0x22B59C, b"und"),
            _el(0x86, codec_id.encode()), _uint_el(0x83, 1),
            _uint_el(0x23E383, int(round(1e9 / self.fps))), video,
            _el(0x63A2, config) if config else b"")))

    def _info(self, duration_ms: float) -> bytes:
        return _el(0x1549A966, _uint_el(0x2AD7B1, 1000000), _el(0x4D80, b"fmvfi_tpu_torch"),
                   _el(0x5741, b"fmvfi_tpu_torch"), _el(0x4489, struct.pack(">d", duration_ms)))

    def _ms(self, i: int) -> int:
        return int(round(i * 1000 / self.fps))

    def _close_cluster(self) -> None:
        if self._cluster_at is not None:
            end = self._f.tell()
            self._f.seek(self._cluster_at)
            self._f.write(_size(end - self._cluster_at - 8, 8))
            self._f.seek(end)
            self._cluster_at = None

    def write_frame(self, data: bytes, key: bool) -> None:
        """Append one coded frame (a key frame when `key`)."""
        ms = self._ms(self._n)
        if key or self._cluster_at is None or ms - self._cluster_ms > 32767:
            self._close_cluster()
            self._cues.append((ms, self._f.tell() - self._segment))
            self._f.write(_id_bytes(CLUSTER))
            self._cluster_at = self._f.tell()
            self._f.write(_size(0, 8) + _uint_el(0xE7, ms))
            self._cluster_ms = ms
        block = _size(1) + struct.pack(">hB", ms - self._cluster_ms, 0x80 if key else 0) + data
        self._f.write(_el(0xA3, block))
        self._n += 1

    def close(self) -> None:
        if self._f.closed:
            return
        self._close_cluster()
        cues_at = self._f.tell() - self._segment
        self._f.write(_el(0x1C53BB6B, *(
            _el(0xBB, _uint_el(0xB3, ms), _el(0xB7, _uint_el(0xF7, 1), _uint_el(0xF1, at)))
            for ms, at in self._cues)))
        end = self._f.tell()
        seek = _el(0x114D9B74, *(_el(0x4DBB, _el(0x53AB, _id_bytes(eid)), _uint_el(0x53AC, at))
                                 for eid, at in ((0x1549A966, self._info_at),
                                                 (0x1654AE6B, self._tracks_at),
                                                 (0x1C53BB6B, cues_at))))
        self._f.seek(self._segment)
        self._f.write(seek + _el(0xEC, bytes(self.SEEK_ROOM - len(seek) - 2)))
        self._f.seek(self._segment + self._info_at)
        self._f.write(self._info(float(self._ms(self._n))))
        self._f.seek(self._segment - 8)
        self._f.write(_size(end - self._segment, 8))
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class MkvWriter(MkvMuxer):
    """Write (H, W, 3) uint8 RGB frames of one size as an MPEG-4 Part 2
    stream (`V_MPEG4/ISO/ASP`, the encoder's VOS / VO / VOL as CodecPrivate,
    an I-VOP every `gop` frames) in a Matroska file at `fps`."""

    def __init__(self, path, width: int, height: int, fps: float = 30, quant: int = QUANT,
                 gop: int = GOP):
        self.encoder = native.Mpeg4Encoder(width, height, fps, quant, gop, in_band=False)
        self.gop = int(gop)
        super().__init__(path, "V_MPEG4/ISO/ASP", width, height, fps, self.encoder.config)

    def write(self, frame: np.ndarray) -> None:
        """Append one (H, W, 3) uint8 RGB frame of the writer's size."""
        self.write_frame(self.encoder.encode(frame), self._n % self.gop == 0)

    def close(self) -> None:
        super().close()
        self.encoder.close()
