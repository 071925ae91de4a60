"""ISO base media files (.mp4, .m4v, .mov, .3gp) without cv2: a reader for pipeline/video.py and a writer for
utils/datasets.py::images_to_video.

The reader (`open_video`, `iter_samples`) walks the boxes as FFmpeg's mov
demuxer does for such a file: `ftyp`, `moov` before or after `mdat`
(64-bit box sizes too), the first video track's sample tables (`stts`,
`stsc`, `stsz` / `stz2`, `stco` / `co64`, `stss`), its `mp4v` sample
entry's `esds` (its object type names the codec, as FFmpeg's demuxer reads
it: 0x20 MPEG-4 Visual, whose DecoderSpecificInfo holds the VOS / VO / VOL
headers; 0x60-0x65 and 0x6A MPEG-2 and MPEG-1, whose DecoderSpecificInfo
is the sequence header; 0x6C Motion-JPEG: what cv2's MPG2 and MJPG writers
store in .mp4), QuickTime's `m2v1` / `m1v ` (MPEG-1/2) and `jpeg`
(Motion-JPEG) entries (what those writers store in .mov), `png ` (PNG
frames) and `RGBA` (raw frames: what cv2's png and RGBA writers store in
.mov; `raw ` and packed YUV raise naming item 18.4g), `s263` / `h263`
(H.263: what cv2's H263 writer stores in .3gp and .mov), or its `vp09`
sample entry (VP9, what cv2.VideoWriter(fourcc "VP90") writes into .mp4;
its `vpcC` changes nothing cv2 returns), `tkhd`'s display matrix composed with `mvhd`'s (the
rotation cv2 applies, CAP_PROP_ORIENTATION_AUTO: 90, 180 or 270 degrees
clockwise) and the edit list (one that plays every sample, as cv2's
writer's do: from media time 0 or from the first composition time).  What
the port cannot decode as cv2 does
raises NotImplementedError naming it and ROADMAP item 18.4: any other
sample entry (`avc1`, `hvc1`, `av01`, ...), an `esds` of another object
type, a non-trivial edit list, fragmented or compressed movies, several
sample descriptions.

The writer (`Mp4Writer`) writes what cv2.VideoWriter(fourcc "mp4v")'s
muxer (FFmpeg's) writes, box for box where a reader looks: `ftyp` by the
extension (`isom` for .mp4, `M4V ` for .m4v, `qt  ` for .mov), a `free`
(`wide` in .mov) box that lets `mdat` grow a 64-bit size, `mdat`, then
`moov`: `mvhd` (timescale 1000), one `trak` with `tkhd`, a one-entry edit
list, `mdhd` (the stream's time resolution doubled up to at least 10000,
as FFmpeg picks it), `hdlr`, `vmhd`, `dref`, and the sample tables: `stsd`
(`mp4v` with the `esds` carrying the encoder's VOS / VO / VOL), `stts`,
`stss` (the I-VOPs), `stsc` (one chunk), `stsz`, `stco`.  The frames are
coded by native/mpeg4_enc.cpp.
"""

from __future__ import annotations

import math
import os
import struct
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np

from .. import native
from .formats import unsupported

QUANT = 3  # the writer's fixed vop_quant (no rate control)
GOP = 12  # cv2's: an I-VOP every 12 frames
BRANDS = {".mp4": (b"isom", 512, (b"isom", b"iso2", b"mp41")),
          ".m4v": (b"M4V ", 512, (b"M4V ", b"isom", b"iso2")),
          ".mov": (b"qt  ", 512, (b"qt  ",))}
CONTAINERS = {b"moov", b"trak", b"mdia", b"minf", b"stbl", b"edts", b"dinf", b"udta"}
MPEG4_VISUAL = 0x20  # esds objectTypeIndication
# the esds object types FFmpeg's mov demuxer (ff_mp4_obj_type) reads as
# mpeg2video (the MPEG-2 profiles 0x60-0x65) and mpeg1video (0x6A), and as
# mjpeg (0x6C); cv2's MPG2 and MJPG writers store an mp4v entry of type 0x61
# or 0x6C in .mp4
MPEG12_OBJECT_TYPES = (0x60, 0x61, 0x62, 0x63, 0x64, 0x65, 0x6A)
MJPEG_OBJECT_TYPE = 0x6C
# QuickTime sample entries of MPEG-1/2 (cv2's MPG2 and PIM1 writers store
# m2v1 and 'm1v ' in .mov) and Motion-JPEG (its MJPG writer stores jpeg)
MPEG12_ENTRIES = (b"m1v ", b"m1v1", b"mp1v", b"m2v1", b"mp2v")
MJPEG_ENTRIES = (b"jpeg",)
# QuickTime sample entries of PNG frames and of raw frames whose pixel
# format the port converts (cv2's png and RGBA writers store them in .mov)
PNG_ENTRIES = (b"png ",)
RAW_ENTRIES = (b"RGBA",)
# isom.c's sample entries of H.263 (cv2's H263 writer stores s263 in .3gp,
# h263 in .mov); each sample one picture, its size from its header
H263_ENTRIES = (b"s263", b"h263", b"H263")


def _boxes(data: bytes, start: int = 0, end: Optional[int] = None) -> Iterator[Tuple[bytes, int, int]]:
    """(type, body offset, body length) of each box of data[start:end]."""
    end = len(data) if end is None else end
    pos = start
    while pos + 8 <= end:
        size, kind = struct.unpack(">I4s", data[pos:pos + 8])
        head = 8
        if size == 1:
            if pos + 16 > end:
                raise ValueError(f"a {kind!r} box cut short")
            size, head = struct.unpack(">Q", data[pos + 8:pos + 16])[0], 16
        elif size == 0:
            size = end - pos
        if size < head or pos + size > end:
            raise ValueError(f"a {kind!r} box of {size} bytes runs past its parent")
        yield kind, pos + head, size - head
        pos += size


def _top_level(f, size: int) -> Dict[bytes, Tuple[int, int]]:
    """The top-level boxes of an open file: {type: (body offset, length)}
    (the first of each type), mdat's body never read."""
    found: Dict[bytes, Tuple[int, int]] = {}
    pos = 0
    while pos + 8 <= size:
        f.seek(pos)
        head = f.read(16)
        n, kind = struct.unpack(">I4s", head[:8])
        hl = 8
        if n == 1:
            n, hl = struct.unpack(">Q", head[8:16])[0], 16
        elif n == 0:
            n = size - pos
        if n < hl or pos + n > size:
            raise ValueError(f"a {kind!r} box of {n} bytes runs past the file")
        found.setdefault(kind, (pos + hl, n - hl))
        pos += n
    return found


def _full(body: bytes) -> Tuple[int, bytes]:
    """A full box's version and its body after version and flags."""
    return body[0], body[4:]


def _matrix(raw: bytes) -> np.ndarray:
    return np.array(struct.unpack(">9i", raw), np.int64).reshape(3, 3)


def _descriptors(data: bytes, pos: int, end: int) -> Iterator[Tuple[int, int, int]]:
    """(tag, body offset, body length) of the MPEG-4 descriptors in data[pos:end]."""
    while pos + 2 <= end:
        tag, pos = data[pos], pos + 1
        n = 0
        for _ in range(4):
            b, pos = data[pos], pos + 1
            n = n << 7 | (b & 0x7F)
            if not b & 0x80:
                break
        if pos + n > end:
            raise ValueError("an esds descriptor runs past its box")
        yield tag, pos, n
        pos += n


def _esds_config(body: bytes) -> Tuple[int, bytes]:
    """(objectTypeIndication, DecoderSpecificInfo) of an esds box's body."""
    _, d = _full(body)
    for tag, pos, n in _descriptors(d, 0, len(d)):
        if tag != 0x03:
            continue
        flags = d[pos + 2]
        p = pos + 3 + (2 if flags & 0x80 else 0)
        if flags & 0x40:
            p += 1 + d[p]
        if flags & 0x20:
            p += 2
        for tag2, pos2, n2 in _descriptors(d, p, pos + n):
            if tag2 != 0x04:
                continue
            oti = d[pos2]
            for tag3, pos3, n3 in _descriptors(d, pos2 + 13, pos2 + n2):
                if tag3 == 0x05:
                    return oti, bytes(d[pos3:pos3 + n3])
            return oti, b""
    raise ValueError("an esds box without a decoder configuration")


class Track(NamedTuple):
    """The first video track of an ISO base media file."""

    path: str
    codec: bytes  # the sample entry's type
    decoder: str  # "mpeg4", "mpeg12", "mjpeg" or "vp9" (utils/formats.py's decoders)
    width: int
    height: int
    config: bytes  # the esds DecoderSpecificInfo (mp4v), the vpcC body (vp09)
    offsets: List[int]  # each sample's file offset
    sizes: List[int]
    keyframes: Optional[List[int]]  # stss (1-based), None when every sample is one
    timescale: int
    deltas: List[int]  # each sample's duration in timescale units
    rotation: int  # clockwise degrees cv2 turns each frame (0, 90, 180, 270)

    @property
    def fps(self) -> float:
        return self.timescale * len(self.deltas) / max(sum(self.deltas), 1)


def _rotation(tkhd_matrix: np.ndarray, mvhd_matrix: np.ndarray) -> int:
    """The track's display matrix (mov.c: tkhd's times mvhd's, shifts 16,
    16, 30 by the inner index) read as OpenCV reads it:
    -round(av_display_rotation_get), in [0, 360)."""
    sh = (16, 16, 30)
    m = np.zeros((3, 3), np.int64)
    for i in range(3):
        for j in range(3):
            m[i, j] = sum(int(tkhd_matrix[i, e]) * int(mvhd_matrix[e, j]) >> sh[e] for e in range(3))
    a, b, c, d = (float(v) / 65536 for v in (m[0, 0], m[0, 1], m[1, 0], m[1, 1]))
    s0, s1 = math.hypot(a, c), math.hypot(b, d)
    if s0 == 0 or s1 == 0:
        return 0
    angle = -math.degrees(math.atan2(b / s1, a / s0))  # av_display_rotation_get
    r = -int(math.floor(angle + 0.5))  # cvRound
    return r + 360 if r < 0 else r


def open_video(path) -> Track:
    """The first video track of the ISO base media file at `path`.
    ValueError for a file that is not one or has no video track;
    NotImplementedError for what the port cannot decode as cv2 does."""
    path = os.fspath(path)
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        top = _top_level(f, size)
        if b"moov" not in top:
            if b"moof" in top:
                raise unsupported(path, "a fragmented MP4 file")
            raise ValueError(f"{path}: no moov box")
        pos, n = top[b"moov"]
        f.seek(pos)
        moov = f.read(n)
    mvhd_matrix = np.diag([65536, 65536, 1 << 30]).astype(np.int64)
    track = None
    for kind, p, n in _boxes(moov):
        if kind == b"cmov":
            raise unsupported(path, "a compressed moov box")
        if kind == b"mvex":
            raise unsupported(path, "a fragmented MP4 file")
        if kind == b"mvhd":
            v, body = _full(moov[p:p + n])
            at = (28 if v else 16) + 16  # past the times, rate, volume and reserved
            mvhd_matrix = _matrix(body[at:at + 36])
        if kind == b"trak" and track is None:
            try:
                track = _video_track(path, moov, p, n)
            except (struct.error, IndexError) as e:
                raise ValueError(f"{path}: a malformed track ({e})") from None
    if track is None:
        raise ValueError(f"{path}: no video track")
    tkhd_matrix, fields = track
    return Track(path=path, rotation=_rotation(tkhd_matrix, mvhd_matrix), **fields)


def _video_track(path: str, moov: bytes, start: int, length: int):
    """(tkhd matrix, Track fields) of a trak box, or None when it is not
    video."""
    found: Dict[bytes, bytes] = {}

    def walk(s: int, e: int):
        for kind, p, n in _boxes(moov, s, e):
            if kind in CONTAINERS:
                walk(p, p + n)
            elif kind not in found:
                found[kind] = moov[p:p + n]

    walk(start, start + length)
    hdlr = found.get(b"hdlr")
    if hdlr is None or hdlr[8:12] != b"vide":
        return None
    for need in (b"tkhd", b"mdhd", b"stsd", b"stts", b"stsc", b"stsz" if b"stz2" not in found else b"stz2"):
        if need not in found:
            raise ValueError(f"{path}: a video track without {need.decode()}")
    v, tkhd = _full(found[b"tkhd"])
    at = 32 if v else 20  # past the times, track id, reserved and duration
    tkhd_matrix = _matrix(tkhd[at + 16:at + 52])
    v, mdhd = _full(found[b"mdhd"])
    timescale = struct.unpack(">I", mdhd[16:20] if v else mdhd[8:12])[0]

    # the sample description
    _, stsd = _full(found[b"stsd"])
    count = struct.unpack(">I", stsd[:4])[0]
    if count != 1:
        raise unsupported(path, f"a track with {count} sample descriptions")
    entries = list(_boxes(stsd, 4))
    if not entries:
        raise ValueError(f"{path}: an empty stsd box")
    codec, p, n = entries[0]
    if codec not in ((b"mp4v", b"vp09") + MPEG12_ENTRIES + MJPEG_ENTRIES + PNG_ENTRIES + RAW_ENTRIES
                     + H263_ENTRIES):
        raise unsupported(path, f"a {codec.decode('latin-1')!r} video track",
                          "18.4g" if codec in (b"raw ", b"2vuy", b"yuv2", b"v210") else "18.4")
    width, height = struct.unpack(">HH", stsd[p + 24:p + 28])
    children = {kind: stsd[q:q + m] for kind, q, m in _boxes(stsd, p + 78, p + n)}
    config = b""
    if codec == b"vp09":
        # the VP9 stream's own colour config decides cv2's conversion: a vpcC
        # saying another profile, depth, sampling, range or matrix changes
        # nothing (measured on forged files)
        config, decoder = children.get(b"vpcC", b""), "vp9"
    elif codec in MPEG12_ENTRIES:
        decoder = "mpeg12"  # the sequence header is in the samples
    elif codec in MJPEG_ENTRIES:
        decoder = "mjpeg"
    elif codec in PNG_ENTRIES:
        decoder = "png"  # the frame's size is its IHDR's
    elif codec in RAW_ENTRIES:
        decoder = "rawvideo"  # at the sample entry's size
    elif codec in H263_ENTRIES:
        decoder = "h263"
    else:
        if b"esds" not in children:
            raise ValueError(f"{path}: an mp4v sample entry without esds")
        oti, config = _esds_config(children[b"esds"])
        if oti == MPEG4_VISUAL:
            decoder = "mpeg4"
        elif oti in MPEG12_OBJECT_TYPES:
            decoder = "mpeg12"
        elif oti == MJPEG_OBJECT_TYPE:
            decoder, config = "mjpeg", b""
        else:
            raise unsupported(path, f"an mp4v track of object type 0x{oti:02x}")
    sizes = _sizes(found)
    offsets = _offsets(path, found, sizes)
    deltas = []
    _, stts = _full(found[b"stts"])
    for i in range(struct.unpack(">I", stts[:4])[0]):
        c, d = struct.unpack(">II", stts[4 + 8 * i:12 + 8 * i])
        deltas += [d] * c
    deltas = (deltas + [deltas[-1] if deltas else 1] * len(sizes))[:len(sizes)]
    if b"elst" in found:
        cts = _composition_times(found, deltas)
        _check_edits(path, found[b"elst"], min(cts, default=0), max(cts, default=0), timescale,
                     _movie_timescale(moov))
    keyframes = None
    if b"stss" in found:
        _, stss = _full(found[b"stss"])
        keyframes = list(struct.unpack(f">{struct.unpack('>I', stss[:4])[0]}I", stss[4:]))
    return tkhd_matrix, dict(codec=codec, decoder=decoder, width=width, height=height,
                             config=config, offsets=offsets, sizes=sizes, keyframes=keyframes,
                             timescale=timescale, deltas=deltas)


def _movie_timescale(moov: bytes) -> int:
    for kind, p, n in _boxes(moov):
        if kind == b"mvhd":
            v, body = _full(moov[p:p + n])
            return struct.unpack(">I", body[16:20] if v else body[8:12])[0]
    return 1000


def _composition_times(found: Dict[bytes, bytes], deltas: List[int]) -> List[int]:
    """Each sample's composition time: its decode time plus its ctts offset
    (MPEG-1/2 with B pictures, and the one-picture delay of MPEG-1/2
    without them)."""
    times, t = [], 0
    for d in deltas:
        times.append(t)
        t += d
    if b"ctts" in found:
        v, b = _full(found[b"ctts"])
        i = 0
        for k in range(struct.unpack(">I", b[:4])[0]):
            count, offset = struct.unpack(">Ii" if v else ">II", b[4 + 8 * k:12 + 8 * k])
            for _ in range(count):
                if i < len(times):
                    times[i] += offset
                i += 1
    return times


def _check_edits(path: str, elst: bytes, first: int, last: int, timescale: int,
                 movie_scale: int):
    """An edit list cv2 plays as the media itself: none, or one edit at rate 1
    from a media time no later than the first composition time `first`
    (what FFmpeg's muxer writes for a codec's delay) that reaches past the
    last sample's composition time `last` (FFmpeg keeps the samples that
    start inside the edit)."""
    v, body = _full(elst)
    count = struct.unpack(">I", body[:4])[0]
    if count == 0:
        return
    fmt, size = (">QqHH", 20) if v else (">IiHH", 12)
    edits = [struct.unpack(fmt, body[4 + size * i:4 + size * (i + 1)]) for i in range(count)]
    whole = count == 1 and 0 <= edits[0][1] <= max(first, 0) and edits[0][2:] == (1, 0) and (
        edits[0][0] == 0 or edits[0][0] * timescale > (last - edits[0][1]) * movie_scale)
    if not whole:
        raise unsupported(path, f"a non-trivial edit list ({count} edits: "
                                f"{[(e[0], e[1], e[2] + e[3] / 65536) for e in edits]})")


def _sizes(found: Dict[bytes, bytes]) -> List[int]:
    if b"stsz" in found:
        _, b = _full(found[b"stsz"])
        size, count = struct.unpack(">II", b[:8])
        return [size] * count if size else list(struct.unpack(f">{count}I", b[8:8 + 4 * count]))
    _, b = _full(found[b"stz2"])
    bits, count = b[3], struct.unpack(">I", b[4:8])[0]
    if bits == 16:
        return list(struct.unpack(f">{count}H", b[8:8 + 2 * count]))
    if bits == 8:
        return list(b[8:8 + count])
    if bits == 4:
        return [(b[8 + i // 2] >> (4 if i % 2 == 0 else 0)) & 15 for i in range(count)]
    raise ValueError(f"an stz2 box of {bits}-bit sizes")


def _offsets(path: str, found: Dict[bytes, bytes], sizes: List[int]) -> List[int]:
    count = len(sizes)
    if b"stco" in found:
        _, b = _full(found[b"stco"])
        n = struct.unpack(">I", b[:4])[0]
        chunks = list(struct.unpack(f">{n}I", b[4:4 + 4 * n]))
    elif b"co64" in found:
        _, b = _full(found[b"co64"])
        n = struct.unpack(">I", b[:4])[0]
        chunks = list(struct.unpack(f">{n}Q", b[4:4 + 8 * n]))
    else:
        raise ValueError(f"{path}: a video track without stco or co64")
    _, b = _full(found[b"stsc"])
    runs = [struct.unpack(">III", b[4 + 12 * i:16 + 12 * i])
            for i in range(struct.unpack(">I", b[:4])[0])]
    if any(r[2] != 1 for r in runs):
        raise unsupported(path, "samples of a second sample description")
    offsets: List[int] = []
    for k, (first, per_chunk, _) in enumerate(runs):
        last = runs[k + 1][0] - 1 if k + 1 < len(runs) else len(chunks)
        for chunk in range(first - 1, min(last, len(chunks))):
            pos = chunks[chunk]
            for _ in range(per_chunk):
                if len(offsets) == count:
                    return offsets
                offsets.append(pos)
                pos += sizes[len(offsets) - 1]
    return offsets


def iter_samples(track: Track) -> Iterator[bytes]:
    """Each sample's bytes, in decode order."""
    with open(track.path, "rb") as f:
        for pos, n in zip(track.offsets, track.sizes):
            f.seek(pos)
            data = f.read(n)
            if len(data) != n:
                raise ValueError(f"{track.path}: a sample at {pos} runs past the file")
            yield data


def rotate(frame: np.ndarray, degrees: int) -> np.ndarray:
    """A frame turned clockwise as cv2.rotate turns it (90, 180, 270)."""
    if degrees == 90:
        return np.ascontiguousarray(np.rot90(frame, -1))
    if degrees == 180:
        return np.ascontiguousarray(frame[::-1, ::-1])
    if degrees == 270:
        return np.ascontiguousarray(np.rot90(frame, 1))
    return frame


def _box(kind: bytes, *parts: bytes) -> bytes:
    body = b"".join(parts)
    return struct.pack(">I4s", 8 + len(body), kind) + body


def _full_box(kind: bytes, version: int, flags: int, *parts: bytes) -> bytes:
    return _box(kind, struct.pack(">I", version << 24 | flags), *parts)


def _descriptor(tag: int, body: bytes) -> bytes:
    n = len(body)  # FFmpeg's four-byte size form
    return bytes([tag, 0x80 | (n >> 21 & 0x7F), 0x80 | (n >> 14 & 0x7F), 0x80 | (n >> 7 & 0x7F),
                  n & 0x7F]) + body


IDENTITY = struct.pack(">9i", 65536, 0, 0, 0, 65536, 0, 0, 0, 1 << 30)


class Mp4Writer:
    """Write (H, W, 3) uint8 RGB frames of one size as an MPEG-4 Part 2
    stream in the ISO base media file its extension names (.mp4, .m4v,
    .mov) at `fps` (a context manager; `close()` writes the moov box)."""

    def __init__(self, path, width: int, height: int, fps: float = 30, quant: int = QUANT,
                 gop: int = GOP, options: int = 0):
        self.path = os.fspath(path)
        ext = os.path.splitext(self.path)[1].lower()
        if ext not in BRANDS:
            raise ValueError(f"{self.path}: an ISO base media file is .mp4, .m4v or .mov")
        self.mov = ext == ".mov"
        self.encoder = native.Mpeg4Encoder(width, height, fps, quant, gop, in_band=False,
                                           options=options)
        self.width, self.height, self.gop = int(width), int(height), int(gop)
        res = self.encoder.resolution
        self.timescale = res
        while self.timescale < 10000:  # FFmpeg's track timescale
            self.timescale *= 2
        self.delta = self.encoder.increment * self.timescale // res
        self._sizes: List[int] = []
        self._keys: List[int] = []
        self._f = open(self.path, "wb")
        brand, minor, compat = BRANDS[ext]
        self._f.write(_box(b"ftyp", brand, struct.pack(">I", minor), *compat))
        self._f.write(_box(b"wide" if self.mov else b"free"))
        self._mdat_at = self._f.tell()
        self._f.write(struct.pack(">I4s", 8, b"mdat"))

    def write(self, frame: np.ndarray) -> None:
        """Append one (H, W, 3) uint8 RGB frame of the writer's size."""
        data = self.encoder.encode(frame)
        if len(self._sizes) % self.gop == 0:
            self._keys.append(len(self._sizes) + 1)
        self._f.write(data)
        self._sizes.append(len(data))

    def close(self) -> None:
        if self._f.closed:
            return
        mdat = 8 + sum(self._sizes)
        if mdat < 1 << 32:
            self._f.seek(self._mdat_at)
            self._f.write(struct.pack(">I4s", mdat, b"mdat"))
        else:  # the free box before mdat becomes a 64-bit size
            self._f.seek(self._mdat_at - 8)
            self._f.write(struct.pack(">I4sQ", 1, b"mdat", mdat + 8))
        self._f.seek(0, os.SEEK_END)
        self._f.write(self._moov(self._mdat_at + 8))  # the samples: one chunk
        self._f.close()
        self.encoder.close()

    def _moov(self, chunk_at: int) -> bytes:
        n = len(self._sizes)
        media = n * self.delta
        movie = -(-media * 1000 // self.timescale)  # rounded up, as FFmpeg's muxer
        w, h = self.width, self.height
        mvhd = _full_box(b"mvhd", 0, 0, struct.pack(">IIII", 0, 0, 1000, movie),
                         struct.pack(">IH10x", 0x00010000, 0x0100), IDENTITY, bytes(24),
                         struct.pack(">I", 2))
        tkhd = _full_box(b"tkhd", 0, 3, struct.pack(">IIIII", 0, 0, 1, 0, movie), bytes(8),
                         struct.pack(">hhhH", 0, 0, 0, 0), IDENTITY, struct.pack(">II", w << 16, h << 16))
        elst = _full_box(b"elst", 0, 0, struct.pack(">IIiHH", 1, movie, 0, 1, 0))
        mdhd = _full_box(b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0, self.timescale, media,
                                                    0x7FFF if self.mov else 0x55C4, 0))
        hdlr = _full_box(b"hdlr", 0, 0, b"mhlr" if self.mov else bytes(4), b"vide", bytes(12),
                         b"\x0cVideoHandler" if self.mov else b"VideoHandler\0")
        vmhd = _full_box(b"vmhd", 0, 1, bytes(8))
        dinf = _box(b"dinf", _full_box(b"dref", 0, 0, struct.pack(">I", 1),
                                       _full_box(b"url ", 0, 1)))
        minf_hdlr = (_full_box(b"hdlr", 0, 0, b"dhlr", b"url ", bytes(12), b"\x0bDataHandler")
                     if self.mov else b"")
        cfg = self.encoder.config
        dcd = _descriptor(0x04, bytes([MPEG4_VISUAL, 0x11]) + struct.pack(">I", 0)[1:]
                          + struct.pack(">II", 0, 0) + _descriptor(0x05, cfg))
        esds = _full_box(b"esds", 0, 0, _descriptor(0x03, struct.pack(">HB", 1, 0) + dcd
                                                     + _descriptor(0x06, b"\x02")))
        vendor = struct.pack(">HH4sII", 0, 0, b"FFMP", 512, 512) if self.mov else bytes(16)
        mp4v = _box(b"mp4v", bytes(6), struct.pack(">H", 1), vendor, struct.pack(">HH", w, h),
                    struct.pack(">III", 0x00480000, 0x00480000, 0), struct.pack(">H", 1), bytes(32),
                    struct.pack(">Hh", 0x18, -1), esds)
        stsd = _full_box(b"stsd", 0, 0, struct.pack(">I", 1), mp4v)
        stts = _full_box(b"stts", 0, 0, struct.pack(">III", 1, n, self.delta) if n
                         else struct.pack(">I", 0))
        stss = _full_box(b"stss", 0, 0, struct.pack(f">I{len(self._keys)}I", len(self._keys),
                                                    *self._keys))
        stsc = _full_box(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, n, 1) if n
                         else struct.pack(">I", 0))
        stsz = _full_box(b"stsz", 0, 0, struct.pack(f">II{n}I", 0, n, *self._sizes))
        stco = (_full_box(b"stco", 0, 0, struct.pack(">II", 1, chunk_at)) if chunk_at < 1 << 32
                else _full_box(b"co64", 0, 0, struct.pack(">IQ", 1, chunk_at)))
        stbl = _box(b"stbl", stsd, stts, stss, stsc, stsz, stco)
        minf = _box(b"minf", vmhd, minf_hdlr, dinf, stbl)
        mdia = _box(b"mdia", mdhd, hdlr, minf)
        trak = _box(b"trak", tkhd, _box(b"edts", elst), mdia)
        return _box(b"moov", mvhd, trak)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
