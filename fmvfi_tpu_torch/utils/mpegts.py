"""MPEG transport streams (.ts, .m2ts), program streams (.mpg, .vob) and raw
MPEG video streams (.m1v, .m2v) without cv2: the reader pipeline/video.py
uses for them, as FFmpeg's mpegts, mpeg (PS) and mpegvideo demuxers read
them.

- A transport stream (`_ts_es`): 188-byte packets, or 192-byte ones after a
  4-byte prefix (M2TS); the PAT, the first program's PMT, adaptation fields
  skipped, each PID's continuity counter checked, the first video stream's
  PES packets stripped of their headers.  Stream types 0x01 and 0x02 are
  MPEG-1 / MPEG-2 video, 0x10 MPEG-4 Part 2; H.264, HEVC and the rest raise
  NotImplementedError (item 18.4).
- A program stream (`_ps_es`): MPEG-1 and MPEG-2 pack headers (with their
  stuffing), system headers, the program stream map (whose stream types
  name the codec of a video stream), padding and private streams (a DVD's
  audio, subpictures and navigation packets) skipped, MPEG-1 and MPEG-2
  PES headers; the first video stream (ids 0xE0-0xEF) is read.
- A raw stream is its own elementary stream.

The elementary stream is then split into pictures at start codes, as
FFmpeg's parsers split it (`split_mpeg12`: a picture ends at the first
start code that is not a slice's after its slices, a sequence end code
included in it; `split_mpeg4`: a VOP ends at the next start code), and PES
boundaries play no part.  cv2 returns the decoder's frames in its output
order and reads no timestamps, and neither does this reader.  Truncated or
corrupt packets raise ValueError.
"""

from __future__ import annotations

import os
from typing import Iterator, List, NamedTuple, Optional, Tuple

from .formats import unsupported

TS_SYNC = 0x47
PACK = b"\x00\x00\x01\xba"
SEQUENCE = b"\x00\x00\x01\xb3"
# PMT / PSM stream types: the codec each names
STREAM_TYPES = {0x01: "mpeg12", 0x02: "mpeg12", 0x10: "mpeg4"}
OTHER_VIDEO = {0x1B: "H.264", 0x24: "HEVC", 0x42: "AVS", 0xD1: "Dirac", 0xEA: "VC-1",
               0x20: "H.264 (MVC)", 0x21: "JPEG 2000", 0x33: "VVC", 0x80: "a private stream type "
               "0x80 (DigiCipher II or PCM)"}


class Stream(NamedTuple):
    """The first video stream of an MPEG stream file: its codec ("mpeg12"
    or "mpeg4") and its elementary stream's bytes."""

    path: str
    codec: str
    es: bytes


def ts_packet_size(head: bytes) -> int:
    """188 or 192 when `head` (the file's first bytes) holds transport
    stream packets of that size, as FFmpeg's probe finds them: a sync byte
    at the start of each of the first few packets; else 0."""
    for size, offset in ((188, 0), (192, 4)):
        n = min(len(head) // size, 5)
        if n >= 1 and all(head[i * size + offset] == TS_SYNC for i in range(n)) and (
                n >= 2 or len(head) == size):
            return size
    return 0


def open_stream(path, container: str) -> Stream:
    """The first video stream of the file at `path`; `container` is "ts",
    "ps" or "es" (pipeline/video.py::_container tells them apart).
    ValueError for a malformed file or one without video; NotImplementedError
    for a video codec the port does not decode."""
    path = os.fspath(path)
    with open(path, "rb") as f:
        data = f.read()
    if container == "ts":
        codec, es = _ts_es(path, data)
    elif container == "ps":
        codec, es = _ps_es(path, data)
    else:
        codec, es = "mpeg12", data
    if not es:
        raise ValueError(f"{path}: no video data")
    return Stream(path, codec, es)


def iter_packets(stream: Stream) -> Iterator[bytes]:
    """The stream's pictures (MPEG-1/2) or VOPs (MPEG-4 Part 2), each with the
    headers before it, as FFmpeg's parser hands them to the decoder."""
    split = split_mpeg12 if stream.codec == "mpeg12" else split_mpeg4
    es = stream.es
    for start, end in split(es):
        yield es[start:end]


def _start_codes(es: bytes) -> Iterator[int]:
    """Offsets of each 00 00 01 in es."""
    i = es.find(b"\x00\x00\x01")
    while i >= 0:
        yield i
        i = es.find(b"\x00\x00\x01", i + 3)


def split_mpeg12(es: bytes) -> List[Tuple[int, int]]:
    """ff_mpeg1_find_frame_end for frame pictures: a packet ends before the
    first start code after its slices that is not a slice's, or just after
    a sequence end code; the bytes before the first picture go with it."""
    out, start, in_slices = [], 0, False
    for i in _start_codes(es):
        if i + 3 >= len(es):
            break
        code = es[i + 3]
        if code == 0xB7:  # sequence end: the packet ends with it
            out.append((start, i + 4))
            start, in_slices = i + 4, False
        elif 0x01 <= code <= 0xAF:
            in_slices = True
        elif in_slices:
            out.append((start, i))
            start, in_slices = i, False
    if start < len(es) and es[start:].strip(b"\x00"):
        out.append((start, len(es)))
    return out


def split_mpeg4(es: bytes) -> List[Tuple[int, int]]:
    """ff_mpeg4_find_frame_end: a packet runs from the previous end through a
    VOP start code (00 00 01 B6) to the next start code."""
    out, start, in_vop = [], 0, False
    for i in _start_codes(es):
        if i + 3 >= len(es):
            break
        code = es[i + 3]
        if in_vop:
            out.append((start, i))
            start, in_vop = i, False
        if code == 0xB6:
            in_vop = True
    if start < len(es) and es[start:].strip(b"\x00"):
        out.append((start, len(es)))
    return out


# --- transport streams --------------------------------------------------------

def _section(payload: bytes, unit_start: bool) -> Optional[bytes]:
    """A PSI section from the payload of the packet that starts it."""
    if not unit_start or not payload:
        return None
    pointer = payload[0]
    sec = payload[1 + pointer:]
    if len(sec) < 3:
        raise ValueError("a PSI section cut short")
    length = ((sec[1] & 0x0F) << 8) | sec[2]
    if len(sec) < 3 + length or length < 9:
        raise ValueError("a PSI section longer than its packet")
    return sec[:3 + length]


def _ts_es(path: str, data: bytes) -> Tuple[str, bytes]:
    size = ts_packet_size(data[:192 * 5])
    if not size:
        raise ValueError(f"{path}: not a transport stream")
    offset = size - 188
    pmt_pid = video_pid = None
    codec = None
    pes: List[Tuple[bool, bytes]] = []  # the video PID's (unit start, payload)
    cc = {}
    started = False
    for pos in range(0, len(data) - size + 1, size):
        pkt = data[pos + offset:pos + size]
        if pkt[0] != TS_SYNC:
            raise ValueError(f"{path}: a transport packet at {pos} without its sync byte")
        unit_start = bool(pkt[1] & 0x40)
        pid = ((pkt[1] & 0x1F) << 8) | pkt[2]
        afc = (pkt[3] >> 4) & 3
        if pid == 0x1FFF:
            continue
        body = 4
        discontinuity = False
        if afc & 2:
            n = pkt[4]
            if n > 183:
                raise ValueError(f"{path}: an adaptation field of {n} bytes at {pos}")
            discontinuity = n > 0 and bool(pkt[5] & 0x80)
            body = 5 + n
        if not afc & 1:
            continue
        counter = pkt[3] & 0x0F
        if pid in cc and not discontinuity and counter != (cc[pid] + 1) & 0x0F:
            raise ValueError(f"{path}: PID 0x{pid:X}'s continuity counter jumps from "
                             f"{cc[pid]} to {counter} at {pos}")
        cc[pid] = counter
        payload = pkt[body:]
        if pid == 0 and pmt_pid is None:
            sec = _section(payload, unit_start)
            if sec is not None:
                for i in range(8, len(sec) - 4 - 3, 4):
                    program = (sec[i] << 8) | sec[i + 1]
                    if program:
                        pmt_pid = ((sec[i + 2] & 0x1F) << 8) | sec[i + 3]
                        break
        elif pid == pmt_pid and video_pid is None:
            sec = _section(payload, unit_start)
            if sec is not None:
                video_pid, codec = _pmt_video(path, sec)
        elif pid == video_pid:
            if unit_start:
                started = True
            if started:
                pes.append((unit_start, payload))
    if pmt_pid is None:
        raise ValueError(f"{path}: no program association table")
    if video_pid is None:
        raise ValueError(f"{path}: no video stream in the program map")
    return codec, _pes_payloads(path, pes)


def _pmt_video(path: str, sec: bytes) -> Tuple[int, str]:
    """The first video elementary stream of a PMT section: (PID, codec)."""
    info = ((sec[10] & 0x0F) << 8) | sec[11]
    i = 12 + info
    end = len(sec) - 4
    while i + 5 <= end:
        stype = sec[i]
        pid = ((sec[i + 1] & 0x1F) << 8) | sec[i + 2]
        n = ((sec[i + 3] & 0x0F) << 8) | sec[i + 4]
        if stype in STREAM_TYPES:
            return pid, STREAM_TYPES[stype]
        if stype in OTHER_VIDEO:
            raise unsupported(path, f"a transport stream whose video is {OTHER_VIDEO[stype]} "
                                    f"(stream type 0x{stype:02X})")
        i += 5 + n
    raise ValueError(f"{path}: no video stream in the program map")


def _pes_payloads(path: str, pieces) -> bytes:
    """The elementary stream of a PID's packets: each PES packet's header
    removed (a packet may be unbounded, PES_packet_length 0)."""
    out = bytearray()
    packets: List[bytearray] = []
    for unit_start, payload in pieces:
        if unit_start:
            packets.append(bytearray(payload))
        elif packets:
            packets[-1] += payload
    for i, p in enumerate(packets):
        if len(p) < 9 or p[:3] != b"\x00\x00\x01":
            if i == len(packets) - 1 and len(p) < 9:
                break  # a last PES packet cut short
            raise ValueError(f"{path}: a PES packet without its start code")
        length = (p[4] << 8) | p[5]
        if (p[6] & 0xC0) != 0x80:
            raise ValueError(f"{path}: a transport stream PES header that is not MPEG-2's")
        start = 9 + p[8]
        end = 6 + length if length else len(p)
        if start > len(p) or (i < len(packets) - 1 and end > len(p)):
            raise ValueError(f"{path}: a PES packet cut short")
        out += p[start:min(end, len(p))]
    return bytes(out)


# --- program streams ------------------------------------------------------------

def _ps_es(path: str, data: bytes) -> Tuple[str, bytes]:
    """The first video stream of a program stream."""
    pos, n = 0, len(data)
    video_id = None
    psm = {}
    out = bytearray()
    while pos + 4 <= n:
        if data[pos:pos + 3] != b"\x00\x00\x01":
            nxt = data.find(b"\x00\x00\x01", pos)
            if nxt < 0:
                break
            pos = nxt  # FFmpeg resyncs on the next start code
            continue
        code = data[pos + 3]
        if code == 0xB9:  # program end
            pos += 4
            continue
        if code == 0xBA:  # pack header
            if pos + 5 > n:
                break
            if (data[pos + 4] & 0xC0) == 0x40:  # MPEG-2: 14 bytes and stuffing
                if pos + 14 > n:
                    raise ValueError(f"{path}: a pack header cut short")
                pos += 14 + (data[pos + 13] & 7)
            elif (data[pos + 4] & 0xF0) == 0x20:  # MPEG-1: 12 bytes
                pos += 12
            else:
                raise ValueError(f"{path}: a pack header of neither MPEG-1 nor MPEG-2")
            continue
        if code < 0xBB:
            raise ValueError(f"{path}: a start code 0x{code:02X} outside a PES packet at {pos}")
        if pos + 6 > n:
            raise ValueError(f"{path}: a PES packet cut short")
        length = (data[pos + 4] << 8) | data[pos + 5]
        body, end = pos + 6, pos + 6 + length
        if end > n:
            if video_id is not None and code == video_id:
                end = n  # a file cut inside its last packet: read up to the cut
            else:
                break
        if code == 0xBC:  # program stream map
            psm = _psm(data[body:end])
        elif 0xE0 <= code <= 0xEF and video_id in (None, code):
            stype = psm.get(code)
            if stype in OTHER_VIDEO or (stype is not None and stype not in STREAM_TYPES):
                raise unsupported(path, "a program stream whose video is "
                                        f"{OTHER_VIDEO.get(stype, f'stream type 0x{stype:02X}')}")
            video_id = code
            out += _ps_pes_payload(path, data[body:end])
        pos = end
    if video_id is None:
        raise ValueError(f"{path}: no video stream in the program stream")
    stype = psm.get(video_id)
    return STREAM_TYPES.get(stype, "mpeg12"), bytes(out)


def _psm(body: bytes) -> dict:
    """{elementary stream id: stream type} of a program stream map."""
    if len(body) < 6:
        return {}
    info = (body[2] << 8) | body[3]
    i = 4 + info
    if i + 2 > len(body):
        return {}
    total = (body[i] << 8) | body[i + 1]
    i += 2
    end = min(i + total, len(body))
    out = {}
    while i + 4 <= end:
        stype, es_id = body[i], body[i + 1]
        n = (body[i + 2] << 8) | body[i + 3]
        out[es_id] = stype
        i += 4 + n
    return out


def _ps_pes_payload(path: str, p: bytes) -> bytes:
    """A program stream PES packet's payload (the bytes after its 6-byte
    start): an MPEG-2 header, or MPEG-1's stuffing, STD buffer and
    timestamps."""
    if len(p) >= 3 and (p[0] & 0xC0) == 0x80:
        start = 3 + p[2]
        if start > len(p):
            raise ValueError(f"{path}: a PES header longer than its packet")
        return p[start:]
    i = 0
    while i < len(p) and p[i] == 0xFF and i < 16:
        i += 1
    if i < len(p) and (p[i] & 0xC0) == 0x40:  # STD buffer
        i += 2
    if i >= len(p):
        raise ValueError(f"{path}: an MPEG-1 PES header cut short")
    if (p[i] & 0xF0) == 0x20:
        i += 5
    elif (p[i] & 0xF0) == 0x30:
        i += 10
    elif p[i] == 0x0F:
        i += 1
    else:
        raise ValueError(f"{path}: a malformed MPEG-1 PES header")
    if i > len(p):
        raise ValueError(f"{path}: an MPEG-1 PES header cut short")
    return p[i:]
