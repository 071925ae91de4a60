#!/usr/bin/env python3
"""Write the input fixtures of tests/data/inputs/ and print their pins.

    python3 tools/make_input_fixtures.py [--out tests/data/inputs]

Each fixture is made from seeded numpy with what JAX's readers are held to:
- Adam7 (interlaced) PNGs, written with zlib and struct (each pass's rows
  filtered with the filter types cycled 0-4): 8-bit RGB, a 4-bit palette
  with tRNS, 16-bit grey, 16-bit RGBA, and a directory of three 64x64 RGB
  frames of a translation;
- progressive JPEGs: cv2's (4:2:0, and 4:4:4 with a restart interval of
  2), the first one cut after its second scan with an EOI put back (block
  smoothing then runs when it is decoded), PIL's optimized grey file, and
  a directory of three 64x64 cv2 progressive frames of the translation;
- Motion-JPEG AVIs: one cv2.VideoWriter(..., "MJPG", ...) writes, and three
  the port's MjpgWriter writes from cv2.imencode's frames at 4:2:2, 4:4:4
  and 4:2:0 (sizes that take each of swscale's conversion routes when
  cv2.VideoCapture decodes them);
- MPEG-4 Part 2 (mp4v) files cv2.VideoWriter writes of a texture sliding
  past the frame's edges (P-VOPs with vectors across macroblocks and out of
  the picture, both rounding types): a 96x72 .mp4 of 15 frames, a .mov
  given 95x71 frames and a FourCC FMP4 .avi given 64x47 ones (OpenCV's
  writer crops both to even sides: 94x70 and 64x46); and two files the
  port's encoder writes, which cv2 decodes for the pins: a 95x71 .avi (odd
  sides: swscale's other yuv420p routes) and a 45x37 .avi coded with 4MV,
  DQUANT, AC prediction and DC-as-TCOEF (paths cv2's writer never takes);
- Matroska and WebM files: cv2.VideoWriter's VP80 in a 96x72 .webm and
  a .mkv given 95x71 frames (94x70), MJPG, mp4v and XVID in .mkv, all of a
  texture sliding past the frame's edges; VP8 clips coded with cv2's own
  libvpx through ctypes (`vp8_encode`) in settings cv2's writer never
  takes, muxed by the port's MkvMuxer: odd sides with 8 token partitions,
  two-pass auto-alt-ref (hidden frames, golden / alt-ref sign bias),
  error-resilient real-time screen coding (segmentation and its map,
  probabilities kept per frame) and versions 1, 2 and 3 (bilinear filters,
  full-pixel chroma, the simple loop filter); copies of the cv2 .webm
  forged with an unknown-size Segment and Clusters, with laced blocks
  (Xiph, EBML, fixed) and BlockGroups, with an audio track before the
  video one and its blocks interleaved, and with a Colour element and a
  PixelCrop (which cv2 ignores in a VP8 track); and the video phase's
  first three 1080x1920 frames as cv2.VideoWriter's VP80 .webm, which
  chip_smoke.py runs `cli video` on;
- VP9: cv2.VideoWriter's VP90 in .webm, .mkv, .mp4 and .avi (odd sizes
  cropped to even); clips coded with cv2's libvpx through ctypes
  (`vp9_encode`) in settings cv2's writer never takes: two-pass
  auto-alt-ref (superframes, hidden frames, compound prediction), tile
  columns and tile rows, lossless, AQ modes 1-3, error-resilient,
  cpu-used 0, 5 and 8, profile 1 at 4:4:4, 4:2:2 and 4:4:0, BT.709 at
  full range, BT.2020 and SMPTE 240M; forged: loop filter sharpness 5 and
  the bilinear filter written into frame headers, 1-byte
  show_existing_frame packets, a Colour element on a VP9 track, an MP4
  whose vpcC says BT.709 at full range; and the smoke clip's first three
  1080x1920 frames as cv2's VP90 .webm;
- WebP and GIF (`--only webp_gif`): cv2's and PIL's lossy WebPs (odd
  sides, ALPH, EXIF Orientation 6), lossless ones made to use each VP8L
  transform, the colour cache, LZ77 and meta prefix codes, palettes of 2,
  4, 16 and 256 colours, animated WebPs, and copies read as video; GIFs of
  this file's own writer (`gif_file`, `gif_lzw`: 87a, local tables,
  interlacing, transparency, a 2-bit and a 5-bit table, a full LZW table
  with and without a Clear, disposals 0-3 over sub-rectangles) and PIL's,
  clips and sequences; and the smoke's two 1080x1920 files, cv2's lossy
  WebP (quality 90) of a smooth scene and a 3-frame animated GIF of it
  moving (PIL's, 256 colours).

It prints INPUT_PINS, chip_smoke.py's table: for each fixture the reader
contract ("imread": cv2.imread + BGR2RGB; "read_jpeg": PIL's Image.open;
"video": cv2.VideoCapture's frames + BGR2RGB, stacked; `gif_clip_`,
`webp_video_` and `video_` names and sequences) and the sha256 of those
pixels.  The CPU tests (tests/test_torch_png_adam7.py,
test_torch_jpeg_progressive.py, test_torch_mjpg_video.py,
test_torch_mp4v_video.py, test_torch_mkv_video.py,
test_torch_vp9_video.py) hold the pins
against cv2 and PIL and the port against the pins; chip_smoke.py's phase
`inputs` holds the port on the card's host, which has neither cv2 nor PIL,
against them.  Needs cv2, PIL and the port (its MjpgWriter and MPEG-4
encoder); not JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import os
import struct
import sys
import zlib
from unittest import mock

import cv2
import numpy as np
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from fmvfi_tpu_torch.eval.synth import translation_video  # noqa: E402
from fmvfi_tpu_torch.utils import avi, mkv  # noqa: E402

VIDEO_SUFFIXES = (".avi", ".mp4", ".mov", ".m4v", ".mkv", ".webm", ".mpg", ".vob", ".ts",
                  ".m2ts", ".m1v", ".m2v", ".ivf", ".flv", ".3gp")

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))
SPP = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(
        ">I", zlib.crc32(body, zlib.crc32(ctype)))


def _filtered(rows: np.ndarray, bpp: int, first: int) -> bytes:
    x = rows.astype(np.int32)
    out = []
    for r in range(x.shape[0]):
        t = (first + r) % 5
        cur, prev = x[r], (x[r - 1] if r else np.zeros_like(x[r]))
        a = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        p = a + prev - c
        pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
        pred = [np.zeros_like(cur), a, prev, (a + prev) >> 1, paeth][t]
        out.append(bytes([t]) + ((cur - pred) & 255).astype(np.uint8).tobytes())
    return b"".join(out)


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(samples.shape[0], -1)
    if depth == 8:
        return samples.astype(np.uint8)
    bits = (samples[..., None] >> np.arange(depth - 1, -1, -1)) & 1
    return np.packbits(bits.reshape(samples.shape[0], -1).astype(np.uint8), axis=1)


def adam7_png(samples: np.ndarray, color: int, depth: int, palette=None, trns=None) -> bytes:
    """(H, W, spp) integer samples as an Adam7 PNG's bytes."""
    h, w = samples.shape[:2]
    bpp = max(1, SPP[color] * depth // 8)
    data, first = b"", 0
    for x0, y0, dx, dy in ADAM7:
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            data += _filtered(_pack(sub.reshape(sub.shape[0], -1), depth), bpp, first)
            first += 1
    chunks = [_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 1))]
    if palette is not None:
        chunks.append(_chunk(b"PLTE", palette.astype(np.uint8).tobytes()))
    if trns is not None:
        chunks.append(_chunk(b"tRNS", trns))
    chunks += [_chunk(b"IDAT", zlib.compress(data, 9)), _chunk(b"IEND", b"")]
    return b"\x89PNG\r\n\x1a\n" + b"".join(chunks)


def _progressive(img, **kw) -> bytes:
    params = [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    for key, value in kw.items():
        params += [getattr(cv2, f"IMWRITE_JPEG_{key.upper()}"), value]
    return cv2.imencode(".jpg", img, params)[1].tobytes()


def scan_ends(data: bytes):
    """The offset just past each scan's entropy-coded data in a JPEG."""
    ends, pos = [], 2
    while True:
        while data[pos + 1] == 0xFF:
            pos += 1
        marker = data[pos + 1]
        if marker == 0xD9:
            return ends
        pos += 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
        if marker == 0xDA:
            while not (data[pos] == 0xFF and data[pos + 1] != 0
                       and not 0xD0 <= data[pos + 1] <= 0xD7):
                pos += 1
            ends.append(pos)


def cut_after(data: bytes, scans: int) -> bytes:
    """A JPEG cut after its first `scans` scans, an EOI put back."""
    return data[:scan_ends(data)[scans - 1]] + b"\xff\xd9"


def mjpg_avi(path: str, jpegs, w: int, h: int, fps: int = 10) -> None:
    """An AVI of the given JPEG files, written by the port's MjpgWriter."""
    frames = iter(jpegs)
    with mock.patch.object(avi.native, "jpeg_encode", lambda image, quality: next(frames)):
        with avi.MjpgWriter(path, w, h, fps) as writer:
            for _ in jpegs:
                writer.write(np.zeros((h, w, 3), np.uint8))


def _texture(rng, h, w, channels=3):
    img = rng.integers(0, 256, (h, w, channels), np.uint8)
    return cv2.GaussianBlur(img, (0, 0), 1.5).reshape(h, w, channels)


def sliding(rng, n: int, h: int, w: int, step=(2.5, -1.5)):
    """n BGR frames of a textured scene sliding by `step` (x, y) pixels a
    frame, the window running past the scene's edge (repeated) late on."""
    scene = cv2.GaussianBlur(rng.integers(0, 256, (h + 24, w + 24, 3), np.uint8), (0, 0), 2.0)
    scene = cv2.normalize(scene, None, 0, 255, cv2.NORM_MINMAX)
    out = []
    for i in range(n):
        m = np.float32([[1, 0, 12 + step[0] * i], [0, 1, 12 + step[1] * i]])
        out.append(cv2.warpAffine(scene, m, (w, h), flags=cv2.INTER_LINEAR,
                                  borderMode=cv2.BORDER_REPLICATE))
    return out


def cv2_video(path: str, fourcc: str, frames, fps: int = 30) -> None:
    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), fps, (w, h))
    assert writer.isOpened(), path
    for frame in frames:
        writer.write(frame)
    writer.release()


def port_mp4v_avi(path: str, frames, options: int = 0, quant: int = 4) -> None:
    """An mp4v AVI of BGR frames written by the port's encoder."""
    h, w = frames[0].shape[:2]
    with avi.Mpeg4AviWriter(path, w, h, 30, quant=quant, options=options) as writer:
        for frame in frames:
            writer.write(np.ascontiguousarray(frame[..., ::-1]))


def make(out: str) -> dict:
    """Write every fixture into `out`; returns {name: (contract, sha256)}."""
    os.makedirs(out, exist_ok=True)
    rng = np.random.default_rng(2026)
    clip = (translation_video(3, 64, 64, step=2.0, seed=3) * 255).astype(np.uint8)
    files = {}

    def put(name, data):
        with open(os.path.join(out, name), "wb") as f:
            f.write(data)
        files[name] = data

    put("adam7_rgb8_29x37.png", adam7_png(rng.integers(0, 256, (29, 37, 3)), 2, 8))
    pal = rng.integers(0, 256, (12, 3))
    put("adam7_pal4_9x13.png", adam7_png(rng.integers(0, 12, (9, 13, 1)), 3, 4, palette=pal,
                                         trns=bytes(rng.integers(0, 256, 12).astype(np.uint8))))
    put("adam7_grey16_5x7.png", adam7_png(rng.integers(0, 65536, (5, 7, 1)), 0, 16,
                                          trns=struct.pack(">H", 1234)))
    put("adam7_rgba16_3x2.png", adam7_png(rng.integers(0, 65536, (3, 2, 4)), 6, 16))
    os.makedirs(os.path.join(out, "adam7_frames"), exist_ok=True)
    for i, frame in enumerate(clip):
        put(f"adam7_frames/{i:05d}.png", adam7_png(frame.astype(np.int64), 2, 8))

    full = _progressive(_texture(rng, 61, 77), quality=80)
    put("progressive_420_61x77.jpg", full)
    put("progressive_420_61x77_cut2.jpg", cut_after(full, 2))
    put("progressive_444_33x40_rst2.jpg",
        _progressive(_texture(rng, 33, 40), quality=60, rst_interval=2,
                     sampling_factor=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444))
    buf = io.BytesIO()
    Image.fromarray(_texture(rng, 45, 50, 1)[..., 0]).save(buf, "JPEG", quality=70,
                                                          progressive=True, optimize=True)
    put("progressive_grey_pil_45x50.jpg", buf.getvalue())
    os.makedirs(os.path.join(out, "progressive_frames"), exist_ok=True)
    for i, frame in enumerate(clip):
        put(f"progressive_frames/{i:05d}.jpg",
            _progressive(np.ascontiguousarray(frame[..., ::-1]), quality=90))

    path = os.path.join(out, "cv2_writer_48x64.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10, (64, 48))
    for _ in range(3):
        writer.write(_texture(rng, 48, 64))
    writer.release()
    files["cv2_writer_48x64.avi"] = None
    for name, (h, w), sampling in (("mjpg_422_45x62.avi", (45, 62), "422"),
                                   ("mjpg_444_21x37.avi", (21, 37), "444"),
                                   ("mjpg_420_21x37.avi", (21, 37), "420")):
        factor = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")
        jpegs = [cv2.imencode(".jpg", _texture(rng, h, w),
                              [cv2.IMWRITE_JPEG_QUALITY, 85, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                               factor])[1].tobytes() for _ in range(2)]
        mjpg_avi(os.path.join(out, name), jpegs, w, h)
        files[name] = None

    for name, fourcc, (h, w), n in (("mp4v_96x72.mp4", "mp4v", (72, 96), 15),
                                    ("mp4v_94x70.mov", "mp4v", (71, 95), 13),
                                    ("mp4v_fmp4_64x46.avi", "FMP4", (47, 64), 13)):
        cv2_video(os.path.join(out, name), fourcc, sliding(rng, n, h, w))
        files[name] = None
    port_mp4v_avi(os.path.join(out, "mp4v_port_95x71.avi"), sliding(rng, 13, 71, 95))
    files["mp4v_port_95x71.avi"] = None
    port_mp4v_avi(os.path.join(out, "mp4v_port_paths_45x37.avi"),
                  sliding(rng, 13, 37, 45, step=(4.5, 3.5)), options=15, quant=5)
    files["mp4v_port_paths_45x37.avi"] = None
    for name in make_matroska(out):
        files[name] = None
    for name in make_vp9(out):
        files[name] = None
    for name in make_mpeg12(out):
        files[name] = None
    for name in make_containers(out):
        files[name] = None
    for name in make_stills(out):
        files[name] = None
    for name in make_webp_gif(out):
        files[name] = None
    for name in make_vp9_highbd(out):
        files[name] = None
    for name in make_lossless_video(out):
        files[name] = None
    for name in make_webp_corrupt(out):
        files[name] = None
    for name in make_h263(out):
        files[name] = None
    return pins(out, files)


# --- Matroska / WebM -------------------------------------------------------

EBML_MASTERS = {0x1A45DFA3, 0x18538067, 0x114D9B74, 0x4DBB, 0x1549A966, 0x1654AE6B, 0xAE, 0xE0,
                0xE1, 0x1F43B675, 0xA0, 0x1C53BB6B, 0xBB, 0xB7, 0x55B0, 0x6D80, 0x6240, 0x5035,
                0x1254C367, 0x7373, 0x63C0, 0x67C8}
SEGMENT, CLUSTER, TRACKS, CUES, SEEK_HEAD, CRC32 = (0x18538067, 0x1F43B675, 0x1654AE6B,
                                                    0x1C53BB6B, 0x114D9B74, 0xBF)


def ebml_parse(data: bytes, pos: int = 0, end=None) -> list:
    """An EBML file as a tree: [[id, children or bytes], ...] (an element of
    unknown size runs to its parent's end)."""
    end = len(data) if end is None else end
    out = []
    while pos < end:
        eid, n, _ = mkv._vint(data, pos, end, keep_marker=True)
        size, m, unknown = mkv._vint(data, pos + n, end)
        body = pos + n + m
        stop = end if unknown else body + size
        out.append([eid, ebml_parse(data, body, stop) if eid in EBML_MASTERS else data[body:stop]])
        pos = stop
    return out


def ebml_dump(tree: list, unknown=()) -> bytes:
    """The bytes of a tree; the ids in `unknown` written with unknown size."""
    out = b""
    for eid, body in tree:
        raw = ebml_dump(body, unknown) if isinstance(body, list) else bytes(body)
        out += mkv._id_bytes(eid) + (b"\x01" + b"\xff" * 7 if eid in unknown
                                     else mkv._size(len(raw))) + raw
    return out


def ebml_find(tree: list, *path):
    for eid, body in tree:
        if eid == path[0]:
            return body if len(path) == 1 else ebml_find(body, *path[1:])
    return None


def ebml_strip(tree: list) -> list:
    """The tree without CRC-32s, SeekHead and Cues (whose offsets a rewrite
    would make wrong)."""
    return [[eid, ebml_strip(body) if isinstance(body, list) else body]
            for eid, body in tree if eid not in (CRC32, SEEK_HEAD, CUES)]


def _uint(eid: int, v: int) -> list:
    return [eid, v.to_bytes(max(1, (v.bit_length() + 7) // 8), "big")]


def forge_unknown_sizes(data: bytes) -> bytes:
    """A MediaRecorder-like file: the Segment and every Cluster of unknown size."""
    return ebml_dump(ebml_strip(ebml_parse(data)), unknown={SEGMENT, CLUSTER})


def forge_laced(data: bytes) -> bytes:
    """Key blocks kept; the following inter frames three (the last two) to a
    block, laced in turn Xiph, EBML and fixed (frames padded with zeros to one size,
    which a VP8 decoder reads as past the last partition's end anyway), or
    as three BlockGroups with a ReferenceBlock."""
    tree = ebml_strip(ebml_parse(data))
    mode = 0
    for eid, cluster in ebml_find(tree, SEGMENT):
        if eid != CLUSTER:
            continue
        blocks = [bytes(b) for i, b in cluster if i == 0xA3]
        out = [[i, b] for i, b in cluster if i != 0xA3]
        k = 0
        while k < len(blocks):
            if blocks[k][3] & 0x80 or k + 2 > len(blocks):
                out.append([0xA3, blocks[k]])
                k += 1
                continue
            group = blocks[k:k + 3]
            head, frames = group[0][:4], [b[4:] for b in group]
            kind, mode = mode % 4, mode + 1
            k += len(group)
            if kind == 3:
                out += [[0xA0, [[0xA1, b], [0xFB, b"\xdf"]]] for b in group]
                continue
            if kind == 0:  # Xiph
                lace = b"".join(b"\xff" * (len(f) // 255) + bytes([len(f) % 255])
                                for f in frames[:-1])
            elif kind == 1:  # EBML: the first size, then signed differences
                lace = mkv._size(len(frames[0]))
                for a, b in zip(frames[:-2], frames[1:-1]):
                    d, n = len(b) - len(a), 1
                    while not -(2 ** (7 * n - 1) - 1) <= d <= 2 ** (7 * n - 1) - 2:
                        n += 1
                    lace += mkv._size(d + 2 ** (7 * n - 1) - 1, n)
            else:  # fixed
                size = max(map(len, frames))
                frames = [f + bytes(size - len(f)) for f in frames]
                lace = b""
            flag = (0x02, 0x06, 0x04)[kind]
            out.append([0xA3, head[:3] + bytes([head[3] | flag, len(frames) - 1]) + lace
                        + b"".join(frames)])
        cluster[:] = out
    return ebml_dump(tree)


def forge_audio_first(data: bytes, rng) -> bytes:
    """An audio track (PCM, number 1) before the video one (renumbered 2),
    a 160-byte audio block before each video block."""
    tree = ebml_strip(ebml_parse(data))
    segment = ebml_find(tree, SEGMENT)
    tracks = ebml_find(segment, TRACKS)
    for e in tracks[0][1]:
        if e[0] == 0xD7:
            e[1] = b"\x02"
    tracks.insert(0, [0xAE, [_uint(0xD7, 1), _uint(0x73C5, 7), _uint(0x83, 2),
                             [0x86, b"A_PCM/INT/LIT"],
                             [0xE1, [[0xB5, struct.pack(">d", 8000.0)], _uint(0x9F, 1),
                                     _uint(0x6264, 16)]]]])
    for eid, cluster in segment:
        if eid != CLUSTER:
            continue
        out = []
        for e in cluster:
            if e[0] == 0xA3:
                b = bytes(e[1])
                out.append([0xA3, b"\x81" + b[1:3] + b"\x80" +
                            rng.integers(0, 256, 160, np.uint8).tobytes()])
                e = [0xA3, b"\x82" + b[1:]]
            out.append(e)
        cluster[:] = out
    return ebml_dump(tree)


def forge_video_elements(data: bytes, elements) -> bytes:
    """The video track's Video element with `elements` ([id, bytes or
    children]) appended."""
    tree = ebml_strip(ebml_parse(data))
    ebml_find(tree, SEGMENT, TRACKS, 0xAE, 0xE0).extend(elements)
    return ebml_dump(tree)


_VPX = None


def _libvpx():
    """cv2's bundled libvpx (opencv_python.libs), loaded with ctypes."""
    global _VPX
    if _VPX is None:
        import ctypes
        import glob
        libs = os.path.join(os.path.dirname(os.path.dirname(cv2.__file__)), "opencv_python.libs")
        lib = ctypes.CDLL(glob.glob(os.path.join(libs, "libvpx-*.so*"))[0])
        vp = ctypes.c_void_p
        for codec in ("vp8_cx", "vp9_cx"):
            getattr(lib, f"vpx_codec_{codec}").restype = vp
        lib.vpx_codec_enc_config_default.argtypes = [vp, vp, ctypes.c_uint]
        lib.vpx_codec_enc_init_ver.argtypes = [vp, vp, vp, ctypes.c_long, ctypes.c_int]
        lib.vpx_codec_encode.argtypes = [vp, vp, ctypes.c_int64, ctypes.c_ulong, ctypes.c_long,
                                         ctypes.c_ulong]
        lib.vpx_codec_get_cx_data.argtypes = [vp, vp]
        lib.vpx_codec_get_cx_data.restype = vp
        lib.vpx_img_wrap.argtypes = [vp, ctypes.c_int, ctypes.c_uint, ctypes.c_uint,
                                     ctypes.c_uint, vp]
        lib.vpx_img_wrap.restype = vp
        lib.vpx_codec_control_.argtypes = [vp, ctypes.c_int, ctypes.c_int]
        lib.vpx_codec_destroy.argtypes = [vp]
        lib.vpx_codec_enc_config_set.argtypes = [vp, vp]
        _VPX = lib
    return _VPX


def _i420(bgr: np.ndarray) -> np.ndarray:
    """A BGR frame as I420 planes, one after the other (_yuv420's)."""
    return np.concatenate([p.reshape(-1) for p in _yuv420(bgr)])


def vp8_encode(frames, version: int = 0, partitions: int = 0, bitrate: int = 200,
               error_resilient: bool = False, realtime: bool = False, screen: bool = False,
               alt_ref: bool = False, kf_max_dist=None, sharpness=None) -> list:
    """VP8 frames (bytes) of BGR frames, coded by cv2's libvpx: `version`
    (g_profile) 0-3, 2**partitions token partitions, error-resilient,
    real-time (with `screen` content: cyclic refresh through segmentation),
    or two-pass with lag 16 and auto-alt-ref (hidden alt-ref frames)."""
    lib = _libvpx()
    if alt_ref:
        stats = _vp8_pass(lib, frames, 1, None, version, partitions, bitrate, error_resilient,
                          False, False, True, kf_max_dist, sharpness)
        return _vp8_pass(lib, frames, 2, b"".join(stats), version, partitions, bitrate,
                         error_resilient, False, False, True, kf_max_dist, sharpness)
    return _vp8_pass(lib, frames, 0, None, version, partitions, bitrate, error_resilient,
                     realtime, screen, False, kf_max_dist, sharpness)


def _vp8_pass(lib, frames, npass, stats, version, partitions, bitrate, error_resilient,
              realtime, screen, alt_ref, kf_max_dist, sharpness) -> list:
    import ctypes
    h, w = frames[0].shape[:2]
    # vpx_codec_enc_cfg_t as 32-bit words: the fields set here lead the
    # struct (g_profile 2, g_w 3, g_h 4, g_error_resilient 9, g_pass 10,
    # g_lag_in_frames 11, rc_end_usage 18, rc_twopass_stats_in at byte 80,
    # rc_target_bitrate 28, kf_max_dist 42)
    cfg = ctypes.create_string_buffer(4096)
    assert lib.vpx_codec_enc_config_default(lib.vpx_codec_vp8_cx(), cfg, 0) == 0
    words = (ctypes.c_uint32 * 64).from_buffer(cfg)
    assert (words[3], words[4], words[28]) == (320, 240, 256), "unexpected vpx_codec_enc_cfg_t"
    words[2], words[3], words[4], words[9], words[28] = version, w, h, int(error_resilient), bitrate
    if realtime:
        words[18] = 1  # VPX_CBR
    if kf_max_dist is not None:
        words[42] = kf_max_dist
    keep = None
    if alt_ref:
        words[10], words[11] = npass, 16
        if npass == 2:
            keep = ctypes.create_string_buffer(stats, len(stats))
            ctypes.c_void_p.from_buffer(cfg, 80).value = ctypes.addressof(keep)
            ctypes.c_size_t.from_buffer(cfg, 88).value = len(stats)
    ctx = ctypes.create_string_buffer(1024)
    for abi in range(64):  # VPX_ENCODER_ABI_VERSION of this build
        err = lib.vpx_codec_enc_init_ver(ctx, lib.vpx_codec_vp8_cx(), cfg, 0, abi)
        if err != 3:  # VPX_CODEC_ABI_MISMATCH
            break
    assert err == 0, f"vpx_codec_enc_init_ver: {err}"
    lib.vpx_codec_control_(ctx, 18, partitions)  # VP8E_SET_TOKEN_PARTITIONS
    if alt_ref:
        lib.vpx_codec_control_(ctx, 14, 1)  # VP8E_SET_ENABLEAUTOALTREF
    if screen:
        lib.vpx_codec_control_(ctx, 39, 1)  # VP8E_SET_SCREEN_CONTENT_MODE
    if sharpness is not None:
        lib.vpx_codec_control_(ctx, 16, sharpness)  # VP8E_SET_SHARPNESS
    deadline = 1 if realtime or not alt_ref else 0  # VPX_DL_REALTIME or best quality
    out, img = [], ctypes.create_string_buffer(256)

    def drain():
        it = ctypes.c_void_p(0)
        while True:
            pkt = lib.vpx_codec_get_cx_data(ctx, ctypes.byref(it))
            if not pkt:
                return
            kind = ctypes.c_int.from_address(pkt).value  # 0: a frame, 1: first-pass stats
            if kind == (1 if npass == 1 else 0):
                buf = ctypes.c_void_p.from_address(pkt + 8).value
                out.append(ctypes.string_at(buf, ctypes.c_size_t.from_address(pkt + 16).value))

    for i, f in enumerate(frames):
        planes = _i420(f)
        lib.vpx_img_wrap(img, 0x102, w, h, 1, planes.ctypes.data)  # VPX_IMG_FMT_I420
        assert lib.vpx_codec_encode(ctx, img, i, 1, 0, deadline) == 0
        drain()
    while True:  # flush the lagged frames
        n = len(out)
        lib.vpx_codec_encode(ctx, None, -1, 1, 0, deadline)
        drain()
        if len(out) == n:
            break
    lib.vpx_codec_destroy(ctx)
    return out


def vp8_webm(path: str, packets, w: int, h: int, fps: int = 30) -> None:
    """VP8 frames in a WebM file, muxed by the port's MkvMuxer."""
    with mkv.MkvMuxer(path, "V_VP8", w, h, fps, doc_type="webm") as mux:
        for p in packets:
            mux.write_frame(p, not p[0] & 1)


def make_matroska(out: str):
    """Write the Matroska / WebM fixtures; yields their names."""
    rng = np.random.default_rng(2027)

    def cv2_file(name, fourcc, frames):
        cv2_video(os.path.join(out, name), fourcc, frames)
        return name

    base = cv2_file("vp8_cv2_96x72.webm", "VP80", sliding(rng, 15, 72, 96))
    yield base
    yield cv2_file("vp8_cv2_94x70.mkv", "VP80", sliding(rng, 13, 71, 95, step=(-3.5, 2.5)))
    yield cv2_file("mjpg_cv2_64x48.mkv", "MJPG", sliding(rng, 5, 48, 64))
    yield cv2_file("mp4v_cv2_96x72.mkv", "mp4v", sliding(rng, 15, 72, 96))
    yield cv2_file("xvid_cv2_64x46.mkv", "XVID", sliding(rng, 13, 47, 64))
    for name, (h, w), n, kw in (
            ("vp8_odd_p8_95x71.webm", (71, 95), 12, dict(partitions=3, bitrate=300)),
            ("vp8_altref_45x37.webm", (37, 45), 30, dict(alt_ref=True, partitions=1,
                                                         bitrate=100)),
            ("vp8_errres_seg_64x48.webm", (48, 64), 16, dict(error_resilient=True,
                                                             realtime=True, screen=True)),
            ("vp8_v1_33x17.webm", (17, 33), 10, dict(version=1, kf_max_dist=6)),
            ("vp8_v2_40x24.webm", (24, 40), 10, dict(version=2, sharpness=5)),
            ("vp8_v3_31x29.webm", (29, 31), 10, dict(version=3, partitions=2))):
        frames = sliding(rng, n, h, w, step=(float(rng.uniform(-4, 4)), float(rng.uniform(-4, 4))))
        vp8_webm(os.path.join(out, name), vp8_encode(frames, **kw), w, h)
        yield name
    with open(os.path.join(out, base), "rb") as f:
        data = f.read()
    forged = {
        "vp8_unknown_size_96x72.webm": forge_unknown_sizes(data),
        "vp8_laced_96x72.webm": forge_laced(data),
        "vp8_audio_first_96x72.webm": forge_audio_first(data, rng),
        "vp8_colour_crop_96x72.webm": forge_video_elements(data, [
            [0x55B0, [_uint(0x55B1, 1), _uint(0x55B9, 2), _uint(0x55B7, 1), _uint(0x55B8, 2)]],
            _uint(0x54BB, 2), _uint(0x54CC, 3)]),
    }
    for name, blob in forged.items():
        with open(os.path.join(out, name), "wb") as f:
            f.write(blob)
        yield name
    # the smoke's clip: translation_video(5, 1080, 1920, step=2.0, seed=0)[:3]
    clip = (translation_video(3, 1080, 1920, step=2.0, seed=0) * 255 + 0.5).astype(np.uint8)
    yield cv2_file(SMOKE_WEBM, "VP80", [np.ascontiguousarray(f[..., ::-1]) for f in clip])


SMOKE_WEBM = "vp8_cv2_1080x1920.webm"


# --- VP9 ---------------------------------------------------------------------

# libvpx's encoder controls (vp8cx.h's vp8e_enc_control_id)
VP9_CONTROLS = dict(cpu_used=13, auto_alt_ref=14, lossless=32, tile_columns=33, tile_rows=34,
                    frame_parallel=35, aq_mode=36, color_space=46, color_range=51)
# vpx_img_fmt and chroma subsampling (x, y) of each sampling (the 16-bit
# formats add VPX_IMG_FMT_HIGHBITDEPTH, 0x800)
VP9_FORMATS = {"420": (0x102, 1, 1), "422": (0x105, 1, 0), "444": (0x106, 0, 0),
               "440": (0x107, 0, 1)}
VPX_CODEC_USE_HIGHBITDEPTH = 0x40000


def _yuv_planes(bgr: np.ndarray, fmt: str) -> np.ndarray:
    """A BGR frame as the planes of a sampling: I420 as _i420, the others
    from cv2's BGR2YUV with the chroma averaged down."""
    if fmt == "420":
        return _i420(bgr)
    _, sx, sy = VP9_FORMATS[fmt]
    h, w = bgr.shape[:2]
    yuv = cv2.cvtColor(bgr, cv2.COLOR_BGR2YUV)
    size = ((w + sx) >> sx, (h + sy) >> sy)
    chroma = [cv2.resize(np.ascontiguousarray(yuv[..., c]), size, interpolation=cv2.INTER_AREA)
              if sx or sy else yuv[..., c] for c in (1, 2)]
    return np.concatenate([yuv[..., 0].reshape(-1)] + [c.reshape(-1) for c in chroma])


def _yuv_planes16(bgr: np.ndarray, fmt: str, bit_depth: int, seed: int) -> np.ndarray:
    """A BGR frame as 16-bit planes of `bit_depth` bits, laid out as
    vpx_img_wrap reads them with stride_align 2 (rows of even length, chroma
    rows half that when subsampled): a uint8 frame through cv2's BGR2YUV,
    each sample shifted up and its new low bits seeded noise; a float one
    (in [0, 1]) through BT.601's limited-range matrix at full precision.
    The chroma is averaged down."""
    rng = np.random.default_rng(seed)
    _, sx, sy = VP9_FORMATS[fmt]
    h, w = bgr.shape[:2]
    if bgr.dtype == np.uint8:
        yuv = cv2.cvtColor(bgr, cv2.COLOR_BGR2YUV).astype(np.float32)
    else:
        b, g, r = (bgr[..., c].astype(np.float64) for c in range(3))
        y = 0.299 * r + 0.587 * g + 0.114 * b
        yuv = np.stack([16 + 219 * y, 128 + 224 * 0.564 * (b - y),
                        128 + 224 * 0.713 * (r - y)], -1).astype(np.float32)
    sw = (w + 1) & ~1
    rows = []
    for c in range(3):
        p = yuv[..., c]
        stride = sw
        if c and (sx or sy):
            p = cv2.resize(p, ((w + sx) >> sx, (h + sy) >> sy), interpolation=cv2.INTER_AREA)
            stride = sw >> sx
        if bgr.dtype == np.uint8:
            p = (np.rint(p).astype(np.int32) << (bit_depth - 8)) + rng.integers(
                0, 1 << (bit_depth - 8), p.shape)
        else:
            p = np.clip(np.rint(p * (1 << (bit_depth - 8))), 0, (1 << bit_depth) - 1)
        plane = np.zeros((p.shape[0], stride), np.uint16)
        plane[:, :p.shape[1]] = p
        rows.append(plane.reshape(-1))
    return np.concatenate(rows)


def vp9_encode(frames, fmt: str = "420", bitrate: int = 200, two_pass: bool = False,
               lag: int = 0, error_resilient: bool = False, realtime: bool = True,
               cbr: bool = False, kf_max_dist=None, resize_at=None, bit_depth: int = 8,
               **controls) -> list:
    """VP9 packets of BGR frames, coded by cv2's libvpx through ctypes:
    profile 0 (4:2:0) or 1 (`fmt` 444, 422, 440), or at `bit_depth` 10 or
    12 profile 2 or 3 (VPX_CODEC_USE_HIGHBITDEPTH, 16-bit planes from
    _yuv_planes16), two-pass with `lag` frames of look-ahead (auto-alt-ref:
    hidden frames in superframes), error-resilient, CBR, the VP9_CONTROLS
    given as keywords (frame_parallel 0 turns the backward adaptation on),
    and `resize_at` (frame index, (width, height)): the frames from there
    coded at another size, which the encoder predicts across by reference
    scaling."""
    lib = _libvpx()
    args = (fmt, bitrate, lag, error_resilient, cbr, kf_max_dist, resize_at, bit_depth, controls)
    if two_pass:
        stats = _vp9_pass(lib, frames, 1, None, False, *args)
        return _vp9_pass(lib, frames, 2, b"".join(stats), False, *args)
    return _vp9_pass(lib, frames, 0, None, realtime, *args)


def _vp9_pass(lib, frames, npass, stats, realtime, fmt, bitrate, lag, error_resilient, cbr,
              kf_max_dist, resize_at, bit_depth, controls) -> list:
    import ctypes
    h, w = frames[0].shape[:2]
    cfg = ctypes.create_string_buffer(4096)
    assert lib.vpx_codec_enc_config_default(lib.vpx_codec_vp9_cx(), cfg, 0) == 0
    words = (ctypes.c_uint32 * 64).from_buffer(cfg)
    words[2], words[3], words[4] = int(fmt != "420") + (2 if bit_depth > 8 else 0), w, h
    words[5] = words[6] = bit_depth  # g_bit_depth, g_input_bit_depth
    words[9], words[11], words[28] = int(error_resilient), lag, bitrate
    if cbr:
        words[18] = 1  # VPX_CBR
    if kf_max_dist is not None:
        words[42] = kf_max_dist
    keep = None
    if npass:
        words[10] = npass
        if npass == 2:
            keep = ctypes.create_string_buffer(stats, len(stats))
            ctypes.c_void_p.from_buffer(cfg, 80).value = ctypes.addressof(keep)
            ctypes.c_size_t.from_buffer(cfg, 88).value = len(stats)
    ctx = ctypes.create_string_buffer(1024)
    flags = VPX_CODEC_USE_HIGHBITDEPTH if bit_depth > 8 else 0
    for abi in range(64):  # VPX_ENCODER_ABI_VERSION of this build
        err = lib.vpx_codec_enc_init_ver(ctx, lib.vpx_codec_vp9_cx(), cfg, flags, abi)
        if err != 3:  # VPX_CODEC_ABI_MISMATCH
            break
    assert err == 0, f"vpx_codec_enc_init_ver: {err}"
    if lag:
        controls = dict(controls, auto_alt_ref=1)
    for name, value in controls.items():
        assert lib.vpx_codec_control_(ctx, VP9_CONTROLS[name], int(value)) == 0, name
    deadline = 1 if realtime else 0  # VPX_DL_REALTIME or best quality
    out, img = [], ctypes.create_string_buffer(256)

    def drain():
        it = ctypes.c_void_p(0)
        while True:
            pkt = lib.vpx_codec_get_cx_data(ctx, ctypes.byref(it))
            if not pkt:
                return
            kind = ctypes.c_int.from_address(pkt).value  # 0: a frame, 1: first-pass stats
            if kind == (1 if npass == 1 else 0):
                buf = ctypes.c_void_p.from_address(pkt + 8).value
                out.append(ctypes.string_at(buf, ctypes.c_size_t.from_address(pkt + 16).value))

    for i, f in enumerate(frames):
        if resize_at is not None and i == resize_at[0]:
            words[3], words[4] = resize_at[1]
            assert lib.vpx_codec_enc_config_set(ctx, cfg) == 0
        fw, fh = words[3], words[4]
        if f.shape[:2] != (fh, fw):
            f = cv2.resize(f, (fw, fh), interpolation=cv2.INTER_AREA).astype(f.dtype)
        if bit_depth > 8:
            planes = _yuv_planes16(f, fmt, bit_depth, seed=i)
            lib.vpx_img_wrap(img, VP9_FORMATS[fmt][0] | 0x800, fw, fh, 2, planes.ctypes.data)
        else:
            planes = _yuv_planes(f, fmt)
            lib.vpx_img_wrap(img, VP9_FORMATS[fmt][0], fw, fh, 1, planes.ctypes.data)
        assert lib.vpx_codec_encode(ctx, img, i, 1, 0, deadline) == 0
        drain()
    while True:  # flush the lagged frames
        n = len(out)
        lib.vpx_codec_encode(ctx, None, -1, 1, 0, deadline)
        drain()
        if len(out) == n:
            break
    lib.vpx_codec_destroy(ctx)
    return out


def vp9_key(packet: bytes) -> bool:
    """Whether a VP9 packet starts with a key frame (profile 3 headers have
    a reserved bit before show_existing_frame)."""
    b = packet[0]
    shift = 1 if (b >> 4) & 3 == 3 else 0
    return (b >> 6) == 2 and not (b >> (3 - shift)) & 1 and not (b >> (2 - shift)) & 1


def vp9_webm(path: str, packets, w: int, h: int, fps: int = 30) -> None:
    """VP9 packets in a WebM file, muxed by the port's MkvMuxer."""
    with mkv.MkvMuxer(path, "V_VP9", w, h, fps, doc_type="webm") as mux:
        for p in packets:
            mux.write_frame(p, vp9_key(p))


def vp9_header_bits(frame: bytes) -> dict:
    """The bit offsets of a VP9 frame's (profile 0 or 1, not intra-only)
    loop filter sharpness and, in an inter frame with one filter for all
    blocks, the interpolation filter's 2-bit literal."""
    pos = [0]

    def bits(n):
        v = 0
        for _ in range(n):
            v = (v << 1) | ((frame[pos[0] >> 3] >> (7 - (pos[0] & 7))) & 1)
            pos[0] += 1
        return v

    assert bits(2) == 2
    profile = bits(1) | bits(1) << 1
    assert profile < 2 and not bits(1), "profile 0 or 1, no show_existing_frame"
    key, show, err = not bits(1), bits(1), bits(1)
    found = {}
    if key:
        bits(24)
        if bits(3) != 7:
            bits(1)
            if profile == 1:
                bits(3)
        bits(32)
        if bits(1):
            bits(32)
    else:
        assert show or not bits(1), "no intra-only frame"
        if not err:
            bits(2)
        bits(8 + 3 * 4)
        for _ in range(3):
            if bits(1):
                break
        else:
            bits(32)
        if bits(1):
            bits(32)
        bits(1)
        if not bits(1):
            found["interp"] = pos[0]
            bits(2)
    if not err:
        bits(2)
    bits(2 + 6)
    found["sharpness"] = pos[0]
    return found


def set_bits(frame: bytes, pos: int, n: int, value: int) -> bytes:
    """`frame` with its n bits at bit offset pos set to value (MSB first)."""
    out = bytearray(frame)
    for i in range(n):
        b, k = divmod(pos + i, 8)
        bit = (value >> (n - 1 - i)) & 1
        out[b] = (out[b] & ~(0x80 >> k)) | (bit << (7 - k))
    return bytes(out)


def forge_mp4_box(data: bytes, kind: bytes, patch) -> bytes:
    """`data` (an MP4 file) with the body of its first `kind` box passed
    through patch(bytearray) (same length)."""
    i = data.index(kind) + 4
    size = struct.unpack(">I", data[i - 8:i - 4])[0] - 8
    body = bytearray(data[i:i + size])
    patch(body)
    assert len(body) == size
    return data[:i] + bytes(body) + data[i + size:]


def make_vp9(out: str):
    """Write the VP9 fixtures; yields their names."""
    rng = np.random.default_rng(2028)

    def cv2_file(name, frames):
        cv2_video(os.path.join(out, name), "VP90", frames)
        return name

    def clip(name, frames, **kw):
        h, w = frames[0].shape[:2]
        vp9_webm(os.path.join(out, name), vp9_encode(frames, **kw), w, h)
        return name

    def scene(n, h, w):
        step = (float(rng.uniform(-4, 4)), float(rng.uniform(-4, 4)))
        return sliding(rng, n, h, w, step=step)

    # cv2.VideoWriter's VP90 in each container (odd sizes cropped to even)
    base = cv2_file("vp9_cv2_96x72.webm", sliding(rng, 15, 72, 96))
    yield base
    yield cv2_file("vp9_cv2_44x36.mkv", scene(12, 37, 45))
    mp4_base = cv2_file("vp9_cv2_96x72.mp4", sliding(rng, 10, 72, 96, step=(-2.5, 1.5)))
    yield mp4_base
    yield cv2_file("vp9_cv2_30x28.avi", scene(10, 29, 31))
    # libvpx through ctypes, in settings cv2's writer never takes
    yield clip("vp9_altref_45x37.webm", scene(24, 37, 45), two_pass=True, lag=16, bitrate=120,
               frame_parallel=0)
    yield clip("vp9_tilecols_520x40.webm", scene(3, 40, 520), bitrate=400, tile_columns=1,
               frame_parallel=0)
    yield clip("vp9_tilerows_48x200.webm", scene(3, 200, 48), bitrate=300, tile_columns=0,
               tile_rows=2, frame_parallel=0)
    yield clip("vp9_lossless_33x17.webm", scene(4, 17, 33), lossless=1)
    for aq, (h, w) in ((1, (35, 47)), (2, (40, 56)), (3, (48, 64))):
        yield clip(f"vp9_aq{aq}_{w}x{h}.webm", scene(12, h, w), bitrate=60, aq_mode=aq,
                   frame_parallel=0, cbr=aq == 3, cpu_used=6 if aq == 3 else 4)
    yield clip("vp9_errres_40x24.webm", scene(10, 24, 40), bitrate=80, error_resilient=True,
               kf_max_dist=6)
    for cpu, (h, w) in ((0, (31, 29)), (5, (26, 50)), (8, (33, 41))):
        yield clip(f"vp9_cpu{cpu}_{w}x{h}.webm", scene(8, h, w), bitrate=90, cpu_used=cpu,
                   frame_parallel=0)
    for fmt, (h, w) in (("444", (37, 45)), ("422", (31, 46)), ("440", (38, 29))):
        yield clip(f"vp9_p1_{fmt}_{w}x{h}.webm", scene(8, h, w), fmt=fmt, bitrate=150,
                   frame_parallel=0)
    yield clip("vp9_bt709_full_47x35.webm", scene(6, 35, 47), color_space=2, color_range=1)
    yield clip("vp9_bt2020_40x30.webm", scene(6, 30, 40), color_space=5)
    yield clip("vp9_smpte240_444_23x19.webm", scene(6, 19, 23), fmt="444", color_space=4)
    # forged: loop filter sharpness 5 in every inter frame, the bilinear
    # filter in a clip whose inter frames have one filter each, a 1-byte
    # show_existing_frame packet showing a reference again, a Colour
    # element on a VP9 track, an MP4 whose vpcC says BT.709 at full range
    frames = scene(8, 40, 48)
    packets = vp9_encode(frames, bitrate=70, frame_parallel=0)
    sharp = [p if vp9_key(p) else set_bits(p, vp9_header_bits(p)["sharpness"], 3, 5)
             for p in packets]
    vp9_webm(os.path.join(out, "vp9_sharpness5_48x40.webm"), sharp, 48, 40)
    yield "vp9_sharpness5_48x40.webm"
    packets = vp9_encode(scene(8, 36, 44), bitrate=70, cpu_used=8)
    bilinear = [p if vp9_key(p) or "interp" not in vp9_header_bits(p)
                else set_bits(p, vp9_header_bits(p)["interp"], 2, 3) for p in packets]
    assert bilinear != packets
    vp9_webm(os.path.join(out, "vp9_bilinear_44x36.webm"), bilinear, 44, 36)
    yield "vp9_bilinear_44x36.webm"
    packets = vp9_encode(scene(10, 30, 42), bitrate=80, kf_max_dist=30)
    shown = packets[:4] + [b"\x88"] + packets[4:7] + [b"\x8f", b"\x88"] + packets[7:]
    vp9_webm(os.path.join(out, "vp9_show_existing_42x30.webm"), shown, 42, 30)
    yield "vp9_show_existing_42x30.webm"
    with open(os.path.join(out, base), "rb") as f:
        data = f.read()
    with open(os.path.join(out, "vp9_colour_96x72.webm"), "wb") as f:
        f.write(forge_video_elements(data, [[0x55B0, [_uint(0x55B1, 1), _uint(0x55B9, 2),
                                                      _uint(0x55BB, 1), _uint(0x55BA, 1)]]]))
    yield "vp9_colour_96x72.webm"
    with open(os.path.join(out, mp4_base), "rb") as f:
        data = f.read()

    def vpcc_709_full(body):
        body[6] |= 1  # videoFullRangeFlag
        body[7:10] = bytes([1, 1, 1])  # BT.709 primaries, transfer, matrix

    with open(os.path.join(out, "vp9_vpcc_96x72.mp4"), "wb") as f:
        f.write(forge_mp4_box(data, b"vpcC", vpcc_709_full))
    yield "vp9_vpcc_96x72.mp4"
    # the smoke's clip: translation_video(5, 1080, 1920, step=2.0, seed=0)[:3]
    # (SMOKE_WEBM's frames are translation_video(3, ...)'s, which differ)
    smoke = (translation_video(5, 1080, 1920, step=2.0, seed=0)[:3] * 255 + 0.5).astype(np.uint8)
    yield cv2_file(SMOKE_VP9, [np.ascontiguousarray(f[..., ::-1]) for f in smoke])


SMOKE_VP9 = "vp9_cv2_1080x1920.webm"
SMOKE_VP9_10BIT = "vp9_hbd10_1080x1920.webm"


def ivf_file(path: str, packets, w: int, h: int, fourcc: bytes = b"VP90", fps: int = 30) -> None:
    """Packets in an IVF file (32-byte header; a 12-byte header a frame)."""
    with open(path, "wb") as f:
        f.write(struct.pack("<4sHH4sHHIIII", b"DKIF", 0, 32, fourcc, w, h, fps, 1, len(packets), 0))
        for i, p in enumerate(packets):
            f.write(struct.pack("<IQ", len(p), i) + p)


class PacketAvi(avi.MjpgWriter):
    """An AVI of coded packets under a FourCC (the port's AVI writer, its
    frames given as bytes), its strf's biBitCount `bit_count` and biHeight
    negated when `top_down`."""

    def __init__(self, path, width: int, height: int, fourcc: bytes, fps: float = 30,
                 bit_count: int = 24, top_down: bool = False):
        self.fourcc, self.bit_count, self.top_down = fourcc, bit_count, top_down
        super().__init__(path, width, height, fps)

    def _headers(self) -> bytes:
        head = bytearray(super()._headers())
        at = head.index(b"strf") + 8
        struct.pack_into("<Ii", head, at + 4, self.width, -self.height if self.top_down
                         else self.height)
        struct.pack_into("<H", head, at + 14, self.bit_count)
        return bytes(head)

    def write_packet(self, data: bytes, key: bool) -> None:
        self._chunk(data, avi.AVIIF_KEYFRAME if key else 0)


def mp4_with_packets(template: bytes, packets, keys, size=None) -> bytes:
    """An MP4 file `template` (cv2's, of as many samples) with its samples
    replaced by `packets`, one chunk after the moov: stsz, stsc, stco and
    stss rewritten, every other box kept (the sample entry too, its width
    and height set to `size`, (w, h), when given)."""
    top = {kind: (at, size) for kind, at, size in _mp4_boxes(template, 0, len(template))}
    n = len(packets)

    def rebuild(data, start, end, chunk_at):
        out = b""
        for kind, at, length in _mp4_boxes(data, start, end):
            body = data[at + 8:at + length]
            if kind in (b"moov", b"trak", b"mdia", b"minf", b"stbl"):
                body = rebuild(data, at + 8, at + length, chunk_at)
            elif kind == b"stsz":
                body = struct.pack(f">4xII{n}I", 0, n, *map(len, packets))
            elif kind == b"stsc":
                body = struct.pack(">4xIIII", 1, 1, n, 1)
            elif kind == b"stco":
                body = struct.pack(">4xII", 1, chunk_at)
            elif kind == b"stss":
                k = [i + 1 for i, key in enumerate(keys) if key]
                body = struct.pack(f">4xI{len(k)}I", len(k), *k)
            elif kind == b"stsd" and size is not None:  # the first entry's width, height
                body = body[:40] + struct.pack(">HH", *size) + body[44:]
            out += struct.pack(">I4s", 8 + len(body), kind) + body
        return out

    at, length = top[b"ftyp"]
    head = template[at:at + length]
    at, length = top[b"moov"]
    moov = rebuild(template, at, at + length, 0)
    chunk_at = len(head) + len(moov) + 8
    moov = rebuild(template, at, at + length, chunk_at)
    assert len(head) + len(moov) + 8 == chunk_at
    mdat = struct.pack(">I4s", 8 + sum(map(len, packets)), b"mdat")
    return head + moov + mdat + b"".join(packets)


def _mp4_boxes(data: bytes, start: int, end: int):
    pos = start
    while pos + 8 <= end:
        size, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, pos, size
        pos += size


def make_vp9_highbd(out: str):
    """Write the VP9 profile 2 and 3 fixtures (10 and 12 bits, each
    sampling, odd and even sides, the coding tools and colour facts, every
    container); yields their names."""
    rng = np.random.default_rng(2032)

    def scene(n, h, w):
        step = (float(rng.uniform(-4, 4)), float(rng.uniform(-4, 4)))
        return sliding(rng, n, h, w, step=step)

    def clip(name, frames, bd, **kw):
        h, w = frames[0].shape[:2]
        path = os.path.join(out, name)
        packets = vp9_encode(frames, bit_depth=bd, **kw)
        if name.endswith(".ivf"):
            ivf_file(path, packets, w, h)
        elif name.endswith(".avi"):
            with PacketAvi(path, w, h, b"VP90") as mux:
                for p in packets:
                    mux.write_packet(p, vp9_key(p))
        elif name.endswith(".mp4"):
            cv2_video(path, "VP90", frames[:len(packets)])
            with open(path, "rb") as f:
                template = f.read()
            with open(path, "wb") as f:
                f.write(mp4_with_packets(template, packets, [vp9_key(p) for p in packets]))
        else:
            with mkv.MkvMuxer(path, "V_VP9", w, h, 30,
                              doc_type="webm" if name.endswith(".webm") else "matroska") as mux:
                for p in packets:
                    mux.write_frame(p, vp9_key(p))
        return name

    # each sampling at 10 and 12 bits, the four parities of the sides
    for bd, cases in ((10, (("420", 48, 64), ("422", 37, 45), ("444", 31, 40), ("440", 38, 29))),
                      (12, (("420", 37, 45), ("422", 31, 46), ("444", 18, 33), ("440", 40, 48)))):
        for fmt, h, w in cases:
            yield clip(f"vp9_hbd{bd}_{fmt}_{w}x{h}.webm", scene(6, h, w), bd, fmt=fmt,
                       bitrate=150, frame_parallel=0)
    yield clip("vp9_hbd10_lossless_33x17.webm", scene(4, 17, 33), 10, lossless=1)
    yield clip("vp9_hbd12_lossless_444_23x19.webm", scene(3, 19, 23), 12, fmt="444", lossless=1)
    yield clip("vp9_hbd10_altref_45x37.webm", scene(16, 37, 45), 10, two_pass=True, lag=8,
               bitrate=120, frame_parallel=0)
    yield clip("vp9_hbd12_errres_40x24.webm", scene(8, 24, 40), 12, bitrate=80,
               error_resilient=True, kf_max_dist=4)
    yield clip("vp9_hbd10_tilecols_520x40.webm", scene(3, 40, 520), 10, bitrate=400,
               tile_columns=1, frame_parallel=0)
    yield clip("vp9_hbd10_bt709_full_47x35.webm", scene(5, 35, 47), 10, color_space=2,
               color_range=1)
    yield clip("vp9_hbd12_bt2020_422_30x26.webm", scene(5, 26, 30), 12, fmt="422", color_space=5)
    # the other containers: Matroska, MP4 (cv2's vpcC says 8 bits; cv2
    # reads the stream's own header), AVI (VP90) and IVF
    yield clip("vp9_hbd10_44x36.mkv", scene(6, 36, 44), 10, bitrate=100)
    yield clip("vp9_hbd12_444_64x48.mp4", scene(6, 48, 64), 12, fmt="444", bitrate=150)
    yield clip("vp9_hbd10_30x28.avi", scene(6, 28, 30), 10, bitrate=100)
    yield clip("ivf_vp9_hbd12_440_36x44.ivf", scene(6, 44, 36), 12, fmt="440", bitrate=100)
    # the smoke's clip at 10 bits: translation_video(5, 1080, 1920, step=2.0,
    # seed=0)[:3] at full precision
    smoke = translation_video(5, 1080, 1920, step=2.0, seed=0)[:3]
    yield clip(SMOKE_VP9_10BIT, [np.ascontiguousarray(f[..., ::-1]) for f in smoke], 10,
               bitrate=20000, cpu_used=8)


# --- MPEG-1 / MPEG-2 and the other containers --------------------------------

_AV = None


def _libavcodec():
    """cv2's bundled libavutil and libavcodec (opencv_python.libs), loaded
    with ctypes: (avutil, avcodec)."""
    global _AV
    if _AV is None:
        import ctypes
        import glob
        libs = os.path.join(os.path.dirname(os.path.dirname(cv2.__file__)), "opencv_python.libs")
        util, codec = (ctypes.CDLL(glob.glob(os.path.join(libs, f"lib{n}-*.so*"))[0],
                                   mode=ctypes.RTLD_GLOBAL) for n in ("avutil", "avcodec"))
        vp, i = ctypes.c_void_p, ctypes.c_int
        for lib, fn, args, res in (
                (codec, "avcodec_find_encoder_by_name", [ctypes.c_char_p], vp),
                (codec, "avcodec_alloc_context3", [vp], vp),
                (codec, "avcodec_open2", [vp, vp, vp], i),
                (codec, "avcodec_send_frame", [vp, vp], i),
                (codec, "avcodec_receive_packet", [vp, vp], i),
                (codec, "av_packet_alloc", [], vp), (codec, "av_packet_unref", [vp], None),
                (codec, "avcodec_free_context", [vp], None),
                (util, "av_frame_alloc", [], vp), (util, "av_frame_free", [vp], None),
                (util, "av_frame_get_buffer", [vp, i], i),
                (util, "av_opt_set", [vp, ctypes.c_char_p, ctypes.c_char_p, i], i),
                (util, "av_opt_find", [vp, ctypes.c_char_p, ctypes.c_char_p, i, i], vp),
                (util, "av_malloc", [ctypes.c_size_t], vp)):
            f = getattr(lib, fn)
            f.argtypes, f.restype = args, res
        _AV = util, codec
    return _AV


def _frame_pts_offset(util) -> int:
    """AVFrame.pts's offset: the first int64 after `format` that
    av_frame_alloc sets to AV_NOPTS_VALUE."""
    import ctypes
    frame = util.av_frame_alloc()
    words = (ctypes.c_int64 * 24).from_address(frame)
    at = next(8 * k for k in range(15, 24) if words[k] == -(1 << 63))
    util.av_frame_free(ctypes.byref(ctypes.c_void_p(frame)))
    return at


def mpeg12_encode(planes, w: int, h: int, codec: str = "mpeg2video", fps: int = 25,
                  options=None, matrices=None):
    """The packets (decode order) of yuv420p frames (Y, U, V uint8 planes),
    coded by cv2's libavcodec through ctypes with AVOptions set by name
    (`options`: "bf", "flags", "intra_vlc", "dc", ...) and custom intra /
    inter matrices (natural order; AVCodecContext's intra_matrix and
    inter_matrix pointers, found 24 and 16 bytes before the "dc" option's
    field)."""
    import ctypes
    util, av = _libavcodec()
    ctx = av.avcodec_alloc_context3(av.avcodec_find_encoder_by_name(codec.encode()))

    def opt(key, value):
        if util.av_opt_set(ctx, key.encode(), str(value).encode(), 1) < 0:
            raise ValueError(f"{codec}: option {key}={value} refused")

    opt("video_size", f"{w}x{h}")
    opt("pixel_format", "yuv420p")
    opt("time_base", f"1/{fps}")
    for key, value in (options or {}).items():
        opt(key, value)
    if matrices:
        dc = ctypes.c_int.from_address(util.av_opt_find(ctx, b"dc", None, 0, 0) + 16).value
        for k, name in enumerate(("intra", "inter")):
            if name in matrices:
                buf = util.av_malloc(128)
                (ctypes.c_uint16 * 64).from_address(buf)[:] = [int(v) for v in matrices[name]]
                ctypes.c_void_p.from_address(ctx + dc - 24 + 8 * k).value = buf
    if av.avcodec_open2(ctx, None, None) != 0:
        raise ValueError(f"{codec}: the encoder does not open with {options}")
    pts_at = _frame_pts_offset(util)
    pkt, out = av.av_packet_alloc(), []

    def drain():
        while av.avcodec_receive_packet(ctx, pkt) == 0:
            data = ctypes.c_void_p.from_address(pkt + 24).value
            out.append(ctypes.string_at(data, ctypes.c_int.from_address(pkt + 32).value))
            av.av_packet_unref(pkt)

    for i, frame_planes in enumerate(planes):
        frame = util.av_frame_alloc()
        for at, v in ((104, w), (108, h), (116, 0)):  # width, height, AV_PIX_FMT_YUV420P
            ctypes.c_int.from_address(frame + at).value = v
        util.av_frame_get_buffer(frame, 0)
        for k, plane in enumerate(frame_planes):
            data = ctypes.c_void_p.from_address(frame + 8 * k).value
            stride = ctypes.c_int.from_address(frame + 64 + 4 * k).value
            for r in range(plane.shape[0]):
                ctypes.memmove(data + r * stride, np.ascontiguousarray(plane[r]).ctypes.data,
                               plane.shape[1])
        ctypes.c_int64.from_address(frame + pts_at).value = i
        av.avcodec_send_frame(ctx, frame)
        util.av_frame_free(ctypes.byref(ctypes.c_void_p(frame)))
        drain()
    av.avcodec_send_frame(ctx, None)
    drain()
    av.avcodec_free_context(ctypes.byref(ctypes.c_void_p(ctx)))
    return out


def yuv_scene(rng, n: int, h: int, w: int, step=(2.5, -1.5), combed: bool = False):
    """n yuv420p frames (Y, U, V) of a textured scene sliding by `step`; with
    `combed`, each frame's odd lines from half a frame later (what field DCT
    and field motion code well)."""
    frames = sliding(rng, 2 * n if combed else n, h, w, step=step)
    out = []
    for i in range(n):
        f = frames[2 * i] if combed else frames[i]
        if combed:
            f = f.copy()
            f[1::2] = frames[2 * i + 1][1::2]
        ch, cw = (h + 1) // 2, (w + 1) // 2
        u = cv2.resize(f[..., 1], (cw, ch), interpolation=cv2.INTER_AREA)
        v = cv2.resize(f[..., 2], (cw, ch), interpolation=cv2.INTER_AREA)
        out.append((np.ascontiguousarray(f[..., 0]), u, v))
    return out


def forge_progressive(es: bytes) -> bytes:
    """An MPEG-2 stream with every picture coding extension's
    progressive_frame (and chroma_420_type) set: cv2's conversion refuses a
    frame FFmpeg marks interlaced, and the decoding does not depend on the
    flag, so field DCT and field motion can be pinned so."""
    out = bytearray(es)
    i = out.find(b"\0\0\1\xb5")
    while i >= 0:
        if out[i + 4] >> 4 == 8:
            out[i + 7] |= 1
            out[i + 8] |= 0x80
        i = out.find(b"\0\0\1\xb5", i + 4)
    return bytes(out)


def forge_quant_matrix_extension(es: bytes, matrices) -> bytes:
    """An MPEG-2 stream with a quant matrix extension after each picture
    coding extension: four optional matrices (intra, inter, chroma intra,
    chroma inter; natural order, written in zigzag order)."""
    zigzag = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48,
              41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15,
              23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]
    bits = "0011"
    for m in matrices:
        bits += "0" if m is None else "1" + "".join(f"{int(m[z]):08b}" for z in zigzag)
    bits += "0" * (-len(bits) % 8)
    ext = b"\0\0\1\xb5" + int(bits, 2).to_bytes(len(bits) // 8, "big")
    out, i = bytearray(), 0
    while True:
        j = es.find(b"\0\0\1\xb5", i)
        if j < 0:
            return bytes(out + es[i:])
        k = es.find(b"\0\0\1", j + 4)
        out += es[i:k]
        if es[j + 4] >> 4 == 8:
            out += ext
        i = k


def make_mpeg12(out: str):
    """Write the MPEG-1 / MPEG-2 fixtures; yields their names."""
    rng = np.random.default_rng(2029)

    def cv2_file(name, fourcc, frames):
        cv2_video(os.path.join(out, name), fourcc, frames, fps=25)
        return name

    def scene(n, h, w):
        return sliding(rng, n, h, w, step=(float(rng.uniform(-4, 4)), float(rng.uniform(-4, 4))))

    # cv2.VideoWriter's MPG2 (B pictures: OpenCV sets max_b_frames 2) and PIM1
    # (I and P pictures; FFmpeg refuses 10 fps) in every container it writes
    yield cv2_file("mpeg2_cv2_96x72.mpg", "MPG2", sliding(rng, 15, 72, 96))
    yield cv2_file("mpeg2_cv2_96x72.vob", "MPG2", scene(12, 72, 96))
    yield cv2_file("mpeg2_cv2_94x70.ts", "MPG2", scene(13, 71, 95))
    yield cv2_file("mpeg2_cv2_96x72.m2ts", "MPG2", scene(12, 72, 96))
    yield cv2_file("mpeg2_cv2_44x36.m2v", "MPG2", scene(14, 37, 45))
    for ext in ("avi", "mkv", "mp4", "mov"):
        yield cv2_file(f"mpeg2_cv2_96x72.{ext}", "MPG2", scene(12, 72, 96))
    yield cv2_file("mpeg1_cv2_96x72.mpg", "PIM1", scene(14, 72, 96))
    yield cv2_file("mpeg1_cv2_44x36.m1v", "PIM1", scene(12, 37, 45))
    for ext in ("ts", "avi", "mkv", "mov"):
        yield cv2_file(f"mpeg1_cv2_96x72.{ext}", "PIM1", scene(12, 72, 96))

    # cv2's libavcodec through ctypes, in settings cv2's writer never takes
    def clip(name, planes, w, h, codec="mpeg2video", forge=None, **kw):
        es = b"".join(mpeg12_encode(planes, w, h, codec, **kw))
        with open(os.path.join(out, name), "wb") as f:
            f.write(forge(es) if forge else es)
        return name

    yield clip("mpeg1_bf_45x37.m1v", yuv_scene(rng, 14, 37, 45), 45, 37, "mpeg1video",
               options={"bf": 2})
    yield clip("mpeg2_scan_vlc_q_96x72.m2v", yuv_scene(rng, 12, 72, 96), 96, 72,
               forge=forge_progressive,
               options={"bf": 2, "intra_vlc": 1, "alternate_scan": 1, "non_linear_quant": 1,
                        "qmax": 28, "dc": 1})
    yield clip("mpeg2_bt709_dc10_47x35.m2v", yuv_scene(rng, 12, 35, 47), 47, 35,
               options={"bf": 2, "dc": 2, "colorspace": "bt709", "color_primaries": "bt709",
                        "color_trc": "bt709"})
    intra = (np.arange(64) * 7) % 60 + 6
    intra[0] = 8
    yield clip("mpeg2_matrices_dc11_64x48.m2v", yuv_scene(rng, 12, 48, 64), 64, 48,
               options={"bf": 2, "dc": 3},
               matrices={"intra": intra, "inter": intra[::-1] + 4},
               forge=lambda es: forge_quant_matrix_extension(
                   es, (None, None, (intra * 2) % 90 + 5, np.full(64, 21))))
    yield clip("mpeg2_field_48x40.m2v", yuv_scene(rng, 12, 40, 48, step=(6.0, 3.0), combed=True),
               48, 40, forge=forge_progressive, options={"bf": 2, "flags": "+ildct+ilme"})
    yield clip("mpeg2_aq_95x71.m2v", yuv_scene(rng, 12, 71, 95), 95, 71,
               options={"bf": 2, "scplx_mask": 0.9})
    # a still scene 45 macroblocks wide: P pictures skip runs past 33 (the
    # address increment's escape)
    wide = yuv_scene(np.random.default_rng(2029), 1, 48, 720)
    yield clip("mpeg2_wide_720x48.m2v", wide * 6, 720, 48, options={"bf": 0})
    # the smoke's clip (translation_video(5, 1080, 1920)[:3], see make_vp9)
    smoke = (translation_video(5, 1080, 1920, step=2.0, seed=0)[:3] * 255 + 0.5).astype(np.uint8)
    yield cv2_file(SMOKE_MPEG2, "MPG2", [np.ascontiguousarray(f[..., ::-1]) for f in smoke])


SMOKE_MPEG2 = "mpeg2_cv2_1080x1920.ts"


def make_containers(out: str):
    """Write the fixtures of the containers the port reads for codecs it
    already decoded elsewhere; yields their names."""
    rng = np.random.default_rng(2030)
    for name, fourcc, (h, w), n in (("ivf_vp8_cv2_96x72.ivf", "VP80", (72, 96), 12),
                                    ("ivf_vp9_cv2_96x72.ivf", "VP90", (72, 96), 12),
                                    ("vp8_cv2_64x48.avi", "VP80", (48, 64), 10),
                                    ("mjpg_cv2_64x48.mov", "MJPG", (48, 64), 4),
                                    ("mjpg_cv2_64x48.mp4", "MJPG", (48, 64), 4),
                                    ("mp4v_cv2_96x72.ts", "mp4v", (72, 96), 13)):
        cv2_video(os.path.join(out, name), fourcc, sliding(rng, n, h, w), fps=25)
        yield name


def pixels(out: str, name: str, contract: str) -> np.ndarray:
    """The RGB pixels cv2 or PIL returns for a fixture under `contract`."""
    path = os.path.join(out, name)
    if contract == "read_jpeg":
        return np.asarray(Image.open(path).convert("RGB"))
    if contract == "imread":
        return cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1]
    cap = cv2.VideoCapture(path)
    # a sequence of GIFs: FFmpeg opens none, cv2 falls back to its own image backend
    assert cap.getBackendName() == ("CV_IMAGES" if name.endswith(".gif") and "%" in name
                                    else "FFMPEG")
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))  # as JAX: a BGRA frame's alpha dropped
    cap.release()
    return np.stack(frames)


def contract_of(name: str) -> str:
    if name.endswith(VIDEO_SUFFIXES) or name.startswith(("video_", "gif_clip_", "webp_video_",
                                                         "gif_seq/")):
        return "video"
    return "read_jpeg" if "_pil_" in name else "imread"


def pins(out: str, files) -> dict:
    table = {}
    for name in sorted(files):
        contract = contract_of(name)
        table[name] = (contract, hashlib.sha256(
            np.ascontiguousarray(pixels(out, name, contract)).tobytes()).hexdigest())
    return table


# --- stills: BMP, PNM, TIFF, CMYK / RGB JPEGs, PNG orientation ------------


def bmp_file(w: int, h: int, bpp: int, pixels: bytes, palette: bytes = b"", comp: int = 0,
             header: int = 40, masks=(), clrused: int = 0, after: bytes = b"") -> bytes:
    """A BMP file: `header` 40, 108 or 124 (Windows; the masks stored in it
    past 40 bytes) or 12 (OS/2: 16-bit sides, 3-byte palette entries);
    `after` goes between the header and the palette (BI_BITFIELDS masks)."""
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bpp)
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, h, 1, bpp, comp, len(pixels), 2835, 2835,
                           clrused, 0)
        info += struct.pack("<4I", *(list(masks) + [0] * 4)[:4]) if header > 40 else b""
        info += bytes(header - len(info))
    off = 14 + len(info) + len(after) + len(palette)
    return (b"BM" + struct.pack("<IHHI", off + len(pixels), 0, 0, off) + info + after + palette
            + pixels)


def bmp_rows(rows: np.ndarray) -> bytes:
    """(h, rowbytes) stored bottom-up, each row padded to 4 bytes."""
    pitch = (rows.shape[1] + 3) & -4
    out = np.zeros((rows.shape[0], pitch), np.uint8)
    out[:, : rows.shape[1]] = rows
    return out[::-1].tobytes()


def rle_encode(idx: np.ndarray, bits: int, rng) -> bytes:
    """BI_RLE8 / BI_RLE4 data for palette indices (h, w), bottom-up: each
    row split into encoded runs and absolute runs (odd lengths padded),
    with an occasional delta over pixels left to palette entry 0, then an
    end of line; RLE8 ends with end of bitmap right after the last row's
    end of line is left out, RLE4 (where end of bitmap only ends a line)
    with every end of line."""
    h, w = idx.shape
    out = bytearray()
    for y, row in enumerate(idx[::-1]):
        x = 0
        while x < w:
            if x and rng.random() < 0.08 and w - x > 4:
                dx = int(rng.integers(1, min(8, w - x - 1)))
                out += bytes([0, 2, dx, 0])  # skipped pixels take entry 0
                x += dx
                continue
            run = 1
            while x + run < w and run < 255 and row[x + run] == row[x]:
                run += 1
            if run >= 3 or w - x < 3:
                n = min(run, w - x)
                out += bytes([n, int(row[x]) if bits == 8 else int(row[x]) * 17])
                x += n
                continue
            n = int(min(w - x, rng.integers(3, 12)))
            vals = row[x : x + n].astype(np.uint8)
            if bits == 8:
                data = vals.tobytes() + bytes(n & 1)
            else:
                nib = np.zeros(n + (n & 1), np.uint8)
                nib[:n] = vals
                data = (nib[0::2] << 4 | nib[1::2]).tobytes()
                data += bytes(len(data) & 1)
            out += bytes([0, n]) + data
            x += n
        if bits == 8 and y == h - 1:
            break
        out += bytes([0, 0])
    return bytes(out + bytes([0, 1]))


def tiff_file(tags: dict, blocks, order: str = "<", tiled: bool = False) -> bytes:
    """A TIFF file of `tags` ({tag: (type, values)}) and its strips or tiles
    `blocks`, their offsets and byte counts filled in."""
    data, offsets, pos = b"", [], 8
    for b in blocks:
        offsets.append(pos)
        data += b
        pos += len(b)
    if pos & 1:
        data += b"\0"
        pos += 1
    tags = dict(tags)
    tags[324 if tiled else 273] = (4, offsets)
    tags[325 if tiled else 279] = (4, [len(b) for b in blocks])
    codes = {1: "B", 2: "B", 3: "H", 4: "I"}
    extra_at, extra, body = pos + 2 + 12 * len(tags) + 4, b"", b""
    for tag in sorted(tags):
        typ, values = tags[tag]
        raw = struct.pack(order + codes[typ] * len(values), *values)
        body += struct.pack(order + "HHI", tag, typ, len(values))
        if len(raw) <= 4:
            body += raw.ljust(4, b"\0")
        else:
            body += struct.pack(order + "I", extra_at + len(extra))
            extra += raw + bytes(len(raw) & 1)
    head = (b"II*\0" if order == "<" else b"MM\0*") + struct.pack(order + "I", pos)
    return head + data + struct.pack(order + "H", len(tags)) + body + bytes(4) + extra


def _pack_bits(v: np.ndarray, bits: int) -> np.ndarray:
    """(h, w) samples of `bits` bits -> (h, rowbytes), each row from the
    high bit."""
    b = (v[..., None] >> np.arange(bits - 1, -1, -1)) & 1
    return np.packbits(b.reshape(v.shape[0], -1).astype(np.uint8), axis=1)


def _png_exif(img: np.ndarray, orientation: int) -> bytes:
    ex = Image.Exif()
    ex[274] = orientation
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "PNG", exif=ex)
    return buf.getvalue()


def _pil(img, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


SMOKE_TIFF = "tiff_cv2_1080x1920.tif"


def make_stills(out: str):
    """Write the still-image fixtures (cv2's, PIL's and forged files, all
    64x64 or smaller but the smoke's 1080p TIFF); yields their names."""
    rng = np.random.default_rng(2031)

    def put(name, data):
        os.makedirs(os.path.dirname(os.path.join(out, name)), exist_ok=True)
        with open(os.path.join(out, name), "wb") as f:
            f.write(data)
        return name

    def tex(h, w, c=3):
        return _texture(rng, h, w, c) if c > 1 else _texture(rng, h, w, 1)[..., 0]

    a = tex(37, 53)
    yield put("bmp_cv2_24_37x53.bmp", cv2.imencode(".bmp", a)[1].tobytes())
    yield put("bmp_cv2_grey_37x53.bmp", cv2.imencode(".bmp", a[..., 0])[1].tobytes())
    yield put("bmp_1bit_37x53.bmp", _pil(Image.fromarray(a).convert("1"), "BMP"))
    yield put("bmp_8bit_29x31.bmp", _pil(Image.fromarray(tex(29, 31)).convert("P"), "BMP"))
    yield put("bmp_32_29x31.bmp", _pil(Image.fromarray(tex(29, 31, 4), "RGBA"), "BMP"))
    idx = rng.integers(0, 16, (29, 31))
    pal = rng.integers(0, 256, (12, 4), np.uint8).tobytes()  # 12 entries: 12-15 read black
    yield put("bmp_4bit_29x31.bmp", bmp_file(31, 29, 4, bmp_rows(_pack_bits(idx, 4)), pal,
                                             clrused=12))
    p16 = rng.integers(0, 65536, (29, 31)).astype("<u2")
    rows16 = bmp_rows(p16.view(np.uint8).reshape(29, -1))
    yield put("bmp_555_29x31.bmp", bmp_file(31, 29, 16, rows16))
    yield put("bmp_565_29x31.bmp", bmp_file(31, 29, 16, rows16, comp=3,
                                            after=struct.pack("<3I", 0xF800, 0x7E0, 0x1F)))
    px32 = rng.integers(0, 256, (29, 31, 4), np.uint8)
    yield put("bmp_v5_bitfields_29x31.bmp",
              bmp_file(31, 29, 32, bmp_rows(px32.reshape(29, -1)), comp=3, header=124,
                       masks=(0xFF00, 0xFF0000, 0xFF000000, 0xFF)))
    b = tex(29, 31)
    yield put("bmp_v5_24_29x31.bmp", bmp_file(31, 29, 24, bmp_rows(b.reshape(29, -1)),
                                              header=124, masks=(0, 0, 0, 0)))
    yield put("bmp_topdown_29x31.bmp",  # a negative height: rows stored top-down
              bmp_file(31, -29, 24, np.pad(b.reshape(29, -1), ((0, 0), (0, 3))).tobytes()))
    pal3 = rng.integers(0, 256, (256, 3), np.uint8).tobytes()
    yield put("bmp_os2_8bit_29x31.bmp",
              bmp_file(31, 29, 8, bmp_rows(rng.integers(0, 256, (29, 31), np.uint8)), pal3,
                       header=12))
    yield put("bmp_os2_24_29x31.bmp", bmp_file(31, 29, 24, bmp_rows(b.reshape(29, -1)),
                                               header=12))
    blocks = np.kron(rng.integers(0, 16, (6, 8)), np.ones((5, 5), np.int64))[:30, :40]
    blocks[::7, 3:9] = rng.integers(0, 16, (5, 6))  # absolute runs among the encoded ones
    for bits in (8, 4):
        pal = rng.integers(0, 256, (1 << bits, 4), np.uint8).tobytes()
        yield put(f"bmp_rle{bits}_40x30.bmp",
                  bmp_file(40, 30, bits, rle_encode(blocks, bits, rng), pal,
                           comp=1 if bits == 8 else 2))

    g = tex(17, 23, 1)
    c = tex(17, 23)
    yield put("pnm_p1_23x17.pbm", b"P1\n# a comment\n23 17\n" + "".join(
        str(v) for v in rng.integers(0, 2, 23 * 17)).encode() + b"\n")
    yield put("pnm_p2_23x17.pgm", b"P2\n23 17\n200\n" + " ".join(
        str(v) for v in rng.integers(0, 230, 23 * 17)).encode() + b"\n")
    yield put("pnm_p2_16bit_23x17.pgm", b"P2\n23 17\n4000\n" + "\n".join(
        str(v) for v in rng.integers(0, 4000, 23 * 17)).encode() + b"\n")
    yield put("pnm_p3_23x17.ppm", b"P3 23 17\n#max\n255\n" + " ".join(
        str(v) for v in c.reshape(-1)).encode() + b" \n")
    yield put("pnm_p4_23x17.pbm", _pil(Image.fromarray(g).convert("1"), "PPM"))
    yield put("pnm_cv2_p5_37x53.pgm", cv2.imencode(".pgm", a[..., 1])[1].tobytes())
    yield put("pnm_cv2_p6_37x53.ppm", cv2.imencode(".ppm", a)[1].tobytes())
    yield put("pnm_p5_16bit_23x17.pgm", b"P5\n23 17\n65535\n"
              + rng.integers(0, 65536, 23 * 17).astype(">u2").tobytes())
    yield put("pnm_p6_max100_23x17.ppm", b"P6\n23 17\n100\n" + rng.integers(
        0, 101, 23 * 17 * 3).astype(np.uint8).tobytes())

    yield put("tiff_cv2_lzw_37x53.tif", cv2.imencode(".tif", a)[1].tobytes())
    yield put("tiff_cv2_grey_37x53.tif", cv2.imencode(".tif", a[..., 2])[1].tobytes())
    t = Image.fromarray(tex(29, 31))
    for comp, tag in (("raw", "raw"), ("tiff_adobe_deflate", "deflate"),
                      ("packbits", "packbits"), ("tiff_lzw", "lzw")):
        yield put(f"tiff_{tag}_29x31.tif", _pil(t, "TIFF", compression=comp))
    yield put("tiff_1bit_29x31.tif", _pil(t.convert("1"), "TIFF", compression="packbits"))
    yield put("tiff_grey16_29x31.tif", _pil(Image.fromarray(
        rng.integers(0, 65536, (29, 31)).astype(np.uint16)), "TIFF", compression="tiff_lzw"))
    yield put("tiff_palette_29x31.tif", _pil(t.convert("P"), "TIFF", compression="tiff_lzw"))
    yield put("tiff_rgba_unassoc_29x31.tif", _pil(Image.fromarray(tex(29, 31, 4), "RGBA"),
                                                  "TIFF", compression="tiff_adobe_deflate"))
    yield put("tiff_cmyk_29x31.tif", _pil(t.convert("CMYK"), "TIFF", compression="tiff_lzw"))
    yield put("tiff_la_29x31.tif", _pil(t.convert("LA"), "TIFF", compression="packbits"))

    def base(w, h, bits, photometric, spp, more=()):
        tags = {256: (3, [w]), 257: (3, [h]), 258: (3, [bits] * spp), 259: (3, [1]),
                262: (3, [photometric]), 277: (3, [spp]), 278: (3, [h])}
        tags.update(dict(more))
        return tags

    v1 = rng.integers(0, 2, (29, 31))
    yield put("tiff_1bit_miniswhite_29x31.tif",
              tiff_file(base(31, 29, 1, 0, 1), [_pack_bits(v1, 1).tobytes()]))
    v4 = rng.integers(0, 16, (29, 31))
    yield put("tiff_miniswhite_29x31.tif",
              tiff_file(base(31, 29, 8, 0, 1, {278: (3, [10])}),
                        [tex(29, 31, 1)[y : y + 10].tobytes() for y in range(0, 29, 10)]))
    cmap = rng.integers(0, 65536, 48).tolist()  # 16-bit entries: their high bytes
    yield put("tiff_palette4_29x31.tif",
              tiff_file(base(31, 29, 4, 3, 1, {320: (3, cmap)}), [_pack_bits(v4, 4).tobytes()]))
    rgb16 = rng.integers(0, 65536, (29, 31, 3)).astype(np.int64)
    diff = rgb16.copy()
    diff[:, 1:] = (rgb16[:, 1:] - rgb16[:, :-1]) & 0xFFFF  # predictor 2
    yield put("tiff_rgb16_mm_29x31.tif",
              tiff_file(base(31, 29, 16, 2, 3, {259: (3, [8]), 317: (3, [2])}),
                        [zlib.compress(diff.astype(">u2").tobytes())], order=">"))
    planes = tex(29, 31)
    yield put("tiff_planar2_29x31.tif",
              tiff_file(base(31, 29, 8, 2, 3, {259: (3, [32946]), 284: (3, [2]),
                                                  278: (3, [16])}),
                        [zlib.compress(planes[y : y + 16, :, k].tobytes())
                         for k in range(3) for y in (0, 16)]))
    yield put("tiff_rgba_assoc_29x31.tif",
              tiff_file(base(31, 29, 8, 2, 4, {338: (3, [1])}), [tex(29, 31, 4).tobytes()]))
    tile = tex(40, 50)
    tiles = []
    for ty in range(0, 40, 32):
        for tx in range(0, 50, 32):
            blk = np.zeros((32, 32, 3), np.int64)
            part = tile[ty : ty + 32, tx : tx + 32]
            blk[: part.shape[0], : part.shape[1]] = part
            d = blk.copy()
            d[:, 1:] = (blk[:, 1:] - blk[:, :-1]) & 255
            tiles.append(zlib.compress(d.astype(np.uint8).tobytes()))
    tiled = base(50, 40, 8, 2, 3, {259: (3, [8]), 317: (3, [2]), 322: (3, [32]),
                                     323: (3, [32])})
    del tiled[278]
    yield put("tiff_tiled_50x40.tif", tiff_file(tiled, tiles, tiled=True))
    yield put("tiff_orient3_29x31.tif",
              tiff_file(base(31, 29, 8, 2, 3, {274: (3, [3])}), [tex(29, 31).tobytes()]))

    j = Image.fromarray(tex(29, 31))
    cmyk = _pil(j.convert("CMYK"), "JPEG", quality=85)
    yield put("jpeg_cmyk_29x31.jpg", cmyk)
    at = cmyk.find(b"\xff\xee")
    yield put("jpeg_cmyk_noadobe_29x31.jpg",
              cmyk[:at] + cmyk[at + 2 + int.from_bytes(cmyk[at + 2 : at + 4], "big"):])
    yield put("jpeg_rgb_29x31.jpg", _pil(j, "JPEG", quality=85, keep_rgb=True))
    yield put("jpeg_rgb_progressive_29x31.jpg", _pil(j, "JPEG", quality=75, keep_rgb=True,
                                                     progressive=True))

    e = tex(37, 53)
    yield put("png_exif6_37x53.png", _png_exif(e, 6))
    ex = Image.Exif()
    ex[274] = 6
    jpeg6 = _pil(Image.fromarray(e), "JPEG", quality=90, exif=ex)
    yield put("jpeg_exif6_37x53.jpg", jpeg6)
    yield put("video_jpeg_exif6_37x53.jpg", jpeg6)
    yield put("video_png_exif6_37x53.png", _png_exif(e, 6))
    yield put("video_png_rgb16_37x53.png", cv2.imencode(".png", rng.integers(
        0, 65536, (37, 53, 3)).astype(np.uint16))[1].tobytes())
    yield put("video_png_rgba16_37x53.png", cv2.imencode(".png", rng.integers(
        0, 65536, (37, 53, 4)).astype(np.uint16))[1].tobytes())
    yield put("video_png_grey16_37x53.png", cv2.imencode(".png", rng.integers(
        0, 65536, (37, 53)).astype(np.uint16))[1].tobytes())
    for mode in ("L", "P", "RGBA"):
        yield put(f"video_png_{mode.lower()}_37x53.png", _pil(Image.fromarray(e).convert(mode),
                                                               "PNG"))
    for i in range(2, 5):
        put(f"video_seq2/{i:03d}.png", cv2.imencode(".png", tex(24, 32))[1].tobytes())
        put(f"video_seq0/{i - 2:05d}.jpg", cv2.imencode(".jpg", tex(24, 32))[1].tobytes())
    yield "video_seq2/%03d.png"
    yield "video_seq0/%05d.jpg"
    # 1080p for cv2's many strips (one row each): seeded noise upsized 32x,
    # bilinear, 2.7 MB (the smoke clip's frames are pixel noise, 8.3 MB as
    # cv2's LZW TIFF)
    big = cv2.resize(rng.integers(0, 256, (34, 60, 3), np.uint8), (1920, 1080))
    yield put(SMOKE_TIFF, cv2.imencode(".tif", big)[1].tobytes())
    t = Image.fromarray(tex(29, 31))
    for mode in ("YCbCr", "RGB", "L", "CMYK", "LA"):  # libjpeg under libtiff's JPEG codec
        yield put(f"tiff_jpeg_{mode.lower()}_29x31.tif",
                  _pil(t.convert(mode), "TIFF", compression="jpeg", quality=80))
    yield put("tiff_jpeg_rgba_29x31.tif", _pil(Image.fromarray(tex(29, 31, 4), "RGBA"), "TIFF",
                                               compression="jpeg", quality=60))


# --- WebP and GIF ----------------------------------------------------------


def gif_lzw(idx, min_code: int, clear_when_full: bool = True) -> bytes:
    """GIF LZW of a flat index sequence; clear_when_full=False keeps coding
    at 12 bits with the full table frozen (a deferred clear)."""
    clear, end = 1 << min_code, (1 << min_code) + 1
    out, acc, nacc, size = bytearray(), 0, 0, min_code + 1

    def emit(code):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += size
        while nacc >= 8:
            out.append(acc & 255)
            acc >>= 8
            nacc -= 8

    table, nxt, w = {}, end + 1, None
    emit(clear)
    for k in (int(v) for v in idx):
        if w is None:
            w = (k,)
            continue
        if w + (k,) in table:
            w = w + (k,)
            continue
        emit(table[w] if len(w) > 1 else w[0])
        if nxt < 4096:
            table[w + (k,)] = nxt
            nxt += 1
            if nxt > (1 << size) and size < 12:
                size += 1
        elif clear_when_full:
            emit(clear)
            table, nxt, size = {}, end + 1, min_code + 1
        w = (k,)
    emit(table[w] if len(w) > 1 else w[0])
    emit(end)
    if nacc:
        out.append(acc & 255)
    return bytes(out)


def _table_bits(n: int) -> int:
    return max(1, int(np.ceil(np.log2(max(n, 2)))))


def gif_file(w: int, h: int, images, gpal=None, bg: int = 0, version: bytes = b"89a") -> bytes:
    """A GIF of `images`: dicts of idx (h, w) palette indices and optional x,
    y, lpal (a local table), trans (index), disposal, delay, interlace,
    min_code, clear_when_full and extensions (raw blocks put before the
    image)."""
    out = bytearray(b"GIF" + version + struct.pack("<HH", w, h))
    if gpal is not None:
        bits = _table_bits(len(gpal))
        table = np.zeros((1 << bits, 3), np.uint8)
        table[: len(gpal)] = gpal
        out += bytes([0x80 | 0x70 | (bits - 1), bg, 0]) + table.tobytes()
    else:
        out += bytes([0x70, bg, 0])
    for im in images:
        idx = np.asarray(im["idx"])
        ih, iw = idx.shape
        if version == b"89a" and any(k in im for k in ("trans", "disposal", "delay")):
            flags = (im.get("disposal", 0) << 2) | (1 if "trans" in im else 0)
            out += b"\x21\xf9\x04" + bytes([flags]) + struct.pack("<H", im.get("delay", 10)) + bytes(
                [im.get("trans", 0), 0])
        out += b"".join(im.get("extensions", ()))  # raw extension blocks, before the image
        flags, lpal = 0x40 if im.get("interlace") else 0, im.get("lpal")
        npal = len(lpal) if lpal is not None else len(gpal)
        if lpal is not None:
            bits = _table_bits(len(lpal))
            flags |= 0x80 | (bits - 1)
        out += b"," + struct.pack("<HHHHB", im.get("x", 0), im.get("y", 0), iw, ih, flags)
        if lpal is not None:
            table = np.zeros((1 << bits, 3), np.uint8)
            table[: len(lpal)] = lpal
            out += table.tobytes()
        if im.get("interlace"):
            idx = idx[np.concatenate([np.arange(a, ih, b) for a, b in ((0, 8), (4, 8), (2, 4),
                                                                      (1, 2))])]
        min_code = im.get("min_code", max(2, _table_bits(npal)))
        data = gif_lzw(idx.reshape(-1), min_code, im.get("clear_when_full", True))
        out += bytes([min_code])
        for i in range(0, len(data), 255):
            out += bytes([len(data[i : i + 255])]) + data[i : i + 255]
        out += b"\0"
    return bytes(out + b";")


def smooth_scene(t: int, h: int = 1080, w: int = 1920) -> np.ndarray:
    """A smooth RGB scene (gradients and soft blobs) at time t, the blobs
    moving right and down a few pixels a step."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([128 + 100 * np.sin(xx / 300 + t * 0.2 + yy / 500),
                    128 + 100 * np.cos(yy / 240 - t * 0.15),
                    128 + 90 * np.sin((xx + yy) / 410 + t * 0.1)], -1)
    for k in range(6):
        cx, cy = 300 + 250 * k + 12 * t, h / 2 + 200 * np.sin(k) + 5 * t
        blob = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * 90.0 ** 2))
        img += 60 * blob[..., None] * np.array([1, -0.5, 0.3 * k - 0.6], np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


SMOKE_WEBP = "webp_cv2_q90_1080x1920.webp"
SMOKE_GIF = "gif_clip_1080x1920.gif"


def make_webp_gif(out: str):
    """Write the WebP and GIF fixtures (cv2's, PIL's and this file's own
    GIF writer's; 64x64 or smaller but the smoke's two 1080p files); yields
    their names.  `gif_clip_`, `webp_video_` and the sequences are read as
    video, the others through imread."""
    rng = np.random.default_rng(2033)

    def put(name, data):
        os.makedirs(os.path.dirname(os.path.join(out, name)), exist_ok=True)
        with open(os.path.join(out, name), "wb") as f:
            f.write(data)
        return name

    def tex(h, w, c=3):
        return _texture(rng, h, w, c)

    def pil_webp(img, mode=None, **kw):
        return _pil(Image.fromarray(img, mode), "WEBP", **kw)

    a = tex(37, 53)
    rgba = tex(37, 53, 4)
    rgba[..., 3] = rng.integers(0, 256, (37, 53))
    rgba[:6, :9, 3] = 0
    yield put("webp_lossy_53x37.webp", cv2.imencode(".webp", a, [cv2.IMWRITE_WEBP_QUALITY, 80])[1]
              .tobytes())
    yield put("webp_lossy_q50_33x17.webp", pil_webp(tex(17, 33), quality=50))
    yield put("webp_lossy_alpha_53x37.webp", pil_webp(rgba, "RGBA", quality=80))
    ex = Image.Exif()
    ex[274] = 6
    yield put("webp_lossy_exif6_53x37.webp", pil_webp(a, quality=80, exif=ex))
    yield put("webp_cv2_lossless_53x37.webp", cv2.imencode(".webp", a)[1].tobytes())
    # libwebp's choices, read back by the tests: predictor and subtract-green
    # (method 0); the colour cache and cross-colour (method 3); meta prefix
    # codes (method 4, quality 100); backward references in all three
    smooth = cv2.GaussianBlur(rng.integers(0, 256, (96, 128, 3), np.uint8), (0, 0), 4)
    yield put("webp_lossless_m0_64x48.webp", pil_webp(np.ascontiguousarray(smooth[:48, :64]),
                                                      lossless=True, quality=0, method=0))
    yield put("webp_lossless_cache_128x96.webp", pil_webp(_texture(rng, 96, 128), lossless=True,
                                                          quality=50, method=3))
    mixed = smooth.copy()  # regions of unlike statistics: one prefix code group each
    mixed[:, 64:] = rng.integers(0, 256, (96, 64, 3), np.uint8) // 8 * 8
    mixed[48:, :64] = np.linspace(0, 255, 64).astype(np.uint8)[None, :, None]
    yield put("webp_lossless_meta_128x96.webp", pil_webp(mixed, lossless=True, quality=100,
                                                         method=4))
    yield put("webp_lossless_alpha_53x37.webp", pil_webp(rgba, "RGBA", lossless=True))
    yield put("webp_lossless_noise_29x31.webp", pil_webp(rng.integers(0, 256, (31, 29, 3),
                                                                     np.uint8), lossless=True))
    for n in (2, 4, 16, 256):
        pal = rng.integers(0, 256, (n, 3), np.uint8)
        yield put(f"webp_lossless_pal{n}_31x29.webp",
                  pil_webp(pal[rng.integers(0, n, (29, 31))], lossless=True))
    frames = [Image.fromarray(np.roll(a, 3 * i, 1)) for i in range(3)]
    for tag, kw in (("lossy", dict(quality=80)), ("lossless", dict(lossless=True))):
        yield put(f"webp_anim_{tag}_53x37.webp", _pil(frames[0], "WEBP", save_all=True,
                                                       append_images=frames[1:], duration=100,
                                                       loop=0, **kw))
    for name in ("webp_lossy_53x37.webp", "webp_lossy_alpha_53x37.webp",
                 "webp_lossy_exif6_53x37.webp", "webp_cv2_lossless_53x37.webp"):
        with open(os.path.join(out, name), "rb") as f:
            yield put("webp_video_" + name[5:], f.read())
    for i in range(3):
        put(f"webp_video_seq/{i:03d}.webp",
            pil_webp(tex(24, 32), **(dict(lossless=True) if i == 1 else dict(quality=75))))
    yield "webp_video_seq/%03d.webp"
    yield put(SMOKE_WEBP, cv2.imencode(".webp", smooth_scene(0)[..., ::-1],
                                       [cv2.IMWRITE_WEBP_QUALITY, 90])[1].tobytes())

    pal16 = rng.integers(0, 256, (16, 3), np.uint8)
    idx = rng.integers(0, 16, (37, 53))
    idx[:3, :7] = 5
    yield put("gif_87a_53x37.gif", gif_file(53, 37, [dict(idx=idx)], pal16, version=b"87a"))
    yield put("gif_quantized_53x37.gif", _pil(Image.fromarray(a).quantize(64), "GIF"))
    yield put("gif_local_53x37.gif", gif_file(53, 37, [dict(idx=idx, lpal=rng.integers(
        0, 256, (16, 3), np.uint8))], pal16, bg=3))
    yield put("gif_local_only_sub_53x37.gif", gif_file(53, 37, [dict(
        idx=idx[5:30, 4:40], x=4, y=5, lpal=rng.integers(0, 256, (16, 3), np.uint8))]))
    yield put("gif_sub_bg_53x37.gif", gif_file(53, 37, [dict(idx=idx[:20, :30], x=11, y=9)],
                                               pal16, bg=7))
    yield put("gif_interlaced_53x37.gif", gif_file(53, 37, [dict(idx=idx, interlace=True)], pal16))
    yield put("gif_transparent_53x37.gif", gif_file(53, 37, [dict(idx=idx, trans=5)], pal16, bg=2))
    pal32 = rng.integers(0, 256, (32, 3), np.uint8)
    yield put("gif_pal32_53x37.gif", gif_file(53, 37, [dict(idx=rng.integers(0, 32, (37, 53)))],
                                              pal32))
    yield put("gif_pal3_2bit_53x37.gif", gif_file(53, 37, [dict(idx=rng.integers(0, 3, (37, 53)))],
                                                  pal16[:3]))
    pal256 = rng.integers(0, 256, (256, 3), np.uint8)
    noise = rng.integers(0, 256, (64, 64))
    yield put("gif_full_table_64x64.gif", gif_file(64, 64, [dict(idx=noise)], pal256))
    yield put("gif_deferred_clear_64x64.gif", gif_file(64, 64, [dict(idx=noise,
                                                                    clear_when_full=False)], pal256))

    # clips, read as video: PIL's optimized sub-rectangles under each
    # disposal, and this writer's disposals, transparency and local tables
    moving = []
    for i in range(4):  # a patch moving over a still background: sub-rectangles
        m = a.copy()
        m[4 + 3 * i : 18 + 3 * i, 6 + 5 * i : 22 + 5 * i] = a[20:34, 30:46][::-1]
        moving.append(Image.fromarray(m))
    # one palette for all, so the unchanged pixels are equal and PIL crops
    moving = [moving[0].quantize(64)] + [m.quantize(palette=moving[0].quantize(64)) for m in moving[1:]]
    for d in range(4):
        yield put(f"gif_clip_pil_disposal{d}_53x37.gif", _pil(
            moving[0], "GIF", save_all=True, append_images=moving[1:], duration=[40, 80, 40, 120],
            loop=0, disposal=d, optimize=True))
    yield put("gif_clip_pil_transparent_53x37.gif", _pil(
        moving[0], "GIF", save_all=True, append_images=moving[1:], duration=60, loop=0,
        transparency=0, disposal=2))
    images = [dict(idx=idx, trans=5, disposal=1)]
    for k, (x, y, w, h) in enumerate(((3, 2, 20, 15), (10, 8, 30, 20), (0, 20, 53, 17),
                                      (25, 0, 28, 37), (5, 5, 12, 12))):
        im = dict(idx=rng.integers(0, 8 if k == 1 else 16, (h, w)), x=x, y=y, disposal=(k + 2) % 4,
                  delay=10 * (k + 1), interlace=k == 3)
        if k % 2 == 0:
            im["trans"] = int(rng.integers(0, 16))
        if k == 1:
            im["lpal"] = rng.integers(0, 256, (8, 3), np.uint8)
        images.append(im)
    yield put("gif_clip_disposals_53x37.gif", gif_file(53, 37, images, pal16, bg=9))
    yield put("gif_clip_local_only_53x37.gif", gif_file(53, 37, [
        dict(idx=idx[:20, :20], x=2, y=3, lpal=pal16, disposal=2),
        dict(idx=idx[10:30, 10:40], x=20, y=10, lpal=pal32[:16], trans=1)]))
    yield put("gif_clip_one_transparent_53x37.gif",
              gif_file(53, 37, [dict(idx=idx, trans=5)], pal16, bg=2))
    for i in range(3):
        put(f"gif_seq/{i:03d}.gif", gif_file(32, 24, [dict(idx=rng.integers(0, 16, (24, 32)),
                                                           trans=3)], pal16, bg=1))
    yield "gif_seq/%03d.gif"
    scenes = [Image.fromarray(smooth_scene(t)).quantize(256) for t in range(3)]
    yield put(SMOKE_GIF, _pil(scenes[0], "GIF", save_all=True, append_images=scenes[1:],
                              duration=40, loop=0))
    # FFmpeg's gif parser splits images off only after an extension block:
    # a GIF87a of 3 images is 1 frame; with a comment before the third
    # image only, 2 (the first and the third)
    small = [dict(idx=rng.integers(0, 16, (12, 16)), x=4 * i, y=3 * i) for i in range(3)]
    yield put("gif_clip_87a_three_images_32x24.gif", gif_file(32, 24, small, pal16,
                                                               version=b"87a"))
    small[2]["extensions"] = [b"\x21\xfe\x07comment\x00"]
    yield put("gif_clip_comment_third_32x24.gif", gif_file(32, 24, small, pal16))


def make_lossless_video(out: str):
    """Write the PNG and raw-frame AVI and MOV fixtures: cv2.VideoWriter's
    (even sides; GREY at a width not a multiple of 4, whose rows FFmpeg reads
    4-byte aligned) and forged ones at odd sides (PNG colour types and
    depths, raw frames, a top-down RGBA AVI); yields their names."""
    rng = np.random.default_rng(2033)

    def cv2_file(name, fourcc, h, w, n=3):
        cv2_video(os.path.join(out, name), fourcc, sliding(rng, n, h, w), fps=10)
        return name

    for name, fourcc, (h, w) in (("lossless_cv2_png_64x48.avi", "png ", (48, 64)),
                                 ("lossless_cv2_mpng_46x36.avi", "MPNG", (36, 46)),
                                 ("lossless_cv2_png_42x30.mov", "png ", (30, 42)),
                                 ("lossless_cv2_rgba_46x36.avi", "RGBA", (36, 46)),
                                 ("lossless_cv2_rgba_64x48.mov", "RGBA", (48, 64)),
                                 ("lossless_cv2_grey_46x36.avi", "GREY", (36, 46)),
                                 ("lossless_cv2_y800_64x48.avi", "Y800", (48, 64)),
                                 ("lossless_cv2_y8_42x30.avi", "Y8  ", (30, 42)),
                                 ("lossless_cv2_i420_46x36.avi", "I420", (36, 46)),
                                 ("lossless_cv2_iyuv_64x48.avi", "IYUV", (48, 64)),
                                 ("lossless_cv2_yv12_42x30.avi", "YV12", (30, 42))):
        yield cv2_file(name, fourcc, h, w)

    def png(a, mode=None):
        buf = io.BytesIO()
        Image.fromarray(a, mode).save(buf, "PNG")
        return buf.getvalue()

    def avi_file(name, fourcc, w, h, packets, bit_count=24, top_down=False):
        with PacketAvi(os.path.join(out, name), w, h, fourcc, 10, bit_count, top_down) as mux:
            for p in packets:
                mux.write_packet(p, True)
        return name

    h, w = 37, 45
    rgb = [f[..., ::-1] for f in sliding(rng, 2, h, w)]
    yield avi_file("lossless_png_rgb_45x37.avi", b"png ", w, h, [png(f) for f in rgb])
    yield avi_file("lossless_png_kinds_31x17.avi", b"MPNG", 31, 17, [
        png(rng.integers(0, 256, (17, 31), np.uint8)),
        png(rng.integers(0, 256, (17, 31, 4), np.uint8), "RGBA"),
        png(rng.integers(0, 65536, (17, 31)).astype(np.uint16)),
        _png_rgb16(rng.integers(0, 65536, (17, 31, 3)))])
    pal = Image.fromarray(rgb[0]).quantize(16)
    buf = io.BytesIO()
    pal.save(buf, "PNG")
    yuv = [np.concatenate([p.reshape(-1) for p in _yuv420(f)]) for f in sliding(rng, 2, h, w)]
    yield avi_file("lossless_i420_45x37.avi", b"I420", w, h, [y.tobytes() for y in yuv], 12)
    yield avi_file("lossless_grey_45x37.avi", b"GREY", w, h, [y.tobytes() for y in yuv], 12)
    yield avi_file("lossless_rgba_topdown_45x37.avi", b"RGBA", w, h, [
        np.concatenate([f, np.full((h, w, 1), 255, np.uint8)], -1).tobytes() for f in rgb], 32,
        top_down=True)
    # a MOV of PNG frames at an odd size (FFmpeg reads the size from each
    # IHDR) and one of raw RGBA frames whose sample entry says 45x37
    template = os.path.join(out, "lossless_png_pal_45x37.mov")
    cv2_video(template, "png ", sliding(rng, 2, 36, 44), fps=10)
    with open(template, "rb") as f:
        data = f.read()
    with open(template, "wb") as f:
        f.write(mp4_with_packets(data, [buf.getvalue(), png(rgb[1])], [True, True]))
    yield "lossless_png_pal_45x37.mov"
    template = os.path.join(out, "lossless_rgba_45x37.mov")
    cv2_video(template, "RGBA", sliding(rng, 2, 36, 44), fps=10)
    with open(template, "rb") as f:
        data = f.read()
    frames = [np.concatenate([f, np.full((h, w, 1), 255, np.uint8)], -1).tobytes() for f in rgb]
    with open(template, "wb") as f:
        f.write(mp4_with_packets(data, frames, [True, True], size=(w, h)))
    yield "lossless_rgba_45x37.mov"


# corrupted copies of two WebP fixtures that libwebp (cv2.imread) reads
# otherwise than FFmpeg's range decoder would: bytes duplicated inside the
# lossy file's VP8 chunk (its last partition runs on past the chunk into
# the file's tail, as cv2 hands libwebp the whole file), and bits flipped in
# the animation (its canvas grows past cv2's image size limit: no image)
WEBP_CORRUPT = (("corrupt_webp_dup140_53x37.webp", "webp_lossy_53x37.webp", (140, 154), ()),
                ("corrupt_webp_dup372_53x37.webp", "webp_lossy_53x37.webp", (372, 78), ()),
                ("corrupt_webp_dup407_53x37.webp", "webp_lossy_53x37.webp", (407, 47), ()),
                ("corrupt_webp_dup244_53x37.webp", "webp_lossy_53x37.webp", (244, 147), ()),
                ("corrupt_webp_canvas_53x37.webp", "webp_anim_lossy_53x37.webp", None,
                 ((26, 128), (115, 32), (606, 128), (910, 8), (1094, 32), (1525, 16),
                  (1560, 8), (1682, 16))))
# what cv2.imread reads of none of them (pinned as ValueError, not pixels)
WEBP_NO_IMAGE = ("corrupt_webp_canvas_53x37.webp",)


def make_webp_corrupt(out: str):
    """Write WEBP_CORRUPT from their sources in `out`; yields the names
    cv2.imread reads an image of."""
    for name, source, dup, flips in WEBP_CORRUPT:
        with open(os.path.join(out, source), "rb") as f:
            data = bytearray(f.read())
        if dup:
            at, n = dup
            data[at:at] = data[at:at + n]
        for at, mask in flips:
            data[at] ^= mask
        with open(os.path.join(out, name), "wb") as f:
            f.write(bytes(data))
        if name not in WEBP_NO_IMAGE:
            yield name


def _png_rgb16(samples: np.ndarray) -> bytes:
    """A 16-bit RGB PNG (filter 0) of (h, w, 3) samples."""
    h, w = samples.shape[:2]
    rows = samples.astype(">u2").reshape(h, w * 6 // 2).view(np.uint8).reshape(h, w * 6)
    raw = b"".join(b"\0" + r.tobytes() for r in rows)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))


def _yuv420(bgr: np.ndarray):
    """cv2's I420 planes of a BGR frame at any size (odd sides through the
    edge-repeated even frame, cropped): Y (h, w), U and V ((h+1)/2, (w+1)/2)."""
    h, w = bgr.shape[:2]
    big = cv2.copyMakeBorder(bgr, 0, h & 1, 0, w & 1, cv2.BORDER_REPLICATE)
    hh, ww = big.shape[:2]
    yuv = cv2.cvtColor(big, cv2.COLOR_BGR2YUV_I420).reshape(-1)
    q = (hh // 2) * (ww // 2)
    return (yuv[:hh * ww].reshape(hh, ww)[:h, :w],
            yuv[hh * ww:hh * ww + q].reshape(hh // 2, ww // 2),
            yuv[hh * ww + q:].reshape(hh // 2, ww // 2))


# --- the H.263 family: H.263, Sorenson Spark, MS-MPEG4 v2 / v3 ------------

SMOKE_MSMPEG4 = "msmpeg4_cv2_mp43_1080x1920.avi"
SMOKE_FLV = "flv1_cv2_smooth_1080x1920.flv"
SMOKE_H263 = "h263_cv2_352x288.avi"
# a corrupted copy of the 12-bit lossless 4:4:4 VP9 fixture (8 bits flipped:
# tools/video_robustness.py's seed 0, file 169 in its first version), whose
# inter frames are no longer lossless and carry coefficients past the 12-bit
# range: residuals past 16 bits, added as x86's 16-bpp transforms add them
# (ROADMAP Q3-11); (source, name, (byte, mask) flips)
VP9_Q3_11 = ("vp9_hbd12_lossless_444_23x19.webm", "corrupt_vp9_hbd12_lossless_444_23x19.webm",
             ((165, 4), (426, 2), (877, 1), (2082, 16), (2096, 32), (2819, 2), (3325, 128),
              (4337, 16)))


class Bitstream:
    """Bits of a packet as a list, for forging header fields."""

    def __init__(self, data: bytes):
        self.bits = [int(b) for b in "".join(f"{x:08b}" for x in data)]

    def get(self, at: int, n: int) -> int:
        return int("".join(map(str, self.bits[at:at + n])) or "0", 2)

    def set(self, at: int, n: int, value: int) -> None:
        self.bits[at:at + n] = [int(b) for b in f"{value:0{n}b}"]

    def bytes(self) -> bytes:
        return _bits_to_bytes(self.bits)


def flv_file(path: str, packets, keys, fps: int = 15) -> None:
    """Sorenson packets in an FLV file: the header, PreviousTagSize0, an
    onMetaData script tag and one video tag a packet (frame type 1 or 2,
    codec 2)."""
    def tag(kind: int, ms: int, body: bytes) -> bytes:
        head = bytes([kind]) + len(body).to_bytes(3, "big") + (ms & 0xFFFFFF).to_bytes(3, "big")
        return head + bytes([ms >> 24, 0, 0, 0]) + body + struct.pack(">I", len(body) + 11)

    meta = (b"\x02\x00\x0aonMetaData\x08\x00\x00\x00\x01\x00\x09framerate\x00"
            + struct.pack(">d", fps) + b"\x00\x00\x09")
    with open(path, "wb") as f:
        f.write(b"FLV\x01\x01" + struct.pack(">I", 9) + struct.pack(">I", 0))
        f.write(tag(18, 0, meta))
        for i, (p, key) in enumerate(zip(packets, keys)):
            f.write(tag(9, i * 1000 // fps, bytes([(1 if key else 2) << 4 | 2]) + p))


def h263_to_sorenson(packet: bytes, size_code: int = 0) -> bytes:
    """A baseline H.263 picture (no GOB headers, Annex F or PEI) as a
    Sorenson picture of format 0 (H.263's escape): the 50-bit picture
    header replaced by Sorenson's (sizes of 8 bits for size_code 0), the
    macroblocks kept."""
    b = Bitstream(packet)
    assert b.get(0, 22) == 0x20 and b.get(35, 3) in (1, 2, 3)
    tr, fmt, p_pic, quant = b.get(22, 8), b.get(35, 3), b.get(38, 1), b.get(43, 5)
    w, h = ((128, 96), (176, 144), (352, 288))[fmt - 1]
    head = f"{1:017b}{0:05b}{tr:08b}{size_code:03b}"
    if size_code == 0:
        head += f"{w:08b}{h:08b}"
    head += f"{p_pic:02b}0{quant:05b}0"
    return _bits_to_bytes([int(c) for c in head] + b.bits[50:])


def _bits_to_bytes(bits) -> bytes:
    bits = list(bits) + [0] * (-len(bits) % 8)
    return bytes(int("".join(map(str, bits[i:i + 8])), 2) for i in range(0, len(bits), 8))


def sorenson_forge(packet: bytes, kind=None, size=None) -> bytes:
    """A Sorenson picture with its picture type (2: disposable) or its 8-bit
    size fields rewritten."""
    b = Bitstream(packet)
    at = 17 + 5 + 8
    code = b.get(at, 3)
    at += 3
    if size is not None:
        assert code == 0
        b.set(at, 8, size[0])
        b.set(at + 8, 8, size[1])
    at += {0: 16, 1: 32}.get(code, 0)
    if kind is not None:
        b.set(at, 2, kind)
    return b.bytes()


def msmpeg4_forge(packet: bytes, slices=None, clear_flipflop=False, pad=0) -> bytes:
    """An MS-MPEG4 I picture with its slice code set to `slices` slices, its
    extension's flipflop_rounding cleared (the packet's last set bit, before
    the zero padding), or `pad` zero bytes appended (FFmpeg then ignores the
    extension)."""
    b = Bitstream(packet)
    assert b.get(0, 2) == 0
    if slices is not None:
        b.set(7, 5, 0x16 + slices)
    if clear_flipflop:
        last = max(i for i, v in enumerate(b.bits) if v)
        b.bits[last] = 0
    return b.bytes() + bytes(pad)


def make_h263(out: str):
    """Write the H.263-family fixtures: cv2.VideoWriter's H263 (AVI, 3GP,
    MOV), U263, FLV1 (FLV, AVI), MP42, MP43 and DIV3 (AVI), odd sides cropped
    to even; clips coded by cv2's libavcodec through ctypes in settings cv2's
    writer never takes (OBMC, 4MV, GOB headers, DQUANT, quantisers 1-31,
    Sorenson at 11-bit escapes); forged ones (Sorenson format 0 from H.263
    pictures, a disposable picture, sizes the picture headers or the AVI say
    45x37, MS-MPEG4 slices, flipflop_rounding off, an extension FFmpeg
    ignores, H.263's Annex D bit); mp4v AVIs with short-header (H.263)
    pictures; the corrupted 12-bit VP9 clip of VP9_Q3_11; and the smoke's
    three files.  Yields their names."""
    rng = np.random.default_rng(2500)

    def cv2_file(name, fourcc, h, w, n=4, step=(2.5, -1.5), fps=15):
        cv2_video(os.path.join(out, name), fourcc, sliding(rng, n, h, w, step=step), fps=fps)
        return name

    for name, fourcc, (h, w) in (("h263_cv2_176x144.avi", "H263", (144, 176)),
                                 ("h263_cv2_128x96.3gp", "H263", (96, 128)),
                                 ("h263_cv2_176x144.mov", "H263", (144, 176)),
                                 ("h263_cv2_u263_128x96.avi", "U263", (96, 128)),
                                 ("flv1_cv2_64x48.flv", "FLV1", (48, 64)),
                                 ("flv1_cv2_44x36.flv", "FLV1", (37, 45)),
                                 ("flv1_cv2_160x120.flv", "FLV1", (120, 160)),
                                 ("flv1_cv2_64x48.avi", "FLV1", (48, 64)),
                                 ("mp42_cv2_64x48.avi", "MP42", (48, 64)),
                                 ("mp42_cv2_44x36.avi", "MP42", (37, 45)),
                                 ("mp43_cv2_64x48.avi", "MP43", (48, 64)),
                                 ("mp43_cv2_44x36.avi", "MP43", (37, 45)),
                                 ("div3_cv2_80x64.avi", "DIV3", (64, 80))):
        yield cv2_file(name, fourcc, h, w, n=5 if fourcc in ("MP42", "MP43", "DIV3") else 4)
    # the smoke's 352x288 clip (its timed H.263 I and P pictures)
    yield cv2_file(SMOKE_H263, "H263", 288, 352, n=3)
    # a still scene (skipped macroblocks) that cuts to another (intra
    # macroblocks in P pictures), in each codec
    still = sliding(rng, 1, 48, 64, step=(0, 0)) * 3 + sliding(rng, 2, 48, 64, step=(9, 7))
    for name, fourcc in (("mp43_cv2_still_64x48.avi", "MP43"), ("mp42_cv2_still_64x48.avi", "MP42"),
                         ("flv1_cv2_still_64x48.flv", "FLV1")):
        cv2_video(os.path.join(out, name), fourcc, still, fps=15)
        yield name
    cv2_video(os.path.join(out, "h263_cv2_still_176x144.avi"), "H263",
              sliding(rng, 1, 144, 176, step=(0, 0)) * 3 + sliding(rng, 2, 144, 176, step=(9, 7)))
    yield "h263_cv2_still_176x144.avi"

    def packets_avi(name, fourcc, w, h, packets):
        with PacketAvi(os.path.join(out, name), w, h, fourcc, 15) as mux:
            for i, p in enumerate(packets):
                mux.write_packet(p, i == 0)
        return name

    # libavcodec's h263 encoder: Annex F (OBMC, 4MV), GOB headers, DQUANT,
    # the quantiser's range (1: 11-bit escaped levels)
    scene = yuv_scene(rng, 5, 144, 176, step=(3.5, -2.5))
    for name, options in (("h263_obmc_176x144.avi", {"obmc": 1}),
                          ("h263_mv4_176x144.avi", {"flags": "+mv4"}),
                          ("h263_obmc_mv4_q4_176x144.avi", {"obmc": 1, "flags": "+mv4",
                                                            "qmin": 4, "qmax": 4}),
                          ("h263_gob_q1_176x144.avi", {"ps": 300, "qmin": 1, "qmax": 1}),
                          ("h263_dquant_176x144.avi", {"scplx_mask": 0.5, "flags": "+mv4"}),
                          ("h263_q31_176x144.avi", {"qmin": 31, "qmax": 31})):
        yield packets_avi(name, b"H263", 176, 144,
                          mpeg12_encode(scene, 176, 144, "h263", options=options))
    cif = yuv_scene(rng, 3, 288, 352, step=(5.5, 2.5))
    yield packets_avi("h263_obmc_gob_352x288.avi", b"H263", 352, 288,
                      mpeg12_encode(cif, 352, 288, "h263", options={"obmc": 1, "ps": 500,
                                                                    "flags": "+mv4"}))
    # pixel noise at quantiser 1 (levels past 127: H.263's -128 escape)
    noise = [tuple(rng.integers(0, 256, (hh, ww), np.uint8) for hh, ww in
                   ((144, 176), (72, 88), (72, 88))) for _ in range(2)]
    yield packets_avi("h263_noise_q1_176x144.avi", b"H263", 176, 144,
                      mpeg12_encode(noise, 176, 144, "h263", options={"qmin": 1, "qmax": 1}))
    # PEI set, one PSPARE byte, in each picture's header
    spare = []
    for p in mpeg12_encode(scene[:3], 176, 144, "h263", options={"qmin": 6, "qmax": 6}):
        b = Bitstream(p)
        b.bits[49:49] = [1, 1, 0, 1, 0, 0, 1, 0, 1]
        spare.append(b.bytes())
    yield packets_avi("h263_pei_176x144.avi", b"H263", 176, 144, spare)
    # Annex D's bit set on the pictures of a clip (vectors decoded without
    # the modulo wrap)
    plain = mpeg12_encode(scene, 176, 144, "h263", options={"qmin": 3, "qmax": 3})
    annex_d = []
    for p in plain:
        b = Bitstream(p)
        b.set(39, 1, 1)
        annex_d.append(b.bytes())
    yield packets_avi("h263_annexd_176x144.avi", b"H263", 176, 144, annex_d)
    # 3GP and MOV of libavcodec's pictures (samples replaced in cv2's files)
    for name, template in (("h263_obmc_176x144.3gp", "h263_cv2_128x96.3gp"),):
        with open(os.path.join(out, template), "rb") as f:
            data = f.read()
        obmc = mpeg12_encode(yuv_scene(rng, 4, 144, 176), 176, 144, "h263",
                             options={"obmc": 1, "flags": "+mv4"})
        with open(os.path.join(out, name), "wb") as f:
            f.write(mp4_with_packets(data, obmc, [True] + [False] * 3, size=(176, 144)))
        yield name

    # Sorenson: libavcodec's flv encoder (format 1) at quantisers 1 and 31;
    # format 0 (H.263's escape, -128 announcing 11 bits) from H.263 pictures
    # at quantiser 1; a disposable picture; a header saying 45x37
    small = yuv_scene(rng, 4, 48, 64, step=(3.5, 2.5))
    for name, q in (("flv1_q1_64x48.flv", 1), ("flv1_q31_64x48.flv", 31)):
        pk = mpeg12_encode(small, 64, 48, "flv", options={"qmin": q, "qmax": q})
        flv_file(os.path.join(out, name), pk, [True] + [False] * (len(pk) - 1))
        yield name
    h263_q1 = mpeg12_encode(scene[:4], 176, 144, "h263", options={"qmin": 1, "qmax": 1})
    fmt0 = [h263_to_sorenson(p, 0 if i % 2 else 3) for i, p in enumerate(h263_q1)]
    flv_file(os.path.join(out, "flv1_format0_176x144.flv"), fmt0, [True, False, False, False])
    yield "flv1_format0_176x144.flv"
    # disposable pictures: the second (FFmpeg skips it: no last picture yet)
    # and the fourth (shown; the fifth predicts from the third)
    pk = mpeg12_encode(yuv_scene(rng, 5, 48, 64, step=(3.5, 2.5)), 64, 48, "flv",
                       options={"qmin": 3, "qmax": 3})
    pk[1], pk[3] = sorenson_forge(pk[1], kind=2), sorenson_forge(pk[3], kind=2)
    flv_file(os.path.join(out, "flv1_disposable_64x48.flv"), pk, [True] + [False] * (len(pk) - 1))
    yield "flv1_disposable_64x48.flv"
    odd = mpeg12_encode(yuv_scene(rng, 3, 36, 44), 44, 36, "flv", options={"qmin": 4, "qmax": 4})
    flv_file(os.path.join(out, "flv1_45x37.flv"), [sorenson_forge(p, size=(45, 37)) for p in odd],
             [True, False, False])
    yield "flv1_45x37.flv"

    # MS-MPEG4: quantisers, slices (forged slice codes; FFmpeg's encoder
    # writes one), flipflop_rounding off, an extension FFmpeg ignores, a
    # size the AVI says is 45x37
    clip = yuv_scene(rng, 5, 48, 64, step=(3.5, 2.5))
    for version, codec, tag in ((2, "msmpeg4v2", b"MP42"), (3, "msmpeg4", b"MP43")):
        for q in (1, 8, 31):
            yield packets_avi(f"msmpeg4v{version}_q{q}_64x48.avi", tag, 64, 48,
                              mpeg12_encode(clip, 64, 48, codec, options={"qmin": q, "qmax": q}))
        pk = mpeg12_encode(clip, 64, 48, codec, options={"qmin": 5, "qmax": 5, "g": 2})
        yield packets_avi(f"msmpeg4v{version}_slices_64x48.avi", tag, 64, 48, [
            msmpeg4_forge(p, slices=(2, 3)[i // 2 % 2]) if i % 2 == 0 else p
            for i, p in enumerate(pk)])
    # 8x8 blocks of black and white (DC differences past v3's escape)
    blocks = []
    for _ in range(3):
        y = np.kron(rng.integers(0, 2, (6, 8)), np.ones((8, 8))).astype(np.uint8) * 255
        c = np.kron(rng.integers(0, 2, (3, 4)), np.ones((8, 8))).astype(np.uint8) * 255
        blocks.append((y, c, 255 - c))
    for version, codec, tag in ((2, "msmpeg4v2", b"MP42"), (3, "msmpeg4", b"MP43")):
        yield packets_avi(f"msmpeg4v{version}_blocks_q2_64x48.avi", tag, 64, 48,
                          mpeg12_encode(blocks, 64, 48, codec, options={"qmin": 2, "qmax": 2}))
    # a black and white pattern moving a pixel right, down or both a frame:
    # chroma at half-pel (x86's inexact unrounded averages where a 0 takes
    # the decremented operand), no_rounding alternating
    big = np.kron(rng.integers(0, 2, (20, 24)), np.ones((4, 4))).astype(np.uint8) * 255
    moving, at = [], np.array([4, 4])
    for step in ((0, 0), (0, 1), (1, 0), (1, 1), (0, 1), (1, 0), (1, 1)):
        at += step
        y = big[at[0]:at[0] + 48, at[1]:at[1] + 64]
        moving.append((y, y[::2, ::2], 255 - y[::2, ::2]))
    yield packets_avi("msmpeg4v3_moving_blocks_64x48.avi", b"MP43", 64, 48,
                      mpeg12_encode(moving, 64, 48, "msmpeg4", options={"qmin": 3, "qmax": 3}))
    pk = mpeg12_encode(clip, 64, 48, "msmpeg4", options={"qmin": 4, "qmax": 4, "g": 3})
    yield packets_avi("msmpeg4v3_noflipflop_64x48.avi", b"MP43", 64, 48, [
        msmpeg4_forge(p, clear_flipflop=True) if i == 0 else (
            msmpeg4_forge(p, pad=3) if i == 3 else p) for i, p in enumerate(pk)])
    pk = mpeg12_encode(yuv_scene(rng, 3, 36, 44), 44, 36, "msmpeg4", options={"qmin": 6, "qmax": 6})
    yield packets_avi("msmpeg4v3_45x37.avi", b"DIV3", 45, 37, pk)
    # what FFmpeg's encoder never writes: DC table 0, MV table 0 and its
    # escape, AC prediction (a stream of this file's own writer)
    yield packets_avi("msmpeg4v3_tables0_acpred_64x48.avi", b"MP43", 64, 48,
                      msmpeg4v3_synthetic(rng, 64, 48, 4))

    # mp4v with short-header (H.263) pictures: FFmpeg's mpeg4 decoder fails
    # each, and cv2 reads no further (no frames; the VOPs before them)
    h263 = mpeg12_encode(scene[:3], 176, 144, "h263", options={"qmin": 4, "qmax": 4})
    cv2_video(os.path.join(out, "mp4v_shortheader_176x144.avi"), "FMP4",
              sliding(rng, 2, 144, 176))
    mp4v = list(avi.iter_frames(avi.open_video(os.path.join(out, "mp4v_shortheader_176x144.avi"))))
    yield packets_avi("mp4v_shortheader_176x144.avi", b"FMP4", 176, 144, mp4v + h263)
    vol = mp4v[0][:mp4v[0].index(b"\0\0\1\xb6")]
    packets_avi("mp4v_shortheader_only_176x144.avi", b"FMP4", 176, 144, [vol + h263[0]] + h263[1:])

    source, name, flips = VP9_Q3_11
    with open(os.path.join(out, source), "rb") as f:
        data = bytearray(f.read())
    for at, mask in flips:
        data[at] ^= mask
    with open(os.path.join(out, name), "wb") as f:
        f.write(bytes(data))
    yield name

    # the smoke's 1080p files: the video clip's first three frames as cv2's
    # MP43 AVI, and the smooth scene's (as the GIF's) as cv2's FLV1 FLV
    smoke = translation_video(5, 1080, 1920, step=2.0, seed=0)[:3]
    cv2_video(os.path.join(out, SMOKE_MSMPEG4), "MP43",
              [np.ascontiguousarray((f[..., ::-1] * 255).astype(np.uint8)) for f in smoke], fps=30)
    yield SMOKE_MSMPEG4
    cv2_video(os.path.join(out, SMOKE_FLV), "FLV1",
              [np.ascontiguousarray(smooth_scene(t)[..., ::-1]) for t in range(3)], fps=15)
    yield SMOKE_FLV


def msmpeg4_tables() -> dict:
    """native/msmpeg4.cpp's code tables by name (read from its source):
    {name: list of ints}, code tables flattened (code, length, ...)."""
    import re
    src = open(os.path.join(ROOT, "fmvfi_tpu_torch", "native", "msmpeg4.cpp")).read()
    out = {}
    for m in re.finditer(r"const (?:Code32|Code|uint8_t|uint16_t) (k\w+)\[\d+\] = \{(.*?)\};", src,
                         re.S):
        out[m.group(1)] = [int(v) for v in re.findall(r"-?\d+", m.group(2))]
    return out


class BitWriter:
    def __init__(self):
        self.bits = []

    def put(self, value: int, n: int) -> None:
        self.bits += [int(b) for b in f"{value:0{n}b}"] if n else []

    def code(self, table, index: int) -> None:
        self.put(table[2 * index], table[2 * index + 1])

    def bytes(self) -> bytes:
        return _bits_to_bytes(self.bits)


def msmpeg4v3_synthetic(rng, w: int, h: int, n: int, q: int = 6) -> list:
    """An MS-MPEG4 v3 stream in what FFmpeg's encoder never writes: DC table
    0, run/level tables 0 and 3 (chroma), MV table 0 with its escape, AC
    prediction; an I picture of intra macroblocks (random coded-block
    patterns, small DC steps, a few escape-3 coefficients a coded block),
    then P pictures of inter macroblocks with random vectors (no residual)
    and a few intra ones.  Codes from native/msmpeg4.cpp's tables (cv2,
    decoding the result, is the judge)."""
    t = msmpeg4_tables()
    mbw, mbh = (w + 15) // 16, (h + 15) // 16
    mv_lens = t["kMv0Len"]
    acc, mv_codes = 0, []
    for ln in mv_lens:  # codes from their lengths, in code order
        mv_codes += [acc >> (32 - ln), ln]
        acc += 1 << (32 - ln)
    esc = {0: (t["kRl0Vlc"][2 * 132], t["kRl0Vlc"][2 * 132 + 1]),
           3: (t["kRl3Vlc"][2 * 148], t["kRl3Vlc"][2 * 148 + 1])}
    coded = {}  # luma blocks' coded flags of the I picture

    def intra_mb(b, mbx, mby, in_p):
        cbp = int(rng.integers(0, 64))
        if in_p:
            b.code(t["kMbNonIntra"], cbp)
        else:
            code = 0
            for i in range(6):
                bit = (cbp >> (5 - i)) & 1
                if i < 4:
                    bx, by = 2 * mbx + (i & 1), 2 * mby + (i >> 1)
                    a_, b_, c_ = (coded.get(k, 0) for k in ((bx - 1, by), (bx - 1, by - 1),
                                                            (bx, by - 1)))
                    coded[(bx, by)] = bit
                    bit ^= a_ if b_ == c_ else c_
                code |= bit << (5 - i)
            b.code(t["kMbIntra"], code)
        b.put(1, 1)  # ac_pred
        for k in range(6):
            diff = int(rng.integers(-6, 7))
            b.code(t["kDc0Chroma" if k >= 4 else "kDc0Lum"], abs(diff))
            if diff:
                b.put(diff < 0, 1)
            if cbp >> (5 - k) & 1:
                pos, count = 0, int(rng.integers(1, 4))
                for j in range(count):
                    run = int(rng.integers(0, 4))
                    if pos + run + 1 > 63:
                        run = 0
                    pos += run + 1
                    last = j == count - 1 or pos >= 60
                    code, length = esc[3 if k >= 4 else 0]
                    b.put(code, length)
                    b.put(0, 2)  # escape 3
                    b.put(int(last), 1)
                    b.put(run, 6)
                    level = int(rng.integers(1, 40)) * (1 if rng.integers(2) else -1)
                    b.put(level & 0xFF, 8)
                    if last:
                        break

    pictures = []
    for f in range(n):
        b = BitWriter()
        b.put(0 if f == 0 else 1, 2)
        b.put(q, 5)
        if f == 0:
            b.put(0x17, 5)
            b.put(0, 1)  # rl_chroma_table_index 0
            b.put(0, 1)  # rl_table_index 0
            b.put(0, 1)  # dc_table_index 0
        else:
            b.put(0, 1)  # use_skip_mb_code
            b.put(0, 1)  # rl_table_index 0
            b.put(0, 1)  # dc_table_index 0
            b.put(0, 1)  # mv_table_index 0
        for mby in range(mbh):
            for mbx in range(mbw):
                if f == 0 or rng.integers(0, 8) == 0:
                    intra_mb(b, mbx, mby, f > 0)
                    continue
                b.code(t["kMbNonIntra"], 0x40)  # inter, no residual
                sym = (t["kMv0Sym"].index(0) if rng.integers(0, 4) == 0  # the escape
                       else int(rng.integers(0, 1100)))
                b.put(mv_codes[2 * sym], mv_codes[2 * sym + 1])
                if t["kMv0Sym"][sym] == 0:  # the escape: two 6-bit values
                    b.put(int(rng.integers(0, 64)), 6)
                    b.put(int(rng.integers(0, 64)), 6)
        if f == 0:  # the extension: fps, bit rate / 1024, flipflop_rounding
            b.put(25, 5)
            b.put(800, 11)
            b.put(1, 1)
        pictures.append(b.bytes())
    return pictures


# what cv2.VideoCapture reads no frame of (pinned as ValueError, not pixels)
H263_NO_FRAMES = ("mp4v_shortheader_only_176x144.avi",)


GROUPS = dict(mpeg12=make_mpeg12, containers=make_containers, stills=make_stills,
              webp_gif=make_webp_gif, vp9_highbd=make_vp9_highbd,
              lossless_video=make_lossless_video, webp_corrupt=make_webp_corrupt,
              h263=make_h263)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=os.path.join(ROOT, "tests", "data", "inputs"))
    p.add_argument("--only", choices=sorted(GROUPS), nargs="+",
                   help="write (and pin) these groups alone, not every fixture")
    args = p.parse_args()
    if args.only:
        os.makedirs(args.out, exist_ok=True)
        table = pins(args.out, [name for g in args.only for name in GROUPS[g](args.out)])
    else:
        table = make(args.out)
    print("INPUT_PINS = {")
    for name, (contract, digest) in table.items():
        print(f'    "{name}": ("{contract}", "{digest}"),')
    print("}")
    total = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(args.out) for f in fs)
    print(f"# {len(table)} fixtures, {total} bytes", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
