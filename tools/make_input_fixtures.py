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
  DQUANT, AC prediction and DC-as-TCOEF (paths cv2's writer never takes).

It prints INPUT_PINS, chip_smoke.py's table: for each fixture the reader
contract ("imread": cv2.imread + BGR2RGB; "read_jpeg": PIL's Image.open;
"video": cv2.VideoCapture's frames + BGR2RGB, stacked) and the sha256 of
those pixels.  The CPU tests (tests/test_torch_png_adam7.py,
test_torch_jpeg_progressive.py, test_torch_mjpg_video.py,
test_torch_mp4v_video.py) hold the pins
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
from fmvfi_tpu_torch.utils import avi  # noqa: E402

VIDEO_SUFFIXES = (".avi", ".mp4", ".mov", ".m4v")

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
    return pins(out, files)


def pixels(out: str, name: str, contract: str) -> np.ndarray:
    """The RGB pixels cv2 or PIL returns for a fixture under `contract`."""
    path = os.path.join(out, name)
    if contract == "read_jpeg":
        return np.asarray(Image.open(path).convert("RGB"))
    if contract == "imread":
        return cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1]
    cap = cv2.VideoCapture(path)
    assert cap.getBackendName() == "FFMPEG"
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame[..., ::-1])
    cap.release()
    return np.stack(frames)


def contract_of(name: str) -> str:
    if name.endswith(VIDEO_SUFFIXES):
        return "video"
    return "read_jpeg" if "_pil_" in name else "imread"


def pins(out: str, files) -> dict:
    table = {}
    for name in sorted(files):
        contract = contract_of(name)
        table[name] = (contract, hashlib.sha256(
            np.ascontiguousarray(pixels(out, name, contract)).tobytes()).hexdigest())
    return table


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=os.path.join(ROOT, "tests", "data", "inputs"))
    args = p.parse_args()
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
