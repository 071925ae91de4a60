#!/usr/bin/env python3
"""native/bmp.cpp and native/tiff.cpp (and jpeg.cpp, for JPEG-compressed
TIFF strips), with the BMP, PNM and TIFF readers around them, under
AddressSanitizer and UndefinedBehaviorSanitizer, on the CPU:

    python3 tools/stills_robustness.py [--streams 300] [--corrupt 600] [--seed 0]

Builds bmp.cpp, tiff.cpp and jpeg.cpp with `-fsanitize=address,undefined` into
build/fmvfi_tpu_torch/sanitize/, then runs itself again with the
sanitizer's runtime preloaded and the port's native library replaced by
that build, and reads through utils/imageio.py:
- every BMP, PNM and TIFF fixture of tests/data/inputs/, held to
  chip_smoke.INPUT_PINS;
- `--streams` seeded run-length BMPs (RLE8 and RLE4, sizes 1-39 x 1-19,
  random runs, absolute runs, deltas, ends of line and of bitmap, a
  quarter with a bit flipped) and TIFF strips LZW-coded by the port's
  encoder (random and repetitive rows, up to 30000 bytes), each against
  cv2.imread;
- `--corrupt` copies of the RLE BMPs, the LZW / PackBits / deflate TIFFs
  and the PNM fixtures (corrupt JPEG data is ROADMAP item 18.10's) with
  bits flipped, bytes zeroed or duplicated, or the
  file cut short.
Every file must end in ValueError, in NotImplementedError (a flipped field
that names a format the port does not read) or in cv2.imread's pixels (a
sanitizer report ends the run).  Prints the counts; exits 1 on any mismatch or other
exception.  Needs g++, cv2 and the port; not JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import os
import struct
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "build", "fmvfi_tpu_torch", "sanitize")
SOURCES = [os.path.join(ROOT, "fmvfi_tpu_torch", "native", f)
           for f in ("bmp.cpp", "tiff.cpp", "jpeg.cpp")]
FLAGS = ["-O1", "-g", "-fno-omit-frame-pointer", "-fsanitize=address,undefined",
         "-fno-sanitize-recover=undefined", "-fPIC", "-shared"]
CORRUPTED = ("bmp_rle8_40x30.bmp", "bmp_rle4_40x30.bmp", "bmp_4bit_29x31.bmp",
             "tiff_lzw_29x31.tif", "tiff_cv2_lzw_37x53.tif", "tiff_packbits_29x31.tif",
             "tiff_deflate_29x31.tif", "tiff_planar2_29x31.tif", "tiff_tiled_50x40.tif",
             "pnm_p3_23x17.ppm", "pnm_p1_23x17.pbm", "pnm_cv2_p6_37x53.ppm")


def build() -> str:
    os.makedirs(OUT, exist_ok=True)
    lib = os.path.join(OUT, "libstills_sanitized.so")
    subprocess.run(["g++", *FLAGS, "-o", lib, *SOURCES], check=True)
    return lib


def _tool():
    spec = importlib.util.spec_from_file_location(
        "make_input_fixtures", os.path.join(ROOT, "tools", "make_input_fixtures.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def _random_rle(rng, w: int, h: int, bits: int) -> bytes:
    """Random RLE ops: runs, absolute runs, deltas, ends of line, perhaps
    an end of bitmap (some past the rows: data cv2 rejects)."""
    import numpy as np

    out, x = bytearray(), 0
    for _ in range(int(rng.integers(1, 80))):
        k = int(rng.integers(10))
        if k < 4 and w - x > 0:
            n = int(rng.integers(1, min(255, w - x) + 1))
            out += bytes([n, int(rng.integers(256))])
            x += n
        elif k < 7 and w - x >= 3:
            n = int(rng.integers(3, min(255, w - x) + 1))
            size = n if bits == 8 else (n + 1) // 2
            out += bytes([0, n]) + rng.integers(0, 256, size + (size & 1), np.uint8).tobytes()
            x += n
        elif k < 8:
            out += bytes([0, 2, int(rng.integers(min(w, 255))), int(rng.integers(3))])
            x = 0
        else:
            out += bytes([0, 0])
            x = 0
    if rng.integers(4):
        out += bytes([0, 1])
    return bytes(out)


def worker(lib_path: str, streams: int, corrupt: int, seed: int) -> int:
    import ctypes

    import cv2
    import numpy as np

    import chip_smoke
    from fmvfi_tpu_torch import native
    from fmvfi_tpu_torch.utils import imageio

    lib = ctypes.CDLL(lib_path)
    native._bind_stills(lib)
    lib.fmvfi_jpeg_header.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                                      ctypes.c_char_p, ctypes.c_int32]
    lib.fmvfi_jpeg_decode_strip.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                                            ctypes.c_int32, ctypes.c_char_p, ctypes.c_int32]
    for fn in (lib.fmvfi_jpeg_header, lib.fmvfi_jpeg_decode_strip):
        fn.restype = ctypes.c_int32
    native._lib = lib  # the port's BMP and TIFF codecs now call the sanitized build
    tool = _tool()
    inputs = os.path.join(ROOT, chip_smoke.INPUTS_DIR)
    names = sorted(n for n in chip_smoke.INPUTS_STILL_PINS if n.startswith(("bmp_", "pnm_",
                                                                            "tiff_")))
    bad = [n for n in names if hashlib.sha256(imageio.imread(os.path.join(inputs, n)).tobytes())
           .hexdigest() != chip_smoke.INPUT_PINS[n][1]]
    print(f"fixtures: {len(names)} read, {len(bad)} unequal to their pins {bad}", flush=True)

    rng = np.random.default_rng(seed)
    outcomes = dict(equal=0, ValueError=0, NotImplementedError=0)
    other = []

    def check(path, what):
        try:
            ref = cv2.imread(path, cv2.IMREAD_COLOR)
        except cv2.error:  # a size past cv2's limits: no image
            ref = None
        try:
            ours = imageio.imread(path)
        except (ValueError, NotImplementedError) as e:
            outcomes[type(e).__name__] += 1
            return
        except Exception as e:  # noqa: BLE001  (reported, then the run fails)
            other.append(f"{what}: {type(e).__name__}: {e}")
            return
        if ref is None or not np.array_equal(ours, ref[..., ::-1]):
            other.append(f"{what}: decoded, but {'cv2 reads no image' if ref is None else 'unequal to cv2'}")
        else:
            outcomes["equal"] += 1

    with tempfile.TemporaryDirectory() as tmp:
        for k in range(streams):
            path = os.path.join(tmp, "s.bmp")
            bits = 8 if k % 2 else 4
            w, h = int(rng.integers(1, 40)), int(rng.integers(1, 20))
            pal = rng.integers(0, 256, (1 << bits) * 4, np.uint8).tobytes()
            data = bytearray(tool.bmp_file(w, h, bits, _random_rle(rng, w, h, bits), pal,
                                           comp=1 if bits == 8 else 2))
            if k % 4 == 0:
                at = int(rng.integers(14 + 40 + len(pal), len(data)))
                data[at] ^= 1 << int(rng.integers(8))
            with open(path, "wb") as f:
                f.write(bytes(data))
            check(path, f"RLE{bits} stream {k} {w}x{h}")
            path = os.path.join(tmp, "s.tif")
            wt, ht = int(rng.integers(1, 200)), int(rng.integers(1, 50))
            px = rng.integers(0, 256, (ht, wt * 3), np.uint8)
            if k % 3:
                px = np.repeat(px[:, : max(1, wt // 4)], 4, axis=1)[:, : wt * 3]
                px = np.pad(px, ((0, 0), (0, wt * 3 - px.shape[1])))
            tags = {256: (3, [wt]), 257: (3, [ht]), 258: (3, [8, 8, 8]), 259: (3, [5]),
                    262: (3, [2]), 277: (3, [3]), 278: (3, [ht])}
            with open(path, "wb") as f:
                f.write(tool.tiff_file(tags, [native.tiff_lzw_encode(px.tobytes())]))
            check(path, f"LZW strip {k} {wt}x{ht}")
        print(f"streams: {streams} RLE BMPs and {streams} LZW TIFFs, {outcomes}", flush=True)

        counts = dict(outcomes)
        for k in range(corrupt):
            name = CORRUPTED[int(rng.integers(len(CORRUPTED)))]
            with open(os.path.join(inputs, name), "rb") as f:
                data = bytearray(f.read())
            kind = int(rng.integers(4))
            at = int(rng.integers(len(data)))
            if kind == 0:
                for _ in range(int(rng.integers(1, 9))):
                    data[int(rng.integers(len(data)))] ^= 1 << int(rng.integers(8))
            elif kind == 1:
                data[at:at + int(rng.integers(1, 64))] = bytes(min(63, len(data) - at))
            elif kind == 2:
                n = int(rng.integers(1, 200))
                data[at:at] = data[at:at + n]
            else:
                del data[at:]
            path = os.path.join(tmp, "corrupt" + os.path.splitext(name)[1])
            with open(path, "wb") as f:
                f.write(bytes(data))
            check(path, f"{name} kind {kind} at {at}")
        print(f"corrupted: {corrupt} files, "
              f"{ {k: outcomes[k] - counts[k] for k in outcomes} }, {len(other)} other outcomes",
              flush=True)
        for line in other[:20]:
            print("  " + line)
    return int(bool(bad or other))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--streams", type=int, default=300)
    p.add_argument("--corrupt", type=int, default=600)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--worker", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.worker:
        return worker(args.worker, args.streams, args.corrupt, args.seed)
    lib = build()
    # the sanitizer's runtime, and libstdc++ beside it so that its exception
    # interceptors find __cxa_throw
    runtime = " ".join(subprocess.run(["g++", f"-print-file-name={name}"], check=True,
                                      capture_output=True, text=True).stdout.strip()
                       for name in ("libasan.so", "libstdc++.so"))
    env = dict(os.environ, LD_PRELOAD=runtime,
               ASAN_OPTIONS="detect_leaks=0:abort_on_error=1",
               UBSAN_OPTIONS="print_stacktrace=1:halt_on_error=1")
    return subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", lib,
                           "--streams", str(args.streams), "--corrupt", str(args.corrupt),
                           "--seed", str(args.seed)], env=env).returncode


if __name__ == "__main__":
    sys.exit(main())
