#!/usr/bin/env python3
"""native/vp9.cpp at 10 and 12 bits, the PNG and raw-frame readers of AVI
and MOV files (png.cpp, rawvideo.cpp), and the H.263 family (h263.cpp,
msmpeg4.cpp, mpeg4.cpp; utils/flv.py) under AddressSanitizer and
UndefinedBehaviorSanitizer, on the CPU:

    python3 tools/video_robustness.py [--clips 60] [--family-clips 30] [--corrupt 600]
                                      [--seed 0]

Builds those sources with `-fsanitize=address,undefined` into
build/fmvfi_tpu_torch/sanitize/, then runs itself again with the
sanitizer's runtime preloaded and the port's native library replaced by
that build, and reads through pipeline/video.py:
- every VP9 profile 2 / 3, lossless AVI / MOV and H.263-family fixture of
  tests/data/inputs/ (but the 1080p clips), held to chip_smoke.INPUT_PINS;
- `--clips` seeded VP9 clips coded by cv2's libvpx at 10 or 12 bits
  (tools/make_input_fixtures.py::vp9_encode: sizes 1-99, each sampling,
  lossless, two-pass alt-ref, error-resilient, tile columns, colour
  configs), muxed into WebM, each bit-equal to cv2.VideoCapture;
- `--family-clips` seeded clips of cv2's libavcodec (h263 with OBMC, 4MV
  and GOB headers in AVI, flv in FLV, msmpeg4v2 / msmpeg4 in AVI; random
  sizes and quantisers), each bit-equal to cv2.VideoCapture;
- `--corrupt` copies of those fixtures with bits flipped, runs zeroed or
  duplicated, or the file cut short, each of which must decode or raise
  ValueError or NotImplementedError (a sanitizer report ends the run); the
  count of those decoded equal to cv2's frames is printed beside, and each
  other outcome (`--keep DIR` copies those files into DIR).
Prints the counts; exits 1 on an unequal fixture or clip or another
exception.  Needs g++, cv2 and the port; not JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "build", "fmvfi_tpu_torch", "sanitize")
SOURCES = [os.path.join(ROOT, "fmvfi_tpu_torch", "native", f)
           for f in ("vp9.cpp", "png.cpp", "rawvideo.cpp", "h263.cpp", "msmpeg4.cpp", "mpeg4.cpp",
                     "mpeg4_enc.cpp")]
FLAGS = ["-O1", "-g", "-fno-omit-frame-pointer", "-fsanitize=address,undefined",
         "-fno-sanitize-recover=undefined", "-fPIC", "-shared"]
PREFIXES = ("vp9_hbd", "ivf_vp9_hbd", "lossless_", "corrupt_vp9_", "h263_", "flv1_", "mp42_",
            "mp43_", "div3_", "msmpeg4", "mp4v_short")
FAMILY = ("h263_", "flv1_", "mp42_", "mp43_", "div3_", "msmpeg4", "mp4v_short")


def build() -> str:
    os.makedirs(OUT, exist_ok=True)
    lib = os.path.join(OUT, "libvideo_sanitized.so")
    subprocess.run(["g++", *FLAGS, "-o", lib, *SOURCES], check=True)
    return lib


def _tool():
    spec = importlib.util.spec_from_file_location(
        "make_input_fixtures", os.path.join(ROOT, "tools", "make_input_fixtures.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def _cv2_frames(path):
    import cv2
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            return frames
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))


def family_clip(tool, rng, path: str) -> None:
    """A seeded clip of cv2's libavcodec in the H.263 family at `path`."""
    codec = str(rng.choice(["h263", "flv", "msmpeg4v2", "msmpeg4"]))
    if codec == "h263":
        w, h = ((128, 96), (176, 144), (352, 288))[int(rng.integers(3))]
    else:
        w, h = (int(v) for v in rng.integers(2, 120, 2))
    q = int(rng.integers(1, 32))
    options = {"qmin": q, "qmax": q, "g": int(rng.integers(2, 8))}
    if codec == "h263":
        options.update(obmc=int(rng.integers(2)), ps=int(rng.choice([0, 300])))
        if rng.integers(2):
            options["flags"] = "+mv4"
    n = int(rng.integers(2, 7))
    scene = tool.yuv_scene(rng, n, h, w, step=tuple(float(v) for v in rng.uniform(-6, 6, 2)))
    data = tool.mpeg12_encode(scene, w, h, codec, options=options)
    if codec == "flv":
        tool.flv_file(path, data, [True] + [False] * (len(data) - 1))
        return
    tag = {"h263": b"H263", "msmpeg4v2": b"MP42", "msmpeg4": b"MP43"}[codec]
    with tool.PacketAvi(path, w, h, tag, 15) as mux:
        for i, p in enumerate(data):
            mux.write_packet(p, i == 0)


def worker(lib_path: str, clips: int, family_clips: int, corrupt: int, seed: int,
           keep=None) -> int:
    import ctypes

    import numpy as np

    import chip_smoke
    from fmvfi_tpu_torch import native
    from fmvfi_tpu_torch.pipeline import video

    lib = ctypes.CDLL(lib_path)
    native._bind_vp9(lib)
    native._bind_h263(lib)
    native._bind_mpeg4(lib)
    u8p, i32, i64 = ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32, ctypes.c_int64
    lib.fmvfi_png_unfilter.argtypes = [u8p, i64, i64, i32, u8p]
    lib.fmvfi_png_unfilter.restype = i64
    lib.fmvfi_png16_swscale.argtypes = [ctypes.c_void_p, i64, i32, u8p]
    lib.fmvfi_png16_swscale.restype = None
    lib.fmvfi_yuv420p_swscale.argtypes = [u8p, u8p, u8p, i32, i32, u8p]
    lib.fmvfi_yuv420p_swscale.restype = None
    native._lib = lib  # the port's decoders now call the sanitized build
    tool = _tool()
    inputs = os.path.join(ROOT, chip_smoke.INPUTS_DIR)
    names = sorted(n for n in chip_smoke.INPUT_PINS if n.startswith(PREFIXES) and "1080" not in n)
    bad = []
    for name in names:
        frames = np.stack(list(video.iter_video_frames(os.path.join(inputs, name))))
        if hashlib.sha256(frames.tobytes()).hexdigest() != chip_smoke.INPUT_PINS[name][1]:
            bad.append(name)
    print(f"fixtures: {len(names)} read, {len(bad)} unequal to their pins {bad}", flush=True)

    rng = np.random.default_rng(seed)
    settings = [{}, {"lossless": 1}, {"two_pass": True, "lag": 8},
                {"error_resilient": True, "kf_max_dist": 4}, {"tile_columns": 1},
                {"color_space": 2, "color_range": 1}, {"color_space": 5}, {"cpu_used": 8},
                {"aq_mode": 3, "cbr": True}]
    unequal = 0
    with tempfile.TemporaryDirectory() as tmp:
        for k in range(clips):
            h, w = (int(v) for v in rng.integers(1, 100, 2))
            fmt = str(rng.choice(["420", "422", "444", "440"]))
            bd = int(rng.choice([10, 12]))
            kw = dict(settings[int(rng.integers(len(settings)))],
                      bitrate=int(rng.choice([40, 150, 600])),
                      frame_parallel=int(rng.integers(0, 2)))
            n = int(rng.integers(2, 9))
            frames = tool.sliding(rng, n, h, w, step=tuple(float(v) for v in rng.uniform(-6, 6, 2)))
            path = os.path.join(tmp, f"clip{k}.webm")
            tool.vp9_webm(path, tool.vp9_encode(frames, fmt=fmt, bit_depth=bd, **kw), w, h)
            ours, theirs = list(video.iter_video_frames(path)), _cv2_frames(path)
            if len(ours) != len(theirs) or not all(np.array_equal(a, b)
                                                   for a, b in zip(ours, theirs)):
                unequal += 1
                print(f"clip {k}: {w}x{h} {fmt} {bd} bits {kw} unequal to cv2", flush=True)
        print(f"clips: {clips} coded, {unequal} unequal to cv2", flush=True)
        family_unequal = 0
        for k in range(family_clips):
            path = os.path.join(tmp, f"family{k}" + (".flv" if k % 4 == 1 else ".avi"))
            family_clip(tool, rng, path)
            ours, theirs = list(video.iter_video_frames(path)), _cv2_frames(path)
            if len(ours) != len(theirs) or not all(np.array_equal(a, b)
                                                   for a, b in zip(ours, theirs)):
                family_unequal += 1
                print(f"family clip {k} unequal to cv2", flush=True)
        unequal += family_unequal
        print(f"family clips: {family_clips} coded, {family_unequal} unequal to cv2", flush=True)

        outcomes = dict(decoded=0, ValueError=0, NotImplementedError=0)
        as_cv2 = dict(vp9=0, lossless=0, h263_family=0)
        other, notes = [], []
        for k in range(corrupt):
            name = names[int(rng.integers(len(names)))]
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
            try:
                ours = list(video.iter_video_frames(path))
                outcomes["decoded"] += 1
            except (ValueError, NotImplementedError) as e:
                outcomes[type(e).__name__] += 1
                if isinstance(e, NotImplementedError):
                    notes.append(f"{name} kind {kind} at {at}: refused: {str(e)[:160]}")
                continue
            except Exception as e:  # noqa: BLE001  (reported, then the run fails)
                other.append(f"{name} kind {kind} at {at}: {type(e).__name__}: {e}")
                continue
            theirs = _cv2_frames(path)
            if len(ours) == len(theirs) and all(np.array_equal(a, b) for a, b in zip(ours, theirs)):
                as_cv2["lossless" if name.startswith("lossless_") else
                       "h263_family" if name.startswith(FAMILY) else "vp9"] += 1
            else:
                notes.append(f"{name} kind {kind} at {at}: {len(ours)} frames, cv2 {len(theirs)}"
                             f"{', unequal' if len(ours) == len(theirs) else ''}")
                if keep:
                    os.makedirs(keep, exist_ok=True)
                    with open(os.path.join(keep, f"{k}_{name}"), "wb") as f:
                        f.write(bytes(data))
        print(f"corrupted: {corrupt} files, {outcomes}, decoded equal to cv2: {as_cv2}, "
              f"{len(other)} other exceptions", flush=True)
        for line in notes[:40] + other[:20]:
            print("  " + line)
    return int(bool(bad or unequal or other))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--clips", type=int, default=60)
    p.add_argument("--family-clips", type=int, default=30)
    p.add_argument("--corrupt", type=int, default=600)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--keep", help="a directory to copy each file decoded unlike cv2 into")
    p.add_argument("--worker", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.worker:
        return worker(args.worker, args.clips, args.family_clips, args.corrupt, args.seed,
                      args.keep)
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
                           "--clips", str(args.clips), "--family-clips", str(args.family_clips),
                           "--corrupt", str(args.corrupt),
                           "--seed", str(args.seed)] + (["--keep", args.keep] if args.keep else []),
                          env=env).returncode


if __name__ == "__main__":
    sys.exit(main())
