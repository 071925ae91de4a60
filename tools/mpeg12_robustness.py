#!/usr/bin/env python3
"""native/mpeg12.cpp and the MPEG demuxers under AddressSanitizer and
UndefinedBehaviorSanitizer, on the CPU:

    python3 tools/mpeg12_robustness.py [--clips 200] [--corrupt 1000] [--seed 0]

Builds mpeg12.cpp with `-fsanitize=address,undefined` into
build/fmvfi_tpu_torch/sanitize/, then runs itself again with the
sanitizer's runtime preloaded and the port's native library replaced by
that build, and reads through pipeline/video.py:
- every MPEG fixture of tests/data/inputs/, held to chip_smoke.INPUT_PINS;
- `--clips` seeded clips coded by cv2's libavcodec (tools/
  make_input_fixtures.py::mpeg12_encode; sizes 1-199, MPEG-1 or MPEG-2,
  B pictures, GOP lengths, table B.15, alternate scan, q_scale_type 1,
  intra DC precision 9-11, custom matrices, field DCT and motion (the
  pictures marked progressive), BT.709, quantiser changes, bit rates) as
  raw streams, each bit-equal to cv2.VideoCapture;
- `--corrupt` copies of the fixtures with bytes flipped, runs zeroed or
  duplicated, or the file cut short, each of which must decode or raise
  ValueError or NotImplementedError (a sanitizer report ends the run).
Prints the counts; exits 1 on any mismatch or other exception.  Needs g++,
cv2 and the port; not JAX.
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
SOURCE = os.path.join(ROOT, "fmvfi_tpu_torch", "native", "mpeg12.cpp")
FLAGS = ["-O1", "-g", "-fno-omit-frame-pointer", "-fsanitize=address,undefined",
         "-fno-sanitize-recover=undefined", "-fPIC", "-shared"]


def build() -> str:
    os.makedirs(OUT, exist_ok=True)
    lib = os.path.join(OUT, "libmpeg12_sanitized.so")
    subprocess.run(["g++", *FLAGS, "-o", lib, SOURCE], check=True)
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
        frames.append(frame[..., ::-1])


def worker(lib_path: str, clips: int, corrupt: int, seed: int) -> int:
    import ctypes

    import numpy as np

    import chip_smoke
    from fmvfi_tpu_torch import native
    from fmvfi_tpu_torch.pipeline import video

    lib = ctypes.CDLL(lib_path)
    native._bind_mpeg12(lib)
    native._lib = lib  # the port's decoders now call the sanitized build
    tool = _tool()
    inputs = os.path.join(ROOT, chip_smoke.INPUTS_DIR)
    names = sorted(n for n in chip_smoke.INPUT_PINS if n.startswith(("mpeg1_", "mpeg2_")))
    bad = []
    for name in names:
        frames = np.stack(list(video.iter_video_frames(os.path.join(inputs, name))))
        if hashlib.sha256(frames.tobytes()).hexdigest() != chip_smoke.INPUT_PINS[name][1]:
            bad.append(name)
    print(f"fixtures: {len(names)} read, {len(bad)} unequal to their pins {bad}", flush=True)

    rng = np.random.default_rng(seed)
    options = [{"intra_vlc": 1}, {"alternate_scan": 1}, {"non_linear_quant": 1, "qmax": 28},
               {"dc": 1}, {"dc": 2}, {"dc": 3}, {"flags": "+ildct+ilme"}, {"scplx_mask": 0.9},
               {"colorspace": "bt709", "color_primaries": "bt709", "color_trc": "bt709"},
               {"b": "40k"}, {"g": 4}]
    unequal = 0
    with tempfile.TemporaryDirectory() as tmp:
        for k in range(clips):
            h, w = (int(v) for v in rng.integers(1, 200, 2))
            mpeg1 = rng.random() < 0.3
            opts = {"bf": int(rng.integers(0, 3))}
            if not mpeg1:
                for i in rng.choice(len(options), int(rng.integers(0, 4)), replace=False):
                    opts.update(options[i])
            elif rng.random() < 0.5:
                opts.update(options[int(rng.choice([7, 9, 10]))])  # what MPEG-1 takes
            matrices = None
            if not mpeg1 and rng.random() < 0.2:
                m = rng.integers(1, 256, 64)
                matrices = {"intra": m, "inter": rng.integers(1, 256, 64)}
            n = int(rng.integers(2, 9))
            step = tuple(float(v) for v in rng.uniform(-6, 6, 2))
            es = b"".join(tool.mpeg12_encode(tool.yuv_scene(rng, n, h, w, step=step,
                                                            combed=bool(rng.random() < 0.3)),
                                             w, h, "mpeg1video" if mpeg1 else "mpeg2video",
                                             options=opts, matrices=matrices))
            if not mpeg1:
                es = tool.forge_progressive(es)
            path = os.path.join(tmp, f"clip{k}.m{'1' if mpeg1 else '2'}v")
            with open(path, "wb") as f:
                f.write(es)
            ours, theirs = list(video.iter_video_frames(path)), _cv2_frames(path)
            if len(ours) != len(theirs) or not all(np.array_equal(a, b)
                                                   for a, b in zip(ours, theirs)):
                unequal += 1
                print(f"clip {k}: {w}x{h} {'mpeg1' if mpeg1 else 'mpeg2'} {opts} unequal to cv2",
                      flush=True)
        print(f"clips: {clips} coded, {unequal} unequal to cv2", flush=True)

        outcomes = dict(decoded=0, ValueError=0, NotImplementedError=0)
        other = []
        for k in range(corrupt):
            name = names[int(rng.integers(len(names)))]
            if "1080" in name:
                name = names[0]
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
                list(video.iter_video_frames(path))
                outcomes["decoded"] += 1
            except (ValueError, NotImplementedError) as e:
                outcomes[type(e).__name__] += 1
            except Exception as e:  # noqa: BLE001  (reported, then the run fails)
                other.append(f"{name} kind {kind} at {at}: {type(e).__name__}: {e}")
        print(f"corrupted: {corrupt} streams, {outcomes}, {len(other)} other exceptions",
              flush=True)
        for line in other[:20]:
            print("  " + line)
    return int(bool(bad or unequal or other))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--clips", type=int, default=200)
    p.add_argument("--corrupt", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--worker", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.worker:
        return worker(args.worker, args.clips, args.corrupt, args.seed)
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
                           "--clips", str(args.clips), "--corrupt", str(args.corrupt),
                           "--seed", str(args.seed)], env=env).returncode


if __name__ == "__main__":
    sys.exit(main())
