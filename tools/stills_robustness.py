#!/usr/bin/env python3
"""native/bmp.cpp, tiff.cpp (and jpeg.cpp, for JPEG-compressed TIFF
strips), webp.cpp, gif.cpp and vp8.cpp (a lossy WebP's key frame), with the
BMP, PNM, TIFF, WebP and GIF readers around them, under AddressSanitizer
and UndefinedBehaviorSanitizer, on the CPU:

    python3 tools/stills_robustness.py [--streams 300] [--corrupt 600] [--seed 0]

Builds bmp.cpp, tiff.cpp, jpeg.cpp, webp.cpp, gif.cpp and vp8.cpp with
`-fsanitize=address,undefined` into
build/fmvfi_tpu_torch/sanitize/, then runs itself again with the
sanitizer's runtime preloaded and the port's native library replaced by
that build, and reads through utils/imageio.py:
- every BMP, PNM, TIFF, WebP and GIF fixture of tests/data/inputs/ (the
  corrupted lossy WebPs that libwebp reads past their chunk too), held to
  chip_smoke.INPUT_PINS;
- `--streams` seeded run-length BMPs (RLE8 and RLE4, sizes 1-39 x 1-19,
  random runs, absolute runs, deltas, ends of line and of bitmap, a
  quarter with a bit flipped) and TIFF strips LZW-coded by the port's
  encoder (random and repetitive rows, up to 30000 bytes), each against
  cv2.imread; and as many WebPs (lossy and lossless, with and without
  alpha, PIL's at random methods and qualities and cv2's, sides 1-199,
  and the port's own lossless files) and GIFs (random screens, global and
  local tables of 2-256 entries, 1-4 images with sub-rectangles,
  interlacing, transparency and disposals 0-3, with and without Graphic
  Control and comment extensions), each against cv2.imread and
  cv2.VideoCapture;
- `--corrupt` copies of the RLE BMPs, the LZW / PackBits / deflate TIFFs,
  the PNM fixtures and the WebP and GIF fixtures (corrupt JPEG data is
  ROADMAP item 18.10's) with bits flipped, bytes zeroed or duplicated, or
  the file cut short.
`--keep DIR` copies each file of another outcome into DIR.
Every file must end in ValueError, in NotImplementedError (a flipped field
that names a format the port does not read) or in cv2's pixels (a
sanitizer report ends the run); a WebP or GIF read as video is held to
cv2.VideoCapture's frames the same way.  Prints the counts; exits 1 on any mismatch or other
exception.  Needs g++, cv2 and the port; not JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import io
import os
import shutil
import struct
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "build", "fmvfi_tpu_torch", "sanitize")
SOURCES = [os.path.join(ROOT, "fmvfi_tpu_torch", "native", f)
           for f in ("bmp.cpp", "tiff.cpp", "jpeg.cpp", "webp.cpp", "gif.cpp", "vp8.cpp")]
FLAGS = ["-O1", "-g", "-fno-omit-frame-pointer", "-fsanitize=address,undefined",
         "-fno-sanitize-recover=undefined", "-fPIC", "-shared"]
CORRUPTED = ("bmp_rle8_40x30.bmp", "bmp_rle4_40x30.bmp", "bmp_4bit_29x31.bmp",
             "tiff_lzw_29x31.tif", "tiff_cv2_lzw_37x53.tif", "tiff_packbits_29x31.tif",
             "tiff_deflate_29x31.tif", "tiff_planar2_29x31.tif", "tiff_tiled_50x40.tif",
             "pnm_p3_23x17.ppm", "pnm_p1_23x17.pbm", "pnm_cv2_p6_37x53.ppm",
             "webp_lossy_53x37.webp", "webp_lossy_alpha_53x37.webp", "webp_cv2_lossless_53x37.webp",
             "webp_lossless_meta_128x96.webp", "webp_lossless_pal4_31x29.webp",
             "webp_anim_lossy_53x37.webp", "gif_clip_disposals_53x37.gif",
             "gif_interlaced_53x37.gif", "gif_clip_pil_disposal3_53x37.gif",
             "gif_deferred_clear_64x64.gif")


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


def worker(lib_path: str, streams: int, corrupt: int, seed: int, keep=None) -> int:
    import ctypes

    import cv2
    import numpy as np

    import chip_smoke
    from fmvfi_tpu_torch import native
    from PIL import Image

    from fmvfi_tpu_torch.pipeline import video
    from fmvfi_tpu_torch.utils import imageio, webp

    lib = ctypes.CDLL(lib_path)
    native._bind_stills(lib)
    lib.fmvfi_jpeg_header.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                                      ctypes.c_char_p, ctypes.c_int32]
    lib.fmvfi_jpeg_decode_strip.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                                            ctypes.c_int32, ctypes.c_char_p, ctypes.c_int32]
    for fn in (lib.fmvfi_jpeg_header, lib.fmvfi_jpeg_decode_strip):
        fn.restype = ctypes.c_int32
    native._bind_vp8(lib)
    native._lib = lib  # the port's still codecs now call the sanitized build
    tool = _tool()
    inputs = os.path.join(ROOT, chip_smoke.INPUTS_DIR)
    names = sorted(n for n in chip_smoke.INPUT_PINS if n.startswith(("bmp_", "pnm_", "tiff_",
                                                                     "webp_", "gif_",
                                                                     "corrupt_webp_")))

    def read(name):
        path = os.path.join(inputs, name)
        if chip_smoke.INPUT_PINS[name][0] == "video":
            return np.stack(list(video.iter_video_frames(path)))
        return imageio.imread(path)

    bad = [n for n in names if hashlib.sha256(np.ascontiguousarray(read(n)).tobytes())
           .hexdigest() != chip_smoke.INPUT_PINS[n][1]]
    print(f"fixtures: {len(names)} read, {len(bad)} unequal to their pins {bad}", flush=True)

    rng = np.random.default_rng(seed)
    outcomes = dict(equal=0, ValueError=0, NotImplementedError=0)
    other = []

    def check(path, what, strict=False):
        """strict: a file cv2 reads must read (the well-formed WebPs and GIFs)."""
        try:
            ref = cv2.imread(path, cv2.IMREAD_COLOR)
        except cv2.error:  # a size past cv2's limits: no image
            ref = None
        try:
            ours = imageio.imread(path)
        except (ValueError, NotImplementedError) as e:
            if strict and ref is not None:
                other.append(f"{what}: {type(e).__name__} where cv2 reads an image: {e}")
                return
            outcomes[type(e).__name__] += 1
            return
        except Exception as e:  # noqa: BLE001  (reported, then the run fails)
            other.append(f"{what}: {type(e).__name__}: {e}")
            return
        if ref is None or not np.array_equal(ours, ref[..., ::-1]):
            other.append(f"{what}: decoded, but "
                         f"{'cv2 reads no image' if ref is None else 'unequal to cv2'}")
            if keep:
                os.makedirs(keep, exist_ok=True)
                shutil.copy(path, os.path.join(keep, f"other_{len(other)}"
                                                     f"{os.path.splitext(path)[1]}"))
        else:
            outcomes["equal"] += 1

    def check_video(path, what, strict=False):
        cap = cv2.VideoCapture(path)
        ref = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            ref.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        cap.release()
        try:
            ours = list(video.iter_video_frames(path))
        except (ValueError, NotImplementedError) as e:
            if strict and ref:
                other.append(f"{what} as video: {type(e).__name__} where cv2 reads "
                             f"{len(ref)} frames: {e}")
                return
            outcomes[type(e).__name__] += 1
            return
        except Exception as e:  # noqa: BLE001  (reported, then the run fails)
            other.append(f"{what} as video: {type(e).__name__}: {e}")
            return
        if len(ours) != len(ref) or not all(np.array_equal(a, b) for a, b in zip(ours, ref)):
            other.append(f"{what} as video: {len(ours)} frames, cv2 {len(ref)}, unequal")
        else:
            outcomes["equal"] += 1

    def random_webp(k):
        h, w = int(rng.integers(1, 200)), int(rng.integers(1, 200))
        img = cv2.resize(rng.integers(0, 256, (h // 8 + 2, w // 8 + 2, 4), np.uint8), (w, h))
        if k % 5 == 0:
            img = rng.integers(0, 256, (h, w, 4), np.uint8)
        if k % 7 == 0:
            pal = rng.integers(0, 256, (int(rng.integers(1, 300)), 4), np.uint8)
            img = pal[rng.integers(0, len(pal), (h, w))]
        alpha = k % 3 == 0
        if not alpha:
            img[..., 3] = 255
        kind = k % 4
        if kind == 0:  # cv2's: lossy at a quality, or lossless at 101
            q = int(rng.integers(1, 102))
            ok, data = cv2.imencode(".webp", img[..., 2::-1] if not alpha else img[..., [2, 1, 0, 3]],
                                    [cv2.IMWRITE_WEBP_QUALITY, q])
            return data.tobytes()
        if kind == 3:  # the port's own
            return webp.encode(np.ascontiguousarray(img[..., :3]))
        buf = io.BytesIO()
        Image.fromarray(img if alpha else np.ascontiguousarray(img[..., :3])).save(
            buf, "WEBP", lossless=kind == 1, quality=int(rng.integers(0, 101)),
            method=int(rng.integers(0, 7)))
        return buf.getvalue()

    def random_gif():
        sw, sh = int(rng.integers(1, 60)), int(rng.integers(1, 60))
        n = int(rng.choice([2, 3, 4, 16, 32, 200, 256]))
        gpal = rng.integers(0, 256, (n, 3), np.uint8) if rng.random() < 0.8 else None
        images = []
        for _ in range(int(rng.integers(1, 5))):
            w, h = int(rng.integers(1, sw + 1)), int(rng.integers(1, sh + 1))
            lpal = (rng.integers(0, 256, (int(rng.choice([2, 8, 64, 256])), 3), np.uint8)
                    if gpal is None or rng.random() < 0.3 else None)
            m = len(lpal) if lpal is not None else n
            im = dict(idx=rng.integers(0, m, (h, w)), x=int(rng.integers(0, sw - w + 1)),
                      y=int(rng.integers(0, sh - h + 1)), lpal=lpal,
                      interlace=bool(rng.random() < 0.3))
            if rng.random() < 0.7:
                im.update(disposal=int(rng.integers(0, 4)), delay=int(rng.integers(0, 20)))
                if rng.random() < 0.6:
                    im["trans"] = int(rng.integers(0, m))
            if rng.random() < 0.15:
                im["extensions"] = [b"\x21\xfe\x03abc\x00"]
            images.append(im)
        bg = int(rng.integers(0, len(gpal))) if gpal is not None else 0
        return tool.gif_file(sw, sh, images, gpal, bg=bg)

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
            path = os.path.join(tmp, "s.webp")
            with open(path, "wb") as f:
                f.write(random_webp(k))
            check(path, f"WebP {k}", strict=True)
            check_video(path, f"WebP {k}", strict=True)
            path = os.path.join(tmp, "s.gif")
            with open(path, "wb") as f:
                f.write(random_gif())
            check(path, f"GIF {k}", strict=True)
            check_video(path, f"GIF {k}", strict=True)
        print(f"streams: {streams} RLE BMPs, LZW TIFFs, WebPs and GIFs (the last two also as "
              f"video), {outcomes}", flush=True)

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
            if name.startswith(("webp_", "gif_")):
                check_video(path, f"{name} kind {kind} at {at}")
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
    p.add_argument("--keep", help="a directory to copy each file with another outcome into")
    p.add_argument("--worker", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.worker:
        return worker(args.worker, args.streams, args.corrupt, args.seed, args.keep)
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
                           "--seed", str(args.seed)] + (["--keep", args.keep] if args.keep else []),
                          env=env).returncode


if __name__ == "__main__":
    sys.exit(main())
