"""Native host runtime, loaded with ctypes: the C++ triplet augmentation of
augment.cpp (port of fmvfi_tpu/native, with its own copy of the source),
the PNG row filters of png.cpp, the baseline JPEG decoder of jpeg.cpp and
the baseline JPEG encoder of jpeg_enc.cpp (all three for utils/imageio.py).

The library is built at first use, never at import, with `g++ -O3
-march=native -fPIC -shared -pthread`, into `build/fmvfi_tpu_torch/` at the
repository root (git-ignored) under a name keyed by a hash of the source
and flags; a second run with the same source loads the existing library.
This is host code: the crop, flips, time reversal, uint8 -> float32 and the
batch assembly of train.data.batch_iterator run in C++ threads outside the
interpreter lock, the PNG codec's row filters in C++ loops, and the JPEG
decoder and encoder (Huffman coding is a bit-serial recurrence) in C++.
`available()` says whether the library builds (a g++ is on PATH); the
functions raise RuntimeError when it does not.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "augment.cpp"
PNG_SOURCE = Path(__file__).resolve().parent / "png.cpp"
JPEG_SOURCE = Path(__file__).resolve().parent / "jpeg.cpp"
JPEG_ENC_SOURCE = Path(__file__).resolve().parent / "jpeg_enc.cpp"
FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None  # why the build failed, once it has
build_seconds: Optional[float] = None  # wall time of the last g++ run, if any

_U8P = ctypes.POINTER(ctypes.c_uint8)
_F32P = ctypes.POINTER(ctypes.c_float)
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64


def _sources() -> Tuple[Path, ...]:
    return SOURCE, PNG_SOURCE, JPEG_SOURCE, JPEG_ENC_SOURCE


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in _sources():
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfmvfi_native_{h.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    """Compile the sources into `path` through a private temporary name, so
    a reader never sees half a library."""
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = os.path.join(tmp, path.name)
        subprocess.run(["g++", *FLAGS, "-o", out, *map(str, _sources())], check=True,
                       capture_output=True, text=True, timeout=300)
        os.replace(out, path)
    build_seconds = time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The loaded library (built on the first call); raises RuntimeError,
    with the reason, when it does not build or load."""
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is None:
            path = library_path()
            try:
                if not path.exists():
                    _build(path)
                lib = ctypes.CDLL(str(path))
            except FileNotFoundError:
                _error = "g++ not found on PATH"
            except subprocess.CalledProcessError as e:
                _error = f"g++ failed ({e.returncode}):\n{e.stderr}"
            except (subprocess.TimeoutExpired, OSError) as e:
                _error = f"{type(e).__name__}: {e}"
            else:
                lib.fmvfi_augment_batch.argtypes = [
                    _U8P, _I32, _I32, _I32, _I32, ctypes.POINTER(_I32), _F32P, _F32P, _F32P,
                ]
                lib.fmvfi_augment_batch.restype = None
                lib.fmvfi_u8_to_f32.argtypes = [_U8P, _F32P, ctypes.c_int64]
                lib.fmvfi_u8_to_f32.restype = None
                lib.fmvfi_png_unfilter.argtypes = [_U8P, _I64, _I64, _I32, _U8P]
                lib.fmvfi_png_unfilter.restype = _I64
                lib.fmvfi_png_filter.argtypes = [_U8P, _I64, _I64, _I32, _U8P]
                lib.fmvfi_png_filter.restype = None
                for fn in (lib.fmvfi_jpeg_header, lib.fmvfi_jpeg_decode):
                    fn.argtypes = [_U8P, _I64, ctypes.c_void_p, ctypes.c_char_p, _I32]
                    fn.restype = _I32
                lib.fmvfi_jpeg_encode.argtypes = [_U8P, _I32, _I32, _I32, _I32, _U8P, _I64]
                lib.fmvfi_jpeg_encode.restype = _I64
                _lib = lib
                return _lib
        raise RuntimeError(f"the native library is unavailable: {_error}")


def available() -> bool:
    """Whether the library builds and loads (built on the first call)."""
    try:
        library()
    except RuntimeError:
        return False
    return True


def augment_batch(frames_u8: np.ndarray, crop: int, params: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """frames_u8: (B, 3, H, W, 3) uint8 RGB triplets; params (B, 5) ints of
    (y0, x0, hflip, vflip, tswap).  Returns three (B, crop, crop, 3) float32
    batches in [0, 1] (frame1, target, frame2), time reversal applied."""
    lib = library()
    frames_u8 = np.ascontiguousarray(frames_u8, dtype=np.uint8)
    params = np.ascontiguousarray(params, dtype=np.int32)
    if frames_u8.ndim != 5 or frames_u8.shape[1] != 3 or frames_u8.shape[4] != 3:
        raise ValueError(f"frames must be (B, 3, H, W, 3), got {frames_u8.shape}")
    b, _, h, w, _ = frames_u8.shape
    if params.shape != (b, 5):
        raise ValueError(f"params must be ({b}, 5), got {params.shape}")
    y0, x0 = params[:, 0], params[:, 1]
    if crop < 1 or (y0 < 0).any() or (x0 < 0).any() or (y0 + crop > h).any() \
            or (x0 + crop > w).any():
        raise ValueError(f"crops of {crop} at {params[:, :2].tolist()} leave {h}x{w} frames")
    outs = [np.empty((b, crop, crop, 3), np.float32) for _ in range(3)]
    lib.fmvfi_augment_batch(
        frames_u8.ctypes.data_as(_U8P), h, w, b, crop,
        params.ctypes.data_as(ctypes.POINTER(_I32)),
        *(o.ctypes.data_as(_F32P) for o in outs),
    )
    return tuple(outs)


def u8_to_f32(src: np.ndarray) -> np.ndarray:
    """uint8 -> float32 in [0, 1] (x / 255), any shape."""
    lib = library()
    src = np.ascontiguousarray(src, dtype=np.uint8)
    dst = np.empty(src.shape, np.float32)
    lib.fmvfi_u8_to_f32(src.ctypes.data_as(_U8P), dst.ctypes.data_as(_F32P), src.size)
    return dst


def png_unfilter(data: np.ndarray, rows: int, rowbytes: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters: `data` holds rows * (1 + rowbytes) uint8,
    each row its filter type and its filtered bytes; returns the (rows,
    rowbytes) image bytes.  bpp: max(1, bits per pixel // 8).  Raises
    ValueError on a filter type other than 0-4."""
    lib = library()
    data = np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
    if data.size != rows * (rowbytes + 1) or bpp < 1:
        raise ValueError(f"{data.size} bytes for {rows} rows of {rowbytes} (+1), bpp {bpp}")
    out = np.empty((rows, rowbytes), np.uint8)
    bad = lib.fmvfi_png_unfilter(data.ctypes.data_as(_U8P), rows, rowbytes, bpp,
                                 out.ctypes.data_as(_U8P))
    if bad >= 0:
        raise ValueError(f"row {bad} has filter type {data[bad * (rowbytes + 1)]}, not 0-4")
    return out


def png_filter(image: np.ndarray, bpp: int) -> np.ndarray:
    """The PNG row filters of a (rows, rowbytes) uint8 image, each row's
    chosen by libpng's heuristic (least sum of absolute signed bytes):
    (rows, 1 + rowbytes), each row its filter type and its filtered bytes."""
    lib = library()
    image = np.ascontiguousarray(image, dtype=np.uint8)
    if image.ndim != 2 or bpp < 1:
        raise ValueError(f"image must be (rows, rowbytes) with bpp >= 1, got {image.shape}, {bpp}")
    rows, rowbytes = image.shape
    out = np.empty((rows, rowbytes + 1), np.uint8)
    lib.fmvfi_png_filter(image.ctypes.data_as(_U8P), rows, rowbytes, bpp, out.ctypes.data_as(_U8P))
    return out


_JPEG_ERRORS = {1: NotImplementedError, 2: ValueError}
MAX_JPEG_PIXELS = 1 << 30  # cv2's limit (CV_IO_MAX_IMAGE_PIXELS)


def jpeg_decode(data: bytes) -> np.ndarray:
    """Decode a baseline JPEG file's bytes into an (H, W, 3) uint8 RGB array
    (grey repeated to three channels), bit-equal to libjpeg-turbo with its
    defaults.  Raises NotImplementedError for what jpeg.cpp does not decode
    (progressive, lossless, arithmetic-coded, 12-bit, CMYK, RGB-coded) and
    ValueError for a malformed or truncated file, each with the reason."""
    lib = library()
    buf = np.frombuffer(data, np.uint8)
    src = buf.ctypes.data_as(_U8P)
    msg = ctypes.create_string_buffer(256)
    info = np.zeros(3, np.int32)
    code = lib.fmvfi_jpeg_header(src, buf.size, info.ctypes.data, msg, len(msg))
    if code == 0:
        w, h, _ = (int(v) for v in info)
        if w * h > MAX_JPEG_PIXELS:
            raise ValueError(f"a {w}x{h} JPEG, over the {MAX_JPEG_PIXELS} pixels decoded")
        out = np.empty((h, w, 3), np.uint8)
        code = lib.fmvfi_jpeg_decode(src, buf.size, out.ctypes.data, msg, len(msg))
    if code:
        raise _JPEG_ERRORS[code](msg.value.decode("ascii", "replace"))
    return out


def jpeg_encode(image: np.ndarray, quality: int = 95) -> bytes:
    """An (H, W, 3) RGB or (H, W) grey uint8 image as the bytes of a
    baseline JPEG file, byte-equal to what cv2.imencode('.jpg') writes of
    the same pixels at IMWRITE_JPEG_QUALITY `quality` (1-100; 4:2:0 chroma,
    the standard Huffman tables)."""
    lib = library()
    image = np.ascontiguousarray(image, dtype=np.uint8)
    if image.ndim not in (2, 3) or (image.ndim == 3 and image.shape[2] != 3):
        raise ValueError(f"jpeg_encode takes (H, W, 3) or (H, W) uint8, got {image.shape}")
    h, w = image.shape[:2]
    if not (0 < h <= 65535 and 0 < w <= 65535):
        raise ValueError(f"a {w}x{h} image: JPEG sides are 1-65535")
    channels = 1 if image.ndim == 2 else 3
    # the most a block can code to: a DC symbol (<= 11 + 11 bits) and 63 AC
    # symbols (<= 16 + 10 bits each), every byte stuffed, in 8x8 blocks
    # (grey) or 16x16 MCUs of 6 blocks (4:2:0); 2048 bytes hold the headers
    if channels == 1:
        blocks = ((w + 7) // 8) * ((h + 7) // 8)
    else:
        blocks = 6 * ((w + 15) // 16) * ((h + 15) // 16)
    cap = 2 * -(-(22 + 63 * 26) // 8) * blocks + 2048
    out = np.empty(cap, np.uint8)  # only the file's bytes are touched
    n = lib.fmvfi_jpeg_encode(image.ctypes.data_as(_U8P), h, w, channels, int(quality),
                              out.ctypes.data_as(_U8P), cap)
    if n == 0:
        raise MemoryError(f"jpeg_encode: out of memory for a {w}x{h} image")
    if n < 0:
        raise RuntimeError(f"jpeg_encode: a {w}x{h} file of {-n} bytes, over its bound {cap}")
    return out[:n].tobytes()
