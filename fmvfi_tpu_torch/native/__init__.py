"""Native host runtime, loaded with ctypes: the C++ triplet augmentation of
augment.cpp (port of fmvfi_tpu/native, with its own copy of the source),
the PNG row filters of png.cpp (and swscale's route for a 16-bit PNG given
as video, for utils/image2.py), the JPEG decoder of jpeg.cpp (baseline and
progressive) and the baseline JPEG encoder of jpeg_enc.cpp (all three for
utils/imageio.py), the Motion-JPEG frame decoder of mjpeg.cpp (for
utils/avi.py), which shares jpeg.cpp's entropy decoder through
jpeg_common.h, and the MPEG-4 Part 2 decoder of mpeg4.cpp and encoder of
mpeg4_enc.cpp (for utils/mp4.py and utils/avi.py), which share FFmpeg's
IDCT and swscale's conversion with mjpeg.cpp through ffmpeg_common.h, and
the VP8 decoder of vp8.cpp (for utils/mkv.py) and the VP9 decoder of vp9.cpp
(for utils/mkv.py, mp4.py and avi.py), on the same conversion, the H.263
and Sorenson decoder of h263.cpp (for utils/avi.py, mp4.py and flv.py) and
the MS-MPEG4 decoder of msmpeg4.cpp (for utils/avi.py), which share
mpeg4.cpp's mpegvideo core through h263_common.h; and the
still-image codecs behind utils/bmp.py (run-length BMP data, bmp.cpp) and
utils/tiff.py (LZW and PackBits strips, tiff.cpp).

The library is built at first use, never at import, with `g++ -O3
-march=native -fPIC -pthread` a source (all at once) and a `-shared` link,
into `build/fmvfi_tpu_torch/` at the
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
import math
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
MJPEG_SOURCE = Path(__file__).resolve().parent / "mjpeg.cpp"
MPEG4_SOURCES = tuple(Path(__file__).resolve().parent / f for f in ("mpeg4.cpp", "mpeg4_enc.cpp"))
VP8_SOURCE = Path(__file__).resolve().parent / "vp8.cpp"
VP9_SOURCE = Path(__file__).resolve().parent / "vp9.cpp"
MPEG12_SOURCE = Path(__file__).resolve().parent / "mpeg12.cpp"
H263_SOURCES = tuple(Path(__file__).resolve().parent / f for f in ("h263.cpp", "msmpeg4.cpp"))
RAW_SOURCE = Path(__file__).resolve().parent / "rawvideo.cpp"
STILL_SOURCES = tuple(Path(__file__).resolve().parent / f
                      for f in ("bmp.cpp", "tiff.cpp", "webp.cpp", "gif.cpp"))
HEADERS = tuple(Path(__file__).resolve().parent / h
                for h in ("jpeg_common.h", "ffmpeg_common.h", "h263_common.h", "mpeg4.h",
                          "vpx_rac.h"))
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
    return (SOURCE, PNG_SOURCE, JPEG_SOURCE, JPEG_ENC_SOURCE, MJPEG_SOURCE) + MPEG4_SOURCES + (
        VP8_SOURCE, VP9_SOURCE, MPEG12_SOURCE, RAW_SOURCE) + H263_SOURCES + STILL_SOURCES


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in _sources() + HEADERS:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfmvfi_native_{h.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    """Compile the sources into `path` through a private temporary name, so
    a reader never sees half a library: one g++ a source, all started
    together, then the link."""
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    compile_flags = [f for f in FLAGS if f != "-shared"]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, f"{src.stem}.o") for src in _sources()]
        cmds = [["g++", *compile_flags, "-c", "-o", obj, str(src)]
                for src, obj in zip(_sources(), objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for cmd in cmds]
        try:
            for cmd, proc in zip(cmds, procs):
                _, err = proc.communicate(timeout=300)
                if proc.returncode:
                    raise subprocess.CalledProcessError(proc.returncode, cmd, stderr=err)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        out = os.path.join(tmp, path.name)
        subprocess.run(["g++", *FLAGS, "-o", out, *objs], check=True, capture_output=True,
                       text=True, timeout=300)
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
                lib.fmvfi_png16_swscale.argtypes = [ctypes.c_void_p, _I64, _I32, _U8P]
                lib.fmvfi_png16_swscale.restype = None
                lib.fmvfi_yuv420p_swscale.argtypes = [_U8P, _U8P, _U8P, _I32, _I32, _U8P]
                lib.fmvfi_yuv420p_swscale.restype = None
                lib.fmvfi_yuv16_swscale.argtypes = [ctypes.c_void_p] * 3 + [_I32] * 6 + [_U8P]
                lib.fmvfi_yuv16_swscale.restype = None
                for fn in (lib.fmvfi_jpeg_header, lib.fmvfi_jpeg_decode, lib.fmvfi_mjpeg_decode):
                    fn.argtypes = [_U8P, _I64, ctypes.c_void_p, ctypes.c_char_p, _I32]
                    fn.restype = _I32
                lib.fmvfi_jpeg_decode_strip.argtypes = [_U8P, _I64, ctypes.c_void_p, _I32,
                                                        ctypes.c_char_p, _I32]
                lib.fmvfi_jpeg_decode_strip.restype = _I32
                lib.fmvfi_jpeg_encode.argtypes = [_U8P, _I32, _I32, _I32, _I32, _U8P, _I64]
                lib.fmvfi_jpeg_encode.restype = _I64
                _bind_mpeg4(lib)
                _bind_vp8(lib)
                _bind_vp9(lib)
                _bind_mpeg12(lib)
                _bind_h263(lib)
                _bind_stills(lib)
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


def png16_swscale(samples: np.ndarray) -> np.ndarray:
    """(H, W, spp) 16-bit PNG samples (spp 1-2 grey, 3-4 RGB; alpha ignored)
    as cv2.VideoCapture hands them on through FFmpeg and swscale (png.cpp):
    (H, W, 3) uint8 RGB, within a level of their high bytes."""
    lib = library()
    samples = np.ascontiguousarray(samples, dtype=np.uint16)
    h, w, spp = samples.shape
    if spp not in (1, 2, 3, 4):
        raise ValueError(f"png16_swscale takes 1-4 samples a pixel, got {spp}")
    out = np.empty((h, w, 3), np.uint8)
    lib.fmvfi_png16_swscale(samples.ctypes.data, h * w, spp, out.ctypes.data_as(_U8P))
    return out


def yuv420p_swscale(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """A yuv420p frame's planes (uint8 Y (h, w), U and V ((h + 1) // 2,
    (w + 1) // 2)) as cv2.VideoCapture hands them on through swscale
    (BT.601, limited range; rawvideo.cpp): (h, w, 3) uint8 RGB."""
    lib = library()
    h, w = y.shape
    planes = [np.ascontiguousarray(p, dtype=np.uint8) for p in (y, u, v)]
    for p in planes[1:]:
        if p.shape != ((h + 1) // 2, (w + 1) // 2):
            raise ValueError(f"chroma planes of {p.shape} for a {w}x{h} yuv420p frame")
    out = np.empty((h, w, 3), np.uint8)
    lib.fmvfi_yuv420p_swscale(*(p.ctypes.data_as(_U8P) for p in planes), w, h,
                              out.ctypes.data_as(_U8P))
    return out


def yuv16_swscale(y: np.ndarray, u: np.ndarray, v: np.ndarray, depth: int,
                  full_range: bool = False) -> np.ndarray:
    """Planes of `depth` bits in uint16 (Y (h, w), U and V at their
    subsampling, told by their shapes) as swscale converts them to BGR24
    for cv2 (BT.601; rawvideo.cpp): (h, w, 3) uint8 RGB.  Depth 8 takes the
    8-bit formats' routes (yuv420p, yuv440p, ...)."""
    lib = library()
    h, w = y.shape
    planes = [np.ascontiguousarray(p, dtype=np.uint16) for p in (y, u, v)]
    ss_x, ss_y = int(u.shape[1] < w), int(u.shape[0] < h)
    if u.shape != v.shape or u.shape != ((h + ss_y) >> ss_y, (w + ss_x) >> ss_x):
        raise ValueError(f"chroma planes of {u.shape} and {v.shape} for a {w}x{h} frame")
    out = np.empty((h, w, 3), np.uint8)
    lib.fmvfi_yuv16_swscale(*(p.ctypes.data for p in planes), w, h, ss_x, ss_y, depth,
                            int(full_range), out.ctypes.data_as(_U8P))
    return out


class EndOfStream(Exception):
    """A packet on which FFmpeg's decoder fails, so that cv2.VideoCapture
    stops reading the file there (Mpeg4Decoder: a packet without a VOP)."""


_JPEG_ERRORS = {1: NotImplementedError, 2: ValueError, 3: EndOfStream}
MAX_JPEG_PIXELS = 1 << 30  # cv2's limit (CV_IO_MAX_IMAGE_PIXELS)


def jpeg_decode(data: bytes) -> np.ndarray:
    """Decode a baseline or progressive JPEG file's bytes into an (H, W, 3)
    uint8 RGB array (grey repeated to three channels), bit-equal to
    libjpeg-turbo with its defaults.  Raises NotImplementedError for what
    jpeg.cpp does not decode (lossless, arithmetic-coded, 12-bit, CMYK,
    RGB-coded) and ValueError for a malformed or truncated file, each with
    the reason."""
    return _decode(data, library().fmvfi_jpeg_decode)


def mjpeg_decode(data: bytes) -> np.ndarray:
    """Decode a Motion-JPEG frame's bytes into an (H, W, 3) uint8 RGB array
    as cv2.VideoCapture decodes it (FFmpeg's decoder and swscale's
    conversion, mjpeg.cpp), not as cv2.imdecode does.  Raises as
    jpeg_decode, and NotImplementedError for a progressive frame or a
    sampling other than 4:2:0, 4:2:2 and 4:4:4."""
    return _decode(data, library().fmvfi_mjpeg_decode)


def jpeg_decode_strip(data: bytes, ycbcr: bool) -> np.ndarray:
    """Decode one strip or tile of a JPEG-compressed TIFF (the JPEGTables
    segments before its own) as libtiff's JPEG codec has libjpeg-turbo
    decode it: (H, W, components) as the components decode, or with ycbcr
    (H, W, 3) RGB converted from YCbCr.  Raises as jpeg_decode."""
    lib = library()
    return _decode(data, lambda src, n, out, msg, size: lib.fmvfi_jpeg_decode_strip(
        src, n, out, int(ycbcr), msg, size), channels=None if not ycbcr else 3)


def _decode(data: bytes, decode, channels=3) -> np.ndarray:
    """The file's pixels through `decode`, into (H, W, channels); channels
    None: the file's own number of components."""
    lib = library()
    buf = np.frombuffer(data, np.uint8)
    src = buf.ctypes.data_as(_U8P)
    msg = ctypes.create_string_buffer(256)
    info = np.zeros(3, np.int32)
    code = lib.fmvfi_jpeg_header(src, buf.size, info.ctypes.data, msg, len(msg))
    if code == 0:
        w, h, ncomp = (int(v) for v in info)
        if w * h > MAX_JPEG_PIXELS:
            raise ValueError(f"a {w}x{h} JPEG, over the {MAX_JPEG_PIXELS} pixels decoded")
        out = np.empty((h, w, channels or ncomp), np.uint8)
        code = decode(src, buf.size, out.ctypes.data, msg, len(msg))
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


_VP = ctypes.c_void_p


def _bind_stills(lib: ctypes.CDLL) -> None:
    lib.fmvfi_bmp_rle.argtypes = [_VP, _I64, _I32, _I32, _I32, _VP, ctypes.c_char_p, _I32]
    lib.fmvfi_bmp_rle.restype = _I32
    for fn in (lib.fmvfi_tiff_lzw_decode, lib.fmvfi_tiff_packbits_decode):
        fn.argtypes = [_VP, _I64, _VP, _I64, ctypes.c_char_p, _I32]
        fn.restype = _I32
    lib.fmvfi_tiff_lzw_encode.argtypes = [_VP, _I64, _VP, _I64]
    lib.fmvfi_tiff_lzw_encode.restype = _I64
    lib.fmvfi_webp_yuv_rgb.argtypes = [_VP, _VP, _VP, _I64, _I64, _I32, _I32, _VP]
    lib.fmvfi_webp_yuv_rgb.restype = None
    lib.fmvfi_vp8l_decode.argtypes = [_VP, _I64, _I32, _VP, _I64, _VP, ctypes.c_char_p, _I32]
    lib.fmvfi_vp8l_decode.restype = _I32
    lib.fmvfi_vp8l_decode_image.argtypes = [_VP, _I64, _I32, _I32, _VP, ctypes.c_char_p, _I32]
    lib.fmvfi_vp8l_decode_image.restype = _I32
    lib.fmvfi_vp8l_encode.argtypes = [_VP, _I32, _I32, _VP, _I64]
    lib.fmvfi_vp8l_encode.restype = _I64
    lib.fmvfi_gif_lzw.argtypes = [_VP, _I64, _I32, _I32, _VP, _I64, ctypes.c_char_p, _I32]
    lib.fmvfi_gif_lzw.restype = _I64


def bmp_rle(data: bytes, bits: int, width: int, height: int) -> np.ndarray:
    """Decode BI_RLE8 (bits 8) or BI_RLE4 (bits 4) pixel data into (height,
    width) uint8 palette indices in stored row order, as OpenCV's BMP
    decoder does (bmp.cpp); ValueError for data that runs past a row or
    ends before the last one."""
    lib = library()
    buf = np.frombuffer(data, np.uint8)
    out = np.zeros((height, width), np.uint8)
    msg = ctypes.create_string_buffer(256)
    if lib.fmvfi_bmp_rle(buf.ctypes.data, buf.size, bits, width, height, out.ctypes.data, msg,
                         len(msg)):
        raise ValueError(msg.value.decode("ascii", "replace"))
    return out


def tiff_decode(data: bytes, method: str, size: int) -> np.ndarray:
    """One TIFF strip or tile of `method` ("lzw" or "packbits") decoded into
    `size` bytes, as libtiff decodes it (tiff.cpp); ValueError for corrupt
    data or data that ends before `size` bytes."""
    lib = library()
    fn = lib.fmvfi_tiff_lzw_decode if method == "lzw" else lib.fmvfi_tiff_packbits_decode
    buf = np.frombuffer(data, np.uint8)
    out = np.empty(size, np.uint8)
    msg = ctypes.create_string_buffer(256)
    if fn(buf.ctypes.data, buf.size, out.ctypes.data, size, msg, len(msg)):
        raise ValueError(msg.value.decode("ascii", "replace"))
    return out


def tiff_lzw_encode(data) -> bytes:
    """One TIFF strip's bytes LZW-coded as libtiff codes them (tiff.cpp):
    Clear first, EOI last, byte-equal to what cv2.imwrite writes."""
    lib = library()
    buf = np.ascontiguousarray(np.frombuffer(data, np.uint8) if isinstance(data, bytes)
                               else data, dtype=np.uint8).reshape(-1)
    cap = 2 * buf.size + 16
    out = np.empty(cap, np.uint8)
    n = lib.fmvfi_tiff_lzw_encode(buf.ctypes.data, buf.size, out.ctypes.data, cap)
    if n < 0:
        raise RuntimeError(f"tiff_lzw_encode: {buf.size} bytes overran their bound {cap}")
    return out[:n].tobytes()


def webp_yuv_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """A lossy WebP's decoded planes (Y (h, w), U and V ((h + 1) // 2,
    (w + 1) // 2)) as libwebp's fancy upsampling and YUV -> RGB conversion
    give them to cv2.imread (webp.cpp): (h, w, 3) uint8 RGB."""
    lib = library()
    y, u, v = (np.ascontiguousarray(p, dtype=np.uint8) for p in (y, u, v))
    h, w = y.shape
    if u.shape != ((h + 1) // 2, (w + 1) // 2) or v.shape != u.shape:
        raise ValueError(f"planes {y.shape}, {u.shape}, {v.shape}: not 4:2:0")
    out = np.empty((h, w, 3), np.uint8)
    lib.fmvfi_webp_yuv_rgb(y.ctypes.data, u.ctypes.data, v.ctypes.data, w, u.shape[1], w, h,
                           out.ctypes.data)
    return out


# webp.cpp's feature bits (vp8l_decode's second value): what a VP8L stream uses
VP8L_FEATURES = dict(predictor=1, cross_color=2, subtract_green=4, color_indexing=8,
                     color_cache=16, meta_codes=32, backward_refs=64, simple_code=128,
                     bundled=256)
MAX_WEBP_PIXELS = 1 << 30


def vp8l_decode(data: bytes, ffmpeg: bool = False) -> Tuple[np.ndarray, int]:
    """A VP8L (lossless WebP) bitstream decoded (webp.cpp) as libwebp decodes
    it, or with ffmpeg as FFmpeg's vp8l decoder does (the two part only on
    streams no encoder writes: a colour cache read of an empty entry, a
    predictor mode past 13): ((h, w) uint32 ARGB, the feature bits of
    VP8L_FEATURES it used); ValueError for a malformed stream, with the
    reason."""
    lib = library()
    buf = np.frombuffer(data, np.uint8)
    info = np.zeros(3, np.int32)
    msg = ctypes.create_string_buffer(256)
    if lib.fmvfi_vp8l_decode(buf.ctypes.data, buf.size, int(ffmpeg), None, 0, info.ctypes.data,
                             msg, len(msg)):
        raise ValueError(msg.value.decode("ascii", "replace"))
    w, h = int(info[0]), int(info[1])
    if w * h > MAX_WEBP_PIXELS:
        raise ValueError(f"a {w}x{h} VP8L image, over the {MAX_WEBP_PIXELS} pixels decoded")
    out = np.empty((h, w), np.uint32)
    if lib.fmvfi_vp8l_decode(buf.ctypes.data, buf.size, int(ffmpeg), out.ctypes.data, out.size,
                             info.ctypes.data, msg, len(msg)):
        raise ValueError(msg.value.decode("ascii", "replace"))
    return out, int(info[2])


def vp8l_decode_image(data: bytes, width: int, height: int) -> np.ndarray:
    """A VP8L image stream without the 5-byte header, of the size given (a
    lossy WebP's ALPH data), decoded (webp.cpp): (height, width) uint32
    ARGB; ValueError for a malformed stream."""
    lib = library()
    buf = np.frombuffer(data, np.uint8)
    out = np.empty((height, width), np.uint32)
    msg = ctypes.create_string_buffer(256)
    if lib.fmvfi_vp8l_decode_image(buf.ctypes.data, buf.size, width, height, out.ctypes.data, msg,
                                   len(msg)):
        raise ValueError(msg.value.decode("ascii", "replace"))
    return out


def vp8l_encode(image: np.ndarray) -> bytes:
    """An (H, W, 3) uint8 RGB image as a VP8L bitstream (webp.cpp:
    subtract-green, the predictor transform and a colour cache), which
    decodes to the same pixels; sides 1-16384."""
    lib = library()
    image = np.ascontiguousarray(image, dtype=np.uint8)
    h, w = image.shape[:2]
    if image.ndim != 3 or image.shape[2] != 3 or not (0 < h <= 16384 and 0 < w <= 16384):
        raise ValueError(f"vp8l_encode takes (H, W, 3) uint8 of sides 1-16384, got {image.shape}")
    # a literal costs at most 4 x 15 bits; the codes and the mode image 64 KiB
    cap = 8 * h * w + (1 << 16)
    out = np.empty(cap, np.uint8)
    n = lib.fmvfi_vp8l_encode(image.ctypes.data, w, h, out.ctypes.data, cap)
    if n == -2:
        raise MemoryError(f"vp8l_encode: out of memory for a {w}x{h} image")
    if n < 0:
        raise RuntimeError(f"vp8l_encode: a {w}x{h} image overran its bound {cap}")
    return out[:n].tobytes()


def gif_lzw(data: bytes, min_code: int, npix: int, strict: bool = False) -> np.ndarray:
    """A GIF image's LZW data (its sub-blocks joined) decoded into `npix`
    palette indices (gif.cpp), as FFmpeg decodes it, or with strict as
    OpenCV's decoder does (the data must end with the last pixel);
    ValueError for a code past the table, a minimum code size outside 1-8,
    data that ends first or (strict) goes on after."""
    lib = library()
    buf = np.frombuffer(data, np.uint8)
    out = np.empty(npix, np.uint8)
    msg = ctypes.create_string_buffer(256)
    if lib.fmvfi_gif_lzw(buf.ctypes.data, buf.size, int(min_code), int(strict), out.ctypes.data,
                         npix, msg, len(msg)) < 0:
        raise ValueError(msg.value.decode("ascii", "replace"))
    return out


def _bind_mpeg4(lib: ctypes.CDLL) -> None:
    lib.fmvfi_mpeg4_open.argtypes = [ctypes.c_uint32, _VP, _I64, ctypes.c_char_p, _I32,
                                     ctypes.POINTER(_I32)]
    lib.fmvfi_mpeg4_open.restype = _VP
    lib.fmvfi_mpeg4_decode.argtypes = [_VP, _VP, _I64, _VP, ctypes.c_char_p, _I32]
    lib.fmvfi_mpeg4_decode.restype = _I32
    lib.fmvfi_mpeg4_frame.argtypes = [_VP, _VP]
    lib.fmvfi_mpeg4_frame.restype = None
    lib.fmvfi_mpeg4_close.argtypes = [_VP]
    lib.fmvfi_mpeg4_close.restype = None
    lib.fmvfi_mpeg4_enc_open.argtypes = [_I32] * 8 + [ctypes.c_char_p, _I32, ctypes.POINTER(_I32)]
    lib.fmvfi_mpeg4_enc_open.restype = _VP
    lib.fmvfi_mpeg4_enc_config.argtypes = [_VP, _VP, _I64]
    lib.fmvfi_mpeg4_enc_config.restype = _I64
    lib.fmvfi_mpeg4_enc_frame.argtypes = [_VP, _VP, ctypes.c_char_p, _I32]
    lib.fmvfi_mpeg4_enc_frame.restype = _I64
    lib.fmvfi_mpeg4_enc_take.argtypes = [_VP, _VP]
    lib.fmvfi_mpeg4_enc_take.restype = None
    lib.fmvfi_mpeg4_enc_recon.argtypes = [_VP, _VP]
    lib.fmvfi_mpeg4_enc_recon.restype = None
    lib.fmvfi_mpeg4_enc_close.argtypes = [_VP]
    lib.fmvfi_mpeg4_enc_close.restype = None


def _bind_vp8(lib: ctypes.CDLL) -> None:
    lib.fmvfi_vp8_open.argtypes = [ctypes.c_char_p, _I32, ctypes.POINTER(_I32)]
    lib.fmvfi_vp8_open.restype = _VP
    lib.fmvfi_vp8_decode.argtypes = [_VP, _VP, _I64, _I64, _VP, ctypes.c_char_p, _I32]
    lib.fmvfi_vp8_decode.restype = _I32
    for fn in (lib.fmvfi_vp8_frame, lib.fmvfi_vp8_close, lib.fmvfi_vp8_planes):
        fn.restype = None
    lib.fmvfi_vp8_frame.argtypes = [_VP, _VP]
    lib.fmvfi_vp8_planes.argtypes = [_VP, _VP, _VP, _VP]
    lib.fmvfi_vp8_libwebp.argtypes = [_VP, _I32]
    lib.fmvfi_vp8_libwebp.restype = None
    lib.fmvfi_vp8_close.argtypes = [_VP]


def _bind_vp9(lib: ctypes.CDLL) -> None:
    lib.fmvfi_vp9_open.argtypes = [ctypes.c_char_p, _I32, ctypes.POINTER(_I32)]
    lib.fmvfi_vp9_open.restype = _VP
    lib.fmvfi_vp9_decode.argtypes = [_VP, _VP, _I64, _VP, ctypes.c_char_p, _I32]
    lib.fmvfi_vp9_decode.restype = _I32
    for fn in (lib.fmvfi_vp9_frame, lib.fmvfi_vp9_planes, lib.fmvfi_vp9_close):
        fn.restype = None
    lib.fmvfi_vp9_frame.argtypes = [_VP, _I32, _VP]
    lib.fmvfi_vp9_planes.argtypes = [_VP, _I32, _VP, _VP, _VP]
    lib.fmvfi_vp9_close.argtypes = [_VP]


def _bind_mpeg12(lib: ctypes.CDLL) -> None:
    lib.fmvfi_mpeg12_open.argtypes = [_VP, _I64, ctypes.c_char_p, _I32, ctypes.POINTER(_I32)]
    lib.fmvfi_mpeg12_open.restype = _VP
    lib.fmvfi_mpeg12_decode.argtypes = [_VP, _VP, _I64, _VP, ctypes.c_char_p, _I32]
    lib.fmvfi_mpeg12_decode.restype = _I32
    lib.fmvfi_mpeg12_flush.argtypes = [_VP, _VP]
    lib.fmvfi_mpeg12_flush.restype = _I32
    for fn in (lib.fmvfi_mpeg12_frame, lib.fmvfi_mpeg12_close):
        fn.restype = None
    lib.fmvfi_mpeg12_frame.argtypes = [_VP, _VP]
    lib.fmvfi_mpeg12_close.argtypes = [_VP]


def _bind_h263(lib: ctypes.CDLL) -> None:
    for name in ("h263", "msmpeg4"):
        opener = getattr(lib, f"fmvfi_{name}_open")
        opener.argtypes = [_I32, ctypes.c_char_p, _I32, ctypes.POINTER(_I32)]
        opener.restype = _VP
        dec = getattr(lib, f"fmvfi_{name}_decode")
        dec.argtypes = [_VP, _VP, _I64, _VP, ctypes.c_char_p, _I32]
        dec.restype = _I32
        for fn in ("frame", "close"):
            getattr(lib, f"fmvfi_{name}_{fn}").restype = None
        getattr(lib, f"fmvfi_{name}_frame").argtypes = [_VP, _VP]
        getattr(lib, f"fmvfi_{name}_close").argtypes = [_VP]
    lib.fmvfi_msmpeg4_set_size.argtypes = [_VP, _I32, _I32]
    lib.fmvfi_msmpeg4_set_size.restype = _I32


def _fourcc_int(fourcc: bytes) -> int:
    return int.from_bytes(fourcc.ljust(4, b"\0")[:4], "little") if fourcc else 0


class Mpeg4Decoder:
    """An MPEG-4 Part 2 video stream decoded as cv2.VideoCapture decodes it
    (FFmpeg's mpeg4 decoder and swscale's yuv420p -> BGR24 conversion,
    mpeg4.cpp): `decode(packet)` takes one container sample (headers and at
    most one VOP) and returns the frame it yields, (H, W, 3) uint8 RGB, or
    None for a packet of headers alone.  `config` is the out-of-band
    configuration (an MP4 file's esds DecoderSpecificInfo) and `fourcc`
    the container's codec tag, upper-cased as FFmpeg reads it (it picks
    FFmpeg's Xvid / DivX behaviour when no user data names the encoder).
    Raises NotImplementedError for what FFmpeg decodes differently or with
    workarounds (mpeg4.cpp lists it), ValueError for a malformed stream and
    EndOfStream for a packet without a VOP (headers alone or a short video
    header picture: FFmpeg fails it and cv2 reads no further), each with the
    reason."""

    def __init__(self, config: bytes = b"", fourcc: bytes = b""):
        lib = library()
        self._lib = lib
        self._msg = ctypes.create_string_buffer(256)
        code = _I32(0)
        buf = np.frombuffer(config, np.uint8) if config else np.zeros(1, np.uint8)
        self._h = lib.fmvfi_mpeg4_open(_fourcc_int(fourcc.upper()), buf.ctypes.data, len(config),
                                       self._msg, len(self._msg), ctypes.byref(code))
        if not self._h:
            raise _JPEG_ERRORS[code.value](self._msg.value.decode("ascii", "replace"))
        self._info = np.zeros(5, np.int32)
        self.vop_type = ""  # of the last frame: "I" or "P"
        self.rounding = 0  # its vop_rounding_type

    def decode(self, packet: bytes) -> Optional[np.ndarray]:
        buf = np.frombuffer(packet, np.uint8)
        code = self._lib.fmvfi_mpeg4_decode(self._h, buf.ctypes.data, buf.size,
                                            self._info.ctypes.data, self._msg, len(self._msg))
        if code:
            raise _JPEG_ERRORS[code](self._msg.value.decode("ascii", "replace"))
        w, h, got, vop, self.rounding = (int(v) for v in self._info)
        if not got:
            return None
        self.vop_type = chr(vop)
        out = np.empty((h, w, 3), np.uint8)
        self._lib.fmvfi_mpeg4_frame(self._h, out.ctypes.data)
        return out

    def close(self) -> None:
        if self._h:
            self._lib.fmvfi_mpeg4_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


class Mpeg4Encoder:
    """An MPEG-4 Part 2 Simple Profile encoder (mpeg4_enc.cpp) for
    (height, width, 3) uint8 RGB frames: an I-VOP every `gop` frames,
    P-VOPs between, a fixed `quant` (vop_quant, 1-31).  `fps` becomes the
    VOL's time resolution and frame increment (resolution / increment).
    `in_band` repeats the VOS/VO/VOL headers before each I-VOP (AVI), else
    they are only in `config` (MP4's esds).  `encode(frame)` returns the
    frame's packet; `reconstruction()` the frame as any decoder of the
    stream (cv2 included) returns it.  `options` (mpeg4_enc.cpp's FOUR_MV
    1, DQUANT 2, AC_PRED 4, DC_AS_AC 8) codes with paths the default does
    not use."""

    def __init__(self, width: int, height: int, fps: float = 30, quant: int = 3, gop: int = 12,
                 in_band: bool = True, options: int = 0):
        lib = library()
        self._lib = lib
        self._msg = ctypes.create_string_buffer(256)
        self.width, self.height = int(width), int(height)
        self.resolution, self.increment = _vol_rate(fps)
        code = _I32(0)
        self._h = lib.fmvfi_mpeg4_enc_open(self.width, self.height, self.resolution,
                                           self.increment, int(quant), int(gop), int(in_band),
                                           int(options), self._msg, len(self._msg),
                                           ctypes.byref(code))
        if not self._h:
            raise ValueError(self._msg.value.decode("ascii", "replace"))
        n = lib.fmvfi_mpeg4_enc_config(self._h, None, 0)
        cfg = np.empty(n, np.uint8)
        lib.fmvfi_mpeg4_enc_config(self._h, cfg.ctypes.data, n)
        self.config = cfg.tobytes()

    def encode(self, frame: np.ndarray) -> bytes:
        frame = np.ascontiguousarray(frame, dtype=np.uint8)
        if frame.shape != (self.height, self.width, 3):
            raise ValueError(f"a frame of {frame.shape}, the stream is "
                             f"({self.height}, {self.width}, 3)")
        n = self._lib.fmvfi_mpeg4_enc_frame(self._h, frame.ctypes.data, self._msg, len(self._msg))
        if n < 0:
            raise ValueError(self._msg.value.decode("ascii", "replace"))
        out = np.empty(n, np.uint8)
        self._lib.fmvfi_mpeg4_enc_take(self._h, out.ctypes.data)
        return out.tobytes()

    def reconstruction(self) -> np.ndarray:
        out = np.empty((self.height, self.width, 3), np.uint8)
        self._lib.fmvfi_mpeg4_enc_recon(self._h, out.ctypes.data)
        return out

    def close(self) -> None:
        if self._h:
            self._lib.fmvfi_mpeg4_enc_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


# vp8.cpp's feature bits (Vp8Decoder.info["features"]): what a frame's
# header and macroblocks use
VP8_FEATURES = dict(segmentation=1, segment_map=2, keep_probs=4, golden=8, altref=16,
                    sign_bias=32, splitmv=64, lf_deltas=128, simple_filter=256,
                    intra_in_inter=512, bpred_in_inter=1024, golden_altref_refs=2048)


class Vp8Decoder:
    """A VP8 video stream decoded as cv2.VideoCapture decodes it (FFmpeg's
    vp8 decoder and swscale's yuv420p -> BGR24 conversion, vp8.cpp):
    `decode(frame)` takes one frame's bytes (a Matroska / WebM block) and
    returns the picture it shows, (H, W, 3) uint8 RGB, or None for a frame
    with show_frame 0 (an alt-ref frame, decoded into the references only);
    `planes()` returns the frame's Y, U and V planes before the conversion
    (for a lossy WebP, which libwebp converts otherwise: utils/webp.py).
    `libwebp`: decode a key frame as libwebp does at the data's ends (the
    last partition running on through `after`, a read past a partition's
    end an error; vp8.cpp), as cv2.imread's lossy WebP.
    After each call `info` holds the frame's header facts (key frame,
    version, token partitions, vp8.cpp's feature bits: VP8_FEATURES).
    Raises NotImplementedError for what vp8.cpp refuses and ValueError for
    malformed data, each with the reason."""

    INFO = ("width", "height", "shown", "keyframe", "version", "partitions", "features")

    def __init__(self, libwebp: bool = False):
        lib = library()
        self._lib = lib
        self._msg = ctypes.create_string_buffer(256)
        code = _I32(0)
        self._h = lib.fmvfi_vp8_open(self._msg, len(self._msg), ctypes.byref(code))
        if not self._h:
            raise _JPEG_ERRORS[code.value](self._msg.value.decode("ascii", "replace"))
        lib.fmvfi_vp8_libwebp(self._h, int(libwebp))
        self._info = np.zeros(len(self.INFO), np.int32)
        self.info = {}

    def decode(self, frame: bytes, after: bytes = b"") -> Optional[np.ndarray]:
        """`after`: the bytes that follow the frame where it lies (a WebP
        file's after its VP8 chunk), which FFmpeg's range decoder may read
        past the last partition's end; zeros by default, as a packet's
        padding."""
        buf = np.frombuffer(frame + after, np.uint8)
        code = self._lib.fmvfi_vp8_decode(self._h, buf.ctypes.data, len(frame), len(after),
                                          self._info.ctypes.data, self._msg, len(self._msg))
        if code:
            raise _JPEG_ERRORS[code](self._msg.value.decode("ascii", "replace"))
        self.info = dict(zip(self.INFO, (int(v) for v in self._info)))
        if not self.info["shown"]:
            return None
        out = np.empty((self.info["height"], self.info["width"], 3), np.uint8)
        self._lib.fmvfi_vp8_frame(self._h, out.ctypes.data)
        return out

    def planes(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The last decoded frame's Y, U and V planes before swscale, cropped
        to its size: (h, w), and ((h + 1) // 2, (w + 1) // 2) twice."""
        h, w = self.info["height"], self.info["width"]
        y = np.empty((h, w), np.uint8)
        u, v = (np.empty(((h + 1) // 2, (w + 1) // 2), np.uint8) for _ in range(2))
        self._lib.fmvfi_vp8_planes(self._h, y.ctypes.data, u.ctypes.data, v.ctypes.data)
        return y, u, v

    def close(self) -> None:
        if self._h:
            self._lib.fmvfi_vp8_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


# vp9.cpp's feature bits (Vp9Decoder.info["features"]): what a packet's
# frames use
VP9_FEATURES = dict(
    superframe=1, hidden=2, show_existing=4, compound=8, tile_cols=16, tile_rows=32, lossless=64,
    segmentation=128, seg_temporal=256, error_resilient=512, frame_parallel=1024, sharpness=2048,
    switchable=4096, tx_select=8192, sub8x8_inter=16384, tx32=32768, high_precision_mv=65536,
    smooth=1 << 17, sharp=1 << 18, bilinear=1 << 19, seg_feature=1 << 21, prev_mvs=1 << 22,
    full_range=1 << 23, intra_in_inter=1 << 24, golden_altref=1 << 25, adapt=1 << 26,
    context_reset=1 << 27)


class Vp9Decoder:
    """A VP9 video stream decoded as cv2.VideoCapture decodes it (FFmpeg's
    vp9 decoder and swscale's conversion to BGR24, vp9.cpp):
    `decode(packet)` takes one container packet (a frame, or a superframe of
    several) and returns the pictures it shows, each (H, W, 3) uint8 RGB: none
    for a hidden frame, the reference it names for a show_existing_frame.
    After each call `info` holds the packet's facts (the last shown frame's
    size, the profile, chroma subsampling, colour space and range, tile
    columns and rows as log2, key frame, vp9.cpp's feature bits:
    VP9_FEATURES, bits a sample: 8, 10 or 12, profiles 0-3) and `planes(i)`
    returns the i-th shown frame's Y, U, V planes before the conversion
    (uint16).  Raises NotImplementedError for what vp9.cpp refuses
    (reference scaling, intra-only frames, the sRGB colour space) and
    ValueError for malformed data, each with the reason."""

    INFO = ("frames", "width", "height", "profile", "ss_x", "ss_y", "color_space", "color_range",
            "tile_cols_log2", "tile_rows_log2", "keyframe", "features", "bit_depth")

    def __init__(self):
        lib = library()
        self._lib = lib
        self._msg = ctypes.create_string_buffer(256)
        code = _I32(0)
        self._h = lib.fmvfi_vp9_open(self._msg, len(self._msg), ctypes.byref(code))
        if not self._h:
            raise _JPEG_ERRORS[code.value](self._msg.value.decode("ascii", "replace"))
        self._info = np.zeros(len(self.INFO), np.int32)
        self.info = {}

    def decode(self, packet: bytes) -> list:
        buf = np.frombuffer(packet, np.uint8)
        code = self._lib.fmvfi_vp9_decode(self._h, buf.ctypes.data, buf.size,
                                          self._info.ctypes.data, self._msg, len(self._msg))
        if code:
            raise _JPEG_ERRORS[code](self._msg.value.decode("ascii", "replace"))
        self.info = dict(zip(self.INFO, (int(v) for v in self._info)))
        frames = []
        for i in range(self.info["frames"]):
            out = np.empty((self.info["height"], self.info["width"], 3), np.uint8)
            self._lib.fmvfi_vp9_frame(self._h, i, out.ctypes.data)
            frames.append(out)
        return frames

    def planes(self, i: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The i-th frame the last packet showed, as Y (h, w) and U, V at the
        stream's subsampling, before swscale (the frames of one packet share
        a size and sampling)."""
        h, w, sx, sy = (self.info[k] for k in ("height", "width", "ss_x", "ss_y"))
        y = np.empty((h, w), np.uint16)
        u, v = (np.empty(((h + sy) >> sy, (w + sx) >> sx), np.uint16) for _ in range(2))
        self._lib.fmvfi_vp9_planes(self._h, i, y.ctypes.data, u.ctypes.data, v.ctypes.data)
        return y, u, v

    def close(self) -> None:
        if self._h:
            self._lib.fmvfi_vp9_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


# mpeg12.cpp's feature bits (Mpeg12Decoder.info["features"]): what a
# packet's picture uses
MPEG12_FEATURES = dict(
    b_picture=1, skipped=2, intra_in_inter=4, field_dct=8, field_motion=16, alternate_scan=32,
    intra_vlc=64, nonlinear_q=128, quant_change=256, custom_intra=1024,
    custom_inter=2048, quant_ext=4096, bt709=8192, escape=16384, bidirectional=32768,
    half_pel=65536, interlaced_seq=1 << 17, multi_row_slice=1 << 18, mba_escape=1 << 19,
    backward=1 << 20, zero_mv=1 << 21)


# h263.cpp's feature bits (H263Decoder.features): what a picture used
H263_FEATURES = dict(p_picture=1, skipped=2, intra_in_p=4, dquant=8, four_mv=16, obmc=32,
                     long_vectors=64, gob=128, escape=256, escape_long=512,
                     sorenson_esc7=1024, sorenson_esc11=2048, disposable=4096, pei=8192)
# msmpeg4.cpp's feature bits (Msmpeg4Decoder.features)
MSMPEG4_FEATURES = dict(p_picture=1, skipped=2, intra_in_p=4, ac_pred=8, escape1=16,
                        escape2=32, escape3=64, dc_escape=128, slices=256, flipflop=512,
                        mv_escape=1024, ext_header=2048, rl_table1=4096, rl_table2=8192,
                        dc_table1=16384, mv_table1=32768)


class _H263Family:
    """A decoder of FFmpeg's H.263 family (h263.cpp, msmpeg4.cpp): one
    container sample a picture, `decode(packet)` returning its frame
    ((H, W, 3) uint8 RGB); `picture_type` and `features` describe the last
    one.  NotImplementedError for what FFmpeg decodes otherwise, ValueError
    for a malformed stream, each with the reason."""

    NAME = ""
    _h = None

    def __init__(self, variant: int):
        lib = library()
        self._lib = lib
        self._msg = ctypes.create_string_buffer(256)
        code = _I32(0)
        self._h = getattr(lib, f"fmvfi_{self.NAME}_open")(variant, self._msg, len(self._msg),
                                                          ctypes.byref(code))
        if not self._h:
            raise _JPEG_ERRORS[code.value](self._msg.value.decode("ascii", "replace"))
        self._info = np.zeros(5, np.int32)
        self.picture_type = ""
        self.features = 0

    def decode(self, packet: bytes) -> Optional[np.ndarray]:
        buf = np.frombuffer(packet, np.uint8) if packet else np.zeros(0, np.uint8)
        code = getattr(self._lib, f"fmvfi_{self.NAME}_decode")(
            self._h, buf.ctypes.data, buf.size, self._info.ctypes.data, self._msg,
            len(self._msg))
        if code:
            raise _JPEG_ERRORS[code](self._msg.value.decode("ascii", "replace"))
        w, h, got, kind, self.features = (int(v) for v in self._info)
        if not got:
            return None
        self.picture_type = chr(kind)
        out = np.empty((h, w, 3), np.uint8)
        getattr(self._lib, f"fmvfi_{self.NAME}_frame")(self._h, out.ctypes.data)
        return out

    def close(self) -> None:
        if self._h:
            getattr(self._lib, f"fmvfi_{self.NAME}_close")(self._h)
            self._h = None

    def __del__(self):
        self.close()


class H263Decoder(_H263Family):
    """H.263 (variant "h263": FFmpeg's h263 decoder) or Sorenson Spark
    (variant "flv1": its flv decoder) as cv2.VideoCapture decodes them
    (h263.cpp, features in H263_FEATURES): each packet one picture, its size
    from the picture header."""

    NAME = "h263"

    def __init__(self, variant: str = "h263"):
        if variant not in ("h263", "flv1"):
            raise ValueError(f"no H.263 variant {variant!r}")
        super().__init__(0 if variant == "h263" else 1)


class Msmpeg4Decoder(_H263Family):
    """MS-MPEG4 v2 or v3 (`version` 2 or 3: FFmpeg's msmpeg4v2 and msmpeg4
    decoders) as cv2.VideoCapture decodes it (msmpeg4.cpp, features in
    MSMPEG4_FEATURES) at the container's `size` (width, height): each
    packet one picture."""

    NAME = "msmpeg4"

    def __init__(self, version: int, size: Tuple[int, int]):
        if version not in (2, 3):
            raise ValueError(f"no MS-MPEG4 version {version!r}")
        super().__init__(int(version))
        if self._lib.fmvfi_msmpeg4_set_size(self._h, int(size[0]), int(size[1])):
            raise ValueError(f"an MS-MPEG4 stream of size {size[0]}x{size[1]}")


class Mpeg12Decoder:
    """An MPEG-1 or MPEG-2 video stream decoded as cv2.VideoCapture decodes
    it (FFmpeg's mpeg1video / mpeg2video decoder and swscale's conversion to
    BGR24, mpeg12.cpp): `decode(packet)` takes one packet (a picture and the
    headers before it, as FFmpeg's parser or a container's sample holds it)
    and returns the frames now ready for display, each (H, W, 3) uint8 RGB:
    a B picture at once, an I or P picture when the next one arrives;
    `flush()` returns the last one at the end of the stream.  `config` is
    headers decoded first (a container's sequence header).  After each call
    `info` holds the picture's facts (size, type, MPEG-2 or not, mpeg12.cpp's
    feature bits: MPEG12_FEATURES, intra DC precision).  Raises
    NotImplementedError for what mpeg12.cpp refuses (field pictures, dual
    prime, 4:2:2 / 4:4:4, scalability, D pictures) and ValueError for
    malformed data, each with the reason."""

    INFO = ("ready", "width", "height", "picture", "mpeg2", "features", "dc_bits")

    def __init__(self, config: bytes = b""):
        lib = library()
        self._lib = lib
        self._msg = ctypes.create_string_buffer(256)
        code = _I32(0)
        buf = np.frombuffer(config, np.uint8) if config else np.zeros(1, np.uint8)
        self._h = lib.fmvfi_mpeg12_open(buf.ctypes.data, len(config), self._msg, len(self._msg),
                                        ctypes.byref(code))
        if not self._h:
            raise _JPEG_ERRORS[code.value](self._msg.value.decode("ascii", "replace"))
        self._info = np.zeros(len(self.INFO), np.int32)
        self.info = {}

    def _frames(self) -> list:
        self.info = dict(zip(self.INFO, (int(v) for v in self._info)))
        self.info["picture"] = chr(self.info["picture"]) if self.info["picture"] else ""
        if not self.info["ready"]:
            return []
        out = np.empty((self.info["height"], self.info["width"], 3), np.uint8)
        self._lib.fmvfi_mpeg12_frame(self._h, out.ctypes.data)
        return [out]

    def decode(self, packet: bytes) -> list:
        buf = np.frombuffer(packet, np.uint8)
        code = self._lib.fmvfi_mpeg12_decode(self._h, buf.ctypes.data, buf.size,
                                             self._info.ctypes.data, self._msg, len(self._msg))
        if code:
            raise _JPEG_ERRORS[code](self._msg.value.decode("ascii", "replace"))
        return self._frames()

    def flush(self) -> list:
        self._lib.fmvfi_mpeg12_flush(self._h, self._info.ctypes.data)
        return self._frames()

    def close(self) -> None:
        if self._h:
            self._lib.fmvfi_mpeg12_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


def _vol_rate(fps: float) -> Tuple[int, int]:
    """(vop_time_increment_resolution, frame increment) of a frame rate, as
    OpenCV's writer turns fps into FFmpeg's time base: fps rounded, else
    scaled by powers of ten until within 1e-3, reduced, the resolution at
    most 65535."""
    if not fps > 0:
        raise ValueError(f"a frame rate of {fps}")
    rate, base = int(fps + 0.5), 1
    while abs(rate / base - fps) > 0.001:
        base *= 10
        rate = int(fps * base + 0.5)
    g = math.gcd(rate, base)
    rate, base = rate // g, base // g
    if rate > 65535:
        raise ValueError(f"a frame rate of {fps}: its time resolution {rate} is over 65535")
    return rate, base
