"""What the port reads, in one table, and the decoders behind it.

`READS` lists each container the port reads with the codecs it decodes in
it, as cv2.VideoCapture decodes them; every refusal message of the readers
(pipeline/video.py, utils/avi.py, mp4.py, mkv.py, mpegts.py, ivf.py, flv.py) names
it through `unsupported`, with the ROADMAP item that would lift the
refusal.  `decoder` turns a codec name of those readers into the native
decoder's calls.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

from .. import native

READS = (
    ("AVI", ("Motion-JPEG", "MPEG-4 Part 2 (mp4v)", "MPEG-1/2", "VP8", "VP9", "PNG",
             "raw RGBA / grey / I420 / YV12 frames", "H.263", "Sorenson Spark (FLV1)",
             "MS-MPEG4 v2 / v3 (MP42, MP43 / DIV3)")),
    ("MP4 / M4V / MOV / 3GP", ("mp4v", "MPEG-1/2", "Motion-JPEG", "VP9", "PNG", "raw RGBA frames",
                               "H.263")),
    ("Matroska / WebM (.mkv, .webm)", ("VP8", "VP9", "Motion-JPEG", "mp4v", "MPEG-1/2")),
    ("MPEG transport and program streams (.ts, .m2ts, .mpg, .vob)", ("MPEG-1/2", "mp4v")),
    ("raw MPEG video (.m1v, .m2v)", ("MPEG-1/2",)),
    ("IVF", ("VP8", "VP9")),
    ("FLV", ("Sorenson Spark (FLV1)",)),
)
# ROADMAP Queue 1's items, each with why the port does not read the input yet
ITEMS = {
    "18.4": "other codecs need a video decoder the card's machine lacks",
    "18.4g": "FFmpeg's rawvideo decoder reads it in a pixel format the port does not convert, "
             "or cv2's writer writes no such file",
    "18.4h": "FFmpeg's MPEG-1/2 decoder decodes it otherwise, or cv2 returns no pixels of it",
    "18.4i": "FFmpeg's H.263 family decodes it with what the port's H.263, Sorenson and "
             "MS-MPEG4 v2 / v3 decoders do not repeat (H.263+, MS-MPEG4 v1, WMV1 / WMV2, "
             "Intel H.263)",
    "18.4k": "cv2 reads a lone BMP, TIFF or PNM image, or a numbered sequence of them, as a "
             "video through FFmpeg's own decoders for them; the port reads lone PNG, JPEG and "
             "WebP images, GIF clips and sequences of them",
    "18.11": "cv2.imread decodes it (PFM, PAM, JPEG 2000, Sun raster, Radiance HDR, YCbCr TIFF "
             "not JPEG-compressed, YCCK JPEG), or cv2.imwrite writes it (GIF); that waits for the "
             "port's own codec",
}
STILLS = ("PNG, JPEG (grey, YCbCr, RGB and CMYK), BMP, PNM (P1-P6), TIFF, WebP (lossy and "
          "lossless) and GIF images")


def reads() -> str:
    """The table as a sentence."""
    parts = [f"{name} files of {', '.join(codecs)} video" for name, codecs in READS]
    return "; ".join(parts) + ("; directories of PNG or JPEG frames; GIF files (animated or "
                               "not); and lone PNG, JPEG or WebP images and numbered sequences "
                               "of them or of GIFs (frames/%05d.png)")


def unsupported(path: str, what: str, item: str = "18.4") -> NotImplementedError:
    """The refusal of `what` in the file at `path`, naming ROADMAP item `item`
    (18.11's is an image: the refusal lists the still formats imread reads)."""
    listing = STILLS if item == "18.11" else reads()
    return NotImplementedError(f"{path}: {what}; the port reads {listing} (ROADMAP Queue 1, "
                               f"item {item}: {ITEMS[item]})")


# FFmpeg's raw.c tags of the raw frames the port converts, each with its
# pixel format (rawdec.c picks it by the stream's tag)
RAW_PIXEL_FORMATS = {b"RGBA": "rgba", b"GREY": "gray", b"Y800": "gray", b"Y8  ": "gray",
                     b"I420": "yuv420p", b"IYUV": "yuv420p", b"YV12": "yvu420p"}


def raw_frame(data: bytes, fourcc: bytes, width: int, height: int) -> np.ndarray:
    """One packet of FFmpeg's rawvideo decoder in the pixel format of
    `fourcc`, as swscale hands it to cv2, (height, width, 3) uint8 RGB:
    rgba with alpha dropped, grey repeated to three channels (its rows 4-byte
    aligned when the packet holds that many: rawdec.c's linesize_align, so
    cv2's 12-bit-a-pixel GREY packets read skewed rows at widths not a
    multiple of 4), yuv420p (yvu420p: V before U) through swscale's BT.601
    limited-range routes.  Tagged raw frames are never flipped, whatever
    biHeight's sign.  ValueError for a packet shorter than a frame."""
    fmt = RAW_PIXEL_FORMATS[fourcc]
    w, h = width, height
    cw, ch = (w + 1) // 2, (h + 1) // 2
    need = {"rgba": 4 * w * h, "gray": w * h}.get(fmt, w * h + 2 * cw * ch)
    if len(data) < need:
        raise ValueError(f"a raw {fmt} packet of {len(data)} bytes for a {w}x{h} frame "
                         f"({need} bytes)")
    buf = np.frombuffer(data, np.uint8)
    if fmt == "rgba":
        return np.ascontiguousarray(buf[:need].reshape(h, w, 4)[..., :3])
    if fmt == "gray":
        stride = (w + 3) & ~3
        stride = stride if stride * h <= len(data) else w
        y = np.lib.stride_tricks.as_strided(buf, (h, w), (stride, 1))
        return np.repeat(y[..., None], 3, axis=2)
    y = buf[:w * h].reshape(h, w)
    u = buf[w * h:w * h + cw * ch].reshape(ch, cw)
    v = buf[w * h + cw * ch:need].reshape(ch, cw)
    if fmt == "yvu420p":
        u, v = v, u
    return native.yuv420p_swscale(y, u, v)


def png_frame(data: bytes) -> np.ndarray:
    """A PNG packet as FFmpeg's png decoder and swscale hand it to cv2 (the
    frame's size its IHDR's, whatever the container says)."""
    from . import image2
    return image2.png_frame(data, "a PNG frame")


def decoder(codec: str, config: bytes = b"", fourcc: bytes = b"", size: Tuple[int, int] = (0, 0)
            ) -> Tuple[Callable, Optional[Callable[[], list]]]:
    """(decode, flush) for a stream of `codec` ("mjpeg", "mpeg4", "mpeg12",
    "vp8", "vp9", "h263", "flv1", "msmpeg4", "png" or "rawvideo", the last
    in the pixel format of its
    `fourcc` at `size`, (width, height)): decode(packet) returns a frame,
    None or a list of frames; flush, where the codec holds frames back
    (MPEG-1/2's display order), returns the frames left at the end of the
    stream.  "h263" and "flv1" take their sizes from the pictures;
    "msmpeg4" is version 2 or 3 by its `fourcc` (utils/avi.py's
    MSMPEG4_FOURCCS), at `size`."""
    if codec == "png":
        return png_frame, None
    if codec == "rawvideo":
        return (lambda data: raw_frame(data, fourcc, *size)), None
    if codec == "mjpeg":
        return native.mjpeg_decode, None
    if codec == "mpeg4":
        return native.Mpeg4Decoder(config, fourcc).decode, None
    if codec == "vp8":
        return native.Vp8Decoder().decode, None
    if codec == "vp9":
        return native.Vp9Decoder().decode, None
    if codec == "mpeg12":
        dec = native.Mpeg12Decoder(config)
        return dec.decode, dec.flush
    if codec in ("h263", "flv1"):
        return native.H263Decoder(codec).decode, None
    if codec == "msmpeg4":
        from .avi import MSMPEG4_FOURCCS
        return native.Msmpeg4Decoder(MSMPEG4_FOURCCS[fourcc.upper()], size).decode, None
    raise ValueError(f"no decoder for codec {codec!r}")
