"""What the port reads, in one table, and the decoders behind it.

`READS` lists each container the port reads with the codecs it decodes in
it, as cv2.VideoCapture decodes them; every refusal message of the readers
(pipeline/video.py, utils/avi.py, mp4.py, mkv.py, mpegts.py, ivf.py) names
it through `unsupported`, with the ROADMAP item that would lift the
refusal.  `decoder` turns a codec name of those readers into the native
decoder's calls.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

from .. import native

READS = (
    ("AVI", ("Motion-JPEG", "MPEG-4 Part 2 (mp4v)", "MPEG-1/2", "VP8", "VP9")),
    ("MP4 / M4V / MOV", ("mp4v", "MPEG-1/2", "Motion-JPEG", "VP9")),
    ("Matroska / WebM (.mkv, .webm)", ("VP8", "VP9", "Motion-JPEG", "mp4v", "MPEG-1/2")),
    ("MPEG transport and program streams (.ts, .m2ts, .mpg, .vob)", ("MPEG-1/2", "mp4v")),
    ("raw MPEG video (.m1v, .m2v)", ("MPEG-1/2",)),
    ("IVF", ("VP8", "VP9")),
)
# ROADMAP Queue 1's items, each with why the port does not read the input yet
ITEMS = {
    "18.4": "other codecs need a video decoder the card's machine lacks",
    "18.4h": "FFmpeg's MPEG-1/2 decoder decodes it otherwise, or cv2 returns no pixels of it",
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


def decoder(codec: str, config: bytes = b"", fourcc: bytes = b""
            ) -> Tuple[Callable, Optional[Callable[[], list]]]:
    """(decode, flush) for a stream of `codec` ("mjpeg", "mpeg4", "mpeg12",
    "vp8" or "vp9"): decode(packet) returns a frame, None or a list of
    frames; flush, where the codec holds frames back (MPEG-1/2's display
    order), returns the frames left at the end of the stream."""
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
    raise ValueError(f"no decoder for codec {codec!r}")
