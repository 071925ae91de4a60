"""Dataset bootstrap helpers (port of fmvfi_tpu/utils/datasets.py): the
reference's download sources, a streaming download, zip extraction, and the
Testset bootstrap's check for git-LFS pointers.

`video_to_images` (and `videos_to_images`, `bootstrap_testset`) extract
the frames of the video files utils/formats.py's table lists (Motion-JPEG,
MPEG-4 Part 2, MPEG-1/2, VP8 or VP9 in AVI, MP4 / M4V / MOV, Matroska /
WebM, MPEG transport and program streams, raw MPEG video and IVF), decoded
as cv2.VideoCapture decodes them (pipeline/video.py),
resized as cv2.resize resizes them and written as cv2.imwrite writes them.
`images_to_video` writes MPEG-4 Part 2 ("mp4v", as JAX's cv2.VideoWriter)
into the container its extension names (.mp4, .m4v, .mov: utils/mp4.py;
.avi: utils/avi.py; .mkv: utils/mkv.py) with the port's encoder
(native/mpeg4_enc.cpp, a fixed quantiser where cv2's is rate-controlled).
Other codecs need what the card's machine lacks: they raise
NotImplementedError (ROADMAP Queue 1, item 18.4).
Downloads need network egress; without it `download` raises
ConnectionError with JAX's message.
"""

from __future__ import annotations

import os
import urllib.error
import urllib.request
import zipfile
from typing import Optional, Tuple

import numpy as np

from . import avi, mkv, mp4
from .imageio import imread, imwrite
from .resample import resize_bilinear_u8

DATASET_URLS = {
    # the reference's sources (setup.py:111-132)
    "vimeo90k_triplet": "http://data.csail.mit.edu/tofu/dataset/vimeo_triplet.zip",
    "davis": "https://data.vision.ee.ethz.ch/csergi/share/davis/DAVIS-2017-trainval-480p.zip",
}

VIDEO_SUFFIXES = (".mp4", ".avi", ".mov")
FRAME_SUFFIXES = (".png", ".jpg")  # what JAX's images_to_video stitches
LFS_POINTER_BYTES = 1024  # a git-LFS pointer file is ~130 bytes; a video is larger


def download(url: str, dest: str, chunk: int = 1 << 20) -> str:
    """Stream `url` to `dest` (its directory made); raises ConnectionError
    when the URL cannot be read."""
    os.makedirs(os.path.dirname(os.path.abspath(dest)), exist_ok=True)
    try:
        with urllib.request.urlopen(url) as r, open(dest, "wb") as f:
            while True:
                buf = r.read(chunk)
                if not buf:
                    break
                f.write(buf)
    except (urllib.error.URLError, OSError) as e:
        raise ConnectionError(
            f"cannot download {url} (no network egress in this environment?); "
            f"place the archive at {dest} manually"
        ) from e
    return dest


def extract(archive: str, dest_dir: str) -> str:
    """Extract the zip file `archive` into `dest_dir` (made if missing)."""
    os.makedirs(dest_dir, exist_ok=True)
    with zipfile.ZipFile(archive) as z:
        z.extractall(dest_dir)
    return dest_dir


def video_to_images(video_path: str, out_dir: str,
                    resize: Optional[Tuple[int, int]] = (1280, 720), ext: str = "png") -> int:
    """Extract a video file into <out_dir>/00000.<ext>, 00001.<ext>, ...
    (fmvfi_tpu/utils/datasets.py:52-75), each frame resized to resize =
    (width, height) unless it is None; returns the number of frames.  A
    video the port cannot decode as cv2 does raises NotImplementedError
    (item 18.4)."""
    from ..pipeline.video import iter_video_frames

    frames = iter_video_frames(video_path)  # ValueError when no frame decodes, as JAX's
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for frame in frames:
        if resize is not None:
            frame = resize_bilinear_u8(frame, resize)
        imwrite(os.path.join(out_dir, f"{n:05d}.{ext}"), frame)
        n += 1
    return n


def videos_to_images(video_dir: str, out_root: str, **kw) -> dict:
    """Every clip in a directory to <out_root>/<clipname>/ frames (sorted
    names; .mp4, .avi and .mov, as JAX): {clipname: frames}.  The first
    clip the port cannot decode raises NotImplementedError."""
    counts = {}
    for name in sorted(os.listdir(video_dir)):
        if not name.lower().endswith(VIDEO_SUFFIXES):
            continue
        stem = os.path.splitext(name)[0]
        counts[stem] = video_to_images(
            os.path.join(video_dir, name), os.path.join(out_root, stem), **kw
        )
    return counts


def images_to_video(frame_dir: str, out_path: str, fps: int = 30) -> str:
    """Stitch a frame directory (sorted .png / .jpg names) into an MPEG-4
    Part 2 video at `fps`, as JAX's cv2.VideoWriter(fourcc "mp4v") does
    (fmvfi_tpu/utils/datasets.py:92-108): the container by the extension
    (.mp4, .m4v, .mov, .avi or .mkv), the frames at the first one's size
    cropped to even sides as OpenCV's writer crops them (it drops a frame
    of another size).  The port codes with a fixed quantiser (utils/mp4.py's
    QUANT), cv2 with FFmpeg's rate control.  WebM holds no mp4v: cv2's
    writer opens nothing there and JAX's returns the path of no file, the
    port raises ValueError.  Returns out_path."""
    names = sorted(f for f in os.listdir(frame_dir) if f.lower().endswith(FRAME_SUFFIXES))
    if not names:
        raise ValueError(f"no frames in {frame_dir}")
    ext = os.path.splitext(out_path)[1].lower()
    if ext == ".webm":
        raise ValueError(f"{out_path}: a WebM file holds VP8, VP9 or AV1 video, not the mp4v "
                         "that images_to_video writes (cv2's writer opens nothing there); use "
                         ".mkv, .mp4, .m4v, .mov or .avi")
    if ext not in mp4.BRANDS and ext not in (".avi", ".mkv"):
        raise ValueError(f"{out_path}: no container for {ext!r}; the port writes .mp4, .m4v, "
                         ".mov, .avi and .mkv")
    first = imread(os.path.join(frame_dir, names[0]))
    h, w = first.shape[0] & ~1, first.shape[1] & ~1  # OpenCV's writer: width &= -2
    if not (h and w):
        raise ValueError(f"{names[0]}: a {first.shape[1]}x{first.shape[0]} frame has no even "
                         "part to write")
    if ext == ".avi":
        writer = avi.Mpeg4AviWriter(out_path, w, h, fps)
    elif ext == ".mkv":
        writer = mkv.MkvWriter(out_path, w, h, fps)
    else:
        writer = mp4.Mp4Writer(out_path, w, h, fps)
    with writer:
        for i, name in enumerate(names):
            frame = first if i == 0 else imread(os.path.join(frame_dir, name))
            if (frame.shape[0] & ~1, frame.shape[1] & ~1) != (h, w):
                continue  # cv2's writer drops a frame of another size
            writer.write(np.ascontiguousarray(frame[:h, :w]))
    return out_path


def bootstrap_testset(testset_dir: str, out_root: str) -> dict:
    """The reference's Testset bootstrap (Clip*.mp4 -> 1280x720 frame
    directories): a ValueError for an mp4 that is a git-LFS pointer, not
    video data; then videos_to_images."""
    for name in sorted(os.listdir(testset_dir)):
        p = os.path.join(testset_dir, name)
        if name.endswith(".mp4") and os.path.getsize(p) < LFS_POINTER_BYTES:
            raise ValueError(
                f"{p} is a git-LFS pointer, not video data; fetch the real "
                "clips or use eval.synth / eval.evaluate's synthetic sets"
            )
    return videos_to_images(testset_dir, out_root)
