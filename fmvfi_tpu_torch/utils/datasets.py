"""Dataset bootstrap helpers (port of fmvfi_tpu/utils/datasets.py): the
reference's download sources, a streaming download, zip extraction, and the
Testset bootstrap's check for git-LFS pointers.

`video_to_images` (and `videos_to_images`, `bootstrap_testset`) extract
the frames of Motion-JPEG AVI files, decoded as cv2.VideoCapture decodes
them (pipeline/video.py), resized as cv2.resize resizes them and written
as cv2.imwrite writes them.  Other video files, and `images_to_video`'s
mp4v writer, need a video codec, which the card's machine lacks: they raise
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

from .imageio import imwrite
from .resample import resize_bilinear_u8

DATASET_URLS = {
    # the reference's sources (setup.py:111-132)
    "vimeo90k_triplet": "http://data.csail.mit.edu/tofu/dataset/vimeo_triplet.zip",
    "davis": "https://data.vision.ee.ethz.ch/csergi/share/davis/DAVIS-2017-trainval-480p.zip",
}

VIDEO_SUFFIXES = (".mp4", ".avi", ".mov")
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


def _no_video_codec(path: str) -> NotImplementedError:
    return NotImplementedError(
        f"{path}: writing a video file needs a video codec, which the card's machine lacks "
        "(ROADMAP Queue 1, item 18.4)")


def video_to_images(video_path: str, out_dir: str,
                    resize: Optional[Tuple[int, int]] = (1280, 720), ext: str = "png") -> int:
    """Extract a Motion-JPEG AVI into <out_dir>/00000.<ext>, 00001.<ext>, ...
    (fmvfi_tpu/utils/datasets.py:52-75), each frame resized to resize =
    (width, height) unless it is None; returns the number of frames.  A
    video file of another kind raises NotImplementedError (item 18.4)."""
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
    clip that is not a Motion-JPEG AVI raises NotImplementedError."""
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
    """Not ported: JAX writes an mp4v file, which needs a video codec; raises
    NotImplementedError (item 18.4)."""
    raise _no_video_codec(out_path)


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
