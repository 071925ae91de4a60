"""Dataset bootstrap helpers (port of fmvfi_tpu/utils/datasets.py): the
reference's download sources, a streaming download, zip extraction, and the
Testset bootstrap's check for git-LFS pointers.

Converting between video files and frame directories needs a video codec,
which the card's machine lacks: `video_to_images` and `images_to_video`
raise NotImplementedError (ROADMAP Queue 1, item 18.4), and so do
`videos_to_images` and `bootstrap_testset` at the first video they meet.
Downloads need network egress; without it `download` raises
ConnectionError with JAX's message.
"""

from __future__ import annotations

import os
import urllib.error
import urllib.request
import zipfile
from typing import Optional, Tuple

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
        f"{path}: converting between video files and frames needs a video codec, which the "
        "card's machine lacks (ROADMAP Queue 1, item 18.4)")


def video_to_images(video_path: str, out_dir: str,
                    resize: Optional[Tuple[int, int]] = (1280, 720), ext: str = "png") -> int:
    """Not ported: raises NotImplementedError (no video codec)."""
    raise _no_video_codec(video_path)


def videos_to_images(video_dir: str, out_root: str, **kw) -> dict:
    """Every clip in a directory to <out_root>/<clipname>/ frames: {} for a
    directory without video files, else NotImplementedError at the first
    (no video codec)."""
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
    """Not ported: raises NotImplementedError (no video codec)."""
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
