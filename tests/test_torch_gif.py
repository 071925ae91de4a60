"""GIF through the port against cv2 on the CPU (OpenCV's own GIF decoder
under cv2.imread, FFmpeg's gif demuxer and decoder under cv2.VideoCapture):

- every `gif_clip_` fixture of tests/data/inputs/ (tools/make_input_fixtures.py,
  group `webp_gif`) read through imread bit-equal to cv2.imread (its first
  image; the fixtures' pins hold the video route);
- seeded random GIFs (87a and 89a, global and local tables of 2-256
  entries, sub-rectangles, interlacing, transparency, disposals 0-3, with
  and without Graphic Control and other extensions, which decide the
  images FFmpeg's gif parser splits off) bit-equal to cv2.imread and to
  cv2.VideoCapture's frames;
- the white that cv2.VideoCapture shows at a first frame's transparent
  pixels, where cv2.imread shows the background colour, and the black
  outside the first image of a file without a global table;
- the LZW decoder on streams that grow to 12 bits, fill the table with and
  without a Clear, and use KwKwK codes;
- GIF writing refused, naming its ROADMAP item;
- files cv2.imread reads no image of (a background index past the table,
  an image off the screen, a colour index past OpenCV's table, LZW data
  past the End code) raise ValueError, and a local table's index past its
  entries reads the global table's, as OpenCV keeps one table; truncated
  and corrupted files raise ValueError, never crash.
"""

import importlib.util
import io
import os

import cv2
import numpy as np
import pytest
from PIL import Image

import chip_smoke
from fmvfi_tpu.pipeline import video as jx_video
from fmvfi_tpu_torch import native
from fmvfi_tpu_torch.pipeline import video as pt_video
from fmvfi_tpu_torch.utils import gif, imageio

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUTS = os.path.join(ROOT, chip_smoke.INPUTS_DIR)
_spec = importlib.util.spec_from_file_location(
    "make_input_fixtures", os.path.join(ROOT, "tools", "make_input_fixtures.py"))
TOOL = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(TOOL)
CLIPS = tuple(n for n in chip_smoke.INPUT_PINS if n.startswith("gif_clip_") and "1080" not in n)
# a comment and a NETSCAPE2.0 loop block
EXTENSIONS = (b"\x21\xfe\x03abc\x00", b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00")


@pytest.fixture
def toolchain():
    if not native.available():
        pytest.skip("no g++ on PATH: the native decoders cannot be built")


def _cv2(path):
    img = cv2.imread(str(path), cv2.IMREAD_COLOR)
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f[..., ::-1])
    cap.release()
    return (None if img is None else img[..., ::-1]), frames


def _random_gif(rng):
    sw, sh = (int(v) for v in rng.integers(1, 40, 2))
    n = int(rng.choice([2, 3, 4, 16, 32, 200, 256]))
    gpal = rng.integers(0, 256, (n, 3), np.uint8) if rng.random() < 0.8 else None
    images = []
    for _ in range(int(rng.integers(1, 5))):
        w, h = int(rng.integers(1, sw + 1)), int(rng.integers(1, sh + 1))
        lpal = None
        if gpal is None or rng.random() < 0.3:
            lpal = rng.integers(0, 256, (int(rng.choice([2, 8, 64])), 3), np.uint8)
        m = len(lpal) if lpal is not None else n
        im = dict(idx=rng.integers(0, m, (h, w)), x=int(rng.integers(0, sw - w + 1)),
                  y=int(rng.integers(0, sh - h + 1)), lpal=lpal,
                  interlace=bool(rng.random() < 0.3))
        if rng.random() < 0.7:  # a Graphic Control Extension
            im.update(disposal=int(rng.integers(0, 4)), delay=int(rng.integers(0, 20)))
            if rng.random() < 0.6:
                im["trans"] = int(rng.integers(0, m))
        if rng.random() < 0.15:
            im["extensions"] = [EXTENSIONS[int(rng.integers(len(EXTENSIONS)))]]
        images.append(im)
    version = b"87a" if rng.random() < 0.15 else b"89a"
    if version == b"87a":
        for im in images:
            for k in ("trans", "disposal", "delay", "extensions"):
                im.pop(k, None)
    bg = int(rng.integers(0, len(gpal))) if gpal is not None else 0
    return TOOL.gif_file(sw, sh, images, gpal, bg=bg, version=version)


@pytest.mark.parametrize("name", CLIPS)
def test_clip_first_image_through_imread_as_cv2(toolchain, name):
    path = os.path.join(INPUTS, name)
    np.testing.assert_array_equal(imageio.imread(path), cv2.imread(path)[..., ::-1])
    np.testing.assert_array_equal(pt_video.read_video_frames(path),
                                  jx_video.read_video_frames(path))


@pytest.mark.parametrize("seed", range(6))
def test_random_gifs_as_cv2(toolchain, tmp_path, seed):
    rng = np.random.default_rng(500 + seed)
    path = tmp_path / "r.gif"
    for _ in range(12):
        path.write_bytes(_random_gif(rng))
        still, frames = _cv2(path)
        np.testing.assert_array_equal(imageio.imread(path), still)
        ours = list(pt_video.iter_video_frames(str(path)))
        assert len(ours) == len(frames)
        for a, b in zip(ours, frames):
            np.testing.assert_array_equal(a, b)


def test_transparent_first_frame_white_as_video_background_as_imread(toolchain, tmp_path):
    rng = np.random.default_rng(1)
    pal = rng.integers(0, 256, (16, 3), np.uint8)
    idx = rng.integers(0, 16, (10, 12))
    idx[0, :4] = 3
    path = tmp_path / "t.gif"
    path.write_bytes(TOOL.gif_file(12, 10, [dict(idx=idx, trans=3)], pal, bg=5))
    still, frames = _cv2(path)
    hole = idx == 3
    assert (imageio.imread(path)[hole] == pal[5]).all() and (still[hole] == pal[5]).all()
    ours = pt_video.read_video_frames(str(path))[0]
    assert (ours[hole] == 1.0).all() and (frames[0][hole] == 255).all()
    # no global table: black around the first image in imread, white as video
    path.write_bytes(TOOL.gif_file(12, 10, [dict(idx=idx[:5, :6], x=3, y=2, lpal=pal)]))
    still, frames = _cv2(path)
    np.testing.assert_array_equal(imageio.imread(path), still)
    assert (still[0, 0] == 0).all() and (frames[0][0, 0] == 255).all()
    np.testing.assert_array_equal(pt_video.read_video_frames(str(path))[0] * 255, frames[0])


@pytest.mark.parametrize("case", ["grow", "full_clear", "deferred_clear", "kwkwk", "two_colours"])
def test_lzw_streams(toolchain, case):
    rng = np.random.default_rng(7)
    if case == "grow":
        idx, mc = rng.integers(0, 8, 3000), 3
    elif case in ("full_clear", "deferred_clear"):
        idx, mc = rng.integers(0, 256, 20000), 8
    elif case == "kwkwk":
        idx, mc = np.zeros(5000, np.int64), 2
    else:
        idx, mc = rng.integers(0, 2, 777), 2
    data = TOOL.gif_lzw(idx, mc, clear_when_full=case != "deferred_clear")
    np.testing.assert_array_equal(native.gif_lzw(data, mc, idx.size), idx)
    with pytest.raises(ValueError, match="ends"):
        native.gif_lzw(data[: len(data) // 2], mc, idx.size)


def test_gif_writing_is_refused(toolchain, tmp_path):
    with pytest.raises(NotImplementedError, match="item 18.11"):
        imageio.imwrite(tmp_path / "x.gif", np.zeros((4, 4, 3), np.uint8))
    assert not (tmp_path / "x.gif").exists()


def _with_trailing_data(data, entries):
    """A one-image GIF whose LZW data goes on two zero bytes past its End
    code (in a sub-block of its own)."""
    at = 13 + 3 * entries + 10 + 1  # past the header, the table, the descriptor and min code
    blocks, pos = [], at
    while data[pos]:
        blocks.append(data[pos + 1 : pos + 1 + data[pos]])
        pos += 1 + data[pos]
    lzw = b"".join(blocks) + b"\0\0"
    return data[:at] + bytes([len(lzw)]) + lzw + data[pos:]


def test_what_cv2_imread_reads_no_image_of(toolchain, tmp_path):
    rng = np.random.default_rng(2)
    pal = rng.integers(0, 256, (16, 3), np.uint8)
    idx = rng.integers(0, 16, (6, 8))
    past = idx.copy()
    past[0, 0] = 20
    full = TOOL.gif_file(8, 6, [dict(idx=idx)], pal)
    for name, data in (("bg.gif", TOOL.gif_file(8, 6, [dict(idx=idx)], pal, bg=200)),
                       ("off.gif", TOOL.gif_file(8, 6, [dict(idx=idx, x=3)], pal)),
                       ("index.gif", TOOL.gif_file(8, 6, [dict(idx=past, min_code=8)], pal)),
                       ("trailing.gif", _with_trailing_data(full, pal.shape[0]))):
        path = tmp_path / name
        path.write_bytes(data)
        assert cv2.imread(str(path)) is None
        with pytest.raises(ValueError, match=name):
            imageio.imread(path)


def test_a_local_index_past_its_table_reads_the_global_table(toolchain, tmp_path):
    rng = np.random.default_rng(3)
    pal = rng.integers(0, 256, (16, 3), np.uint8)
    idx = rng.integers(0, 8, (6, 8))
    idx[0, 0] = 9
    path = tmp_path / "l.gif"
    path.write_bytes(TOOL.gif_file(8, 6, [dict(idx=idx, lpal=pal[8:] // 2, min_code=5)], pal))
    still, _ = _cv2(path)
    assert (still[0, 0] == pal[9]).all()
    np.testing.assert_array_equal(imageio.imread(path), still)


@pytest.mark.parametrize("name", ["gif_clip_disposals_53x37.gif", "gif_interlaced_53x37.gif"])
def test_truncated_and_corrupted_files_raise(toolchain, tmp_path, name):
    with open(os.path.join(INPUTS, name), "rb") as f:
        data = f.read()
    rng = np.random.default_rng(len(data))
    path = tmp_path / "bad.gif"
    for cut in (7, 13, 40, len(data) // 2):
        path.write_bytes(data[:cut])
        with pytest.raises(ValueError, match="bad.gif"):
            imageio.imread(path)
    for _ in range(20):  # flipped bytes: a ValueError or pictures, never a crash
        bad = bytearray(data)
        for at in rng.integers(13, len(data), 3):
            bad[at] ^= int(rng.integers(1, 256))
        path.write_bytes(bytes(bad))
        for read in (imageio.imread, lambda p: list(pt_video.iter_video_frames(str(p)))):
            try:
                read(path)
            except (ValueError, NotImplementedError):
                pass


def test_pil_animation_with_optimized_sub_rectangles(toolchain, tmp_path):
    """PIL's save_all with durations and a loop: every image a frame (none
    repeated for its delay), as cv2 reads it."""
    base = np.random.default_rng(3).integers(0, 256, (30, 40, 3), np.uint8)
    frames = []
    for i in range(3):
        f = base.copy()
        f[5 + 2 * i : 15 + 2 * i, 5 + 3 * i : 20 + 3 * i] = 255 - f[:10, :15]
        frames.append(Image.fromarray(f).quantize(32))
    buf = io.BytesIO()
    frames[0].save(buf, "GIF", save_all=True, append_images=frames[1:], duration=[40, 80, 120],
                   loop=0, optimize=True)
    path = tmp_path / "p.gif"
    path.write_bytes(buf.getvalue())
    assert len(gif.parse(buf.getvalue()).images) == 3
    np.testing.assert_array_equal(pt_video.read_video_frames(str(path)),
                                  jx_video.read_video_frames(str(path)))
