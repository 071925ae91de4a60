"""PNG and raw frames in AVI and MOV files through the port against cv2 and
JAX on the CPU.

cv2.VideoWriter writes them for the FourCCs `png ` / `MPNG` (FFmpeg's png
encoder), `RGBA`, `GREY` / `Y800` / `Y8  ` and `I420` / `IYUV` / `YV12`
(FFmpeg's rawvideo: its grey tags hold the yuv420p packets the writer
makes, 12 bits a pixel), in AVI, and `png ` and `RGBA` in MOV; it crops
odd sides to even.  cv2.VideoCapture reads them with FFmpeg's png and
rawvideo decoders: a PNG frame's size is its IHDR's; grey rows are 4-byte
aligned when the packet holds that many (rawdec.c's linesize_align); a
tagged raw frame is never flipped, whatever biHeight's sign; yuv420p goes
through swscale's BT.601 limited-range routes.  The port
(utils/formats.py's png and rawvideo decoders behind utils/avi.py and
mp4.py) must return cv2's frames bit for bit: on every committed fixture
(tools/make_input_fixtures.py group lossless_video), on cv2's files at
even sides and forged ones at odd sides for each FourCC, and through
JAX's read_video_frames.  What cv2's writer does not write (BI_RGB, DIB,
packed YUV, `raw ` in MOV) and an interlaced PNG frame raise
NotImplementedError naming ROADMAP item 18.4g.
"""

import hashlib
import importlib.util
import io
import os

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from fmvfi_tpu.pipeline import video as jx_video
from fmvfi_tpu_torch import native
from fmvfi_tpu_torch.pipeline import video as pt_video
from fmvfi_tpu_torch.utils import avi, formats, mp4
from test_torch_vp9_video import assert_as_cv2, cv2_frames

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUTS = os.path.join(ROOT, chip_smoke.INPUTS_DIR)
FIXTURES = sorted(n for n in chip_smoke.INPUT_PINS if n.startswith("lossless_"))
_spec = importlib.util.spec_from_file_location(
    "make_input_fixtures", os.path.join(ROOT, "tools", "make_input_fixtures.py"))
TOOL = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(TOOL)
FOURCCS = [(".avi", "png "), (".avi", "MPNG"), (".avi", "RGBA"), (".avi", "GREY"),
           (".avi", "Y800"), (".avi", "Y8  "), (".avi", "I420"), (".avi", "IYUV"),
           (".avi", "YV12"), (".mov", "png "), (".mov", "RGBA")]


@pytest.fixture
def toolchain():
    if not native.available():
        pytest.skip("no g++ on PATH: the native decoders cannot be built")


def _png(a, mode=None):
    buf = io.BytesIO()
    Image.fromarray(a, mode).save(buf, "PNG")
    return buf.getvalue()


def _packets(fourcc, frames):
    """Each RGB frame as the packet FFmpeg's encoder for `fourcc` writes."""
    if fourcc.strip().upper() in ("PNG", "MPNG"):
        return [_png(f) for f in frames]
    if fourcc == "RGBA":
        return [np.concatenate([f, np.full(f.shape[:2] + (1,), 255, np.uint8)], -1).tobytes()
                for f in frames]
    planes = [TOOL._yuv420(np.ascontiguousarray(f[..., ::-1])) for f in frames]
    if fourcc == "YV12":
        planes = [(y, v, u) for y, u, v in planes]
    return [b"".join(p.tobytes() for p in ps) for ps in planes]


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_decodes_as_cv2_jax_and_its_pin(toolchain, name):
    path = os.path.join(INPUTS, name)
    ours = assert_as_cv2(path, len(cv2_frames(path)))
    contract, digest = chip_smoke.INPUT_PINS[name]
    assert contract == "video"
    assert hashlib.sha256(np.stack(ours).tobytes()).hexdigest() == digest
    np.testing.assert_array_equal(pt_video.read_video_frames(path),
                                  jx_video.read_video_frames(path))


@pytest.mark.parametrize("ext,fourcc", FOURCCS)
def test_each_fourcc_at_odd_and_even_sizes(toolchain, tmp_path, ext, fourcc):
    """cv2's own file at even sides (a width not a multiple of 4), and the
    same FourCC forged at odd sides (AVI: the port's writer around the
    encoder's packets; MOV: cv2's file with its samples replaced and its
    sample entry's size set)."""
    rng = np.random.default_rng(sum(map(ord, ext + fourcc)))
    path = str(tmp_path / f"cv2{ext}")
    TOOL.cv2_video(path, fourcc, TOOL.sliding(rng, 3, 30, 46), fps=10)
    assert assert_as_cv2(path, 3)[0].shape == (30, 46, 3)
    h, w = (int(v) | 1 for v in rng.integers(1, 60, 2))
    frames = [f[..., ::-1] for f in TOOL.sliding(rng, 2, h, w)]
    data = _packets(fourcc, frames)
    path = str(tmp_path / f"odd{ext}")
    if ext == ".avi":
        with TOOL.PacketAvi(path, w, h, fourcc.encode(), 10,
                            {"RGBA": 32, "png ": 24, "MPNG": 24}.get(fourcc, 12)) as mux:
            for p in data:
                mux.write_packet(p, True)
    else:
        TOOL.cv2_video(path, fourcc, TOOL.sliding(rng, 2, 30, 46), fps=10)
        with open(path, "rb") as f:
            template = f.read()
        with open(path, "wb") as f:
            f.write(TOOL.mp4_with_packets(template, data, [True, True], size=(w, h)))
    ours = assert_as_cv2(path, 2)
    if fourcc in ("png ", "MPNG", "RGBA"):
        np.testing.assert_array_equal(np.stack(ours), np.stack(frames))  # lossless


@pytest.mark.parametrize("w", [5, 6, 7, 8, 45])
def test_grey_rows_are_four_byte_aligned_when_the_packet_holds_them(toolchain, tmp_path, w):
    """rawdec.c reads a grey frame's rows 4-byte aligned when the packet
    holds that many bytes (cv2's GREY packets of 12 bits a pixel do, past
    the smallest sizes), else packed."""
    rng = np.random.default_rng(w)
    h = 3
    for size in (w * h, (w * h * 3) // 2, ((w + 3) & ~3) * h):
        data = rng.integers(0, 256, size, np.uint8).tobytes()
        path = str(tmp_path / f"g{size}.avi")
        with TOOL.PacketAvi(path, w, h, b"GREY", 10, 12) as mux:
            mux.write_packet(data, True)
        ours = assert_as_cv2(path, 1)[0]
        stride = (w + 3) & ~3 if ((w + 3) & ~3) * h <= size else w
        rows = np.frombuffer(data, np.uint8)[:stride * (h - 1) + w]
        want = np.stack([rows[r * stride:r * stride + w] for r in range(h)])
        np.testing.assert_array_equal(ours[..., 0], want)
        assert (ours == ours[..., :1]).all()


def test_raw_frames_are_never_flipped(toolchain, tmp_path):
    """A tagged raw frame reads top row first whether biHeight is positive
    (bottom-up for BI_RGB) or negative."""
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (7, 9, 3), np.uint8)
    for top_down in (False, True):
        path = str(tmp_path / f"r{int(top_down)}.avi")
        with TOOL.PacketAvi(path, 9, 7, b"RGBA", 10, 32, top_down) as mux:
            mux.write_packet(_packets("RGBA", [rgb])[0], True)
        np.testing.assert_array_equal(assert_as_cv2(path, 1)[0], rgb)
        assert avi.open_video(path).strf["height"] == 7


def test_raw_yuv420p_through_swscale_at_every_size_class(toolchain, tmp_path):
    """The yuv420p route (native/rawvideo.cpp) on random samples, against
    cv2's reading of I420 AVIs at even and odd widths and heights."""
    rng = np.random.default_rng(11)
    for h, w in ((6, 8), (6, 7), (5, 8), (5, 7), (1, 1), (2, 3), (37, 45)):
        y = rng.integers(0, 256, (h, w), np.uint8)
        u, v = (rng.integers(0, 256, ((h + 1) // 2, (w + 1) // 2), np.uint8) for _ in range(2))
        path = str(tmp_path / f"i420_{w}x{h}.avi")
        with TOOL.PacketAvi(path, w, h, b"I420", 10, 12) as mux:
            mux.write_packet(y.tobytes() + u.tobytes() + v.tobytes(), True)
        np.testing.assert_array_equal(assert_as_cv2(path, 1)[0], native.yuv420p_swscale(y, u, v))
    with pytest.raises(ValueError, match="bytes for a 8x6 frame"):
        formats.raw_frame(bytes(10), b"I420", 8, 6)


def test_short_packets_and_refusals(toolchain, tmp_path):
    rng = np.random.default_rng(5)
    path = str(tmp_path / "short.avi")
    with TOOL.PacketAvi(path, 8, 6, b"RGBA", 10, 32) as mux:
        mux.write_packet(bytes(8 * 6 * 4 - 1), True)
    with pytest.raises(ValueError, match="frame 0: .*a raw rgba packet"):
        list(pt_video.iter_video_frames(path))
    assert cv2_frames(path) == []  # FFmpeg's rawvideo: "Invalid buffer size"
    for tag in (b"\0\0\0\0", b"DIB ", b"YUY2", b"UYVY"):
        path = str(tmp_path / "refused.avi")
        with TOOL.PacketAvi(path, 8, 6, tag, 10, 24) as mux:
            mux.write_packet(bytes(8 * 6 * 3), True)
        with pytest.raises(NotImplementedError, match="strf compression.*item 18.4g"):
            list(pt_video.iter_video_frames(path))
    mov = str(tmp_path / "raw.mov")
    TOOL.cv2_video(mov, "RGBA", TOOL.sliding(rng, 2, 8, 8), fps=10)
    assert mp4.open_video(mov).codec == b"RGBA"
    with open(mov, "rb") as f:
        data = f.read().replace(b"RGBA", b"raw ", 1)  # the sample entry: the file's first
    with open(mov, "wb") as f:
        f.write(data)
    with pytest.raises(NotImplementedError, match="'raw ' video track.*item 18.4g"):
        list(pt_video.iter_video_frames(mov))
    path = str(tmp_path / "adam7.avi")
    with TOOL.PacketAvi(path, 5, 4, b"png ", 10) as mux:
        mux.write_packet(TOOL.adam7_png(rng.integers(0, 256, (4, 5, 3)), 2, 8), True)
    with pytest.raises(NotImplementedError, match="interlaced.*item 18.4g"):
        list(pt_video.iter_video_frames(path))
