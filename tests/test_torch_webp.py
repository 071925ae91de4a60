"""WebP through the port against cv2 and PIL on the CPU (libwebp under
cv2.imread and PIL, FFmpeg's webp decoder under cv2.VideoCapture):

- every `webp_` fixture of tests/data/inputs/ (tools/make_input_fixtures.py,
  group `webp_gif`) read through imread bit-equal to PIL's libwebp (RGB,
  alpha dropped; the EXIF-rotated one as cv2 turns it), and its VP8L
  streams using the transforms they were made for;
- the VP8L decoder's ARGB (alpha too) equal to PIL's RGBA on seeded random
  lossless files: noise, textures, palettes of 2-256 colours, alpha, at
  libwebp's methods 0-6;
- lossy files of odd and tiny sizes bit-equal to cv2.imread (the fancy
  upsampler's edges) and to cv2.VideoCapture (swscale's route);
- vp8.cpp's plane accessor held against its BGR route;
- imwrite's .webp read back by cv2.imread equal to the pixels written, at
  odd sizes and in grey;
- the EXIF Orientation 1-8 applied as cv2.imread applies it, and not on
  the video route;
- an animated WebP as video: JAX's ValueError (cv2 decodes no frame);
- truncated and corrupted files raise ValueError, never crash;
- corrupted lossy files (group webp_corrupt) read as libwebp reads them
  (the last partition on past the chunk to the file's end, a partition run
  out an error) and cv2's image size limits.
"""

import hashlib
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
from fmvfi_tpu_torch.utils import imageio, webp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUTS = os.path.join(ROOT, chip_smoke.INPUTS_DIR)
_spec = importlib.util.spec_from_file_location(
    "make_input_fixtures", os.path.join(ROOT, "tools", "make_input_fixtures.py"))
TOOL = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(TOOL)
WEBP_STILLS = tuple(n for n in chip_smoke.INPUT_PINS
                    if n.startswith("webp_") and chip_smoke.INPUT_PINS[n][0] == "imread")
# the transforms each lossless fixture was made to use (libwebp's choices)
FEATURES = {"webp_lossless_pal2_31x29.webp": ("color_indexing", "bundled"),
            "webp_lossless_pal4_31x29.webp": ("color_indexing", "bundled"),
            "webp_lossless_pal16_31x29.webp": ("color_indexing", "bundled"),
            "webp_lossless_pal256_31x29.webp": ("color_indexing",),
            "webp_lossless_m0_64x48.webp": ("predictor", "subtract_green", "backward_refs"),
            "webp_lossless_cache_128x96.webp": ("predictor", "cross_color", "color_cache"),
            "webp_lossless_meta_128x96.webp": ("predictor", "cross_color", "meta_codes",
                                               "backward_refs")}


@pytest.fixture
def toolchain():
    if not native.available():
        pytest.skip("no g++ on PATH: the native decoders cannot be built")


def _pil(img, mode=None, **kw):
    buf = io.BytesIO()
    Image.fromarray(img, mode).save(buf, "WEBP", **kw)
    return buf.getvalue()


def _cv2_video(path):
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f[..., ::-1])
    cap.release()
    return frames


@pytest.mark.parametrize("name", WEBP_STILLS)
def test_fixture_equals_pil(toolchain, name):
    path = os.path.join(INPUTS, name)
    ours = imageio.imread(path)
    ref = np.asarray(Image.open(path).convert("RGB"))
    if "exif6" in name:
        ref = np.ascontiguousarray(ref.transpose(1, 0, 2)[:, ::-1])
    np.testing.assert_array_equal(ours, ref)
    with open(path, "rb") as f:
        frame = webp.parse(f.read()).frames[0]
    if name in FEATURES:
        _, bits = native.vp8l_decode(frame.bitstream)
        used = {k for k, v in native.VP8L_FEATURES.items() if bits & v}
        assert set(FEATURES[name]) <= used, used


@pytest.mark.parametrize("seed", range(8))
def test_vp8l_decoder_against_pil(toolchain, seed):
    rng = np.random.default_rng(100 + seed)
    for _ in range(4):
        h, w = (int(v) for v in rng.integers(1, 80, 2))
        kind = seed % 4
        if kind == 0:
            img = rng.integers(0, 256, (h, w, 4), np.uint8)
        elif kind == 1:
            pal = rng.integers(0, 256, (int(rng.choice([2, 3, 4, 11, 16, 40, 256])), 4), np.uint8)
            img = pal[rng.integers(0, len(pal), (h, w))]
        else:
            img = cv2.resize(rng.integers(0, 256, (h // 4 + 2, w // 4 + 2, 4), np.uint8), (w, h))
        if kind != 3:
            img[..., 3] = 255 if rng.random() < 0.5 else img[..., 3]
        data = _pil(img, "RGBA", lossless=True, exact=True, method=int(rng.integers(0, 7)),
                    quality=int(rng.integers(0, 101)))
        argb, _ = native.vp8l_decode(webp.parse(data).frames[0].bitstream)
        ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
        got = argb.view(np.uint8).reshape(h, w, 4)[..., [2, 1, 0, 3]]
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("size", [(1, 1), (1, 7), (2, 2), (3, 5), (16, 16), (17, 33), (48, 3)])
def test_lossy_odd_sizes_as_cv2(toolchain, tmp_path, size):
    h, w = size
    img = cv2.resize(np.random.default_rng(h * 100 + w).integers(0, 256, (4, 4, 3), np.uint8),
                     (w, h))
    path = tmp_path / "x.webp"
    assert cv2.imwrite(str(path), img, [cv2.IMWRITE_WEBP_QUALITY, 60])
    np.testing.assert_array_equal(imageio.imread(path), cv2.imread(str(path))[..., ::-1])
    np.testing.assert_array_equal(np.stack(list(pt_video.iter_video_frames(str(path)))),
                                  np.stack(_cv2_video(path)))


def test_vp8_planes_against_the_bgr_route(toolchain):
    """Each frame of a VP8 clip: the planes are the frame's size, and libwebp's
    conversion of them is the BGR route's picture up to chroma upsampling
    (>= 30 dB); the BGR route is unchanged (the clip's pin)."""
    from fmvfi_tpu_torch.utils import mkv

    path = os.path.join(INPUTS, "vp8_cv2_96x72.webm")
    dec = native.Vp8Decoder()
    for sample in mkv.iter_samples(mkv.open_video(path)):
        rgb = dec.decode(sample)
        y, u, v = dec.planes()
        assert y.shape == rgb.shape[:2] and u.shape == v.shape == (36, 48)
        other = native.webp_yuv_rgb(y, u, v).astype(np.float64)
        mse = np.mean((other - rgb) ** 2)
        assert 10 * np.log10(255 ** 2 / max(mse, 1e-12)) >= 30
    dec.close()


@pytest.mark.parametrize("size", [(1, 1), (5, 3), (37, 53), (17, 64), (128, 99)])
def test_imwrite_webp_reads_back_in_cv2(toolchain, tmp_path, size):
    rng = np.random.default_rng(size[0])
    img = rng.integers(0, 256, (*size, 3), np.uint8)
    img[: size[0] // 2] = cv2.GaussianBlur(img, (0, 0), 2)[: size[0] // 2]
    path = tmp_path / "x.webp"
    imageio.imwrite(path, img)
    np.testing.assert_array_equal(cv2.imread(str(path))[..., ::-1], img)
    np.testing.assert_array_equal(imageio.imread(path), img)
    imageio.imwrite(path, img[..., 1])
    np.testing.assert_array_equal(cv2.imread(str(path))[..., ::-1],
                                  np.repeat(img[..., 1:2], 3, axis=2))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_as_cv2(toolchain, tmp_path, orientation):
    img = cv2.resize(np.random.default_rng(orientation).integers(0, 256, (5, 7, 3), np.uint8),
                     (53, 37))
    ex = Image.Exif()
    ex[274] = orientation
    path = tmp_path / "x.webp"
    path.write_bytes(_pil(img, quality=80, exif=ex))
    ours = imageio.imread(path)
    np.testing.assert_array_equal(ours, cv2.imread(str(path))[..., ::-1])
    assert ours.shape == ((53, 37, 3) if orientation >= 5 else (37, 53, 3))
    assert pt_video.read_video_frames(str(path)).shape == (1, 37, 53, 3)


def test_animated_webp_is_no_frames_as_video(toolchain):
    for name in ("webp_anim_lossy_53x37.webp", "webp_anim_lossless_53x37.webp"):
        path = os.path.join(INPUTS, name)
        assert _cv2_video(path) == []
        for fn in (pt_video.read_video_frames, jx_video.read_video_frames):
            with pytest.raises(ValueError, match="no frames decoded"):
                fn(path)
        np.testing.assert_array_equal(imageio.imread(path), cv2.imread(path)[..., ::-1])


@pytest.mark.parametrize("name", ["webp_lossy_53x37.webp", "webp_lossless_meta_128x96.webp",
                                  "webp_lossy_alpha_53x37.webp"])
def test_truncated_and_corrupted_files_raise(toolchain, tmp_path, name):
    with open(os.path.join(INPUTS, name), "rb") as f:
        data = f.read()
    rng = np.random.default_rng(len(data))
    path = tmp_path / "bad.webp"
    for cut in (13, 20, 30, len(data) // 2, len(data) - 1):
        path.write_bytes(data[:cut])
        with pytest.raises(ValueError, match="bad.webp"):
            imageio.imread(path)
    for _ in range(20):  # flipped bytes: a ValueError or a picture, never a crash
        bad = bytearray(data)
        for at in rng.integers(40, len(data), 3):  # past the headers
            bad[at] ^= int(rng.integers(1, 256))
        path.write_bytes(bytes(bad))
        try:
            assert imageio.imread(path).dtype == np.uint8
        except ValueError:
            pass


@pytest.mark.parametrize("name", [n for n, _, _, _ in TOOL.WEBP_CORRUPT])
def test_corrupted_lossy_webps_read_as_libwebp(toolchain, name):
    """Corrupted copies of the lossy fixtures (tools/make_input_fixtures.py
    group webp_corrupt), read as cv2.imread's libwebp reads them: cv2 hands
    libwebp the whole file, so the last token partition runs on past the
    VP8 chunk into the file's tail (FFmpeg's range decoder would read zeros
    there); a canvas past cv2's image size limit is no image (ValueError,
    as cv2.imread gives JAX None)."""
    path = os.path.join(INPUTS, name)
    try:
        ref = cv2.imread(path, cv2.IMREAD_COLOR)
    except cv2.error:  # cv2's size validation raises before the decoder runs
        ref = None
    if name in TOOL.WEBP_NO_IMAGE:
        assert ref is None and name not in chip_smoke.INPUT_PINS
        with pytest.raises(ValueError, match="cv2's image size limits"):
            imageio.imread(path)
        return
    ours = imageio.imread(path)
    np.testing.assert_array_equal(ours, ref[..., ::-1])
    contract, digest = chip_smoke.INPUT_PINS[name]
    assert contract == "imread" and hashlib.sha256(ours.tobytes()).hexdigest() == digest
    # the chunk alone (the file's tail not handed on) runs out: no image
    with open(path, "rb") as f:
        frame = webp.parse(f.read()).frames[0]
    with pytest.raises(ValueError, match="premature end of file"):
        webp._lossy(frame.bitstream, planes=True, after=b"")


def test_libwebp_mode_fails_where_a_partition_runs_out(toolchain):
    """A lossy WebP whose last partition is cut (the file ends there): libwebp
    returns no image, and the port raises ValueError naming the premature
    end; FFmpeg's mode decodes the same bytes (zeros past the end)."""
    with open(os.path.join(INPUTS, "webp_lossy_53x37.webp"), "rb") as f:
        frame = webp.parse(f.read()).frames[0]
    cut = frame.bitstream[:-40]
    dec = native.Vp8Decoder(libwebp=True)
    with pytest.raises(ValueError, match="premature end of file|past the first partition"):
        dec.decode(cut)
    assert native.Vp8Decoder().decode(cut).shape == (37, 53, 3)
