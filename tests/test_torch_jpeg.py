"""The port's JPEG reader and Lanczos resize against cv2 and PIL on the CPU:

- native/jpeg.cpp through utils/imageio.py bit-equal to cv2.imread (and, the
  orientation left alone, to PIL's Image.open) on files cv2 encodes: every
  chroma sampling cv2 writes (4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1) and grey,
  at 1x1, 8x8, 17x9, 37x53 and 64x80 (partial MCUs), quality 10, 75 and
  100, restart intervals 0, 1 and 3; and on grace_hopper.jpg;
- the eight EXIF orientations of PIL-written files against cv2.imread;
- truncated files raising, each naming the file, and lossless, arithmetic-coded
  and 12-bit files naming their SOF;
- a JPEG frame directory read as JAX reads it (pipeline/video.py);
- utils/resample.resize_u8 bit-equal to PIL's Image.resize(size,
  Image.LANCZOS): up, down, mixed, one axis kept, 1-pixel outputs.
"""

import hashlib
import itertools
import os

import cv2
import numpy as np
import pytest
from PIL import Image

import chip_smoke
from fmvfi_tpu.pipeline import video as jx_video
from fmvfi_tpu_torch.eval.synth import SAMPLE_DATA
from fmvfi_tpu_torch.pipeline import video as pt_video
from fmvfi_tpu_torch.utils import imageio
from fmvfi_tpu_torch.utils.resample import resize_u8

HOPPER = os.path.join(SAMPLE_DATA, "grace_hopper.jpg")
SAMPLINGS = {
    "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
    "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
    "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
    "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
    "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
    "grey": None,
}
SIZES = [(1, 1), (8, 8), (17, 9), (37, 53), (64, 80)]
QUALITIES = [10, 75, 100]
RESTARTS = [0, 1, 3]


def _image(rng, h, w):
    """Smooth gradients plus noise: every coefficient band is exercised."""
    y, x = np.mgrid[:h, :w]
    img = np.stack([np.sin(x / 5.0 + c) * 60 + np.cos(y / 7.0 + c) * 50 + 128 for c in range(3)],
                   -1)
    return np.clip(img + rng.normal(0, 25, img.shape), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("sampling", list(SAMPLINGS))
def test_decode_matches_cv2_and_pil(sampling, tmp_path):
    rng = np.random.default_rng(0)
    for (h, w), q, ri in itertools.product(SIZES, QUALITIES, RESTARTS):
        img = _image(rng, h, w)
        params = [cv2.IMWRITE_JPEG_QUALITY, q, cv2.IMWRITE_JPEG_RST_INTERVAL, ri]
        if sampling == "grey":
            img = img[..., 0]
        else:
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLINGS[sampling]]
        path = str(tmp_path / f"{h}x{w}_q{q}_r{ri}.jpg")
        assert cv2.imwrite(path, img, params)
        want = cv2.imread(path)[..., ::-1]
        got = imageio.imread(path)
        assert got.dtype == np.uint8 and got.shape == (h, w, 3)
        np.testing.assert_array_equal(got, want, err_msg=path)
        pil = np.asarray(Image.open(path).convert("RGB"))
        np.testing.assert_array_equal(imageio.read_jpeg(path), pil, err_msg=path)


def test_grace_hopper_matches_pil_and_the_smokes_digest():
    """The bundled photo decodes as PIL and cv2 decode it; its digest is the
    one chip_smoke.py holds the card's host to (no PIL there)."""
    want = np.asarray(Image.open(HOPPER))
    got = imageio.read_jpeg(HOPPER)
    assert got.shape == (600, 512, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(imageio.imread(HOPPER), cv2.imread(HOPPER)[..., ::-1])
    assert hashlib.sha256(want.tobytes()).hexdigest() == chip_smoke.HOPPER_SHA256


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_matches_cv2(orientation, tmp_path):
    img = np.random.default_rng(orientation).integers(0, 256, (16, 24, 3), np.uint8)
    exif = Image.Exif()
    exif[0x0112] = orientation
    path = str(tmp_path / "o.jpg")
    Image.fromarray(img).save(path, exif=exif.tobytes(), quality=90)
    assert imageio.exif_orientation((tmp_path / "o.jpg").read_bytes()) == orientation
    want = cv2.imread(path)[..., ::-1]
    assert want.shape == ((16, 24, 3) if orientation <= 4 else (24, 16, 3))
    np.testing.assert_array_equal(imageio.imread(path), want)
    np.testing.assert_array_equal(imageio.read_jpeg(path), np.asarray(Image.open(path)))


def test_unsupported_and_broken_files_raise(tmp_path):
    img = _image(np.random.default_rng(1), 40, 48)
    # progressive files read (tests/test_torch_jpeg_progressive.py); lossless,
    # arithmetic-coded and 12-bit ones raise, naming the file and the SOF
    progressive = str(tmp_path / "progressive.jpg")
    cv2.imwrite(progressive, img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    np.testing.assert_array_equal(imageio.imread(progressive), cv2.imread(progressive)[..., ::-1])
    data = cv2.imencode(".jpg", img)[1].tobytes()
    sof = data.index(b"\xff\xc0")
    for name, patched, match in (
            ("lossless.jpg", data[:sof + 1] + b"\xc3" + data[sof + 2:], "SOF3 .lossless"),
            ("arith.jpg", data[:sof + 1] + b"\xca" + data[sof + 2:], "SOF10 .arithmetic"),
            ("twelve.jpg", data[:sof + 4] + b"\x0c" + data[sof + 5:], "SOF0 .*12-bit")):
        (tmp_path / name).write_bytes(patched)
        with pytest.raises(NotImplementedError, match=f"{name}.*{match}"):
            imageio.imread(tmp_path / name)
    for name, cut in (("half.jpg", len(data) // 2), ("no_eoi.jpg", len(data) - 2),
                      ("header.jpg", 200)):
        (tmp_path / name).write_bytes(data[:cut])
        with pytest.raises(ValueError, match=name):
            imageio.imread(tmp_path / name)
    with pytest.raises(ValueError, match="not a JPEG"):
        imageio.read_jpeg(os.path.join(os.path.dirname(HOPPER), "README"))
    sof = data.index(b"\xff\xc0")  # a header claiming 65535 x 65535 pixels
    (tmp_path / "huge.jpg").write_bytes(data[:sof + 5] + b"\xff" * 4 + data[sof + 9:])
    with pytest.raises(ValueError, match="huge.jpg.*65535x65535"):
        imageio.imread(tmp_path / "huge.jpg")


def test_jpeg_frame_directory_reads_as_jax_reads_it(tmp_path):
    rng = np.random.default_rng(2)
    for i in range(3):
        cv2.imwrite(str(tmp_path / f"{i:03d}.jpg"), _image(rng, 24, 40))
    np.testing.assert_array_equal(pt_video.read_frame_dir(str(tmp_path)),
                                  jx_video.read_frame_dir(str(tmp_path)))


RESIZE_CASES = [
    ("hopper", (562, 562)),   # photo_video's 512x512 case: up in x, down in y
    ("hopper", (300, 200)),   # down
    ("hopper", (700, 900)),   # up
    ("hopper", (64, 80)),
    ("hopper", (513, 599)),
    ("hopper", (512, 300)),   # the width kept: one pass
    ("hopper", (1, 1)),
    ("random", (100, 20)),
    ("random", (53, 1)),      # 1-pixel output, the width kept
    ("random", (1, 200)),
]


@pytest.mark.parametrize("source,size", RESIZE_CASES)
def test_resize_u8_matches_pil_lanczos(source, size):
    if source == "hopper":
        img = np.asarray(Image.open(HOPPER))
    else:
        img = np.random.default_rng(3).integers(0, 256, (37, 53, 3), np.uint8)
    want = np.asarray(Image.fromarray(img).resize(size, Image.LANCZOS))
    got = resize_u8(img, size)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
