"""The port's JPEG writer against cv2 on the CPU:

- native/jpeg_enc.cpp through utils/imageio.imwrite byte-equal to
  cv2.imwrite of the same pixels (libjpeg-turbo: 4:2:0, the standard
  Huffman tables, JFIF 1.01) on 48 seeded images, 1x1 to 97x97 with odd
  sides where the MCU edges are padded, RGB and grey, at cv2's default
  quality 95 and at 10 and 75 (IMWRITE_JPEG_QUALITY); each file read back
  by the port's imread bit-equal to cv2.imread;
- the extension choosing the format as cv2.imwrite does (.png, .jpg,
  .jpeg, .jpe, .bmp, .tif, any case, each cv2's bytes; .webp a lossless
  file cv2 reads back as written) and .gif, .exr or no extension raising
  NotImplementedError;
- native.jpeg_encode's byte stuffing (0xFF00) on noise at quality 100;
- the digests of cv2.imencode('.jpg') that chip_smoke.py holds the card's
  host build of the writer to (JPEG_PINS), and the writer's bytes equal
  to cv2's there.
"""

import hashlib
import itertools
import json
import os

import cv2
import numpy as np
import pytest

import chip_smoke
from fmvfi_tpu_torch import native
from fmvfi_tpu_torch.eval.synth import SAMPLE_DATA
from fmvfi_tpu_torch.utils import imageio

SIZES = [(1, 1), (1, 97), (97, 1), (8, 8), (15, 17), (16, 16), (37, 53), (97, 64)]
QUALITIES = [95, 10, 75]


@pytest.fixture(scope="module")
def toolchain():
    if not native.available():
        pytest.skip("the native library does not build here (no g++)")


def _image(rng, h, w, grey):
    """Gradients plus noise: large and small coefficients, long runs and
    0xFF bytes in the entropy-coded data."""
    y, x = np.mgrid[:h, :w]
    img = np.stack([np.sin(x / 4.0 + c) * 70 + np.cos(y / 6.0 + c) * 50 + 128 for c in range(3)],
                   -1)
    img = np.clip(img + rng.normal(0, 30, img.shape), 0, 255).astype(np.uint8)
    return img[..., 0] if grey else img


@pytest.mark.parametrize("quality", QUALITIES)
def test_imwrite_jpeg_is_byte_equal_to_cv2(toolchain, tmp_path, quality):
    rng = np.random.default_rng(quality)
    for (h, w), grey in itertools.product(SIZES, (False, True)):
        img = _image(rng, h, w, grey)
        ours, ref = tmp_path / "ours.jpg", tmp_path / "ref.jpg"
        if quality == 95:
            imageio.imwrite(ours, img)  # cv2's default quality
            assert cv2.imwrite(str(ref), img if grey else img[..., ::-1])
        else:
            imageio.imwrite(ours, img, quality=quality)
            assert cv2.imwrite(str(ref), img if grey else img[..., ::-1],
                               [cv2.IMWRITE_JPEG_QUALITY, quality])
        assert ours.read_bytes() == ref.read_bytes(), (h, w, grey, quality)
        want = cv2.cvtColor(cv2.imread(str(ref)), cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(imageio.imread(ours), want, err_msg=f"{(h, w, grey)}")


def test_the_extension_picks_the_format(toolchain, tmp_path):
    img = _image(np.random.default_rng(1), 9, 13, False)
    for name in ("a.JPG", "b.jpeg", "c.jpe"):
        imageio.imwrite(tmp_path / name, img)
        ok, ref = cv2.imencode(".jpg", img[..., ::-1])
        assert ok and (tmp_path / name).read_bytes() == ref.tobytes(), name
    imageio.imwrite(tmp_path / "d.PNG", img)
    assert (tmp_path / "d.PNG").read_bytes().startswith(imageio.SIGNATURE)
    np.testing.assert_array_equal(imageio.imread(tmp_path / "d.PNG"), img)
    for name in ("e.BMP", "f.tif"):
        imageio.imwrite(tmp_path / name, img)
        ok, ref = cv2.imencode(os.path.splitext(name)[1].lower(), img[..., ::-1])
        assert ok and (tmp_path / name).read_bytes() == ref.tobytes(), name
    imageio.imwrite(tmp_path / "e.WEBP", img)  # lossless: cv2 reads back the pixels written
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "e.WEBP"))[..., ::-1], img)
    for name in ("e.gif", "f.exr", "g"):
        with pytest.raises(NotImplementedError, match=name):
            imageio.imwrite(tmp_path / name, img)
        assert not os.path.exists(tmp_path / name)


def test_encoder_stuffs_ff_bytes_on_noise_at_quality_100(toolchain):
    """A noise image at quality 100 codes long, 0xFF-rich data (nearly a
    byte per sample): every 0xFF in the scan is followed by 0x00 (no stray
    marker), and the file is cv2's."""
    img = np.random.default_rng(2).integers(0, 256, (40, 24, 3), dtype=np.uint8)
    data = native.jpeg_encode(img, 100)
    assert len(data) > 0.9 * img.size
    ok, ref = cv2.imencode(".jpg", img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 100])
    assert data == ref.tobytes()
    scan = data[data.index(b"\xff\xda") + 14 : -2]  # after SOS (3 components), before EOI
    ff = [i for i, b in enumerate(scan) if b == 0xFF]
    assert ff and all(scan[i + 1] == 0 for i in ff)
    with pytest.raises(ValueError):
        native.jpeg_encode(np.zeros((4, 4, 4), np.uint8))


def test_the_smokes_jpeg_pins_are_cv2s(toolchain):
    """JPEG_PINS are the digests of cv2.imencode('.jpg') of their images
    (grace_hopper.jpg as the port decodes it, its green channel, a pattern
    at the eval panels' size) at their qualities, and the port's writer
    meets them here as chip_smoke.py asks it to on the card's host."""
    hopper = imageio.read_jpeg(os.path.join(SAMPLE_DATA, "grace_hopper.jpg"))
    images = chip_smoke._jpeg_pin_images(hopper)
    assert images["pattern"].shape == chip_smoke.EVAL_PANEL_SHAPE
    for (name, q), digest in chip_smoke.JPEG_PINS.items():
        img = images[name]
        ok, ref = cv2.imencode(".jpg", img if img.ndim == 2 else img[..., ::-1],
                               [cv2.IMWRITE_JPEG_QUALITY, q])
        assert ok and hashlib.sha256(ref.tobytes()).hexdigest() == digest, (name, q)
    pins = chip_smoke._jpeg_pins(hopper)
    json.dumps(pins)  # the smoke prints it on its photo_data line
    assert pins["ok"] and len(pins["cv2_bytes_equal"]) == len(chip_smoke.JPEG_PINS)
    assert pins["hopper_q95_db"] >= chip_smoke.JPEG_HOPPER_DB
