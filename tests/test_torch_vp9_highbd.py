"""VP9 profiles 2 and 3 (10 and 12 bits a sample) through the port against
cv2, libvpx and JAX on the CPU.

cv2.VideoCapture decodes them with FFmpeg's vp9 decoder into yuv420p10,
yuv422p10, yuv440p10, yuv444p10 (or their 12-bit forms) and converts them
to BGR24 with swscale, whose 16-bit input (hScale16To15) feeds the same
vertical scalers and output routes as 8-bit planes; it returns (H, W, 3)
uint8 frames.  The port (native/vp9.cpp with its samples in 16 bits,
ffmpeg_common.h's yuv_to_rgb at the stream's depth) must return cv2's
frames bit for bit:
- on every committed profile 2 / 3 fixture (tools/make_input_fixtures.py
  group vp9_highbd: each sampling at 10 and 12 bits with odd and even
  sides, lossless coding, two-pass alt-ref frames, error-resilient coding,
  tile columns, BT.709 at full range and BT.2020, in WebM, Matroska, MP4,
  AVI and IVF, and the smoke's 1080p 10-bit clip), against cv2, JAX's
  read_video_frames and the pins chip_smoke.py holds for the card's host;
- on seeded libvpx clips at random sizes (1-99) in each sampling at 10
  and 12 bits, against cv2, and their planes against libvpx's own decoder
  (cv2's bundled libvpx through ctypes);
- the conversion alone (native.yuv16_swscale, the decoder's) against cv2's
  own libswscale through ctypes (sws_getContext(..., bgr24, SWS_BICUBIC),
  as OpenCV calls it) on random, extreme (0 / max) and near-white planes
  at every size class: the MMX rows, the C rows and their luma past 255,
  the full-chroma route.
Malformed high-bit-depth streams raise ValueError.
"""

import ctypes
import glob
import hashlib
import importlib.util
import os

import cv2
import numpy as np
import pytest

import chip_smoke
from fmvfi_tpu.pipeline import video as jx_video
from fmvfi_tpu_torch import native
from fmvfi_tpu_torch.pipeline import video as pt_video
from fmvfi_tpu_torch.utils import avi, ivf, mkv, mp4
from test_torch_vp9_video import assert_as_cv2

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUTS = os.path.join(ROOT, chip_smoke.INPUTS_DIR)
FIXTURES = sorted(n for n in chip_smoke.INPUT_PINS if n.startswith(("vp9_hbd", "ivf_vp9_hbd")))
_spec = importlib.util.spec_from_file_location(
    "make_input_fixtures", os.path.join(ROOT, "tools", "make_input_fixtures.py"))
TOOL = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(TOOL)
SAMPLINGS = {"420": (1, 1), "422": (1, 0), "444": (0, 0), "440": (0, 1)}


@pytest.fixture
def toolchain():
    if not native.available():
        pytest.skip("no g++ on PATH: the native decoders cannot be built")


def packets(path):
    if path.endswith((".webm", ".mkv")):
        return list(mkv.iter_samples(mkv.open_video(path)))
    if path.endswith(".mp4"):
        return list(mp4.iter_samples(mp4.open_video(path)))
    if path.endswith(".ivf"):
        return list(ivf.iter_frames(ivf.open_video(path)))
    return list(avi.iter_frames(avi.open_video(path)))


def libvpx_planes(data):
    """The shown frames' (Y, U, V) uint16 planes of libvpx's VP9 decoder
    (vpx_image_t read as its fields' offsets: fmt, d_w, d_h, the chroma
    shifts, planes, strides)."""
    lib = TOOL._libvpx()
    vp = ctypes.c_void_p
    lib.vpx_codec_vp9_dx.restype = vp
    lib.vpx_codec_dec_init_ver.argtypes = [vp, vp, vp, ctypes.c_long, ctypes.c_int]
    lib.vpx_codec_decode.argtypes = [vp, ctypes.c_char_p, ctypes.c_uint, vp, ctypes.c_long]
    lib.vpx_codec_get_frame.argtypes = [vp, vp]
    lib.vpx_codec_get_frame.restype = vp
    ctx = ctypes.create_string_buffer(1024)
    for abi in range(64):  # VPX_DECODER_ABI_VERSION of this build
        err = lib.vpx_codec_dec_init_ver(ctx, lib.vpx_codec_vp9_dx(), None, 0, abi)
        if err != 3:
            break
    assert err == 0
    out = []
    try:
        for p in data:
            assert lib.vpx_codec_decode(ctx, p, len(p), None, 0) == 0
            it = ctypes.c_void_p(0)
            while True:
                img = lib.vpx_codec_get_frame(ctx, ctypes.byref(it))
                if not img:
                    break
                field = [ctypes.c_int.from_address(img + 4 * k).value for k in range(12)]
                fmt, dw, dh, xs, ys = field[0], field[6], field[7], field[10], field[11]
                assert fmt & 0x800, "a high-bit-depth image"
                planes = []
                for k in range(3):
                    ptr = ctypes.c_void_p.from_address(img + 48 + 8 * k).value
                    stride = ctypes.c_int.from_address(img + 80 + 4 * k).value
                    w, h = (dw, dh) if k == 0 else ((dw + xs) >> xs, (dh + ys) >> ys)
                    rows = np.frombuffer(ctypes.string_at(ptr, stride * h), np.uint16)
                    planes.append(rows.reshape(h, stride // 2)[:, :w].copy())
                out.append(planes)
    finally:
        lib.vpx_codec_destroy(ctx)
    return out


def _libswscale_bgr(y, u, v, depth):
    """cv2's libswscale (opencv_python.libs) converting planes of `depth`
    bits to BGR24 as OpenCV's video reader asks it to; returned RGB."""
    libs = os.path.join(os.path.dirname(os.path.dirname(cv2.__file__)), "opencv_python.libs")
    util, sws = (ctypes.CDLL(glob.glob(os.path.join(libs, f"lib{n}-*.so*"))[0],
                             mode=ctypes.RTLD_GLOBAL) for n in ("avutil", "swscale"))
    vp = ctypes.c_void_p
    util.av_get_pix_fmt.argtypes, util.av_get_pix_fmt.restype = [ctypes.c_char_p], ctypes.c_int
    sws.sws_getContext.argtypes = [ctypes.c_int] * 7 + [vp, vp, vp]
    sws.sws_getContext.restype = vp
    sws.sws_scale.argtypes = [vp, vp, vp, ctypes.c_int, ctypes.c_int, vp, vp]
    sws.sws_freeContext.argtypes = [vp]
    h, w = y.shape
    ss = (int(u.shape[1] < w), int(u.shape[0] < h))
    name = {(1, 1): "yuv420p", (1, 0): "yuv422p", (0, 0): "yuv444p", (0, 1): "yuv440p"}[ss]
    fmt = util.av_get_pix_fmt((name if depth == 8 else f"{name}{depth}le").encode())
    ctx = sws.sws_getContext(w, h, fmt, w, h, util.av_get_pix_fmt(b"bgr24"), 4, None, None, None)
    planes = [np.ascontiguousarray(p, np.uint8 if depth == 8 else np.uint16) for p in (y, u, v)]
    src = (ctypes.c_void_p * 4)(*[p.ctypes.data for p in planes], None)
    strides = (ctypes.c_int * 4)(*[p.strides[0] for p in planes], 0)
    pitch = w * 3 + 64  # room for the SIMD writers past a row's end
    buf = np.zeros((h + 2) * pitch, np.uint8)
    sws.sws_scale(ctx, src, strides, 0, h, (ctypes.c_void_p * 4)(buf.ctypes.data, None, None, None),
                  (ctypes.c_int * 4)(pitch, 0, 0, 0))
    sws.sws_freeContext(ctx)
    return buf[:h * pitch].reshape(h, pitch)[:, :w * 3].reshape(h, w, 3)[..., ::-1]


# extreme alternating chroma at 4:4:0 (even widths' half-width route, whose
# downscaling filter overshoots below 0) pins ROADMAP Q3-10: swscale's
# yuv2packed1 averages two such lines with a logical shift; depth 8 runs
# the 8-bit formats' routes
@pytest.mark.parametrize("fmt,mode", [(f, m) for f in sorted(SAMPLINGS)
                                      for m in ("random", "extreme", "white")])
@pytest.mark.parametrize("depth", [8, 10, 12])
def test_swscale_16_bit_routes_against_libswscale(toolchain, depth, fmt, mode):
    rng = np.random.default_rng(depth * 100 + sorted(SAMPLINGS).index(fmt) * 10 + len(mode))
    sx, sy = SAMPLINGS[fmt]
    top = (1 << depth) - 1
    for h, w in ((8, 8), (8, 7), (7, 8), (7, 7), (1, 1), (2, 3), (3, 2), (5, 4), (37, 45),
                 (36, 46), (40, 520)):
        shapes = ((h, w), ((h + sy) >> sy, (w + sx) >> sx), ((h + sy) >> sy, (w + sx) >> sx))
        if mode == "random":
            y, u, v = (rng.integers(0, top + 1, s) for s in shapes)
        elif mode == "extreme":
            y, u, v = (rng.choice([0, top], s) for s in shapes)
        else:  # luma near white: the C rows' Y reaches 256
            y = rng.integers(top - 40, top + 1, shapes[0])
            u, v = (rng.integers(0, top + 1, s) for s in shapes[1:])
        y, u, v = (a.astype(np.uint16) for a in (y, u, v))
        np.testing.assert_array_equal(native.yuv16_swscale(y, u, v, depth),
                                      _libswscale_bgr(y, u, v, depth), err_msg=f"{w}x{h}")


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_decodes_as_cv2_jax_and_its_pin(toolchain, name):
    path = os.path.join(INPUTS, name)
    ours = assert_as_cv2(path)
    contract, digest = chip_smoke.INPUT_PINS[name]
    assert contract == "video"
    assert hashlib.sha256(np.stack(ours).tobytes()).hexdigest() == digest
    if name != chip_smoke.INPUTS_VP9_10BIT:  # JAX's reader is plain cv2 (the 1080p clip: above)
        np.testing.assert_array_equal(pt_video.read_video_frames(path),
                                      jx_video.read_video_frames(path))


def test_a_corrupt_clip_past_the_12_bit_range_decodes_as_cv2(toolchain):
    """ROADMAP Q3-11: a copy of the 12-bit lossless 4:4:4 fixture with 8 bits
    flipped, whose inter frames lose lossless coding and carry coefficients
    past the 12-bit range (libvpx rejects the clip): residuals past 16 bits,
    which x86's 16-bpp transforms saturate and add to the samples in 16
    bits, decode equal to cv2 and to the pin."""
    source, name, _ = TOOL.VP9_Q3_11
    assert name in chip_smoke.INPUT_PINS and source in FIXTURES
    path = os.path.join(INPUTS, name)
    ours = assert_as_cv2(path, 3)
    assert hashlib.sha256(np.stack(ours).tobytes()).hexdigest() == chip_smoke.INPUT_PINS[name][1]
    dec = native.Vp9Decoder()
    lossless = [dec.decode(p) is not None and bool(dec.info["features"] & native.VP9_FEATURES[
        "lossless"]) for p in packets(path)]
    assert lossless[0] and not lossless[1]


def test_fixtures_are_what_they_were_made_for(toolchain):
    """Each fixture's headers, as the decoder parses them: the profile, bit
    depth, sampling, colour config and the coding tools it was made with."""
    F = native.VP9_FEATURES

    def facts(name):
        dec = native.Vp9Decoder()
        bits, seen = 0, {}
        for p in packets(os.path.join(INPUTS, name)):
            dec.decode(p)
            bits |= dec.info["features"]
            for k, v in dec.info.items():
                seen.setdefault(k, set()).add(v)
        return bits, seen

    depths = set()
    for name in FIXTURES:
        bits, seen = facts(name)
        bd = 10 if "hbd10" in name else 12
        fmt = next((f for f in SAMPLINGS if f"_{f}_" in name), "420")
        sx, sy = SAMPLINGS[fmt]
        assert seen["bit_depth"] - {0} == {bd}, name
        assert seen["profile"] == {2 + (fmt != "420")}, name
        assert (seen["ss_x"], seen["ss_y"]) == ({sx}, {sy}), name
        depths |= {(bd, fmt)}
        want = {"lossless": ["lossless"], "altref": ["superframe", "hidden", "compound"],
                "errres": ["error_resilient"], "tilecols": ["tile_cols"],
                "bt709_full": ["full_range"]}
        for key, features in want.items():
            if key in name:
                assert all(bits & F[f] for f in features), (name, key)
        if "bt709" in name:
            assert seen["color_space"] == {2}
        if "bt2020" in name:
            assert seen["color_space"] == {5}
    assert depths == {(bd, f) for bd in (10, 12) for f in SAMPLINGS}
    suffixes = {os.path.splitext(n)[1] for n in FIXTURES}
    assert suffixes == {".webm", ".mkv", ".mp4", ".avi", ".ivf"}
    vpcc = mp4.open_video(os.path.join(INPUTS, "vp9_hbd12_444_64x48.mp4")).config
    assert vpcc[4] == 0  # cv2's vpcC says profile 0: the stream's header decides


@pytest.mark.parametrize("bit_depth", [10, 12])
@pytest.mark.parametrize("fmt", sorted(SAMPLINGS))
def test_libvpx_clips_decode_as_cv2_and_libvpx(toolchain, tmp_path, fmt, bit_depth):
    """Seeded clips at random sizes 1-99 (each size class of swscale's
    routes over the cases), coded by cv2's libvpx at the depth: the port's
    planes equal libvpx's decoder's, its frames cv2's."""
    rng = np.random.default_rng(7000 + 10 * bit_depth + sorted(SAMPLINGS).index(fmt))
    for k in range(2):
        w, h = (int(v) for v in rng.integers(1, 100, 2))
        frames = TOOL.sliding(rng, 5, h, w, step=tuple(float(v) for v in rng.uniform(-6, 6, 2)))
        kw = dict(frame_parallel=int(rng.integers(0, 2)), bitrate=int(rng.choice([40, 150, 600])))
        if k:
            kw.update(lossless=int(rng.integers(0, 2)), color_space=int(rng.choice([0, 1, 2, 5])),
                      color_range=int(rng.integers(0, 2)))
        data = TOOL.vp9_encode(frames, fmt=fmt, bit_depth=bit_depth, **kw)
        dec = native.Vp9Decoder()
        ours = []
        for p in data:
            for i, _ in enumerate(dec.decode(p)):
                ours.append(dec.planes(i))
        theirs = libvpx_planes(data)
        assert len(ours) == len(theirs) == 5
        for i, (a, b) in enumerate(zip(ours, theirs)):
            for c in range(3):
                np.testing.assert_array_equal(a[c], b[c], err_msg=f"{fmt} {bit_depth} {w}x{h} "
                                              f"frame {i} plane {c}")
        path = str(tmp_path / f"c{k}.webm")
        TOOL.vp9_webm(path, data, w, h)
        assert assert_as_cv2(path, 5)[0].shape == (h, w, 3)


def _clip(bit_depth=10, fmt="420"):
    rng = np.random.default_rng(13)
    return TOOL.vp9_encode(TOOL.sliding(rng, 4, 24, 32), fmt=fmt, bit_depth=bit_depth,
                           bitrate=100)


def _bits(frame, pos, n, value):
    return TOOL.set_bits(frame, pos, n, value)


def test_malformed_high_bit_depth_streams_raise_value_error(toolchain, tmp_path):
    """A profile 3 header's reserved bit, 4:2:0 coded in profile 3, the
    colour config's reserved bit, a key frame cut short: ValueError naming
    it, as FFmpeg's decoder fails them."""
    p2, p3 = _clip(10, "420"), _clip(12, "444")
    # profile 3: marker (2 bits), profile (2), reserved (1), show_existing,
    # frame type, show, error resilient, sync code (24), ten_or_twelve_bit,
    # colour space (3), range, subsampling x and y, reserved
    cases = [
        ("reserved.webm", [_bits(p3[0], 4, 1, 1)] + p3[1:], "reserved bit set"),
        ("p3_420.webm", [_bits(p3[0], 38, 2, 3)] + p3[1:], "4:2:0 in VP9 profile 3"),
        ("cc_reserved.webm", [_bits(p3[0], 40, 1, 1)] + p3[1:], "reserved bit set"),
        ("cut.webm", [p2[0][:6]] + p2[1:], "past the frame's end"),
    ]
    for name, data, what in cases:
        path = str(tmp_path / name)
        TOOL.vp9_webm(path, data, 32, 24)
        with pytest.raises(ValueError, match=f"frame \\d+: .*{what}"):
            list(pt_video.iter_video_frames(path))


def test_eight_bit_and_high_bit_depth_key_frames_alternate(toolchain, tmp_path):
    """A stream whose key frames change the depth (8, 10, 12, 8 bits):
    each key frame sets the depth its inter frames decode at, as cv2's
    decoder reallocates its frames."""
    rng = np.random.default_rng(21)
    frames = TOOL.sliding(rng, 3, 20, 28)
    data = []
    for bd in (8, 10, 12, 8):
        data += TOOL.vp9_encode(frames, bit_depth=bd, bitrate=120)
    path = str(tmp_path / "depths.webm")
    TOOL.vp9_webm(path, data, 28, 20)
    dec = native.Vp9Decoder()
    depths = [dec.decode(p) and dec.info["bit_depth"] for p in data]
    assert depths == [8] * 3 + [10] * 3 + [12] * 3 + [8] * 3
    assert_as_cv2(path, 12)
