"""Matroska and WebM files (VP8, Motion-JPEG and mp4v video) through the
port against cv2 and JAX on the CPU.

JAX reads video through cv2.VideoCapture, whose backend here is FFmpeg:
its matroska demuxer, its vp8 decoder (bit-exact to libvpx) into yuv420p
and swscale's conversion to BGR24.  The port (pipeline/video.py over
utils/mkv.py and native/vp8.cpp, mjpeg.cpp and mpeg4.cpp) must return
cv2's frames bit for bit:
- on every committed Matroska / WebM fixture of tests/data/inputs/
  (tools/make_input_fixtures.py: cv2's VP80 .webm and .mkv, MJPG, mp4v and
  XVID .mkv; libvpx clips at odd sides with 8 token partitions, with
  hidden alt-ref frames, with segmentation, in versions 1-3; forged copies
  with unknown sizes, laced blocks, an audio track first, Colour and
  PixelCrop), whose digests chip_smoke.py pins for the card's host;
- on a seeded sweep of clips coded by cv2's libvpx through ctypes (sizes
  1-99, each version, 1-8 token partitions, two-pass alt-ref,
  error-resilient real-time coding, key frame intervals), muxed by the
  port's MkvMuxer;
- through JAX's read_video_frames and video_to_images, and
  interpolate_video_file (fusion) and `cli video` (adacof) on a 64x64 WebM
  against JAX's interpolate_video_file (>= 60 dB a frame, the originals
  exact).
images_to_video(".mkv") writes a file cv2 reads with the right count, fps
and size, whose frames cv2 and the port decode alike, equal to the
encoder's own reconstruction, within 1 dB below JAX's file.  What the port
cannot decode as cv2 does raises NotImplementedError naming it and item
18.4: AV1, H.264, HEVC and Theora tracks, a VP9 track in the reserved
colour space (VP9 in general: tests/test_torch_vp9_video.py),
ContentEncodings, an mp4v track
whose Colour says BT.709 or full range.
"""

import hashlib
import importlib.util
import os

import cv2
import numpy as np
import pytest
import torch

import chip_smoke
from fmvfi_tpu.eval import evaluate as jx_eval
from fmvfi_tpu.pipeline import video as jx_video
from fmvfi_tpu.utils import datasets as jx_data
from fmvfi_tpu_torch import cli as pt_cli
from fmvfi_tpu_torch import native
from fmvfi_tpu_torch.eval import evaluate as pt_eval
from fmvfi_tpu_torch.eval.synth import translation_video
from fmvfi_tpu_torch.pipeline import video as pt_video
from fmvfi_tpu_torch.utils import mkv, mp4
from fmvfi_tpu_torch.utils import datasets as pt_data

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUTS = os.path.join(ROOT, chip_smoke.INPUTS_DIR)
MKV_FIXTURES = sorted(n for n in chip_smoke.INPUT_PINS if n.endswith((".mkv", ".webm")))
_spec = importlib.util.spec_from_file_location(
    "make_input_fixtures", os.path.join(ROOT, "tools", "make_input_fixtures.py"))
TOOL = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(TOOL)
PIPE_DB = 60.0
F = native.VP8_FEATURES


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def toolchain():
    if not native.available():
        pytest.skip("no g++ on PATH: the native decoders cannot be built")


def cv2_frames(path):
    """cv2.VideoCapture's frames, RGB."""
    cap = cv2.VideoCapture(path)
    assert cap.getBackendName() == "FFMPEG"
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame[..., ::-1])
    cap.release()
    return frames


def assert_as_cv2(path, n=None):
    ours = list(pt_video.iter_video_frames(path))
    theirs = cv2_frames(path)
    assert len(ours) == len(theirs) and (n is None or len(ours) == n), (path, len(ours),
                                                                        len(theirs))
    for i, (a, b) in enumerate(zip(ours, theirs)):
        assert a.dtype == np.uint8 and a.shape == b.shape, (path, i, a.shape, b.shape)
        if not np.array_equal(a, b):
            raise AssertionError(f"{path} frame {i}: {int(np.abs(a.astype(int) - b).max())} "
                                 f"levels off at {int((a != b).any(-1).sum())} pixels")
    return ours


def vp8_features(path):
    """(feature bits, versions, partition counts, hidden frames) over a VP8 file."""
    track = mkv.open_video(path)
    dec = native.Vp8Decoder()
    bits, versions, parts, hidden = 0, set(), set(), 0
    for sample in mkv.iter_samples(track):
        dec.decode(sample)
        bits |= dec.info["features"]
        versions.add(dec.info["version"])
        parts.add(dec.info["partitions"])
        hidden += not dec.info["shown"]
    return bits, versions, parts, hidden


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


@pytest.mark.parametrize("name", MKV_FIXTURES)
def test_fixture_decodes_as_cv2_and_to_its_pin(toolchain, name):
    path = os.path.join(INPUTS, name)
    ours = assert_as_cv2(path)
    contract, digest = chip_smoke.INPUT_PINS[name]
    assert contract == "video"
    assert hashlib.sha256(np.stack(ours).tobytes()).hexdigest() == digest


def test_fixtures_cover_the_stream_features(toolchain):
    """Each libvpx fixture reaches what it was made for (read from the
    frame headers as the decoder parses them), and each forged container
    holds what it was forged with."""
    def at(name):
        return os.path.join(INPUTS, name)

    bits, versions, parts, hidden = vp8_features(at("vp8_odd_p8_95x71.webm"))
    assert parts == {8} and versions == {0}
    bits, _, parts, hidden = vp8_features(at("vp8_altref_45x37.webm"))
    assert hidden >= 1 and parts == {2}
    assert bits & F["sign_bias"] and bits & F["altref"] and bits & F["golden"]
    bits, _, _, _ = vp8_features(at("vp8_errres_seg_64x48.webm"))
    assert bits & F["segmentation"] and bits & F["segment_map"] and bits & F["keep_probs"]
    for v in (1, 2, 3):
        name = next(n for n in MKV_FIXTURES if n.startswith(f"vp8_v{v}_"))
        bits, versions, _, _ = vp8_features(at(name))
        assert versions == {v} and bits & F["simple_filter"], name
    bits, _, _, _ = vp8_features(at("vp8_cv2_96x72.webm"))
    assert not bits & F["simple_filter"]
    for name in ("splitmv", "intra_in_inter", "bpred_in_inter", "golden_altref_refs",
                 "lf_deltas"):
        assert bits & F[name], name
    base = mkv.open_video(at("vp8_cv2_96x72.webm"))
    assert (base.codec_id, base.width, base.height, len(base.sizes), round(base.fps, 6)) == \
        ("V_VP8", 96, 72, 15, 30.0)
    laced = open(at("vp8_laced_96x72.webm"), "rb").read()
    tree = TOOL.ebml_parse(laced)
    flags = {bytes(b)[3] & 0x06 for c in TOOL.ebml_find(tree, TOOL.SEGMENT) if c[0] == TOOL.CLUSTER
             for i, b in c[1] if i == 0xA3}
    groups = [b for c in TOOL.ebml_find(tree, TOOL.SEGMENT) if c[0] == TOOL.CLUSTER
              for i, b in c[1] if i == 0xA0]
    assert flags == {0, 2, 4, 6} and groups
    assert b"\x18\x53\x80\x67\x01\xff\xff\xff\xff\xff\xff\xff" in open(
        at("vp8_unknown_size_96x72.webm"), "rb").read()
    audio = mkv.open_video(at("vp8_audio_first_96x72.webm"))
    assert audio.number == 2 and len(audio.sizes) == 15
    for name in ("vp8_cv2_94x70.mkv", "mjpg_cv2_64x48.mkv", "mp4v_cv2_96x72.mkv",
                 "xvid_cv2_64x46.mkv"):
        assert mkv.open_video(at(name)).codec_id in mkv.CODECS


SWEEP = [  # (seed, encoder settings drawn per clip)
    (0, dict()), (1, dict(version=1)), (2, dict(version=2)), (3, dict(version=3)),
    (4, dict(partitions=3)), (5, dict(alt_ref=True)), (6, dict(error_resilient=True,
                                                             realtime=True, screen=True)),
    (7, dict(partitions=2, version=1)),
]


@pytest.mark.parametrize("seed,settings", SWEEP)
def test_libvpx_clips_decode_as_cv2(toolchain, tmp_path, seed, settings):
    """Clips coded by cv2's libvpx at any size (odd sides take swscale's
    filtering routes) with each version, partition count, alt-ref and
    error-resilient coding, muxed into WebM, against cv2."""
    rng = np.random.default_rng(300 + seed)
    for k in range(3):
        w, h = (int(v) for v in rng.integers(1, 100, 2))
        n = 24 if settings.get("alt_ref") else 10
        frames = TOOL.sliding(rng, n, h, w, step=tuple(float(v) for v in rng.uniform(-6, 6, 2)))
        kw = dict(settings, bitrate=int(rng.choice([40, 150, 600])),
                  kf_max_dist=int(rng.integers(3, 9)) if k == 1 else None)
        path = str(tmp_path / f"c{k}.webm")
        packets = TOOL.vp8_encode(frames, **kw)
        TOOL.vp8_webm(path, packets, w, h)
        assert len(assert_as_cv2(path)) == n
        assert assert_as_cv2(path)[0].shape == (h, w, 3)


def test_jax_readers_equal_the_ports(toolchain, tmp_path):
    for name in ("vp8_cv2_96x72.webm", "vp8_cv2_94x70.mkv", "mjpg_cv2_64x48.mkv",
                 "mp4v_cv2_96x72.mkv"):
        path = os.path.join(INPUTS, name)
        np.testing.assert_array_equal(pt_video.read_video_frames(path),
                                      jx_video.read_video_frames(path))
        np.testing.assert_array_equal(pt_video.read_video_frames(path, (33, 47)),
                                      jx_video.read_video_frames(path, (33, 47)))
    path = os.path.join(INPUTS, "vp8_odd_p8_95x71.webm")
    np.testing.assert_array_equal(pt_eval.load_set(path), jx_eval.load_set(path))
    np.testing.assert_array_equal(np.stack(list(pt_eval.load_set(path, stream=True)())),
                                  (jx_eval.load_set(path) * 255).round().astype(np.uint8))
    ours, theirs = tmp_path / "pt", tmp_path / "jx"
    assert pt_data.video_to_images(path, str(ours)) == jx_data.video_to_images(path, str(theirs))
    names = sorted(os.listdir(theirs))
    assert sorted(os.listdir(ours)) == names and len(names) == 12
    for name in names:
        a, b = cv2.imread(str(ours / name)), cv2.imread(str(theirs / name))
        assert a.shape == (720, 1280, 3)
        np.testing.assert_array_equal(a, b)


def test_images_to_video_mkv(toolchain, tmp_path):
    rng = np.random.default_rng(7)
    frames_dir = tmp_path / "frames"
    frames_dir.mkdir()
    src = TOOL.sliding(rng, 14, 71, 95)  # BGR; the writers crop to 94x70
    for i, f in enumerate(src):
        cv2.imwrite(str(frames_dir / f"{i:03d}.{'png' if i % 3 else 'jpg'}"), f)
    ours, theirs = str(tmp_path / "ours.mkv"), str(tmp_path / "jax.mkv")
    assert pt_data.images_to_video(str(frames_dir), ours) == ours
    jx_data.images_to_video(str(frames_dir), theirs)
    for path in (ours, theirs):
        cap = cv2.VideoCapture(path)
        assert (cap.get(cv2.CAP_PROP_FPS), cap.get(cv2.CAP_PROP_FRAME_WIDTH),
                cap.get(cv2.CAP_PROP_FRAME_HEIGHT)) == (30, 94, 70)
        cap.release()
    track = mkv.open_video(ours)
    assert track.codec_id == "V_MPEG4/ISO/ASP" and track.keyframes == [0, 12]
    decoded = assert_as_cv2(ours, 14)
    pixels = [cv2.imread(str(frames_dir / n))[:70, :94, ::-1]
              for n in sorted(os.listdir(frames_dir))]
    enc = native.Mpeg4Encoder(94, 70, 30, mp4.QUANT, mp4.GOP, in_band=False)
    assert enc.config == track.config
    for f, got in zip(pixels, decoded):
        enc.encode(np.ascontiguousarray(f))
        np.testing.assert_array_equal(enc.reconstruction(), got)
    ours_db = np.mean([_psnr(a, b) for a, b in zip(decoded, pixels)])
    jax_db = np.mean([_psnr(a, b) for a, b in zip(cv2_frames(theirs), pixels)])
    print(f"mkv: port {ours_db:.2f} dB, {os.path.getsize(ours)} bytes; "
          f"JAX (cv2) {jax_db:.2f} dB, {os.path.getsize(theirs)} bytes")
    assert ours_db >= jax_db - 1.0, (ours_db, jax_db)


def _with_track(tmp_path, name, edit):
    """A copy of the cv2 .webm (or, for "mp4v", the cv2 mp4v .mkv; for
    "vp9", the cv2 VP9 .webm) whose TrackEntry children edit(list, tree)
    changes (the tree: the whole file's elements)."""
    src = ("mp4v_cv2_96x72.mkv" if name.startswith("mp4v") else
           "vp9_cv2_96x72.webm" if name.startswith("vp9") else "vp8_cv2_96x72.webm")
    tree = TOOL.ebml_strip(TOOL.ebml_parse(open(os.path.join(INPUTS, src), "rb").read()))
    edit(TOOL.ebml_find(tree, TOOL.SEGMENT, TOOL.TRACKS, 0xAE), tree)
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(TOOL.ebml_dump(tree))
    return path


def _codec(codec_id):
    def edit(entry, tree=None):
        for e in entry:
            if e[0] == 0x86:
                e[1] = codec_id
    return edit


def _colour(crop=(), **values):
    """A Colour element of `values` (and PixelCrop elements) in the Video element."""
    ids = dict(matrix=0x55B1, range=0x55B9, siting_h=0x55B7, siting_v=0x55B8)

    def edit(entry, tree=None):
        video = next(e[1] for e in entry if e[0] == 0xE0)
        video.append([0x55B0, [TOOL._uint(ids[k], v) for k, v in values.items()]])
        video.extend(TOOL._uint(eid, v) for eid, v in crop)
    return edit


def _vp9_reserved_colour(entry, tree):
    """The VP9 track's (profile 0) key frame given the reserved colour space
    (6), which cv2 converts with no swscale matrix."""
    cluster = next(c for c in TOOL.ebml_find(tree, TOOL.SEGMENT) if c[0] == TOOL.CLUSTER)
    block = next(e for e in cluster[1] if e[0] == 0xA3)
    data = bytearray(block[1])
    # after the track number, timecode and flags (4 bytes), the frame's
    # marker, profile, flags and sync code (32 bits): color_space, 3 bits
    data[8] = (data[8] & 0x1F) | (6 << 5)
    block[1] = bytes(data)


@pytest.mark.parametrize("name,edit,what", [
    ("vp9.webm", _vp9_reserved_colour, "reserved VP9 colour space"),
    ("av1.webm", _codec(b"V_AV1"), "V_AV1"),
    ("avc.mkv", _codec(b"V_MPEG4/ISO/AVC"), "V_MPEG4/ISO/AVC"),
    ("hevc.mkv", _codec(b"V_MPEGH/ISO/HEVC"), "V_MPEGH/ISO/HEVC"),
    ("theora.mkv", _codec(b"V_THEORA"), "V_THEORA"),
    ("enc.webm", lambda entry, tree: entry.append(
        [0x6D80, [[0x6240, [TOOL._uint(0x5032, 1)]]]]), "ContentEncodings"),
    ("mp4v_709.mkv", _colour(matrix=1), "MatrixCoefficients 1"),
    ("mp4v_full.mkv", _colour(range=2), "Range 2"),
])
def test_what_the_port_refuses(toolchain, tmp_path, name, edit, what):
    path = _with_track(tmp_path, name, edit)
    with pytest.raises(NotImplementedError, match=f"{what}.*item 18.4"):
        list(pt_video.iter_video_frames(path))


def test_what_cv2_ignores_the_port_ignores(toolchain, tmp_path):
    """BT.601, limited range, a chroma siting and a PixelCrop on an mp4v
    track, and a VP8 track's Colour and PixelCrop (the committed
    vp8_colour_crop fixture), leave cv2's frames as they are: the port's
    are equal."""
    path = _with_track(tmp_path, "mp4v_601.mkv", _colour(
        crop=((0x54BB, 2), (0x54CC, 4)), matrix=6, range=1, siting_h=1, siting_v=1))
    assert assert_as_cv2(path, 15)[0].shape == (72, 96, 3)
    assert len(assert_as_cv2(os.path.join(INPUTS, "vp8_colour_crop_96x72.webm"))) == 15


def test_malformed_frames_raise_value_error(toolchain, tmp_path):
    """A frame whose header claims more bytes than it has: cv2 skips it and
    decodes the next frames from stale references, the port raises."""
    data = bytearray(open(os.path.join(INPUTS, "vp8_cv2_96x72.webm"), "rb").read())
    track = mkv.open_video(os.path.join(INPUTS, "vp8_cv2_96x72.webm"))
    data[track.offsets[1]:track.offsets[1] + 3] = b"\xff\xff\xff"
    (tmp_path / "bad.webm").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="frame 1: .*larger than its data"):
        list(pt_video.iter_video_frames(str(tmp_path / "bad.webm")))
    with pytest.raises(ValueError, match="no frames decoded"):
        pt_video.read_video_frames(str(tmp_path / "missing.webm"))
    # a key frame that fails part way leaves no references: the next inter
    # frame raises, where it would read pictures the key frame replaced
    frames = list(mkv.iter_samples(track))
    dec = native.Vp8Decoder()
    assert dec.decode(frames[0]).shape == (72, 96, 3)
    with pytest.raises(ValueError, match="token partition read past its end"):
        dec.decode(frames[0][:600])
    with pytest.raises(ValueError, match="without a decoded key frame"):
        dec.decode(frames[1])
    assert dec.decode(frames[0]) is not None and dec.decode(frames[1]) is not None


@pytest.mark.parametrize("frames_kept", [4, 9])
def test_a_file_cut_short_reads_as_cv2(toolchain, tmp_path, frames_kept):
    """A recording cut off inside a block (the Segment and Cluster sizes
    then run past the file): FFmpeg's demuxer stops at the cut block, and
    cv2 returns the frames before it; so does the port."""
    src = os.path.join(INPUTS, "vp8_cv2_96x72.webm")
    track = mkv.open_video(src)
    cut = track.offsets[frames_kept] + track.sizes[frames_kept] // 2
    (tmp_path / "cut.webm").write_bytes(open(src, "rb").read()[:cut])
    assert len(assert_as_cv2(str(tmp_path / "cut.webm"))) == frames_kept


@pytest.fixture(scope="module")
def weights():
    """(JAX FusionWeights, port FusionModels): the bundled AdaCoF, a
    fixed-key PhaseNet and a fixed-key variant-0 FusionNet with 3 maps (as
    test_torch_mjpg_video.py builds them)."""
    import jax
    import jax.numpy as jnp
    from flax import serialization

    from fmvfi_tpu.models import fusion_net as jx_fusion
    from fmvfi_tpu.models import phase_net as jx_phase
    from fmvfi_tpu.pipeline import interpolate as jx_pipe
    from fmvfi_tpu_torch.models.adacof import AdaCoFNet
    from fmvfi_tpu_torch.models.fusion_net import FusionNet
    from fmvfi_tpu_torch.models.phase_net import PhaseNetCore
    from fmvfi_tpu_torch.pipeline import interpolate as pt_pipe
    from fmvfi_tpu_torch.utils import convert

    with open(os.path.join(ROOT, "checkpoints", "adacof_synth_demo.msgpack"), "rb") as f:
        ada_tree = serialization.msgpack_restore(f.read())
    low, lev = jnp.zeros((1, 4, 4, 2)), [jnp.zeros((1, 4, 4, 8))] * 7
    phase_tree = jax.tree.map(np.asarray, jax.jit(
        lambda k: jx_phase.PhaseNetCore(num_img=2).init(k, low, lev, lev))(jax.random.key(0)))
    z = jnp.zeros((1, 16, 16, 3))
    fusion_tree = jax.tree.map(np.asarray, jax.jit(
        lambda k: jx_fusion.FusionNet(uncertainty_maps=3).init(
            k, z, z, z, jnp.zeros((1, 16, 16, 6)), jnp.zeros((1, 16, 16, 3)), 0))(
        jax.random.key(1)))
    jx = jx_pipe.FusionWeights(phase_net=phase_tree, adacof=ada_tree, fusion_net=fusion_tree)
    phase = PhaseNetCore().eval()
    phase.load_state_dict(convert.phase_net_from_flax(phase_tree))
    ada = AdaCoFNet().eval()
    ada.load_state_dict(convert.adacof_from_flax(ada_tree))
    fusion = FusionNet().eval()
    fusion.load_state_dict(convert.fusion_net_from_flax(fusion_tree))
    return jx, pt_pipe.FusionModels(phase, ada, fusion)


def test_cli_video_and_interpolate_on_a_webm_match_jax(toolchain, tmp_path, weights):
    """`cli video` (adacof, the bundled weights) and interpolate_video_file
    (fusion) on a 3-frame 64x64 WebM against JAX's interpolate_video_file
    through cv2."""
    jx, pt = weights
    clip = (translation_video(3, 64, 64, step=2.0, seed=0) * 255).astype(np.uint8)
    src = str(tmp_path / "clip.webm")
    TOOL.vp8_webm(src, TOOL.vp8_encode([np.ascontiguousarray(f[..., ::-1]) for f in clip],
                                       bitrate=2000), 64, 64)
    pt_cli.main(["video", "--input", src, "--output_dir", str(tmp_path / "cli"), "--method",
                 "adacof", "--device", "cpu"])
    assert jx_video.interpolate_video_file(src, str(tmp_path / "jx_ada"), jx, "adacof") == 5
    n = pt_video.interpolate_video_file(src, str(tmp_path / "pt"), pt, "fusion", device="cpu")
    assert n == jx_video.interpolate_video_file(src, str(tmp_path / "jx"), jx, "fusion") == 5
    for ours_dir, theirs_dir in (("cli", "jx_ada"), ("pt", "jx")):
        names = sorted(os.listdir(tmp_path / ours_dir))
        assert len(names) == 5
        for i, name in enumerate(names):
            ours = cv2.imread(str(tmp_path / ours_dir / name))
            theirs = cv2.imread(str(tmp_path / theirs_dir / f"{i:05d}.png"))
            if i % 2 == 0:  # the decoded originals, quantized alike
                np.testing.assert_array_equal(ours, theirs)
            assert _psnr(ours, theirs) >= PIPE_DB, (ours_dir, i, _psnr(ours, theirs))
