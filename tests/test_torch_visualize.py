"""The port's figures (eval/visualize.py, utils/raster.py, utils/avi.py,
train/loop.py's MetricsWriter.plot) against JAX's matplotlib figures and
cv2 on the CPU:

- the glyph atlas equal to what tools/make_glyph_atlas.py generates, `jet`
  and `tab10` equal to matplotlib's;
- resize_bilinear_u8 bit-equal to cv2.resize (INTER_LINEAR) on 36 seeded
  up-, down- and mixed sizes;
- prediction_panel for 1-4 methods: 330 (n + 1) x 660 px, each image box
  within 2 px of the window extent of JAX's axes (drawn at 110 dpi), its
  pixels the port's resize of its frame or |diff| map, and its content
  >= 20 dB against JAX's figure's, both crops area-averaged to the frame's
  size;
- metric_bars for 1 and 2 metrics: 660 k x 440 px, each bar's left and
  top within 2 px of JAX's bar patch, and its colour there; an inf and a
  NaN metric not drawn, the y range that of the finite bars, as JAX's;
- MetricsWriter.plot: an 800 x 400 <name>_curve.png whose pixels within
  2 px of each logged point (as JAX's transData places it) hold the key's
  colour; with a NaN and an inf loss logged, JAX's axis limits and a
  break in the line at each;
- panels_to_video: cv2.VideoCapture reads 3 frames of the panel size at 2
  fps, each 00dc chunk is cv2.imencode('.jpg') of its panel (a mismatched
  panel resized as cv2.resize does), and the frames are no further from
  the panels than those of JAX's own AVI; the RIFF 1.0 limit raises;
- evaluate_suite(visualize=True) against JAX's on one 32x32 set of 4
  frames (adacof, baseline): the same files, the summary within 0.05 dB,
  a cached npz without predictions scored again, a streamed set skipped.
"""

import importlib.util
import os

import cv2
import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")
import matplotlib.figure  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402

from fmvfi_tpu.eval import evaluate as jx_eval  # noqa: E402
from fmvfi_tpu.eval import visualize as jx_vis  # noqa: E402
from fmvfi_tpu.pipeline import interpolate as jx_pipe  # noqa: E402
from fmvfi_tpu.train import loop as jx_loop  # noqa: E402
from fmvfi_tpu_torch import native  # noqa: E402
from fmvfi_tpu_torch.eval import evaluate as pt_eval  # noqa: E402
from fmvfi_tpu_torch.eval import synth  # noqa: E402
from fmvfi_tpu_torch.eval import visualize as pt_vis  # noqa: E402
from fmvfi_tpu_torch.models.adacof import AdaCoFNet  # noqa: E402
from fmvfi_tpu_torch.models.phase_net import PhaseNetCore  # noqa: E402
from fmvfi_tpu_torch.pipeline.interpolate import FusionModels  # noqa: E402
from fmvfi_tpu_torch.train import loop as pt_loop  # noqa: E402
from fmvfi_tpu_torch.utils import avi, convert, imageio, raster  # noqa: E402
from fmvfi_tpu_torch.utils.resample import resize_bilinear_u8  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ADACOF_CKPT = os.path.join(ROOT, "checkpoints", "adacof_synth_demo.msgpack")
BOX_PX = 2.0
PANEL_DB = 20.0
SUITE_DB = 0.05  # tests/test_torch_eval.py's suite tolerance
NAMES = ("adacof", "baseline", "fusion", "phase")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def toolchain():
    if not native.available():
        pytest.skip("the native library does not build here (no g++)")


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)


def _jax_drawn(fig, dpi):
    """JAX's figure drawn at `dpi` as savefig draws it (its layout made at
    100 dpi): (RGB pixels, the figure)."""
    fig.set_dpi(dpi)
    fig.canvas.draw()
    return np.asarray(fig.canvas.buffer_rgba())[..., :3].copy(), fig


def _rows_cols(box, height):
    """Display box (x0, y0, x1, y1) -> pixel slices, edges rounded."""
    x0, y0, x1, y1 = (int(np.floor(v + 0.5)) for v in box)
    return slice(height - y1, height - y0), slice(x0, x1)


def test_atlas_is_what_the_tool_generates():
    spec = importlib.util.spec_from_file_location(
        "make_glyph_atlas", os.path.join(ROOT, "tools", "make_glyph_atlas.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    arrays = tool.generate()
    with np.load(raster.FONT_FILE) as f:
        assert sorted(f.files) == sorted(arrays)
        for k, v in arrays.items():
            np.testing.assert_array_equal(f[k], v, err_msg=k)


def test_colour_tables_are_matplotlibs():
    np.testing.assert_array_equal(raster.JET, matplotlib.colormaps["jet"](np.arange(256))[:, :3])
    cycle = matplotlib.rcParams["axes.prop_cycle"].by_key()["color"]
    assert [matplotlib.colors.to_hex(c) for c in cycle] == list(raster.TAB10)
    x = np.concatenate([np.linspace(-0.05, 0.3, 997), [0.0, 0.25, np.nan]])
    norm = matplotlib.colors.Normalize(0.0, 0.25)
    np.testing.assert_array_equal(raster.colormap_u8(x, raster.JET, 0.0, 0.25),
                                  matplotlib.colormaps["jet"](norm(x), bytes=True)[:, :3])


def test_resize_bilinear_matches_cv2():
    rng = np.random.default_rng(0)
    cases = [(20, 20, 10, 10), (64, 64, 32, 31), (7, 9, 70, 90), (1, 1, 5, 7), (5, 7, 1, 1),
             (660, 1650, 600, 1500)]
    cases += [tuple(int(v) for v in rng.integers(1, 120, 4)) for _ in range(30)]
    for i, (h, w, oh, ow) in enumerate(cases):
        img = rng.integers(0, 256, (h, w, 3) if i % 4 else (h, w), dtype=np.uint8)
        np.testing.assert_array_equal(resize_bilinear_u8(img, (ow, oh)),
                                      cv2.resize(img, (ow, oh)), err_msg=f"{(h, w, oh, ow)}")


def _frames(n, h, w, seed):
    video = synth.translation_video(3, h, w, step=2.0, seed=seed)
    target = video[1]
    preds = {NAMES[i]: np.clip(video[0] * (1 - 0.1 * i) + video[2] * 0.1 * i, 0, 1)
             for i in range(n)}
    return target, preds


@pytest.mark.parametrize("n, h, w", [(1, 64, 64), (2, 128, 128), (3, 48, 80), (4, 64, 64)])
def test_prediction_panel_against_jax(n, h, w):
    target, preds = _frames(n, h, w, seed=n)
    ours = pt_vis.prediction_panel(target, preds)
    assert ours.shape == (660, 330 * (n + 1), 3) and ours.dtype == np.uint8
    ref, fig = _jax_drawn(jx_vis.prediction_panel(target, preds), pt_vis.PANEL_DPI)
    assert ref.shape == ours.shape
    layout = pt_vis.panel_figure(target, preds)
    images = [target] + list(preds.values())
    sources = {0: pt_vis._to_u8(target)}
    for j, p in enumerate(preds.values(), start=1):
        sources[j] = pt_vis._to_u8(p)
        diff = np.abs(p.astype(np.float32) - target.astype(np.float32)).mean(-1)
        sources[n + 1 + j] = raster.colormap_u8(diff, raster.JET, 0.0, 0.25)
    assert len(images) == n + 1
    for i, ax in enumerate(fig.axes):
        if i not in sources:
            assert not ax.axison  # the blank cell
            continue
        jbox = ax.get_window_extent().extents
        box = layout.box(i)
        assert np.abs(np.subtract(box, jbox)).max() <= BOX_PX, (i, box, jbox)
        col, row, cols, rows, (c0, r0, c1, r1) = layout.axes[i].placement(layout.cells[i],
                                                                           layout.ctx)
        drawn = pt_vis.fit_image(sources[i], cols, rows)[r0 - row : r1 - row, c0 - col : c1 - col]
        got = ours[r0 : r0 + drawn.shape[0], c0 : c0 + drawn.shape[1]]
        np.testing.assert_array_equal(got, drawn)
        # each figure's box inside its spines, area-averaged to the frame's size
        size = sources[i].shape[1::-1]
        want, mine = (cv2.resize(img[_rows_cols(b, img.shape[0])][1:-1, 1:-1], size,
                                 interpolation=cv2.INTER_AREA)
                      for img, b in ((ref, jbox), (ours, box)))
        assert _psnr(mine, want) >= PANEL_DB, (i, _psnr(mine, want))
    plt.close(fig)


SUMMARY = {"translation": {"adacof": {"psnr": 31.5, "ssim": 0.91},
                           "baseline": {"psnr": 24.25, "ssim": 0.78}},
           "rotate_zoom": {"adacof": {"psnr": 28.0, "ssim": 0.86},
                           "baseline": {"psnr": 22.5, "ssim": 0.7}}}


NON_FINITE = {s: {m: dict(v) for m, v in r.items()} for s, r in SUMMARY.items()}
NON_FINITE["translation"]["baseline"]["psnr"] = np.inf  # a prediction equal to its target
NON_FINITE["rotate_zoom"]["adacof"]["ssim"] = np.nan


@pytest.mark.parametrize("metrics,summary", [(("psnr",), SUMMARY), (("psnr", "ssim"), SUMMARY),
                                             (("psnr", "ssim"), NON_FINITE)],
                         ids=["psnr", "psnr-ssim", "non_finite"])
def test_metric_bars_against_jax(metrics, summary):
    """An inf or NaN bar is not drawn and the y range is the finite bars'."""
    ours = pt_vis.metric_bars(summary, metrics)
    k = len(metrics)
    assert ours.shape == (440, 660 * k, 3)
    ref, fig = _jax_drawn(jx_vis.metric_bars(summary, metrics), pt_vis.PANEL_DPI)
    layout = pt_vis.bars_figure(summary, metrics)
    H = ours.shape[0]
    for i, ax in enumerate(fig.axes):
        np.testing.assert_allclose(layout.axes[i].ylim, ax.get_ylim(), rtol=1e-12)
        mine = layout.axes[i].bar_boxes(layout.box(i))
        assert len(mine) == len(ax.patches) == 4
        for b, patch, (_, _, _, ci) in zip(mine, ax.patches, layout.axes[i].bars):
            colour = raster.hex_rgb(raster.TAB10[ci])
            if not np.isfinite(patch.get_height()):
                r, c = int(H - (b[1] + layout.box(i)[3]) / 2), int((b[0] + b[2]) / 2)
                assert tuple(ref[r, c]) == tuple(ours[r, c]) == (255, 255, 255)
                continue
            x0, y0, x1, y1 = patch.get_window_extent().extents
            assert abs(b[0] - x0) <= BOX_PX and abs(b[3] - y1) <= BOX_PX, (b, (x0, y0, x1, y1))
            assert tuple(ref[H - int(y1) + 3, int((x0 + x1) / 2)]) == colour
            assert tuple(ours[H - int(y1) + 3, int((x0 + x1) / 2)]) == colour
    plt.close(fig)


@pytest.fixture
def jax_figure(monkeypatch):
    """The Figure that JAX's MetricsWriter.plot saves."""
    seen = []
    real = matplotlib.figure.Figure.savefig

    def savefig(self, *a, **k):
        seen.append(self)
        return real(self, *a, **k)

    monkeypatch.setattr(matplotlib.figure.Figure, "savefig", savefig)
    return seen


@pytest.mark.parametrize("history", ["finite", "non_finite"])
def test_metrics_writer_plot_against_jax(tmp_path, jax_figure, history):
    """With a NaN and an inf loss logged mid-run (a step the trainer skips
    and survives), the limits are those of the finite points and the line
    breaks at each, as in JAX's figure."""
    steps = np.arange(10, 410, 10)
    logged = {"loss": 0.4 * np.exp(-steps / 120.0) + 0.05, "g_loss": 0.3 + 0.0004 * steps,
              "psnr": 20 + steps / 40.0}
    gaps = [(0, 12), (0, 25), (1, 20)] if history == "non_finite" else []
    for (ki, i), bad in zip(gaps, (np.nan, np.inf, np.nan)):
        logged[("loss", "g_loss")[ki]][i] = bad
    writers = [pt_loop.MetricsWriter(str(tmp_path / "pt"), name="run"),
               jx_loop.MetricsWriter(str(tmp_path / "jx"), name="run")]
    for w in writers:
        for i, s in enumerate(steps):
            w.write(int(s), {k: v[i] for k, v in logged.items()})
    path = writers[0].plot()
    writers[1].plot()
    for w in writers:
        w.close()
    assert path == str(tmp_path / "pt" / "run_curve.png")
    assert os.path.exists(tmp_path / "pt" / "run_metrics.jsonl")
    img = imageio.imread(path)
    assert img.shape == (400, 800, 3)
    fig = jax_figure[-1]
    ax = fig.axes[0]
    ours = pt_vis.curve_figure({k: (steps, logged[k]) for k in ("loss", "g_loss")}).axes[0]
    np.testing.assert_allclose(ours.xlim, ax.get_xlim(), rtol=1e-12)
    np.testing.assert_allclose(ours.ylim, ax.get_ylim(), rtol=1e-12)
    assert [line.get_label() for line in ax.lines] == ["loss", "g_loss"]  # psnr is no loss
    for ci, line in enumerate(ax.lines):
        colour = np.array(raster.hex_rgb(raster.TAB10[ci]))
        for x, y in ax.transData.transform(line.get_xydata()):
            if not np.isfinite((x, y)).all():
                continue
            r, c = int(400 - y), int(x)
            win = img[max(0, r - 2) : r + 3, max(0, c - 2) : c + 3]
            assert (win == colour).all(-1).any(), (line.get_label(), x, y)
    fig.canvas.draw()
    ref = np.asarray(fig.canvas.buffer_rgba())[..., :3]
    for ki, i in gaps:  # no line across a non-finite point, in either figure
        colour = np.array(raster.hex_rgb(raster.TAB10[ki]))
        xy = ax.transData.transform(np.stack([steps[[i - 1, i + 1]],
                                              logged[("loss", "g_loss")[ki]][[i - 1, i + 1]]], 1))
        x, y = xy.mean(0)
        r, c = int(400 - y), int(x)
        for im in (img, ref):
            assert not (im[r - 1 : r + 2, c - 1 : c + 2] == colour).all(-1).any(), (ki, i)
    plt.close("all")


def _panel_files(tmp_path):
    """Three RGBA panel PNGs written by JAX's prediction_panel, the third of
    another size (three methods, so 1320 px wide, not 990)."""
    paths = []
    for i in range(3):
        target, preds = _frames(2 if i < 2 else 3, 64, 64, seed=10 + i)
        paths.append(str(tmp_path / f"panel_{i:03d}.png"))
        jx_vis.prediction_panel(target, preds, out_path=paths[-1])
    plt.close("all")
    return paths


def _cv2_frames(path):
    cap = cv2.VideoCapture(str(path))
    meta = (cap.get(cv2.CAP_PROP_FRAME_COUNT), cap.get(cv2.CAP_PROP_FPS))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    return meta, frames


def test_panels_to_video_against_cv2_and_jax(toolchain, tmp_path, monkeypatch):
    paths = _panel_files(tmp_path)
    out = pt_vis.panels_to_video(paths, str(tmp_path / "ours.avi"), fps=2)
    jx_vis.panels_to_video(paths, str(tmp_path / "jax.avi"), fps=2)
    panels = [cv2.imread(p) for p in paths]  # BGR, alpha dropped
    h, w = panels[0].shape[:2]
    assert panels[2].shape[:2] != (h, w)
    panels[2] = cv2.resize(panels[2], (w, h))
    meta, frames = _cv2_frames(out)
    assert meta == (3.0, 2.0) and [f.shape for f in frames] == [(h, w, 3)] * 3
    video = avi.read(out)
    assert video.strh["handler"] == b"MJPG" and len(video.index) == 3
    for chunk, panel in zip(video.frames, panels):
        assert chunk == cv2.imencode(".jpg", panel)[1].tobytes()
    _, jax_frames = _cv2_frames(tmp_path / "jax.avi")
    assert len(jax_frames) == 3
    for ours, theirs, panel in zip(frames, jax_frames, panels):
        assert _psnr(ours, panel) >= _psnr(theirs, panel), (_psnr(ours, panel),
                                                            _psnr(theirs, panel))
    monkeypatch.setattr(avi, "RIFF_LIMIT", 20000)
    with pytest.raises(ValueError, match="RIFF"):
        pt_vis.panels_to_video(paths, str(tmp_path / "big.avi"))


@pytest.fixture(scope="module")
def weights():
    """(JAX FusionWeights, port FusionModels): the bundled AdaCoF and a
    fixed-key flax PhaseNet carried across (what adacof and baseline use;
    tests/test_torch_eval.py builds the same)."""
    import jax
    import jax.numpy as jnp
    from flax import serialization

    from fmvfi_tpu.models import phase_net as jx_phase

    low = jnp.zeros((1, 4, 4, 2))
    lev = [jnp.zeros((1, 4, 4, 8))] * 7
    phase_tree = jax.jit(lambda k: jx_phase.PhaseNetCore(num_img=2).init(k, low, lev, lev))(
        jax.random.key(0))
    with open(ADACOF_CKPT, "rb") as f:
        tree = serialization.msgpack_restore(f.read())
    jx = jx_pipe.FusionWeights(phase_net=phase_tree, adacof=tree, fusion_net=None)
    phase = PhaseNetCore().eval()
    phase.load_state_dict(convert.phase_net_from_flax(jax.tree.map(np.asarray, phase_tree)))
    ada = AdaCoFNet(max_offset=None).eval()
    ada.load_state_dict(convert.load_adacof_weights(ADACOF_CKPT))
    return jx, FusionModels(phase_net=phase, adacof=ada, fusion_net=None)


def test_evaluate_suite_draws_as_jax(weights, tmp_path, monkeypatch):
    jx, pt = weights
    sets = {"clip": synth.translation_video(4, 32, 32, step=1.5, seed=5)}
    methods = ("adacof", "baseline")
    ref = jx_eval.evaluate_suite(jx, str(tmp_path / "jax"), sets=sets, methods=methods, dim=32)
    plt.close("all")
    out = tmp_path / "torch"
    # a cache without predictions first: the drawing run must score again
    pt_eval.evaluate_suite(pt, str(out), sets=sets, methods=methods, dim=32, visualize=False,
                           device="cpu")
    assert not (out / "panels_clip").exists()
    calls = []
    real = pt_eval.evaluate_frames
    monkeypatch.setattr(pt_eval, "evaluate_frames", lambda *a, **k: calls.append(k) or real(*a, **k))
    ours = pt_eval.evaluate_suite(pt, str(out), sets=sets, methods=methods, dim=32,
                                  device="cpu")
    assert len(calls) == 2 and all(k["return_preds"] for k in calls)
    for root in (tmp_path / "jax", out):
        assert sorted(os.listdir(root / "panels_clip")) == ["panel_000.png", "panel_001.png"]
        assert (root / "clip.avi").exists() and (root / "summary.json").exists()
    for m in methods:
        for k, v in ref["clip"][m].items():
            if k == "psnr":
                assert abs(ours["clip"][m][k] - v) <= SUITE_DB, (m, ours["clip"][m][k], v)
    for name in ("panel_000.png", "panel_001.png"):
        mine = imageio.imread(out / "panels_clip" / name)
        theirs = cv2.cvtColor(cv2.imread(str(tmp_path / "jax" / "panels_clip" / name)),
                              cv2.COLOR_BGR2RGB)
        assert mine.shape == theirs.shape == (660, 990, 3)
    meta, frames = _cv2_frames(out / "clip.avi")
    assert meta == (2.0, 2.0) and len(frames) == 2
    # a cached npz with predictions: no scoring; a streamed set: no drawing
    calls.clear()
    streamed = {"stream": lambda: iter(sets["clip"])}
    pt_eval.evaluate_suite(pt, str(out), sets={**sets, **streamed}, methods=methods, dim=32,
                           device="cpu")
    assert len(calls) == 2 and not any(k["return_preds"] for k in calls)
    assert not (out / "panels_stream").exists() and not (out / "stream.avi").exists()
