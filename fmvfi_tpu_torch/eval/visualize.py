"""Result figures without matplotlib (port of fmvfi_tpu/eval/visualize.py):
prediction/|diff| panels, grouped metric bars, panel videos, and the
loss-curve chart of train/loop.py's MetricsWriter.plot.

JAX draws these with matplotlib, which the card's machine does not have.
The port lays each figure out as matplotlib does and draws it with
utils/raster.py:

- the figure is JAX's figsize in inches at JAX's dpi (the panels and bars
  are saved at 110 dpi, their layout computed at the figure's 100 dpi, as
  `fig.tight_layout()` then `savefig(dpi=110)` compute it; the curve at 100);
- subplots sit on matplotlib's GridSpec; `tight_layout` (pad 1.08 of the
  10 pt font) moves them as matplotlib's _tight_layout does, from the tight
  bounding boxes of each Axes at the default subplot parameters: titles
  (12 pt, 6 pt above the axes, collapsed to 1 px wide), tick labels (10 pt,
  3.5 pt ticks + 3.5 pt pad), axis labels (4 pt pad, collapsed along
  their length) and the aspect-shrunk box of an image;
- view limits are matplotlib's autoscale (5 % margins, bars sticky at 0),
  ticks MaxNLocator's (steps 1, 2, 2.5, 5, 10; as many bins as the axis
  has room for) with ScalarFormatter's labels, offset and exponent;
- the legend is placed at matplotlib's "best" location among its nine
  candidates (least overlap with bars and line vertices);
- text comes from the DejaVu Sans atlas (matplotlib's glyph masks), without
  kerning and on whole pixels.

Images in axes are resized with utils/resample.resize_bilinear_u8 (cv2's
INTER_LINEAR), or by nearest neighbour where the box is at least 3x the
image (matplotlib's 'auto' interpolation), to the box's size rounded up,
placed and clipped as matplotlib places and clips them; the 1 px frame is drawn
just outside the clipped pixels.  The |diff| maps go through
`jet` (vmin 0, vmax 0.25) before they are resized.

Deliberate differences from JAX: a plot call without `out_path` returns
the (H, W, 3) uint8 image where JAX returns a matplotlib Figure, and the
PNGs are RGB where matplotlib writes RGBA with opaque alpha (cv2.imread
reads the same three channels).  `panels_to_video` writes an MJPG AVI
through utils/avi.py, each frame the JPEG of native/jpeg_enc.cpp at
quality 95 (what cv2.VideoWriter's MJPG encoder writes through libjpeg).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils import avi, imageio
from ..utils import raster
from ..utils.resample import resize_bilinear_u8

LAYOUT_DPI = 100  # rcParams["figure.dpi"]: tight_layout runs at it
PANEL_DPI = 110  # JAX's savefig dpi for the panels and the bars
FONT_PT, TITLE_PT = 10, 12  # rcParams font.size; axes.titlesize "large"
PAD = 1.08  # tight_layout's pad, in font sizes
TITLE_PAD_PT = 6.0
TICK_PT, TICK_PAD_PT, TICK_WIDTH_PT = 3.5, 3.5, 0.8
LABEL_PAD_PT = 4.0
OFFSET_PAD_PT = 3.0
SPINE_PT = 0.8
LINE_PT = 1.5
MARGIN = 0.05  # axes.xmargin / ymargin
SUBPLOT_DEFAULTS = (0.125, 0.9, 0.11, 0.88, 0.2, 0.2)  # left, right, bottom, top, wspace, hspace
LEGEND = dict(borderpad=0.4, labelspacing=0.5, handlelength=2.0, handleheight=0.7,
              handletextpad=0.8, borderaxespad=0.5, framealpha=0.8)
LEGEND_EDGE = (204, 204, 204)  # legend.edgecolor "0.8"
DIFF_VMAX = 0.25
BLACK = (0, 0, 0)

Box = Tuple[float, float, float, float]  # x0, y0, x1, y1


def _union(boxes: Sequence[Box]) -> Box:
    boxes = list(boxes)
    return (min(b[0] for b in boxes), min(b[1] for b in boxes),
            max(b[2] for b in boxes), max(b[3] for b in boxes))


def _pt(points: float, dpi: float) -> float:
    return points * dpi / 72.0


# --- ticks: MaxNLocator and ScalarFormatter --------------------------------

def _nonsingular(vmin: float, vmax: float, expander: float = 0.001,
                 tiny: float = 1e-15) -> Tuple[float, float]:
    """matplotlib.transforms.nonsingular (increasing)."""
    if not (np.isfinite(vmin) and np.isfinite(vmax)):
        return -expander, expander
    if vmax < vmin:
        vmin, vmax = vmax, vmin
    vmin, vmax = float(vmin), float(vmax)
    maxabs = max(abs(vmin), abs(vmax))
    if maxabs < (1e6 / tiny) * np.finfo(float).tiny:
        return -expander, expander
    if vmax - vmin <= maxabs * tiny:
        if vmax == 0 and vmin == 0:
            return -expander, expander
        vmin -= expander * abs(vmin)
        vmax += expander * abs(vmax)
    return vmin, vmax


def _autoscale(lo: float, hi: float, stickies: Sequence[float] = ()) -> Tuple[float, float]:
    """The view interval Axes.autoscale_view gives data [lo, hi]: the
    locator's nonsingular, 5 % margins that do not cross a sticky edge."""
    x0, x1 = _nonsingular(lo, hi, expander=0.05)
    st = np.sort(np.asarray(stickies, np.float64))
    tol = 1e-5 * abs(x1 - x0)
    i0 = int(np.searchsorted(st, x0 + tol)) - 1
    i1 = int(np.searchsorted(st, x1 - tol))
    delta = (x1 - x0) * MARGIN
    x0, x1 = x0 - delta, x1 + delta
    if i0 != -1:
        x0 = max(x0, st[i0])
    if i1 != len(st):
        x1 = min(x1, st[i1])
    return _nonsingular(x0, x1)


_STEPS = np.array([0.1, 0.2, 0.25, 0.5, 1.0, 2.0, 2.5, 5.0, 10.0, 20.0])  # extended [1, 2, 2.5, 5, 10]


def _edge_closeto(ms: float, edge: float, step: float, offset: float) -> bool:
    if offset > 0:
        tol = min(0.4999, max(1e-10, 10 ** (np.log10(offset / step) - 12)))
    else:
        tol = 1e-10
    return abs(ms - edge) < tol


def _max_n_ticks(vmin: float, vmax: float, nbins: int) -> np.ndarray:
    """MaxNLocator(nbins).tick_values(vmin, vmax) with its default steps."""
    vmin, vmax = _nonsingular(vmin, vmax, expander=1e-13, tiny=1e-14)
    dv = abs(vmax - vmin)
    meanv = (vmax + vmin) / 2
    offset = 0.0 if abs(meanv) / dv < 100 else math.copysign(10 ** (math.log10(abs(meanv)) // 1),
                                                               meanv)
    scale = 10 ** (math.log10(dv / nbins) // 1)
    _vmin, _vmax = vmin - offset, vmax - offset
    steps = _STEPS * scale
    raw_step = (_vmax - _vmin) / nbins
    large = np.nonzero(steps >= raw_step)[0]
    istep = int(large[0]) if len(large) else len(steps) - 1
    ticks = np.array([])
    for step in steps[: istep + 1][::-1]:
        best_vmin = (_vmin // step) * step
        d, m = divmod(_vmin - best_vmin, step)
        low = d + 1 if _edge_closeto(m / step, 1, step, abs(offset)) else d
        d, m = divmod(_vmax - best_vmin, step)
        high = d if _edge_closeto(m / step, 0, step, abs(offset)) else d + 1
        ticks = np.arange(low, high + 1) * step + best_vmin
        if ((ticks <= _vmax) & (ticks >= _vmin)).sum() >= 2:
            break
    return ticks + offset


def _minus(s: str) -> str:
    return s.replace("-", "−")


def _format_ticks(locs: np.ndarray, view: Tuple[float, float]) -> Tuple[List[str], str]:
    """ScalarFormatter's labels of `locs` and its offset text, for the view
    interval `view` (offset threshold 4, power limits (-5, 6))."""
    locs = np.asarray(locs, np.float64)
    vmin, vmax = sorted(view)
    vis = locs[(vmin <= locs) & (locs <= vmax)]
    offset = 0.0
    if len(vis) and vis.min() != vis.max() and not (vis.min() <= 0 <= vis.max()):
        lmin, lmax = vis.min(), vis.max()
        abs_min, abs_max = sorted([abs(float(lmin)), abs(float(lmax))])
        sign = math.copysign(1, lmin)
        oom_max = np.ceil(math.log10(abs_max))
        oom = oom_max
        while abs_min // 10 ** oom == abs_max // 10 ** oom:
            oom -= 1
        oom += 1
        if (abs_max - abs_min) / 10 ** oom <= 1e-2:
            oom = oom_max
            while abs_max // 10 ** oom - abs_min // 10 ** oom <= 1:
                oom -= 1
            oom += 1
        if abs_max // 10 ** oom >= 10 ** 3:
            offset = sign * (abs_max // 10 ** oom) * 10 ** oom
    order = 0
    if len(vis):
        if offset:
            oom = math.floor(math.log10(vmax - vmin))
        else:
            val = np.abs(vis).max()
            oom = 0 if val == 0 else math.floor(math.log10(val))
        order = oom if (oom <= -5 or oom >= 6) else 0
    scaled = (locs - offset) / 10.0 ** order
    ref = scaled if len(locs) >= 2 else np.concatenate(
        [scaled, (np.array(view, np.float64) - offset) / 10.0 ** order])
    loc_range = np.ptp(ref)
    if loc_range == 0:
        loc_range = np.max(np.abs(ref))
    if loc_range == 0:
        loc_range = 1
    range_oom = int(math.floor(math.log10(loc_range)))
    sigfigs = max(0, 3 - range_oom)
    thresh = 1e-3 * 10 ** range_oom
    while sigfigs >= 0:
        if np.abs(scaled - np.round(scaled, decimals=sigfigs)).max() < thresh:
            sigfigs -= 1
        else:
            break
    sigfigs += 1
    labels = []
    for v in scaled:
        v = 0.0 if abs(v) < 1e-8 else v
        labels.append(_minus(f"%1.{sigfigs}f" % v))
    text = ""
    if order or offset:
        off = ""
        if offset:
            e = math.floor(math.log10(abs(offset)))
            s = round(offset / 10 ** e, 10)
            sig = "%d" % s if s % 1 == 0 else "%1.10g" % s
            off = sig if e == 0 else f"{sig}e{e}"
            if offset > 0:
                off = "+" + off
        text = _minus(("1e%d" % order if order else "") + off)
    return labels, text


# --- axes ------------------------------------------------------------------

@dataclass
class _Ctx:
    """A figure at one dpi: its size in px and its fonts."""

    width_in: float
    height_in: float
    dpi: float

    @property
    def w(self) -> float:
        return self.width_in * self.dpi

    @property
    def h(self) -> float:
        return self.height_in * self.dpi

    def font(self, pt: int) -> raster.Font:
        return raster.font(pt, int(self.dpi))

    def px(self, frac: Box) -> Box:
        return (frac[0] * self.w, frac[1] * self.h, frac[2] * self.w, frac[3] * self.h)


def _title_at(box: Box, ctx: _Ctx) -> Tuple[float, float]:
    """Where an axes' title is anchored (ha center, va baseline): its box's
    middle, TITLE_PAD_PT above its top."""
    return (box[0] + box[2]) / 2, box[3] + _pt(TITLE_PAD_PT, ctx.dpi)


def _collapse(b: Box, axis: str) -> Box:
    """A text box as tight_layout counts a title ("x": 1 px wide) or an
    axis label along its length."""
    if axis == "x":
        mid = (b[0] + b[2]) / 2 - 0.5
        return (mid, b[1], mid + 1.0, b[3])
    mid = (b[1] + b[3]) / 2 - 0.5
    return (b[0], mid, b[2], mid + 1.0)


def _title_box(title: str, box: Box, ctx: _Ctx) -> List[Box]:
    """The title's box as tight_layout counts it (none without a title)."""
    if not title:
        return []
    return [_collapse(raster.text_bbox(title, *_title_at(box, ctx), ctx.font(TITLE_PT),
                                       ha="center", va="baseline"), "x")]


def _draw_title(canvas: raster.Canvas, title: str, box: Box, ctx: _Ctx) -> None:
    if title:
        canvas.text(title, *_title_at(box, ctx), ctx.font(TITLE_PT), ha="center", va="baseline")


class _Blank:
    """An Axes with axis('off'): only its box counts."""

    def tight(self, frac: Box, ctx: _Ctx) -> Box:
        return ctx.px(frac)

    def draw(self, canvas: raster.Canvas, frac: Box, ctx: _Ctx) -> None:
        pass


@dataclass
class _Image:
    """imshow of an (h, w, 3) uint8 image, no ticks, a title above."""

    rgb: np.ndarray
    title: str

    def active(self, frac: Box, ctx: _Ctx) -> Box:
        """apply_aspect: the box shrunk to the image's aspect, centred."""
        h, w = self.rgb.shape[:2]
        box_aspect = h / w
        fig_aspect = ctx.height_in / ctx.width_in
        bw, bh = frac[2] - frac[0], frac[3] - frac[1]
        nh = bw * box_aspect / fig_aspect
        if nh <= bh:
            nw = bw
        else:
            nw, nh = bh * fig_aspect / box_aspect, bh
        x0 = frac[0] + (bw - nw) / 2
        y0 = frac[1] + (bh - nh) / 2
        return (x0, y0, x0 + nw, y0 + nh)

    def tight(self, frac: Box, ctx: _Ctx) -> Box:
        box = ctx.px(self.active(frac, ctx))
        return _union([box] + _title_box(self.title, box, ctx))

    def placement(self, frac: Box, ctx: _Ctx):
        """Where the image goes, as AxesImage._make_image and Agg's
        draw_image put it: resampled to (cols, rows) = the box's size
        rounded up, its bottom-left corner at the box's rounded to whole
        pixels, (col, row) its top-left pixel; then clipped to the box
        rounded as Agg rounds its clip box, `clip` = (col0, row0, col1,
        row1)."""
        x0, y0, x1, y1 = ctx.px(self.active(frac, ctx))
        H = int(round(ctx.h))
        cols, rows = int(math.ceil(x1 - x0)), int(math.ceil(y1 - y0))
        col, row = int(math.floor(x0 + 0.5)), H - (int(math.floor(y0 + 0.5)) + rows)
        clip = (int(math.floor(x0 + 0.5)), int(math.floor(H - y1 + 0.5)),
                int(math.floor(x1 + 0.5)), int(math.floor(H - y0 + 0.5)))
        return col, row, cols, rows, clip

    def draw(self, canvas: raster.Canvas, frac: Box, ctx: _Ctx) -> None:
        col, row, cols, rows, (c0, r0, c1, r1) = self.placement(frac, ctx)
        img = fit_image(self.rgb, cols, rows)
        canvas.blit(img[r0 - row : r1 - row, c0 - col : c1 - col], c0, r0)
        # the spines: a 1 px frame just outside the clip box
        H = canvas.height
        canvas.fill_rect(c0 - 1, H - r0, c1 + 1, H - r0 + 1, BLACK)  # top
        canvas.fill_rect(c0 - 1, H - r1 - 1, c1 + 1, H - r1, BLACK)  # bottom
        canvas.fill_rect(c0 - 1, H - r1, c0, H - r0, BLACK)  # left
        canvas.fill_rect(c1, H - r1, c1 + 1, H - r0, BLACK)  # right
        _draw_title(canvas, self.title, ctx.px(self.active(frac, ctx)), ctx)


def fit_image(rgb: np.ndarray, cols: int, rows: int) -> np.ndarray:
    """An (h, w, 3) uint8 image resized to (rows, cols, 3) as the panels
    resize it: nearest neighbour where both sides grow 3x or more (what
    matplotlib's 'auto' interpolation picks), else resize_bilinear_u8."""
    h, w = rgb.shape[:2]
    if (h, w) == (rows, cols):
        return rgb
    if rows >= 3 * h and cols >= 3 * w:
        ri = np.minimum(((np.arange(rows) + 0.5) * h / rows).astype(np.int64), h - 1)
        ci = np.minimum(((np.arange(cols) + 0.5) * w / cols).astype(np.int64), w - 1)
        return rgb[ri][:, ci]
    return resize_bilinear_u8(rgb, (cols, rows))


@dataclass
class _Chart:
    """An Axes of bars or lines with ticks, labels, a title and a legend.

    bars: (x centre, height, width, colour index); lines: (xs, ys, colour
    index); legend: (label, colour index, "patch" or "line")."""

    bars: List[Tuple[float, float, float, int]] = field(default_factory=list)
    lines: List[Tuple[np.ndarray, np.ndarray, int]] = field(default_factory=list)
    xticks: Optional[Tuple[np.ndarray, List[str]]] = None  # fixed ticks and labels
    xrotation: float = 0.0
    xha: str = "center"
    title: str = ""
    xlabel: str = ""
    ylabel: str = ""
    legend: List[Tuple[str, int, str]] = field(default_factory=list)

    def __post_init__(self):
        if self.bars:
            b = np.asarray(self.bars, np.float64)
            xlo, xhi = (b[:, 0] - b[:, 2] / 2).min(), (b[:, 0] + b[:, 2] / 2).max()
            hgt = b[np.isfinite(b[:, 1]), 1]  # a NaN or inf bar adds only its base
            ylo, yhi = min([0.0, *hgt]), max([0.0, *hgt])
            self.xlim = _autoscale(xlo, xhi)
            self.ylim = _autoscale(ylo, yhi, stickies=[0.0] * len(b))
        elif self.lines:
            # the data limits hold the points whose x and y are both finite
            # (none: matplotlib's empty limits, +-0.055 after nonsingular)
            xs = np.concatenate([np.asarray(l[0], np.float64) for l in self.lines])
            ys = np.concatenate([np.asarray(l[1], np.float64) for l in self.lines])
            ok = np.isfinite(xs) & np.isfinite(ys)
            xs, ys = (xs[ok], ys[ok]) if ok.any() else (np.array([np.inf, -np.inf]),) * 2
            self.xlim = _autoscale(xs.min(), xs.max())
            self.ylim = _autoscale(ys.min(), ys.max())
        else:
            self.xlim = self.ylim = (0.0, 1.0)

    # data -> display within the axes box
    def _tx(self, box: Box, x):
        return box[0] + (np.asarray(x, np.float64) - self.xlim[0]) / (
            self.xlim[1] - self.xlim[0]) * (box[2] - box[0])

    def _ty(self, box: Box, y):
        return box[1] + (np.asarray(y, np.float64) - self.ylim[0]) / (
            self.ylim[1] - self.ylim[0]) * (box[3] - box[1])

    def _ticks(self, box: Box, ctx: _Ctx):
        """The drawn ticks of each axis: (x locs, labels, offset text) and
        the same for y, at the axes' size in inches."""
        if self.xticks is not None:
            xl, xlab = np.asarray(self.xticks[0], np.float64), list(self.xticks[1])
            xoff = ""
        else:
            length = (box[2] - box[0]) / ctx.dpi * 72
            nbins = int(np.clip(int(np.floor(length / (FONT_PT * 3))), 1, 9))
            xl = _max_n_ticks(*self.xlim, nbins)
            xlab, xoff = _format_ticks(xl, self.xlim)
        length = (box[3] - box[1]) / ctx.dpi * 72
        nbins = int(np.clip(int(np.floor(length / (FONT_PT * 2))), 1, 9))
        yl = _max_n_ticks(*self.ylim, nbins)
        ylab, yoff = _format_ticks(yl, self.ylim)

        def shown(locs, labels, lim):
            lo, hi = sorted(lim)
            tol = (hi - lo) * 1e-10
            keep = [(l, s) for l, s in zip(locs, labels) if lo - tol <= l <= hi + tol]
            return [k[0] for k in keep], [k[1] for k in keep]

        return shown(xl, xlab, self.xlim) + (xoff,), shown(yl, ylab, self.ylim) + (yoff,)

    def _texts(self, box: Box, ctx: _Ctx):
        """Every 10 pt text of the axes as (s, x, y, Canvas.text keywords,
        the axis tight_layout collapses it along or None), with the tick
        positions."""
        (xl, xlab, xoff), (yl, ylab, yoff) = self._ticks(box, ctx)
        f = ctx.font(FONT_PT)
        out = []
        gap = _pt(TICK_PT + TICK_PAD_PT, ctx.dpi)
        xt = []
        for loc, s in zip(xl, xlab):
            kw = dict(ha=self.xha, va="top", rotation=self.xrotation)
            x, y = float(self._tx(box, loc)), box[1] - gap
            xt.append(raster.text_bbox(s, x, y, f, **kw))
            out.append((s, x, y, kw, None))
        yt = []
        for loc, s in zip(yl, ylab):
            kw = dict(ha="right", va="center_baseline")
            x, y = box[0] - gap, float(self._ty(box, loc))
            yt.append(raster.text_bbox(s, x, y, f, **kw))
            out.append((s, x, y, kw, None))
        tick = _pt(TICK_PT, ctx.dpi)
        bottom = min([b[1] for b in xt] + [box[1] - (tick if xl else 0)])
        left = min([b[0] for b in yt] + [box[0] - (tick if yl else 0)])
        if xoff:
            out.append((xoff, box[2], bottom - _pt(OFFSET_PAD_PT, ctx.dpi),
                        dict(ha="right", va="top"), None))
        if yoff:
            out.append((yoff, box[0], box[3] + _pt(OFFSET_PAD_PT, ctx.dpi),
                        dict(ha="left", va="baseline"), None))
        if self.xlabel:
            out.append((self.xlabel, (box[0] + box[2]) / 2, bottom - _pt(LABEL_PAD_PT, ctx.dpi),
                        dict(ha="center", va="top"), "x"))
        if self.ylabel:
            out.append((self.ylabel, left - _pt(LABEL_PAD_PT, ctx.dpi), (box[1] + box[3]) / 2,
                        dict(ha="center", va="bottom", rotation=90, rotation_mode="anchor"),
                        "y"))
        return out, (xl, yl)

    def tight(self, frac: Box, ctx: _Ctx) -> Box:
        box = ctx.px(frac)
        boxes = [box]
        texts, (xl, yl) = self._texts(box, ctx)
        tick = _pt(TICK_PT, ctx.dpi)
        if xl:  # the bottom spine's extent counts its ticks
            boxes.append((box[0], box[1] - tick, box[2], box[1]))
        if yl:
            boxes.append((box[0] - tick, box[1], box[0], box[3]))
        for s, x, y, kw, axis in texts:
            b = raster.text_bbox(s, x, y, ctx.font(FONT_PT), **kw)
            if axis:
                b = _collapse(b, axis)
            if b[2] > b[0] and b[3] > b[1]:
                boxes.append(b)
        return _union(boxes + _title_box(self.title, box, ctx))

    def bar_boxes(self, box: Box) -> List[Box]:
        """Each bar's display box (x0, y0, x1, y1)."""
        out = []
        for x, hgt, w, _ in self.bars:
            xa, xb = self._tx(box, [x - w / 2, x + w / 2])
            ya, yb = self._ty(box, [0.0, hgt])
            out.append((float(min(xa, xb)), float(min(ya, yb)), float(max(xa, xb)),
                        float(max(ya, yb))))
        return out

    def draw(self, canvas: raster.Canvas, frac: Box, ctx: _Ctx) -> None:
        box = ctx.px(frac)
        colors = raster.TAB10
        # clip the data to the axes box
        clip = raster.Canvas(canvas.width, canvas.height)
        clip.img = canvas.img.copy()
        for (x, hgt, w, ci), b in zip(self.bars, self.bar_boxes(box)):
            clip.fill_rect(b[0], b[1], b[2], b[3], raster.hex_rgb(colors[ci % 10]))
        lw = _pt(LINE_PT, ctx.dpi)
        for xs, ys, ci in self.lines:
            pts = np.stack([self._tx(box, xs), self._ty(box, ys)], 1)
            clip.polyline(pts, raster.hex_rgb(colors[ci % 10]), lw)
        H = canvas.height
        c0, c1 = int(math.floor(box[0] + 0.5)), int(math.floor(box[2] + 0.5))
        r0, r1 = int(math.floor(H - box[3] + 0.5)), int(math.floor(H - box[1] + 0.5))
        canvas.img[r0:r1, c0:c1] = clip.img[r0:r1, c0:c1]
        # spines and ticks
        sw = max(1.0, round(_pt(SPINE_PT, ctx.dpi)))
        for x0, y0, x1, y1 in ((box[0], box[1], box[2], box[1]), (box[0], box[3], box[2], box[3]),
                               (box[0], box[1], box[0], box[3]), (box[2], box[1], box[2], box[3])):
            canvas.fill_rect(x0 - sw / 2, y0 - sw / 2, x1 + sw / 2, y1 + sw / 2, BLACK)
        texts, (xl, yl) = self._texts(box, ctx)
        tick, tw = _pt(TICK_PT, ctx.dpi), max(1.0, round(_pt(TICK_WIDTH_PT, ctx.dpi)))
        for loc in xl:
            x = float(self._tx(box, loc))
            canvas.fill_rect(x - tw / 2, box[1] - tick, x + tw / 2, box[1], BLACK)
        for loc in yl:
            y = float(self._ty(box, loc))
            canvas.fill_rect(box[0] - tick, y - tw / 2, box[0], y + tw / 2, BLACK)
        for s, x, y, kw, _ in texts:
            canvas.text(s, x, y, ctx.font(FONT_PT), **kw)
        _draw_title(canvas, self.title, box, ctx)
        if self.legend:
            self._draw_legend(canvas, box, ctx)

    def _legend_geometry(self, ctx: _Ctx):
        f = ctx.font(FONT_PT)
        fs = _pt(FONT_PT, ctx.dpi)
        metrics = [f.metrics(label) for label, _, _ in self.legend]
        row_h = [max(h - d, LEGEND["handleheight"] * fs) + d for _, h, d in metrics]
        width = (2 * LEGEND["borderpad"] + LEGEND["handlelength"] + LEGEND["handletextpad"]) * fs \
            + max(m[0] for m in metrics)
        height = 2 * LEGEND["borderpad"] * fs + sum(row_h) \
            + (len(row_h) - 1) * LEGEND["labelspacing"] * fs
        return width, height, metrics, row_h

    def legend_box(self, box: Box, ctx: _Ctx) -> Box:
        """The legend's display box at matplotlib's loc='best'."""
        width, height, _, _ = self._legend_geometry(ctx)
        pad = LEGEND["borderaxespad"] * _pt(FONT_PT, ctx.dpi)
        x0, y0, x1, y1 = box[0] + pad, box[1] + pad, box[2] - pad, box[3] - pad
        cx, cy = (x0 + x1 - width) / 2, (y0 + y1 - height) / 2
        # codes 1-10: upper right, upper left, lower left, lower right, right,
        # center left, center right, lower center, upper center, center
        candidates = [(x1 - width, y1 - height), (x0, y1 - height), (x0, y0), (x1 - width, y0),
                      (x1 - width, cy), (x0, cy), (x1 - width, cy), (cx, y0), (cx, y1 - height),
                      (cx, cy)]
        bars = self.bar_boxes(box)
        paths = [np.stack([self._tx(box, xs), self._ty(box, ys)], 1) for xs, ys, _ in self.lines]
        best = None
        for l, b in candidates:
            lb = (l, b, l + width, b + height)
            bad = sum(int(((p[:, 0] > lb[0]) & (p[:, 0] < lb[2]) & (p[:, 1] > lb[1])
                           & (p[:, 1] < lb[3])).sum()) for p in paths)
            bad += sum(1 for r in bars if lb[0] <= r[2] and r[0] <= lb[2] and lb[1] <= r[3]
                       and r[1] <= lb[3])
            bad += sum(1 for p in paths if _path_hits_box(p, lb))
            if bad == 0:
                return lb
            if best is None or bad < best[0]:
                best = (bad, lb)
        return best[1]

    def _draw_legend(self, canvas: raster.Canvas, box: Box, ctx: _Ctx) -> None:
        lb = self.legend_box(box, ctx)
        _, _, metrics, row_h = self._legend_geometry(ctx)
        fs = _pt(FONT_PT, ctx.dpi)
        canvas.fill_rect(*lb, (255, 255, 255), alpha=LEGEND["framealpha"])
        for x0, y0, x1, y1 in ((lb[0], lb[1], lb[2], lb[1] + 1), (lb[0], lb[3] - 1, lb[2], lb[3]),
                               (lb[0], lb[1], lb[0] + 1, lb[3]), (lb[2] - 1, lb[1], lb[2], lb[3])):
            canvas.fill_rect(x0, y0, x1, y1, LEGEND_EDGE, alpha=LEGEND["framealpha"])
        f = ctx.font(FONT_PT)
        top = lb[3] - LEGEND["borderpad"] * fs
        hx0 = lb[0] + LEGEND["borderpad"] * fs
        hx1 = hx0 + LEGEND["handlelength"] * fs
        for (label, ci, kind), (_, h, d), rh in zip(self.legend, metrics, row_h):
            baseline = top - (rh - d)
            color = raster.hex_rgb(raster.TAB10[ci % 10])
            hh = LEGEND["handleheight"] * fs
            if kind == "patch":
                canvas.fill_rect(hx0, baseline, hx1, baseline + hh, color)
            else:
                canvas.polyline([(hx0, baseline + hh / 2), (hx1, baseline + hh / 2)], color,
                                _pt(LINE_PT, ctx.dpi))
            canvas.text(label, hx1 + LEGEND["handletextpad"] * fs, baseline, f, va="baseline")
            top -= rh + LEGEND["labelspacing"] * fs


def _path_hits_box(p: np.ndarray, lb: Box) -> bool:
    """Whether the polyline `p` ((n, 2) display points) meets box `lb`
    (Liang-Barsky on each segment).  As Path.intersects_bbox, non-finite
    points are dropped and the points either side of them joined."""
    p = p[np.isfinite(p).all(1)]
    if len(p) == 1:
        return bool(lb[0] <= p[0, 0] <= lb[2] and lb[1] <= p[0, 1] <= lb[3])
    for (xa, ya), (xb, yb) in zip(p[:-1], p[1:]):
        t0, t1 = 0.0, 1.0
        dx, dy = xb - xa, yb - ya
        ok = True
        for q, r in ((-dx, xa - lb[0]), (dx, lb[2] - xa), (-dy, ya - lb[1]), (dy, lb[3] - ya)):
            if q == 0:
                if r < 0:
                    ok = False
                    break
            else:
                t = r / q
                if q < 0:
                    t0 = max(t0, t)
                else:
                    t1 = min(t1, t)
                if t0 > t1:
                    ok = False
                    break
        if ok:
            return True
    return False


# --- figures ---------------------------------------------------------------

def _grid(rows: int, cols: int, left: float, right: float, bottom: float, top: float,
          wspace: float, hspace: float) -> List[Box]:
    """GridSpec.get_grid_positions: each cell's box in figure fractions,
    row-major from the top."""
    cell_h = (top - bottom) / (rows + hspace * (rows - 1))
    cell_w = (right - left) / (cols + wspace * (cols - 1))
    out = []
    for r in range(rows):
        t = top - r * cell_h * (1 + hspace)
        for c in range(cols):
            l = left + c * cell_w * (1 + wspace)
            out.append((l, t - cell_h, l + cell_w, t))
    return out


def _tight_layout(width_in: float, height_in: float, rows: int, cols: int, axes) -> tuple:
    """Figure.tight_layout(): the subplot parameters (left, right, bottom,
    top, wspace, hspace) _tight_layout._auto_adjust_subplotpars computes at
    LAYOUT_DPI from the axes' tight boxes at the default parameters."""
    ctx = _Ctx(width_in, height_in, LAYOUT_DPI)
    cells = _grid(rows, cols, *SUBPLOT_DEFAULTS)
    hspaces = np.zeros((rows, cols + 1))
    vspaces = np.zeros((rows + 1, cols))
    for i, ax in enumerate(axes):
        r, c = divmod(i, cols)
        cell = cells[i]
        t = ax.tight(cell, ctx)
        t = (t[0] / ctx.w, t[1] / ctx.h, t[2] / ctx.w, t[3] / ctx.h)
        hspaces[r, c] += cell[0] - t[0]
        hspaces[r, c + 1] += t[2] - cell[2]
        vspaces[r, c] += t[3] - cell[3]
        vspaces[r + 1, c] += cell[1] - t[1]
    pad = PAD * FONT_PT / 72  # inches
    left = max(hspaces[:, 0].max(), 0) + pad / width_in
    right = max(hspaces[:, -1].max(), 0) + pad / width_in
    top = max(vspaces[0, :].max(), 0) + pad / height_in
    bottom = max(vspaces[-1, :].max(), 0) + pad / height_in
    wspace = hspace = 0.0
    if cols > 1:
        hs = hspaces[:, 1:-1].max() + pad / width_in
        wspace = hs / ((1 - right - left - hs * (cols - 1)) / cols)
    if rows > 1:
        vs = vspaces[1:-1, :].max() + pad / height_in
        hspace = vs / ((1 - top - bottom - vs * (rows - 1)) / rows)
    return left, 1 - right, bottom, 1 - top, wspace, hspace


@dataclass
class Figure:
    """A laid-out figure: its axes, their final boxes (figure fractions)
    and the dpi it is drawn at."""

    width_in: float
    height_in: float
    dpi: int
    rows: int
    cols: int
    axes: list
    cells: List[Box] = field(default_factory=list)

    def __post_init__(self):
        params = _tight_layout(self.width_in, self.height_in, self.rows, self.cols, self.axes)
        self.cells = _grid(self.rows, self.cols, *params)
        self.ctx = _Ctx(self.width_in, self.height_in, self.dpi)

    def render(self) -> np.ndarray:
        canvas = raster.Canvas(int(round(self.ctx.w)), int(round(self.ctx.h)))
        for ax, cell in zip(self.axes, self.cells):
            ax.draw(canvas, cell, self.ctx)
        return canvas.img

    def box(self, i: int) -> Box:
        """Axes i's display box at the drawing dpi (an image's shrunk box)."""
        ax, cell = self.axes[i], self.cells[i]
        if isinstance(ax, _Image):
            cell = ax.active(cell, self.ctx)
        return self.ctx.px(cell)


def _save(img: np.ndarray, out_path: Optional[str]):
    if not out_path:
        return img
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    imageio.imwrite(out_path, img)
    return out_path


def _to_u8(frame: np.ndarray) -> np.ndarray:
    return np.rint(np.clip(np.asarray(frame, np.float64), 0, 1) * 255).astype(np.uint8)


def panel_figure(target: np.ndarray, predictions: Dict[str, np.ndarray]) -> Figure:
    """prediction_panel's figure, laid out: axes row-major over the 2 x
    (n + 1) grid (target, predictions; blank, |diff| maps)."""
    n = len(predictions)
    target = np.asarray(target, np.float32)
    top: list = [_Image(_to_u8(target), "target")]
    bottom: list = [_Blank()]
    for name, pred in predictions.items():
        pred = np.asarray(pred, np.float32)
        top.append(_Image(_to_u8(pred), name))
        diff = np.abs(pred - target).mean(-1)
        bottom.append(_Image(raster.colormap_u8(diff, raster.JET, 0.0, DIFF_VMAX),
                             f"|diff| {name}"))
    return Figure(3.0 * (n + 1), 6.0, PANEL_DPI, 2, n + 1, top + bottom)


def prediction_panel(
    target: np.ndarray,
    predictions: Dict[str, np.ndarray],
    out_path: Optional[str] = None,
):
    """Grid figure: row 1 target + predictions, row 2 jet |diff| maps
    (vmin 0, vmax 0.25), 330 (n + 1) x 660 px.  Frames are (H, W, 3) in
    [0, 1].  Writes `out_path` (a PNG, or a JPEG by its extension) and
    returns it; without one, returns the (H, W, 3) uint8 image."""
    return _save(panel_figure(target, predictions).render(), out_path)


def bars_figure(summary: Dict[str, Dict[str, Dict[str, float]]],
                metrics: Sequence[str] = ("psnr", "ssim")) -> Figure:
    """metric_bars' figure, laid out: one axes per metric."""
    sets = list(summary)
    methods = list(next(iter(summary.values())))
    x = np.arange(len(sets), dtype=np.float64)
    width = 0.8 / max(len(methods), 1)
    axes = []
    for metric in metrics:
        bars = [(float(x[si] + mi * width), float(summary[s][m][metric]), width, mi)
                for mi, m in enumerate(methods) for si, s in enumerate(sets)]
        axes.append(_Chart(bars=bars, xticks=(x + width * (len(methods) - 1) / 2, sets),
                           xrotation=30.0, xha="right", title=metric,
                           legend=[(m, mi, "patch") for mi, m in enumerate(methods)]))
    return Figure(6.0 * len(metrics), 4.0, PANEL_DPI, 1, len(metrics), axes)


def metric_bars(
    summary: Dict[str, Dict[str, Dict[str, float]]],
    metrics: Sequence[str] = ("psnr", "ssim"),
    out_path: Optional[str] = None,
):
    """Grouped bars: one subplot per metric, groups = test sets, bars =
    methods in tab10 order, 660 k x 440 px for k metrics.  Writes
    `out_path` and returns it; without one, returns the uint8 image."""
    return _save(bars_figure(summary, metrics).render(), out_path)


def curve_figure(series: Dict[str, Tuple[Sequence[float], Sequence[float]]],
                 xlabel: str = "step", ylabel: str = "value") -> Figure:
    """The loss-curve figure of MetricsWriter.plot: one line per series in
    tab10 order, 8 x 4 in at 100 dpi."""
    lines = [(np.asarray(xs, np.float64), np.asarray(ys, np.float64), i)
             for i, (xs, ys) in enumerate(series.values())]
    ax = _Chart(lines=lines, xlabel=xlabel, ylabel=ylabel,
                legend=[(k, i, "line") for i, k in enumerate(series)])
    return Figure(8.0, 4.0, LAYOUT_DPI, 1, 1, [ax])


def panels_to_video(panel_paths: Sequence[str], out_path: str, fps: int = 2) -> str:
    """Stitch saved panel images into an MJPG AVI at `fps`, the first
    panel's size; a panel of another size is resized to it (cv2.resize,
    INTER_LINEAR).  Each frame is a quality-95 baseline JPEG."""
    first = imageio.imread(panel_paths[0])
    h, w = first.shape[:2]
    with avi.MjpgWriter(out_path, w, h, fps) as vw:
        for p in panel_paths:
            img = first if p is panel_paths[0] else imageio.imread(p)
            if img.shape[:2] != (h, w):
                img = resize_bilinear_u8(img, (w, h))
            vw.write(img)
    return out_path
