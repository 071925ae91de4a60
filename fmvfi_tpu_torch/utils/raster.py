"""A small numpy canvas for the port's figures (eval/visualize.py and
train/loop.py's MetricsWriter.plot), in place of matplotlib's Agg renderer.

Coordinates are matplotlib's display coordinates: pixels, the origin at the
bottom-left corner, y up; pixel column c covers x in [c, c + 1), pixel row r
(from the top) covers y in [H - r - 1, H - r).  The canvas draws

- filled rectangles, edges rounded half up to whole pixels, with alpha;
- polylines of any width, solid: a pixel is drawn when its centre lies
  within half the width of a segment (no anti-aliasing, so a line's pixels
  carry its exact colour);
- text from the DejaVu Sans atlas of data/font/ (matplotlib's own glyph
  masks and metrics at 10 and 12 pt, 100 and 110 dpi), anti-aliased by its
  coverage, with alpha, placed by matplotlib's rules for horizontal and
  vertical alignment and rotated by any angle (rotation_mode "default" or
  "anchor").  Glyphs sit on whole pixels and kerning is left out, so a
  string may lie a pixel from where matplotlib puts it.

The colour tables of the figures are carried here: matplotlib's `jet`
(its segment data, sampled to 256 entries as matplotlib's
colors._create_lookup_table samples it) and the default colour cycle
`tab10` (rcParams["axes.prop_cycle"], C0-C9).
"""

from __future__ import annotations

import functools
import math
import os
from typing import Sequence, Tuple

import numpy as np

FONT_FILE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "data", "font", "dejavu_sans.npz")

# matplotlib's default colour cycle (matplotlib/_cm.py _tab10_data, as hex)
TAB10 = ("#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
         "#8c564b", "#e377c2", "#7f7f7f", "#bcbd22", "#17becf")

# matplotlib/_cm.py _jet_data: (x, y0, y1) per channel
_JET_SEGMENTS = {
    "red": ((0.0, 0.0, 0.0), (0.35, 0.0, 0.0), (0.66, 1.0, 1.0), (0.89, 1.0, 1.0),
            (1.0, 0.5, 0.5)),
    "green": ((0.0, 0.0, 0.0), (0.125, 0.0, 0.0), (0.375, 1.0, 1.0), (0.64, 1.0, 1.0),
              (0.91, 0.0, 0.0), (1.0, 0.0, 0.0)),
    "blue": ((0.0, 0.5, 0.5), (0.11, 1.0, 1.0), (0.34, 1.0, 1.0), (0.65, 0.0, 0.0),
             (1.0, 0.0, 0.0)),
}
LUT_SIZE = 256  # rcParams["image.lut"]


def _segment_lut(segments, n: int) -> np.ndarray:
    """matplotlib.colors._create_lookup_table(n, segments) with gamma 1."""
    data = np.asarray(segments, np.float64)
    x, y0, y1 = data[:, 0] * (n - 1), data[:, 1], data[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1], [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


# jet's 256 entries in [0, 1] (alpha 1), as colormaps["jet"](np.arange(256))[:, :3]
JET = np.stack([_segment_lut(_JET_SEGMENTS[c], LUT_SIZE) for c in ("red", "green", "blue")],
               axis=1)


def colormap_u8(values: np.ndarray, lut: np.ndarray, vmin: float, vmax: float) -> np.ndarray:
    """`values` through Normalize(vmin, vmax) and the colour table `lut`
    ((N, 3) in [0, 1]) as uint8 RGB, as Colormap.__call__(bytes=True) maps
    them: index int(x * N), x == 1 to the last entry, values past either end
    to the end entries (jet's over and under colours), NaN to black."""
    n = lut.shape[0]
    x = (np.asarray(values, np.float64) - vmin) / (vmax - vmin)
    bad = ~np.isfinite(x)
    xa = np.where(bad, 0.0, x) * n
    xa[xa == n] = n - 1
    idx = np.clip(np.where(xa < 0, -1, xa).astype(np.int64), 0, n - 1)
    rgb = (lut * 255).astype(np.uint8)[idx]
    rgb[bad] = 0
    return rgb


def hex_rgb(color: str) -> Tuple[int, int, int]:
    """'#rrggbb' -> (r, g, b) ints."""
    return tuple(int(color[i : i + 2], 16) for i in (1, 3, 5))


class Font:
    """One size of the atlas: DejaVu Sans at `points` pt and `dpi`."""

    def __init__(self, points: int, dpi: int):
        key = f"{points}_{dpi}"
        with np.load(FONT_FILE) as f:
            if f"{key}_advance" not in f.files:
                raise ValueError(f"the glyph atlas has no {points} pt at {dpi} dpi")
            self.codepoints = {int(c): i for i, c in enumerate(f["codepoints"])}
            self.advance = f[f"{key}_advance"]
            self.box = f[f"{key}_box"]
            shape, start, masks = f[f"{key}_shape"], f[f"{key}_start"], f[f"{key}_masks"]
        self.points, self.dpi = points, dpi
        self.masks = [masks[s : s + r * c].reshape(r, c) for s, (r, c) in zip(start, shape)]
        self.lp = self._raw_metrics("lp")

    def _index(self, ch: str) -> int:
        i = self.codepoints.get(ord(ch))
        if i is None:
            raise ValueError(f"the glyph atlas has no {ch!r} (U+{ord(ch):04X})")
        return i

    def _raw_metrics(self, s: str) -> Tuple[float, float, float]:
        """FT2Font.set_text's width (the advances), height and descent, px."""
        if not s:
            return 0.0, 0.0, 0.0
        idx = [self._index(ch) for ch in s]
        ymin = min(int(self.box[i, 1]) for i in idx)
        ymax = max(int(self.box[i, 3]) for i in idx)
        if ymin > ymax:  # only blanks: FT2Font's empty box
            ymin = ymax = 0
        width = sum(int(self.advance[i]) for i in idx)
        return width / 64.0, (ymax - ymin) / 64.0, -ymin / 64.0

    def metrics(self, s: str) -> Tuple[float, float, float]:
        """(width, height, descent) of a one-line Text in px, as
        Text._get_layout sizes it: height and descent at least those of
        "lp"."""
        w, h, d = self._raw_metrics(s)
        return w, max(h, self.lp[1]), max(d, self.lp[2])

    def render(self, s: str) -> Tuple[np.ndarray, int, int]:
        """(coverage (rows, cols) uint8, left, top): the string's mask, its
        column 0 `left` px right of the pen's start, its row 0 covering the
        pixel row whose top edge is `top` px above the baseline."""
        placed, pen = [], 0
        for ch in s:
            i = self._index(ch)
            m = self.masks[i]
            left = (pen + int(self.box[i, 0])) // 64
            top = int(self.box[i, 3]) // 64 + 1
            placed.append((m, left, top))
            pen += int(self.advance[i])
        placed = [p for p in placed if p[0].size]
        if not placed:
            return np.zeros((0, 0), np.uint8), 0, 0
        left = min(p[1] for p in placed)
        top = max(p[2] for p in placed)
        right = max(p[1] + p[0].shape[1] for p in placed)
        bottom = min(p[2] - p[0].shape[0] for p in placed)
        out = np.zeros((top - bottom, right - left), np.uint8)
        for m, x, y in placed:
            r, c = top - y, x - left
            np.maximum(out[r : r + m.shape[0], c : c + m.shape[1]], m,
                       out=out[r : r + m.shape[0], c : c + m.shape[1]])
        return out, left, top


@functools.lru_cache(maxsize=None)
def font(points: int, dpi: int) -> Font:
    """The atlas's size `points` pt at `dpi` (loaded once)."""
    return Font(points, dpi)


def _rotation(deg: float) -> np.ndarray:
    t = math.radians(deg)
    return np.array([[math.cos(t), -math.sin(t)], [math.sin(t), math.cos(t)]])


def text_layout(s: str, x: float, y: float, fnt: Font, ha: str = "left",
                va: str = "baseline", rotation: float = 0.0,
                rotation_mode: str = "default"):
    """Where matplotlib's Text._get_layout puts one line of text anchored at
    display (x, y): (bbox (x0, y0, x1, y1), the pen's start on the baseline,
    the rotation matrix)."""
    w, h, d = fnt.metrics(s)
    baseline = h - d
    rot = _rotation(rotation)
    corners = np.array([[0.0, -h], [0.0, 0.0], [w, 0.0], [w, -h]]) @ rot.T
    xmin, ymin = corners.min(0)
    xmax, ymax = corners.max(0)
    if rotation_mode == "anchor":
        ox = {"center": w / 2, "right": w}.get(ha, 0.0)
        oy = {"center": -h / 2, "top": 0.0, "baseline": -baseline,
              "center_baseline": -baseline / 2}.get(va, -h)
        ox, oy = rot @ np.array([ox, oy])
    else:
        ox = {"center": (xmin + xmax) / 2, "right": xmax}.get(ha, xmin)
        height = ymax - ymin
        oy = {"center": (ymin + ymax) / 2, "top": ymax, "baseline": ymin + height - baseline,
              "center_baseline": ymin + height - baseline / 2}.get(va, ymin)
    origin = np.array([x - ox, y - oy])
    bbox = (origin[0] + xmin, origin[1] + ymin, origin[0] + xmax, origin[1] + ymax)
    pen = origin + rot @ np.array([0.0, -baseline])
    return bbox, pen, rot


class Canvas:
    """An (H, W, 3) uint8 RGB image, white unless `color` says otherwise."""

    def __init__(self, width: int, height: int, color=(255, 255, 255)):
        self.width, self.height = int(width), int(height)
        self.img = np.empty((self.height, self.width, 3), np.uint8)
        self.img[:] = color

    def _blend(self, rows, cols, color, alpha):
        """Blend `color` into img[rows, cols] with per-pixel `alpha` in [0, 1]."""
        dst = self.img[rows, cols].astype(np.float64)
        a = np.asarray(alpha, np.float64)[..., None]
        self.img[rows, cols] = np.rint(dst * (1 - a) + np.asarray(color, np.float64) * a
                                       ).astype(np.uint8)

    def fill_rect(self, x0: float, y0: float, x1: float, y1: float, color,
                  alpha: float = 1.0) -> None:
        """Fill display box [x0, x1] x [y0, y1], each edge rounded to the
        nearest pixel boundary; a box with a non-finite edge draws nothing,
        as Agg drops such a path."""
        if not np.isfinite((x0, y0, x1, y1)).all():
            return

        def rnd(v):  # half up, as Agg snaps
            return int(math.floor(v + 0.5))

        c0, c1 = max(0, rnd(x0)), min(self.width, rnd(x1))
        r0, r1 = max(0, self.height - rnd(y1)), min(self.height, self.height - rnd(y0))
        if c0 >= c1 or r0 >= r1:
            return
        if alpha >= 1.0:
            self.img[r0:r1, c0:c1] = color
        else:
            self._blend(slice(r0, r1), slice(c0, c1), color, np.full((r1 - r0, c1 - c0), alpha))

    def blit(self, image: np.ndarray, col: int, row: int) -> None:
        """Copy an (h, w, 3) uint8 image with its top-left pixel at (col, row)."""
        h, w = image.shape[:2]
        self.img[row : row + h, col : col + w] = image

    def polyline(self, points: Sequence[Tuple[float, float]], color, width: float) -> None:
        """A solid polyline through display `points`, `width` px wide (a
        single point draws nothing, as a matplotlib line without markers).
        A point with a non-finite coordinate breaks the line there, as Agg's
        NaN remover does."""
        pts = np.asarray(points, np.float64).reshape(-1, 2)
        half = width / 2
        for (xa, ya), (xb, yb) in zip(pts[:-1], pts[1:]):
            if not np.isfinite((xa, ya, xb, yb)).all():
                continue
            c0 = max(0, int(math.floor(min(xa, xb) - half)))
            c1 = min(self.width, int(math.ceil(max(xa, xb) + half)) + 1)
            r0 = max(0, int(math.floor(self.height - max(ya, yb) - half)))
            r1 = min(self.height, int(math.ceil(self.height - min(ya, yb) + half)) + 1)
            if c0 >= c1 or r0 >= r1:
                continue
            px = np.arange(c0, c1) + 0.5
            py = self.height - (np.arange(r0, r1) + 0.5)
            dx, dy = xb - xa, yb - ya
            n2 = dx * dx + dy * dy
            if n2 > 0:
                t = np.clip(((px[None] - xa) * dx + (py[:, None] - ya) * dy) / n2, 0, 1)
            else:
                t = np.zeros((len(py), len(px)))
            ex = px[None] - (xa + t * dx)
            ey = py[:, None] - (ya + t * dy)
            on = ex * ex + ey * ey <= half * half
            self.img[r0:r1, c0:c1][on] = color

    def text(self, s: str, x: float, y: float, fnt: Font, color=(0, 0, 0), ha: str = "left",
             va: str = "baseline", rotation: float = 0.0, rotation_mode: str = "default",
             alpha: float = 1.0):
        """Draw one line of text anchored at display (x, y) as matplotlib's
        Text(x, y, s, ha=, va=, rotation=, rotation_mode=) lays it out;
        returns its bbox (x0, y0, x1, y1)."""
        bbox, pen, rot = text_layout(s, x, y, fnt, ha, va, rotation, rotation_mode)
        mask, left, top = fnt.render(s)
        if not mask.size:
            return bbox
        cover = mask.astype(np.float64) / 255.0 * alpha
        if rotation % 360 == 0:
            c0 = int(round(pen[0])) + left
            r0 = self.height - int(round(pen[1])) - top
            rows, cols = mask.shape
            rs, cs = max(0, -r0), max(0, -c0)
            re, ce = min(rows, self.height - r0), min(cols, self.width - c0)
            if rs < re and cs < ce:
                self._blend(slice(r0 + rs, r0 + re), slice(c0 + cs, c0 + ce), color,
                            cover[rs:re, cs:ce])
            return bbox
        # rotated: sample the mask at each canvas pixel of the box, bilinearly
        c0, c1 = max(0, int(math.floor(bbox[0])) - 1), min(self.width, int(math.ceil(bbox[2])) + 1)
        r0 = max(0, self.height - int(math.ceil(bbox[3])) - 1)
        r1 = min(self.height, self.height - int(math.floor(bbox[1])) + 1)
        if c0 >= c1 or r0 >= r1:
            return bbox
        px, py = np.meshgrid(np.arange(c0, c1) + 0.5, self.height - (np.arange(r0, r1) + 0.5))
        u = rot[0, 0] * (px - pen[0]) + rot[1, 0] * (py - pen[1])  # along the baseline
        v = rot[0, 1] * (px - pen[0]) + rot[1, 1] * (py - pen[1])  # up from it
        fc = u - left - 0.5  # mask column, row of each sample
        fr = top - v - 0.5
        col0, row0 = np.floor(fc).astype(np.int64), np.floor(fr).astype(np.int64)
        tx, ty = fc - col0, fr - row0
        padded = np.pad(cover, 1)
        acc = np.zeros_like(fc)
        for dr, dc, wgt in ((0, 0, (1 - ty) * (1 - tx)), (0, 1, (1 - ty) * tx),
                            (1, 0, ty * (1 - tx)), (1, 1, ty * tx)):
            rr = np.clip(row0 + dr + 1, 0, padded.shape[0] - 1)
            cc = np.clip(col0 + dc + 1, 0, padded.shape[1] - 1)
            inside = (row0 + dr >= -1) & (row0 + dr <= cover.shape[0]) & \
                     (col0 + dc >= -1) & (col0 + dc <= cover.shape[1])
            acc += np.where(inside, padded[rr, cc], 0.0) * wgt
        hit = acc > 0
        if hit.any():
            sub = self.img[r0:r1, c0:c1]
            dst = sub[hit].astype(np.float64)
            a = acc[hit][:, None]
            sub[hit] = np.rint(dst * (1 - a) + np.asarray(color, np.float64) * a).astype(np.uint8)
        return bbox


def text_bbox(s: str, x: float, y: float, fnt: Font, **kw) -> Tuple[float, float, float, float]:
    """The display bbox (x0, y0, x1, y1) of Canvas.text with the same
    arguments, without drawing."""
    return text_layout(s, x, y, fnt, **kw)[0]

