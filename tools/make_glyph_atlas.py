"""Write fmvfi_tpu_torch/data/font/dejavu_sans.npz: the coverage masks and
metrics of DejaVu Sans that fmvfi_tpu_torch/utils/raster.py draws text with.

The glyphs are rendered by matplotlib's own FreeType wrapper (FT2Font, as
font_manager.get_font opens it, with rcParams' hinting factor and
text.hinting flag), from the DejaVuSans.ttf that matplotlib bundles, at the
sizes matplotlib uses in the port's figures (eval/visualize.py and
train/loop.py): 10 and 12 pt, each at 100 and 110 dpi.  The characters are
printable ASCII (32-126) and U+2212, the minus sign of tick labels.

Per size (key `<pt>_<dpi>`), per character:
  advance  the pen advance, 1/64 px (FreeType 26.6)
  box      the glyph's control box (xmin, ymin, xmax, ymax), 1/64 px,
           relative to the pen on the baseline, y up
  shape    (rows, cols) of its coverage mask; `masks` holds the masks one
           after another, row-major, at `start`
The mask is draw_glyphs_to_bitmap's image of the lone character (two spare
columns and rows included): its column 0 lies about xmin / 64 px right of
the pen, its row 0 about ymax / 64 + 1 px above the baseline.

Needs matplotlib; the port only reads the file.  Run from the repository
root: python3 tools/make_glyph_atlas.py [--check]
(--check compares the generated arrays with the committed file and exits 1
when they differ).
"""

from __future__ import annotations

import argparse
import io
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "fmvfi_tpu_torch", "data", "font", "dejavu_sans.npz")
SIZES = ((10, 100), (12, 100), (10, 110), (12, 110))
CODEPOINTS = tuple(range(32, 127)) + (0x2212,)


def generate() -> dict:
    """The atlas's arrays, by name."""
    from matplotlib import font_manager
    from matplotlib.backends.backend_agg import get_hinting_flag

    path = os.path.join(os.path.dirname(font_manager.__file__), "mpl-data", "fonts", "ttf",
                        "DejaVuSans.ttf")
    font = font_manager.get_font(path)
    flags = get_hinting_flag()
    arrays = {"codepoints": np.array(CODEPOINTS, np.int32)}
    for pt, dpi in SIZES:
        font.set_size(pt, dpi)
        advance, box, shape, start, masks = [], [], [], [], []
        offset = 0
        for cp in CODEPOINTS:
            glyph = font.load_char(cp, flags=flags)
            font.set_text(chr(cp), 0, flags=flags)  # its width is the advance
            font.draw_glyphs_to_bitmap(antialiased=True)
            mask = np.asarray(font.get_image(), np.uint8)
            advance.append(font.get_width_height()[0])
            box.append(glyph.bbox)
            shape.append(mask.shape)
            start.append(offset)
            masks.append(mask.ravel())
            offset += mask.size
        key = f"{pt}_{dpi}"
        arrays[f"{key}_advance"] = np.array(advance, np.int32)
        arrays[f"{key}_box"] = np.array(box, np.int32)
        arrays[f"{key}_shape"] = np.array(shape, np.int32)
        arrays[f"{key}_start"] = np.array(start, np.int64)
        arrays[f"{key}_masks"] = np.concatenate(masks)
    return arrays


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--check", action="store_true",
                   help="compare with the committed file instead of writing it")
    args = p.parse_args(argv)
    arrays = generate()
    if args.check:
        with np.load(OUT) as f:
            same = set(f.files) == set(arrays) and all(
                np.array_equal(f[k], v) for k, v in arrays.items())
        print("atlas matches" if same else "atlas differs")
        return 0 if same else 1
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    with open(OUT, "wb") as f:
        f.write(buf.getvalue())
    print(f"wrote {OUT} ({len(buf.getvalue())} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
