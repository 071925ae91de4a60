"""Dataset-layout adapters for the reference's benchmark sets (port of
fmvfi_tpu/eval/datasets.py, reading PNGs with utils.imageio).

Re-derives the directory contracts of the reference's src/adacof/TestModule.py
(Middlebury-other :31-42, DAVIS :69-80, UCF101 :106-117, Middlebury-eval
:10-20) and the Vimeo90k interpolation test split
(the reference's src/evaluation/evaluate.py:132-140) as plain loaders
returning explicit (frame1, gt, frame2) triplets.  Scene lists are DISCOVERED
from the directory (sorted) rather than hard-coded, so subsets work; the
canonical scene lists ship in the reference and any full download matches.

Layouts:
- middlebury-other / davis:  <input_dir>/<scene>/frame10.png + frame11.png,
                             <gt_dir>/<scene>/frame10i11.png
- middlebury-eval:           <input_dir>/input/<scene>/frame10.png+frame11.png
                             (no ground truth — interpolation-only)
- ucf101:                    <dir>/<n>/frame0.png frame1.png frame2.png
- vimeo:                     <root>/tri_testlist.txt + target/<trip>/im{1,2,3}.png
                             (inputs from input/<trip>/ when present)
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils import imageio

Triplet = Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]


def _imread(path: str) -> np.ndarray:
    return imageio.imread(path).astype(np.float32) / 255.0


def _scenes(d: str) -> List[str]:
    return sorted(
        s for s in os.listdir(d) if os.path.isdir(os.path.join(d, s))
    )


def middlebury_other(input_dir: str, gt_dir: str) -> Dict[str, Triplet]:
    """TestModule.Middlebury_other layout -> {scene: (f1, gt, f2)}."""
    out = {}
    for scene in _scenes(input_dir):
        f1 = _imread(os.path.join(input_dir, scene, "frame10.png"))
        f2 = _imread(os.path.join(input_dir, scene, "frame11.png"))
        gt = _imread(os.path.join(gt_dir, scene, "frame10i11.png"))
        out[scene] = (f1, gt, f2)
    return out


def davis(input_dir: str, gt_dir: str) -> Dict[str, Triplet]:
    """Same file contract as middlebury_other (TestModule.Davis)."""
    return middlebury_other(input_dir, gt_dir)


def middlebury_eval(input_dir: str) -> Dict[str, Tuple[np.ndarray, None, np.ndarray]]:
    """TestModule.Middlebury_eval: inputs only, no ground truth."""
    base = os.path.join(input_dir, "input")
    base = base if os.path.isdir(base) else input_dir
    out = {}
    for scene in _scenes(base):
        f1 = _imread(os.path.join(base, scene, "frame10.png"))
        f2 = _imread(os.path.join(base, scene, "frame11.png"))
        out[scene] = (f1, None, f2)
    return out


def ucf101(input_dir: str) -> Dict[str, Triplet]:
    """TestModule.ucf layout: frame0/frame1/frame2 per numbered directory."""
    out = {}
    for scene in _scenes(input_dir):
        f1 = _imread(os.path.join(input_dir, scene, "frame0.png"))
        gt = _imread(os.path.join(input_dir, scene, "frame1.png"))
        f2 = _imread(os.path.join(input_dir, scene, "frame2.png"))
        out[scene] = (f1, gt, f2)
    return out


def vimeo_interp_test(
    root: str, max_num: Optional[int] = None
) -> Dict[str, Triplet]:
    """vimeo_interp_test split: tri_testlist.txt rows like '00001/0389';
    inputs im1/im3 (from input/ when present, else target/), gt im2."""
    listfile = os.path.join(root, "tri_testlist.txt")
    with open(listfile) as f:
        trips = [x.strip() for x in f if x.strip()]
    if max_num is not None:
        trips = trips[:max_num]
    input_root = os.path.join(root, "input")
    if not os.path.isdir(input_root):
        input_root = os.path.join(root, "target")
    out = {}
    for t in trips:
        f1 = _imread(os.path.join(input_root, t, "im1.png"))
        f2 = _imread(os.path.join(input_root, t, "im3.png"))
        gt = _imread(os.path.join(root, "target", t, "im2.png"))
        out[t.replace("/", "_")] = (f1, gt, f2)
    return out


_ADAPTERS = {
    "middlebury": lambda args, **kw: middlebury_other(*args),
    "middlebury_eval": lambda args, **kw: middlebury_eval(*args),
    "davis": lambda args, **kw: davis(*args),
    "ucf101": lambda args, **kw: ucf101(*args),
    "vimeo": lambda args, **kw: vimeo_interp_test(*args, **kw),
}


def load_test_set(spec: str, max_num: Optional[int] = None) -> Dict[str, Triplet]:
    """Parse an eval-set spec 'adapter:path[:path2]':

        middlebury:/data/middlebury/other:/data/middlebury/other-gt
        davis:/data/davis/input:/data/davis/gt
        ucf101:/data/ucf
        vimeo:/data/vimeo_interp_test
        middlebury_eval:/data/middlebury/eval
    """
    kind, _, rest = spec.partition(":")
    if kind not in _ADAPTERS:
        raise ValueError(f"unknown test-set adapter '{kind}' (have {sorted(_ADAPTERS)})")
    args = rest.split(":") if rest else []
    kw = {"max_num": max_num} if kind == "vimeo" else {}
    return _ADAPTERS[kind](args, **kw)
