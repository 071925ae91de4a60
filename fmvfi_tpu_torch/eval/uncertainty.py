"""The three uncertainty maps of the fusion pipeline, for study (port of the
array side of fmvfi_tpu/eval/uncertainty.py): AdaCoF's flow variance, the
phase high-frequency difference and the median-filtered artifact map, with
the intermediate frames, straight from `fusion_interpolate(...,
return_parts=True)`, optionally written as PNGs."""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from ..pipeline.interpolate import FusionModels, fusion_interpolate
from ..utils import imageio


def generate_uncertainty_maps(
    models: FusionModels,
    frame1: np.ndarray,
    frame2: np.ndarray,
    out_dir: str | None = None,
    prefix: str = "maps",
    *,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """{'ada_uncertainty', 'phase_uncertainty', 'flow_variance' (each (H, W)),
    'phase_pred', 'adacof_pred', 'baseline', 'fused' (each (H, W, 3))} of the
    first pair of (H, W, 3) or (B, H, W, 3) frames.  The fusion head must use
    the 3 maps.  With `out_dir`, each is also written as
    <out_dir>/<prefix>_<name>.png, grey or RGB, as JAX writes them
    (clipped to [0, 1], times 255, truncated)."""
    if models.fusion_net.uncertainty_maps != 3:
        raise ValueError("the fusion head runs without the uncertainty maps")
    f1 = frame1[None] if frame1.ndim == 3 else frame1
    f2 = frame2[None] if frame2.ndim == 3 else frame2
    final, parts = fusion_interpolate(models, f1, f2, return_parts=True, device=device)
    maps = parts["maps"][0].cpu().numpy()  # (H, W, 3): [ada, phase, flow_var]
    out = {
        "ada_uncertainty": maps[..., 0],
        "phase_uncertainty": maps[..., 1],
        "flow_variance": maps[..., 2],
        "phase_pred": parts["phase"][0].cpu().numpy(),
        "adacof_pred": parts["adacof"][0].cpu().numpy(),
        "baseline": parts["baseline"][0].cpu().numpy(),
        "fused": final[0].cpu().numpy(),
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        for name, img in out.items():
            imageio.imwrite(os.path.join(out_dir, f"{prefix}_{name}.png"),
                            (np.clip(img, 0, 1) * 255).astype(np.uint8))
    return out
