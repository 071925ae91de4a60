"""Training losses (port of fmvfi_tpu/train/losses.py).

- PhaseNet loss: L1 image + circular phase distance.
- Charbonnier and the spec-string loss factory of the reference's AdaCoF
  ('1*Charb+0.01*g_Spatial+0.005*g_Occlusion'): weighted terms parsed once,
  evaluated on tensors.  VGG and the GAN family parse here; the AdaCoF
  trainer computes them (train/vgg.py, train/adversarial.py).

Under active spatial bands (spatial training, parallel/spatial.py) the image
losses take a band of rows and give its share of the whole frame's mean
(`spatial.band_mean`); the shares of the spatial group sum to the mean.
"""

from __future__ import annotations

import re
from typing import Dict, List, NamedTuple, Tuple

import torch

from ..ops.decomp import Decomp
from ..parallel.spatial import band_mean


def l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return band_mean(torch.abs(a - b))


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return band_mean((a - b) ** 2)


def charbonnier(a: torch.Tensor, b: torch.Tensor, eps: float = 0.001) -> torch.Tensor:
    return band_mean(torch.sqrt((a - b) ** 2 + eps**2))


def circular_phase_loss(pred: Decomp, target: Decomp) -> torch.Tensor:
    """Sum over levels and orientation bands of mean |atan2(sin d, cos d)|;
    bands are (N, nbands, h, w)."""
    total = 0.0
    for p, t in zip(pred.phase, target.phase):
        d = t - p
        delta = torch.atan2(torch.sin(d), torch.cos(d))
        # per-orientation mean, summed over the nbands axis (dim 1)
        total = total + torch.sum(torch.mean(torch.abs(delta), dim=(0, 2, 3)))
    return total


def phase_net_loss(
    pred_img: torch.Tensor,
    target_img: torch.Tensor,
    pred_vals: Decomp,
    target_vals: Decomp,
    weighting_factor: float = 0.005,
):
    """total = L1(img) + w * circular phase loss.
    Returns (total, dict of unweighted parts)."""
    l_1 = l1(pred_img, target_img)
    p_l = circular_phase_loss(pred_vals, target_vals)
    total = l_1 + weighting_factor * p_l
    return total, {"l1": l_1, "phase": p_l}


class LossSpec(NamedTuple):
    terms: Tuple[Tuple[float, str], ...]

    def __call__(self, values: Dict[str, torch.Tensor]) -> torch.Tensor:
        total = 0.0
        for w, name in self.terms:
            if name not in values:
                raise KeyError(f"loss term '{name}' not provided (have {list(values)})")
            total = total + w * values[name]
        return total


_SIMPLE = {"Charb", "L1", "MSE", "g_Spatial", "g_Occlusion"}
GAN_TYPES = {"GAN", "WGAN", "WGAN_GP", "FI_GAN", "T_WGAN_GP"}


def gan_terms(spec: LossSpec) -> List[Tuple[float, str]]:
    """The adversarial terms of a spec (the reference matches by substring
    'GAN')."""
    return [(w, n) for w, n in spec.terms if n in GAN_TYPES]


def has_term(spec: LossSpec, name: str) -> bool:
    return any(n == name for _, n in spec.terms)


def parse_loss_spec(spec: str) -> LossSpec:
    """'1*Charb+0.01*g_Spatial+0.005*g_Occlusion' -> LossSpec."""
    terms: List[Tuple[float, str]] = []
    for part in spec.split("+"):
        part = part.strip()
        if not part:
            continue
        m = re.fullmatch(r"([0-9.eE+-]+)\s*\*\s*(\w+)", part)
        if not m:
            raise ValueError(f"bad loss term '{part}' (want 'weight*Name')")
        w, name = float(m.group(1)), m.group(2)
        if name not in _SIMPLE and name != "VGG" and name not in GAN_TYPES:
            raise ValueError(
                f"unknown loss '{name}' (supported: "
                f"{sorted(_SIMPLE) + ['VGG'] + sorted(GAN_TYPES)})"
            )
        terms.append((w, name))
    return LossSpec(tuple(terms))
