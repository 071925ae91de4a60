"""Pyramid decompositions and the helpers that regroup them
(port of fmvfi_tpu/ops/decomp.py).

A `Decomp` carries (N, nbands, h, w) band tensors, level 0 = finest.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch


class Decomp(NamedTuple):
    """One pyramid decomposition of N images."""

    high: torch.Tensor  # (N, H, W) real highpass residual
    low: torch.Tensor  # (N, hL, wL) real lowpass residual
    phase: Tuple[torch.Tensor, ...]  # per level, finest first, (N, nbands, h, w)
    amplitude: Tuple[torch.Tensor, ...]


def split_frames(vals: Decomp, num: int) -> List[Decomp]:
    """Split a Decomp whose leading axis packs `num` frame groups
    (frame-major) into `num` Decomps."""
    n = vals.high.shape[0] // num
    outs = []
    for i in range(num):
        sl = slice(i * n, (i + 1) * n)
        outs.append(
            Decomp(
                high=vals.high[sl],
                low=vals.low[sl],
                phase=tuple(p[sl] for p in vals.phase),
                amplitude=tuple(a[sl] for a in vals.amplitude),
            )
        )
    return outs


def concat_frames(vals_list: Sequence[Decomp]) -> Decomp:
    """Concatenate per-frame Decomps along the leading (batch) axis."""
    nlev = len(vals_list[0].phase)
    return Decomp(
        high=torch.cat([v.high for v in vals_list], 0),
        low=torch.cat([v.low for v in vals_list], 0),
        phase=tuple(torch.cat([v.phase[i] for v in vals_list], 0) for i in range(nlev)),
        amplitude=tuple(
            torch.cat([v.amplitude[i] for v in vals_list], 0) for i in range(nlev)
        ),
    )


def concat_for_net(vals_list: Sequence[Decomp]):
    """PhaseNet inputs from per-frame Decomps: the frames' band axes are
    concatenated (frame0 bands, frame1 bands, ...) and levels are reordered
    coarsest first.

    Returns (low, phases, amps): low (N, num_img, hL, wL); phases and amps
    lists coarse -> fine of (N, num_img*nbands, h_l, w_l)."""
    low = torch.stack([v.low for v in vals_list], dim=1)
    nlev = len(vals_list[0].phase)
    phases = [torch.cat([v.phase[lvl] for v in vals_list], 1) for lvl in range(nlev)]
    amps = [torch.cat([v.amplitude[lvl] for v in vals_list], 1) for lvl in range(nlev)]
    return low, phases[::-1], amps[::-1]
