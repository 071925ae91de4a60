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


def _levels(bands, keep: range) -> Tuple[torch.Tensor, ...]:
    """The band levels whose index is in `keep`, the others zeroed."""
    return tuple(b if i in keep else torch.zeros_like(b) for i, b in enumerate(bands))


def keep_finest_levels(vals: Decomp, use_levels: int = 1) -> Decomp:
    """Zero all but the `use_levels` finest band levels; keep high, zero low."""
    keep = range(use_levels)
    return Decomp(
        high=vals.high,
        low=torch.zeros_like(vals.low),
        phase=_levels(vals.phase, keep),
        amplitude=_levels(vals.amplitude, keep),
    )


def keep_coarsest_levels(vals: Decomp, use_levels: int = 1) -> Decomp:
    """Zero all but the `use_levels` coarsest band levels; keep low, zero high."""
    n = len(vals.phase)
    keep = range(n - use_levels, n)
    return Decomp(
        high=torch.zeros_like(vals.high),
        low=vals.low,
        phase=_levels(vals.phase, keep),
        amplitude=_levels(vals.amplitude, keep),
    )


def abs_difference(v1: Decomp, v2: Decomp) -> Decomp:
    """Elementwise |v1 - v2| on every component."""
    return Decomp(
        high=torch.abs(v1.high - v2.high),
        low=torch.abs(v1.low - v2.low),
        phase=tuple(torch.abs(a - b) for a, b in zip(v1.phase, v2.phase)),
        amplitude=tuple(torch.abs(a - b) for a, b in zip(v1.amplitude, v2.amplitude)),
    )


def exchange_levels(base: Decomp, changer: Decomp, start: int, end: int) -> Decomp:
    """`base` with its band levels [start, end) taken from `changer` (the
    hierarchical training of PhaseNet)."""

    def pick(ours, theirs):
        return tuple(theirs[i] if start <= i < end else b for i, b in enumerate(ours))

    return Decomp(
        high=base.high,
        low=base.low,
        phase=pick(base.phase, changer.phase),
        amplitude=pick(base.amplitude, changer.amplitude),
    )
