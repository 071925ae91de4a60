"""End-to-end two-frame interpolation (port of
fmvfi_tpu/pipeline/interpolate.py): AdaCoF only, PhaseNet only, and the
fusion pipeline.

Public frames are NHWC RGB float32 in [0, 1], (B, H, W, 3), numpy arrays or
tensors; results are NHWC tensors on `device`.  Internally everything is
NCHW.  Entry points run on CUDA unless the caller passes device="cpu"; the
models must already live on that device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..models.adacof import AdaCoFNet
from ..models.fusion_net import FusionNet
from ..models.phase_net import PhaseNetCore, normalize_inputs, predictions_to_decomp
from ..ops import decomp as dec_ops
from ..ops.color import lab_to_rgb, rgb_to_lab
from ..ops.decomp import Decomp
from ..ops.filters import gaussian_blur, median_filter_fast
from ..ops.pyramid import (
    _fft2s,
    _ifft2s,
    decompose,
    decompose_coarse,
    finest_recon_mask,
    make_filters,
    max_pyr_height,
    reconstruct,
    reconstruct_coarse,
)


class FusionModels(NamedTuple):
    """The three networks of the fusion pipeline, on one device."""

    phase_net: PhaseNetCore
    adacof: AdaCoFNet
    fusion_net: FusionNet


def _device(device, *modules: torch.nn.Module) -> torch.device:
    """The device to run on; raises if it is CUDA and CUDA is absent, or if a
    module's weights live elsewhere."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    for m in modules:
        p = next(m.parameters())
        if p.device != dev:
            raise ValueError(f"{type(m).__name__} weights are on {p.device}, not {dev}")
    return dev


def _nchw(frame, dev: torch.device) -> torch.Tensor:
    """(B, H, W, 3) array or tensor -> contiguous float32 (B, 3, H, W) on dev."""
    x = torch.as_tensor(frame, dtype=torch.float32, device=dev)
    return x.permute(0, 3, 1, 2).contiguous()


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _filters(x: torch.Tensor, dev: torch.device):
    """The pyramid filter bank for x's size, at the resolution-dependent height."""
    h, w = x.shape[-2:]
    return make_filters(h, w, max_pyr_height(h, w), device=dev)


def _phase_net_predict(phase_net: PhaseNetCore, chan_batch: torch.Tensor, filters) -> Decomp:
    """A packed 2-frame channel batch (2*B*3, H, W) -> the predicted middle
    frame's decomposition (B*3 leading)."""
    vals = decompose(chan_batch, filters)
    v1, v2 = dec_ops.split_frames(vals, 2)
    low, phases, amps = dec_ops.concat_for_net([v1, v2])
    lown, pn, an, norm = normalize_inputs(low, phases, amps)
    lo, pp, ap = phase_net(lown, pn, an)
    return predictions_to_decomp(lo, pp, ap, norm, torch.zeros_like(v1.high))


def _phase_predict_rgb(phase_net, lab1, lab2, filters) -> torch.Tensor:
    """Lab frames (B, 3, H, W) -> PhaseNet's RGB middle frame (B, 3, H, W)."""
    b, c, h, w = lab1.shape
    lab = torch.cat([lab1.reshape(b * c, h, w), lab2.reshape(b * c, h, w)], 0)
    lab_pred = reconstruct(_phase_net_predict(phase_net, lab, filters), filters)
    return torch.clamp(lab_to_rgb(lab_pred.reshape(b, c, h, w)), 0.0, 1.0)


@torch.no_grad()
def phase_interpolate(phase_net: PhaseNetCore, frame1, frame2, *, device="cuda") -> torch.Tensor:
    """PhaseNet-only interpolation: (B, H, W, 3) frames -> (B, H, W, 3)."""
    dev = _device(device, phase_net)
    f1, f2 = _nchw(frame1, dev), _nchw(frame2, dev)
    filters = _filters(f1, dev)
    return _nhwc(_phase_predict_rgb(phase_net, rgb_to_lab(f1), rgb_to_lab(f2), filters))


@torch.no_grad()
def adacof_interpolate(adacof: AdaCoFNet, frame1, frame2, *, device="cuda") -> torch.Tensor:
    """AdaCoF-only interpolation: (B, H, W, 3) frames -> (B, H, W, 3)."""
    dev = _device(device, adacof)
    out = adacof(_nchw(frame1, dev), _nchw(frame2, dev), with_stats=False)
    return _nhwc(torch.clamp(out.blended, 0.0, 1.0))


def adacof_freq_diff(ada_pred: torch.Tensor, phase_pred: torch.Tensor, filters):
    """The pre-median map of the adacof artifact uncertainty, from (B, 3, H,
    W) predictions: |band difference| of the 6 coarsest levels (channel-
    averaged before reconstruction), reconstructed, times 30; (B, H, W)."""
    b, c, h, w = ada_pred.shape
    nlev = filters.height - 2
    dev = ada_pred.device
    start = max(nlev - 6, 0)
    rgb_batch = torch.cat([ada_pred.reshape(b * c, h, w), phase_pred.reshape(b * c, h, w)], 0)
    vals_ada, vals_ph = dec_ops.split_frames(decompose_coarse(rgb_batch, filters, start), 2)

    def chan_mean(x):
        return x.reshape((b, c) + tuple(x.shape[1:])).mean(dim=1)

    phases, amps = [], []
    for lvl in range(nlev):
        if lvl < start:
            sh = (b, filters.nbands) + tuple(filters.level_shapes[lvl])
            phases.append(torch.zeros(sh, device=dev))
            amps.append(torch.zeros(sh, device=dev))
            continue
        da = torch.abs(vals_ph.amplitude[lvl] - vals_ada.amplitude[lvl])
        dp = torch.abs(vals_ph.phase[lvl] - vals_ada.phase[lvl])
        band = chan_mean(torch.polar(da, dp))
        amps.append(torch.abs(band))
        phases.append(torch.atan2(band.imag, band.real))
    low = chan_mean(torch.abs(vals_ph.low - vals_ada.low))
    dvals = Decomp(
        high=torch.zeros((b, h, w), device=dev),
        low=low,
        phase=tuple(phases),
        amplitude=tuple(amps),
    )
    return reconstruct_coarse(dvals, filters, start) * 30.0


def fusion_uncertainty(ada_pred: torch.Tensor, phase_pred: torch.Tensor, filters):
    """The two pyramid-derived uncertainty maps of the fusion pipeline, from
    (B, 3, H, W) predictions; returns (ada_uncertainty, phase_uncertainty),
    each (B, H, W).

    (a) phase uncertainty: the finest band + highpass of the channel-mean
        difference image, as one spectral multiply, |.|, clipped, gaussian.
    (b) adacof artifact uncertainty: `adacof_freq_diff` minus its 50x50
        median."""
    g = torch.mean(ada_pred - phase_pred, dim=1)
    h_diff = torch.abs(_ifft2s(_fft2s(g) * finest_recon_mask(filters)).real)
    phase_unc = gaussian_blur(torch.clamp(h_diff * 100.0, 0.0, 1.0), 5.0)

    freq_diff = adacof_freq_diff(ada_pred, phase_pred, filters)
    freq_med = median_filter_fast(freq_diff, size=50)
    ada_unc = torch.clamp(torch.abs(freq_diff - freq_med) * 5.0, 0.0, 1.0)
    return ada_unc, phase_unc


@torch.no_grad()
def fusion_interpolate(
    models: FusionModels,
    frame1,
    frame2,
    return_parts: bool = False,
    *,
    device="cuda",
    compute_dtype=None,
    spatial_mesh=None,
    seq_chunk: int = 0,
):
    """The fusion pipeline: (B, H, W, 3) frames -> the fused middle frame.

    1. AdaCoF prediction + flow-variance uncertainty,
    2. PhaseNet prediction through the steerable pyramid (Lab domain),
    3. the phase / adacof band-difference uncertainty maps,
    4. the 3-pass AdaCoF baseline composite AdaCoF(AdaCoF(f1, phase),
       AdaCoF(phase, f2)),
    5. the FusionNet blend.

    The head variant and the number of uncertainty maps are those of
    `models.fusion_net`; with 0 maps sections 3 and AdaCoF's flow-stats tail
    are skipped.  Off-grid frames are reflect-padded to /8 and every output
    cropped back.  With return_parts=True also returns a dict of the
    intermediate frames (and the maps), NHWC.

    compute_dtype, spatial_mesh and seq_chunk of the JAX pipeline are not
    ported yet and raise."""
    if compute_dtype is not None or spatial_mesh is not None or seq_chunk:
        raise NotImplementedError(
            "compute_dtype, spatial_mesh and seq_chunk are not ported to fmvfi_tpu_torch yet"
        )
    dev = _device(device, *models)
    f1, f2 = _nchw(frame1, dev), _nchw(frame2, dev)
    b, _, full_h, full_w = f1.shape
    pad_h, pad_w = (-full_h) % 8, (-full_w) % 8
    if pad_h or pad_w:
        f1 = F.pad(f1, (0, pad_w, 0, pad_h), mode="reflect")
        f2 = F.pad(f2, (0, pad_w, 0, pad_h), mode="reflect")
    filters = _filters(f1, dev)
    n_maps = models.fusion_net.uncertainty_maps

    # 1. AdaCoF
    ada_out = models.adacof(f1, f2, with_stats=n_maps != 0)
    ada_pred = ada_out.blended

    # 2. PhaseNet (Lab domain)
    lab1, lab2 = rgb_to_lab(f1), rgb_to_lab(f2)
    phase_pred = _phase_predict_rgb(models.phase_net, lab1, lab2, filters)

    # 3. uncertainty maps, ordered [ada_unc, phase_unc, flow_var]
    maps = None
    if n_maps:
        ada_unc, phase_unc = fusion_uncertainty(ada_pred, phase_pred, filters)
        maps = torch.stack([ada_unc, phase_unc, ada_out.uncertainty[:, 0]], dim=1)

    # 4. baseline composite; passes 1 and 2 are independent -> one batched call
    lhs = torch.cat([f1, phase_pred], 0)
    rhs = torch.cat([phase_pred, f2], 0)
    mids = models.adacof(lhs, rhs, with_stats=False).blended
    base = models.adacof(mids[:b], mids[b:], with_stats=False).blended

    # 5. FusionNet blend; other = the Lab frames
    other = torch.cat([lab1, lab2], dim=1)
    final = models.fusion_net(base, ada_pred, phase_pred, other, maps)

    def out(x):
        return _nhwc(x[:, :, :full_h, :full_w])

    if return_parts:
        parts = {"phase": out(phase_pred), "adacof": out(ada_pred), "baseline": out(base)}
        if n_maps:
            parts["maps"] = out(maps)
        return out(final), parts
    return out(final)
