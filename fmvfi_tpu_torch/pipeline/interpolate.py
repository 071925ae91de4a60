"""End-to-end two-frame interpolation (port of
fmvfi_tpu/pipeline/interpolate.py): AdaCoF only, PhaseNet only, the fusion
pipeline (per pair, or its middle sections chunk by chunk with `seq_chunk`),
the streaming fusion over a frame sequence, and the spectral baseline.

Public frames are NHWC RGB float32 in [0, 1], (B, H, W, 3), numpy arrays or
tensors; results are NHWC tensors on `device`.  Internally everything is
NCHW.  Entry points run on CUDA unless the caller passes device="cpu"; the
models must already live on that device.

`compute_dtype` (None or torch.bfloat16) of the fusion entry points runs the
three networks' convolutions in that dtype, as the JAX package's `dtype=`
does: the parameters stay float32 and are cast per call, the nets return to
float32 at fixed points, and the colour conversion, the pyramid, the
uncertainty maps and the warp (K1 on CUDA: float32 only) stay float32, as do
the returned frames.

`spatial_mesh` (a ("data", "spatial") DeviceMesh, one process per device)
of `fusion_interpolate` and `phase_interpolate` serves frames split over
the processes (parallel/spatial.py): every process passes the whole
frames and gets the whole result; in between each computes its batch
share, the nets on its band of rows.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

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
from ..parallel import spatial


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


def _check_compute_dtype(compute_dtype) -> None:
    if compute_dtype is not None and compute_dtype != torch.bfloat16:
        raise ValueError(f"compute_dtype must be None or torch.bfloat16, got {compute_dtype}")


def _nchw(frame, dev: torch.device) -> torch.Tensor:
    """(B, H, W, 3) array or tensor -> contiguous float32 (B, 3, H, W) on dev."""
    x = torch.as_tensor(frame, dtype=torch.float32, device=dev)
    return x.permute(0, 3, 1, 2).contiguous()


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _filters(x: torch.Tensor, filters=None):
    """`filters` if given, else the pyramid filter bank for x's size on x's
    device, at the resolution-dependent height.  Raises if a given bank is
    for another size."""
    h, w = x.shape[-2:]
    if filters is None:
        return make_filters(h, w, max_pyr_height(h, w), device=x.device)
    if tuple(filters.in_shape) != (h, w):
        raise ValueError(f"filter bank for {filters.in_shape}, frames of {(h, w)}")
    return filters


def _chan_batch(x: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) -> the channel batch (B*3, H, W), batch-major."""
    b, c, h, w = x.shape
    return x.reshape(b * c, h, w)


def _phase_net_from_vals(phase_net: PhaseNetCore, vals: Decomp, compute_dtype=None) -> Decomp:
    """PhaseNet on an already-decomposed packed 2-frame batch (2*B*3 leading)
    -> the predicted middle frame's decomposition (B*3 leading).  Separate
    from the decomposition, so that the stream reuses a frame's
    (fmvfi_tpu/pipeline/interpolate.py:92-102)."""
    v1, v2 = dec_ops.split_frames(vals, 2)
    low, phases, amps = dec_ops.concat_for_net([v1, v2])
    lown, pn, an, norm = normalize_inputs(low, phases, amps)
    lo, pp, ap = phase_net(lown, pn, an, compute_dtype=compute_dtype)
    return predictions_to_decomp(lo, pp, ap, norm, torch.zeros_like(v1.high))


def _phase_net_predict(phase_net: PhaseNetCore, chan_batch: torch.Tensor, filters,
                       compute_dtype=None) -> Decomp:
    """A packed 2-frame channel batch (2*B*3, H, W) -> the predicted middle
    frame's decomposition (B*3 leading)."""
    return _phase_net_from_vals(phase_net, decompose(chan_batch, filters), compute_dtype)


def _lab_dec_to_rgb(dec: Decomp, filters, shape) -> torch.Tensor:
    """A predicted Lab decomposition (B*3 leading) -> the RGB frame
    (B, 3, H, W), clipped to [0, 1]."""
    return torch.clamp(lab_to_rgb(reconstruct(dec, filters).reshape(shape)), 0.0, 1.0)


def _phase_predict_rgb(phase_net, lab1, lab2, filters, compute_dtype=None) -> torch.Tensor:
    """Lab frames (B, 3, H, W) -> PhaseNet's RGB middle frame (B, 3, H, W)."""
    lab = torch.cat([_chan_batch(lab1), _chan_batch(lab2)], 0)
    dec = _phase_net_predict(phase_net, lab, filters, compute_dtype)
    return _lab_dec_to_rgb(dec, filters, lab1.shape)


@torch.no_grad()
def phase_interpolate(
    phase_net: PhaseNetCore, frame1, frame2, *, device="cuda", filters=None, spatial_mesh=None,
    batch_axis: str = "data",
) -> torch.Tensor:
    """PhaseNet-only interpolation: (B, H, W, 3) frames -> (B, H, W, 3).
    `filters`: the frames' pyramid filter bank (None: built, cached).
    `spatial_mesh`: a DeviceMesh with a `batch_axis`; every process passes
    the whole batch and gets the whole result, each computing its share of
    the batch on whole frames (the JAX package pins this FFT section to
    batch-only sharding)."""
    dev = _device(device, phase_net)
    f1, f2 = _nchw(frame1, dev), _nchw(frame2, dev)
    filters = _filters(f1, filters)
    if spatial_mesh is None:
        return _nhwc(_phase_predict_rgb(phase_net, rgb_to_lab(f1), rgb_to_lab(f2), filters))
    spatial._check_mesh(spatial_mesh, batch_axis)
    share, group = spatial.batch_share(spatial_mesh, batch_axis, f1.shape[0])
    out = _nhwc(_phase_predict_rgb(phase_net, rgb_to_lab(f1[share]), rgb_to_lab(f2[share]),
                                   filters))
    whole = (f1.shape[0],) + tuple(out.shape[1:])
    return spatial.Sharded(out, share, slice(None), whole, (None, group)).gather()


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


def _pad8(x: torch.Tensor) -> torch.Tensor:
    """Reflect-pad (B, C, H, W) at the bottom and right to the /8 grid
    FusionNet needs."""
    pad_h, pad_w = (-x.shape[-2]) % 8, (-x.shape[-1]) % 8
    return F.pad(x, (0, pad_w, 0, pad_h), mode="reflect") if pad_h or pad_w else x


def _mid_sections(models: FusionModels, f1, f2, ada_pred, filters, compute_dtype=None,
                  bands=None):
    """Sections 2-4 of the fusion pipeline on (B, 3, H, W) tensors: PhaseNet,
    the uncertainty maps (None without maps) and the 3-pass baseline.  They
    are independent per sample, so they run on the whole batch or chunk by
    chunk (fmvfi_tpu/pipeline/interpolate.py:372-429).  With `bands`
    (parallel/spatial.py) the tensors are bands of rows: PhaseNet and the
    maps run on the gathered frames, the baseline on the bands.
    Returns (phase_pred, lab1, lab2, base, (ada_unc, phase_unc) or None)."""
    b = f1.shape[0]
    whole = (lambda t: t) if bands is None else bands.gather
    band = (lambda t: t) if bands is None else bands.take
    # 2. PhaseNet (Lab domain)
    lab1, lab2 = rgb_to_lab(f1), rgb_to_lab(f2)
    phase_whole = _phase_predict_rgb(models.phase_net, whole(lab1), whole(lab2), filters,
                                     compute_dtype)
    # 3. the pyramid uncertainty maps
    unc = None
    if models.fusion_net.uncertainty_maps:
        unc = tuple(map(band, fusion_uncertainty(whole(ada_pred), phase_whole, filters)))
    phase_pred = band(phase_whole)
    # 4. baseline composite; passes 1 and 2 are independent -> one batched call
    lhs = torch.cat([f1, phase_pred], 0)
    rhs = torch.cat([phase_pred, f2], 0)
    with spatial.running(bands):
        mids = models.adacof(lhs, rhs, with_stats=False, compute_dtype=compute_dtype).blended
        base = models.adacof(mids[:b], mids[b:], with_stats=False,
                             compute_dtype=compute_dtype).blended
    return phase_pred, lab1, lab2, base, unc


def _chunked_mid_sections(models: FusionModels, f1, f2, ada_pred, filters, seq_chunk: int,
                          compute_dtype=None):
    """`_mid_sections` over batch chunks of `seq_chunk`, one after another,
    concatenated (the Python loop in place of JAX's lax.map,
    fmvfi_tpu/pipeline/interpolate.py:431-452): a chunk's activations are
    freed before the next chunk runs."""
    outs = [
        _mid_sections(models, f1[s : s + seq_chunk], f2[s : s + seq_chunk],
                      ada_pred[s : s + seq_chunk], filters, compute_dtype)
        for s in range(0, f1.shape[0], seq_chunk)
    ]
    phase_pred, lab1, lab2, base = (torch.cat([o[i] for o in outs], 0) for i in range(4))
    unc = None
    if outs[0][4] is not None:
        unc = tuple(torch.cat([o[4][j] for o in outs], 0) for j in range(2))
    return phase_pred, lab1, lab2, base, unc


class FusionInputs(NamedTuple):
    """FusionNet's inputs, NCHW on the /8 grid, in its argument order."""

    base: torch.Tensor  # (B, 3, H, W) the 3-pass AdaCoF baseline composite
    adacof: torch.Tensor  # (B, 3, H, W) AdaCoF's prediction
    phase: torch.Tensor  # (B, 3, H, W) PhaseNet's prediction
    other: torch.Tensor  # (B, 6, H, W) frame1 || frame2 in Lab
    maps: Optional[torch.Tensor]  # (B, 3, H, W) [ada_unc, phase_unc, flow_var], or None


def fusion_inputs(models: FusionModels, frame1, frame2, dev: torch.device, seq_chunk: int = 0,
                  filters=None, compute_dtype=None):
    """Sections 1-4 of the fusion pipeline on (B, H, W, 3) frames: the AdaCoF
    main pass, PhaseNet, the uncertainty maps and the 3-pass baseline.
    Returns (FusionInputs, (H, W), the size to crop FusionNet's output back
    to).  `fusion_interpolate` runs FusionNet on them; the fusion trainer
    runs this under no_grad and FusionNet with grad.  `filters`: the filter
    bank at the /8-padded size (None: built, cached).  `compute_dtype`:
    the networks' (see the module's docstring)."""
    f1, f2 = _nchw(frame1, dev), _nchw(frame2, dev)
    b, _, full_h, full_w = f1.shape
    chunked = 0 < seq_chunk < b
    if chunked and b % seq_chunk:
        raise ValueError(f"batch {b} not divisible by seq_chunk {seq_chunk}")
    f1, f2 = _pad8(f1), _pad8(f2)
    return (_sections(models, f1, f2, _filters(f1, filters), seq_chunk, compute_dtype),
            (full_h, full_w))


def _sections(models: FusionModels, f1, f2, filters, seq_chunk: int = 0, compute_dtype=None,
              bands=None) -> "FusionInputs":
    """Sections 1-4 on (B, 3, H, W) frames on the /8 grid, or on their bands
    of rows (`bands`, parallel/spatial.py; not with seq_chunk)."""
    n_maps = models.fusion_net.uncertainty_maps

    # 1. AdaCoF
    with spatial.running(bands):
        ada_out = models.adacof(f1, f2, with_stats=n_maps != 0, compute_dtype=compute_dtype)
    ada_pred = ada_out.blended

    # 2-4. PhaseNet, uncertainty maps, baseline composite
    if 0 < seq_chunk < f1.shape[0]:
        mid = _chunked_mid_sections(models, f1, f2, ada_pred, filters, seq_chunk, compute_dtype)
    else:
        mid = _mid_sections(models, f1, f2, ada_pred, filters, compute_dtype, bands)
    phase_pred, lab1, lab2, base, unc = mid

    # maps ordered [ada_unc, phase_unc, flow_var]
    maps = None
    if n_maps:
        maps = torch.stack([unc[0], unc[1], ada_out.uncertainty[:, 0]], dim=1)
    # other = the Lab frames
    other = torch.cat([lab1, lab2], dim=1)
    return FusionInputs(base, ada_pred, phase_pred, other, maps)


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
    batch_axis: str = "data",
    spatial_axis: str = "spatial",
    seq_chunk: int = 0,
    filters=None,
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

    `seq_chunk` (0 = off): with 0 < seq_chunk < B, sections 2-4 run over
    batch chunks of that size, one after another, which bounds their peak
    memory near a chunk's; the AdaCoF main pass and FusionNet stay at the
    full batch.  B must be divisible by it.  `filters`: the pyramid filter
    bank at the /8-padded size (None: built, cached; utils/export.py passes
    the program's own).  `compute_dtype`: None (float32) or torch.bfloat16,
    the networks' compute dtype (see the module's docstring); the output
    is float32 either way.

    `spatial_mesh`: a DeviceMesh with the axes `batch_axis` and
    `spatial_axis` (parallel/mesh.py::make_mesh(n, ("data", "spatial"),
    shape)), one process per device.  Every process passes the whole frames
    and gets the whole result; each computes its share of the batch, the
    nets and the warps on its band of rows (`fusion_sharded`).  Not with
    seq_chunk."""
    res = fusion_sharded(models, frame1, frame2, spatial_mesh, batch_axis, spatial_axis,
                         return_parts, device=device, compute_dtype=compute_dtype,
                         seq_chunk=seq_chunk, filters=filters)
    if return_parts:
        return res[0].gather(), {k: v.gather() for k, v in res[1].items()}
    return res.gather()


def fusion_sharded(models: FusionModels, frame1, frame2, mesh=None, batch_axis: str = "data",
                   spatial_axis: str = "spatial", return_parts: bool = False, *, device="cuda",
                   compute_dtype=None, seq_chunk: int = 0, filters=None):
    """`fusion_interpolate`, this process's block of it: the whole
    (B, H, W, 3) frames in, the fused frames' entries of this process's
    batch share and rows of its band out, as a `spatial.Sharded`
    (`.gather()`: the whole batch); with return_parts, also a dict of the
    parts as `Sharded`s.  Over a (data x spatial) `mesh` the batch is split
    over `batch_axis` and the /8-padded height over `spatial_axis`
    (parallel/spatial.py::data_spatial_sharding); the AdaCoF passes and
    FusionNet run on the bands under `spatial.running`, PhaseNet and the
    uncertainty maps on the gathered frames of the batch share.  With no
    mesh the block is the whole batch (`.gather()` returns it).  Runs
    under its callers' no_grad: a second no_grad nested in an exported
    program leaves a grad-mode node that torch.export cannot load back."""
    _check_compute_dtype(compute_dtype)
    dev = _device(device, *models)
    f1, f2 = _nchw(frame1, dev), _nchw(frame2, dev)
    b, _, full_h, full_w = f1.shape
    share, groups, bands = slice(None), (None, None), None
    if mesh is not None:
        spatial._check_mesh(mesh, batch_axis, spatial_axis)
        if 0 < seq_chunk < b:
            raise ValueError("seq_chunk is incompatible with spatial_mesh")
        share, batch_group = spatial.batch_share(mesh, batch_axis, b)
    elif 0 < seq_chunk < b and b % seq_chunk:
        raise ValueError(f"batch {b} not divisible by seq_chunk {seq_chunk}")
    f1, f2 = _pad8(f1[share]), _pad8(f2[share])
    filters = _filters(f1, filters)
    rows = slice(0, full_h)
    if mesh is not None:
        bands = spatial.bands_of(mesh, spatial_axis, f1.shape[-2], b // f1.shape[0])
        rows = slice(bands.lo, min(bands.hi, full_h))  # the /8 pad is the last band's
        if bands.n > 1:
            f1, f2 = bands.take(f1), bands.take(f2)
        else:
            bands = None
        groups = (None if bands is None else bands.group, batch_group)
    inputs = _sections(models, f1, f2, filters, seq_chunk, compute_dtype, bands)
    # 5. FusionNet blend
    with spatial.running(bands):
        final = models.fusion_net(*inputs, compute_dtype=compute_dtype)

    def out(x):
        x = _nhwc(x[:, :, : rows.stop - rows.start, :full_w])
        return spatial.Sharded(x, share, rows, (b, full_h, full_w, x.shape[-1]), groups)

    if return_parts:
        parts = {"phase": out(inputs.phase), "adacof": out(inputs.adacof),
                 "baseline": out(inputs.base)}
        if inputs.maps is not None:
            parts["maps"] = out(inputs.maps)
        return out(final), parts
    return out(final)


class FusionStreamCarry(NamedTuple):
    """State carried on the device between `fusion_stream_step` calls; every
    tensor NCHW.

    `frame`, `lab` and `dec` describe the newest frame, which is frame 1 of
    the next pair, so each frame is converted to Lab and decomposed once.
    The rest is the pending pair's: its baseline pass 3 and its FusionNet
    blend wait one step, so that pass 3 runs in one batch with the next
    pair's main AdaCoF pass."""

    frame: torch.Tensor  # (B, 3, H, W) RGB
    lab: torch.Tensor  # (B, 3, H, W) Lab
    dec: Decomp  # decomposition of the Lab channel batch (B*3 leading)
    mids: torch.Tensor  # (2B, 3, H, W) baseline passes 1+2 of the pending pair
    ada_pred: torch.Tensor  # (B, 3, H, W)
    phase_pred: torch.Tensor  # (B, 3, H, W)
    other: torch.Tensor  # (B, 6, H, W) lab1 || lab2 of the pending pair
    maps: Optional[torch.Tensor]  # (B, 3, H, W), or None without maps


@torch.no_grad()
def fusion_stream_init(
    frame0, filters=None, uncertainty_maps: int = 3, *, device="cuda"
) -> FusionStreamCarry:
    """A stream's carry, primed with its first frame (B, H, W, 3) on the /8
    grid (fmvfi_tpu/pipeline/interpolate.py:549-571).  The first
    `fusion_stream_step` output finishes this carry's dummy pending pair and
    is to be discarded."""
    f0 = _nchw(frame0, _device(device))
    b, _, h, w = f0.shape
    if h % 8 or w % 8:
        raise ValueError(f"stream frames must be on the /8 grid, got {h}x{w}")
    filters = _filters(f0, filters)
    lab0 = rgb_to_lab(f0)
    z = torch.zeros_like(f0)
    return FusionStreamCarry(
        frame=f0,
        lab=lab0,
        dec=decompose(_chan_batch(lab0), filters),
        mids=torch.cat([z, z], 0),
        ada_pred=z,
        phase_pred=z,
        other=f0.new_zeros((b, 6, h, w)),
        maps=f0.new_zeros((b, 3, h, w)) if uncertainty_maps else None,
    )


def _stream_step(models: FusionModels, carry: FusionStreamCarry, f3: torch.Tensor, filters,
                 compute_dtype=None):
    """`fusion_stream_step` on an NCHW frame on the carry's device; returns
    (carry, the pending pair's fused frame, NCHW)."""
    f2, lab2, dec2 = carry.frame, carry.lab, carry.dec
    b = f2.shape[0]
    if f3.shape != f2.shape:
        raise ValueError(f"frame {tuple(f3.shape)} differs from the stream's {tuple(f2.shape)}")
    n_maps = models.fusion_net.uncertainty_maps
    lab3 = rgb_to_lab(f3)
    dec3 = decompose(_chan_batch(lab3), filters)

    # the main AdaCoF pass of (f2, f3) in one batch with pass 3 of the
    # pending pair, whose flow-stats tail is not needed
    pm1, pm2 = carry.mids[:b], carry.mids[b:]
    out2 = models.adacof(torch.cat([f2, pm1], 0), torch.cat([f3, pm2], 0),
                         with_stats=n_maps != 0, stats_batch=b, compute_dtype=compute_dtype)
    ada_pred, base_prev = out2.blended[:b], out2.blended[b:]

    # PhaseNet on the cached decomposition of f2 and the fresh one of f3
    dec_pred = _phase_net_from_vals(models.phase_net, dec_ops.concat_frames([dec2, dec3]),
                                    compute_dtype)
    phase_pred = _lab_dec_to_rgb(dec_pred, filters, f3.shape)

    maps = None
    if n_maps:
        ada_unc, phase_unc = fusion_uncertainty(ada_pred, phase_pred, filters)
        maps = torch.stack([ada_unc, phase_unc, out2.uncertainty[:, 0]], dim=1)

    # baseline passes 1+2 of the new pair (pass 3 waits for the next step)
    mids = models.adacof(torch.cat([f2, phase_pred], 0), torch.cat([phase_pred, f3], 0),
                         with_stats=False, compute_dtype=compute_dtype).blended

    # finish the pending pair
    fused_prev = models.fusion_net(base_prev, carry.ada_pred, carry.phase_pred, carry.other,
                                   carry.maps, compute_dtype=compute_dtype)
    new_carry = FusionStreamCarry(
        frame=f3,
        lab=lab3,
        dec=dec3,
        mids=mids,
        ada_pred=ada_pred,
        phase_pred=phase_pred,
        other=torch.cat([lab2, lab3], dim=1),
        maps=maps,
    )
    return new_carry, fused_prev


@torch.no_grad()
def fusion_stream_step(
    models: FusionModels, carry: FusionStreamCarry, frame_next, filters=None, *, device="cuda",
    compute_dtype=None,
) -> Tuple[FusionStreamCarry, torch.Tensor]:
    """One step of the streaming fusion: take the next frame (B, H, W, 3),
    return (carry, the fused middle frame of the PREVIOUS pair, (B, H, W, 3)),
    one step late (fmvfi_tpu/pipeline/interpolate.py:574-678).

    The same math as `fusion_interpolate` per pair, with two savings: the
    frame shared by consecutive pairs is converted to Lab and decomposed
    once (the carry holds it), and the pending pair's baseline pass 3 runs
    in one batch with the new pair's main AdaCoF pass, so a step launches
    two 4B-image warps (K1) instead of 2B, 4B and 2B.  `compute_dtype` as
    `fusion_interpolate`'s."""
    _check_compute_dtype(compute_dtype)
    dev = _device(device, *models)
    f3 = _nchw(frame_next, dev)
    carry, fused = _stream_step(models, carry, f3, _filters(f3, filters), compute_dtype)
    return carry, _nhwc(fused)


@torch.no_grad()
def fusion_stream_scan(
    models: FusionModels, carry: FusionStreamCarry, frames, filters=None, *, device="cuda",
    compute_dtype=None,
) -> Tuple[FusionStreamCarry, torch.Tensor]:
    """`fusion_stream_step` over a (T, B, H, W, 3) window of frames, in a
    loop that keeps the carry on the device and waits for the card nowhere.
    Returns (carry, the (T, B, H, W, 3) fused outputs), with the step's
    one-step latency: output t finishes the pair pending before frame t
    (fmvfi_tpu/pipeline/interpolate.py:681-725).  `compute_dtype` as
    `fusion_interpolate`'s."""
    _check_compute_dtype(compute_dtype)
    dev = _device(device, *models)
    fused = []
    for t in range(len(frames)):
        f3 = _nchw(frames[t], dev)
        filters = _filters(f3, filters)
        carry, out = _stream_step(models, carry, f3, filters, compute_dtype)
        fused.append(_nhwc(out))
    return carry, torch.stack(fused, 0)


@torch.no_grad()
def spectral_baseline(frame_lowsrc, frame_highsrc, height: int | None = None, *, device="cuda"):
    """The --output_baseline composite: the low half of the spectrum from one
    prediction (PhaseNet's), the high half from the other (AdaCoF's),
    recombined through the pyramid (fmvfi_tpu/pipeline/interpolate.py:754-
    772).  RGB (B, H, W, 3) in and out."""
    dev = _device(device)
    lo_src, hi_src = _nchw(frame_lowsrc, dev), _nchw(frame_highsrc, dev)
    h, w = lo_src.shape[-2:]
    filters = make_filters(h, w, height or max_pyr_height(h, w), device=dev)
    v_lo = decompose(_chan_batch(rgb_to_lab(lo_src)), filters)
    v_hi = decompose(_chan_batch(rgb_to_lab(hi_src)), filters)
    split = len(v_lo.phase) // 2
    mixed = Decomp(
        high=v_hi.high,
        low=v_lo.low,
        phase=tuple(v_lo.phase[:split]) + tuple(v_hi.phase[split:]),
        amplitude=tuple(v_lo.amplitude[:split]) + tuple(v_hi.amplitude[split:]),
    )
    return _nhwc(_lab_dec_to_rgb(mixed, filters, lo_src.shape))


@torch.no_grad()
def baseline_interpolate(models: FusionModels, frame1, frame2, *, device="cuda"):
    """The reference's --baseline output, the 4th evaluation method: the
    spectral composite of PhaseNet's prediction (low half) and AdaCoF's
    (high half) (fmvfi_tpu/pipeline/interpolate.py:728-751)."""
    ada = adacof_interpolate(models.adacof, frame1, frame2, device=device)
    phase = phase_interpolate(models.phase_net, frame1, frame2, device=device)
    return spectral_baseline(phase, ada, device=device)
