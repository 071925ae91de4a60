"""AdaCoF: kernel-estimation U-Net + deformable warp
(port of fmvfi_tpu/models/adacof.py).

KernelEstimation: a 5-level conv U-Net (6->32->64->128->256->512, average
pool down, bilinear up with align_corners=True + conv, additive skips) and 7
heads at half resolution, upsampled 2x: weight1/2 (F^2 taps, softmax over
the taps), alpha1/2 and beta1/2 (F^2 taps, linear), occlusion (1, sigmoid).
Parameter names follow the flax tree (utils/convert.py maps one onto the
other); the head tail's `conv3_kernel`/`conv3_bias` pair is `final.conv3`.

AdaCoFNet: reflect-pad the frames to /32, subtract the fixed RGB mean,
estimate the fields, replicate-pad the frames by (F-1)*d/2, warp both frames
in one call, occlusion-blend, then the flow mean/variance maps and the
(detached) uncertainty mask, cropped back.  `smoothness_penalties` gives the
g_Spatial / g_Occlusion training terms from the raw heads (on bands, under
`pad32_bands`, their shares, the row differences across the bands' edges
included).

Under active spatial bands (parallel/spatial.py) AdaCoFNet takes a band of
rows of each frame: the last band builds the /32 reflect tail from its own
rows, the U-Net's layers exchange halo rows, and the warp routes as the JAX
model's `spatial_mesh` does (`_sharded_max_offset`): through the
halo-exchange warp where the bands host its halo, else through the warp of
the gathered frame.

Layout: NCHW; fields (B, F^2, H, W).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import adacof_cuda
from ..ops.adacof import flow_stats, pad_replicate
from ..ops.resize import avg_pool2, upsample2x
from ..parallel import spatial
from .conv import Conv2d, TapConv2d, upcast

# fixed RGB mean shift of the reference's module_normalize
_RGB_MEAN = (0.4631, 0.4352, 0.3990)


def module_normalize(x: torch.Tensor) -> torch.Tensor:
    """x minus the fixed RGB mean, channel by channel with Python scalars: a
    mean tensor built per call would be a host-to-device copy, which blocks
    the host until the card has caught up."""
    return torch.cat([x[:, i : i + 1] - m for i, m in enumerate(_RGB_MEAN)], dim=1)


def _conv3(c_in: int, c_out: int) -> nn.Conv2d:
    return Conv2d(c_in, c_out, 3, padding=1)  # 3x3 'SAME', zero padding


class _Basic(nn.Module):
    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.conv0 = _conv3(c_in, c_out)
        self.conv1 = _conv3(c_out, c_out)
        self.conv2 = _conv3(c_out, c_out)

    def forward(self, x):
        for conv in (self.conv0, self.conv1, self.conv2):
            x = F.relu(conv(x))
        return x


class _Upsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = _conv3(c, c)

    def forward(self, x):
        return F.relu(self.conv(upsample2x(x, align_corners=True)))


class _HeadFinal(nn.Module):
    def __init__(self, ks: int):
        super().__init__()
        self.conv2 = _conv3(64, ks)
        self.conv3 = TapConv2d(ks, ks)

    def forward(self, x):
        x = upsample2x(F.relu(self.conv2(x)), align_corners=True)
        return self.conv3(x)


class _Head(nn.Module):
    """A weight / alpha / beta subnet: two 64->64 convs at half resolution,
    then the tail (64->F^2 conv, 2x upsample, F^2->F^2 conv)."""

    def __init__(self, ks: int):
        super().__init__()
        self.conv0 = _conv3(64, 64)
        self.conv1 = _conv3(64, 64)
        self.final = _HeadFinal(ks)

    def forward(self, x):
        x = F.relu(self.conv1(F.relu(self.conv0(x))))
        return self.final(x)


class _Occlusion(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv0 = _conv3(64, 64)
        self.conv1 = _conv3(64, 64)
        self.conv2 = _conv3(64, 64)
        self.conv3 = _conv3(64, 1)

    def forward(self, x):
        for conv in (self.conv0, self.conv1, self.conv2):
            x = F.relu(conv(x))
        # the sigmoid in float32
        return torch.sigmoid(upcast(self.conv3(upsample2x(x, align_corners=True))))


class KernelEstimation(nn.Module):
    def __init__(self, kernel_size: int = 5):
        super().__init__()
        ks = kernel_size**2
        self.conv1 = _Basic(6, 32)
        self.conv2 = _Basic(32, 64)
        self.conv3 = _Basic(64, 128)
        self.conv4 = _Basic(128, 256)
        self.conv5 = _Basic(256, 512)
        self.deconv5 = _Basic(512, 512)
        self.deconv4 = _Basic(512, 256)
        self.deconv3 = _Basic(256, 128)
        self.deconv2 = _Basic(128, 64)
        self.upsample5 = _Upsample(512)
        self.upsample4 = _Upsample(256)
        self.upsample3 = _Upsample(128)
        self.upsample2 = _Upsample(64)
        self.weight1 = _Head(ks)
        self.alpha1 = _Head(ks)
        self.beta1 = _Head(ks)
        self.weight2 = _Head(ks)
        self.alpha2 = _Head(ks)
        self.beta2 = _Head(ks)
        self.occlusion = _Occlusion()

    def forward(self, f0: torch.Tensor, f2: torch.Tensor, compute_dtype=None):
        """Normalized float32 frames -> (w1, a1, b1, w2, a2, b2, occ), float32.
        With `compute_dtype` (bfloat16) the U-Net and the heads run in that
        dtype (the parameters cast per call); the heads' outputs are cast to
        float32 before the softmax and the sigmoid."""
        x = torch.cat([f0, f2], dim=1)
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        c1 = self.conv1(x)
        c2 = self.conv2(avg_pool2(c1))
        c3 = self.conv3(avg_pool2(c2))
        c4 = self.conv4(avg_pool2(c3))
        c5 = self.conv5(avg_pool2(c4))

        d5 = self.deconv5(avg_pool2(c5))
        u5 = self.upsample5(d5) + c5
        d4 = self.deconv4(u5)
        u4 = self.upsample4(d4) + c4
        d3 = self.deconv3(u4)
        u3 = self.upsample3(d3) + c3
        d2 = self.deconv2(u3)
        u2 = self.upsample2(d2) + c2

        w1 = torch.softmax(upcast(self.weight1(u2)), dim=1)
        w2 = torch.softmax(upcast(self.weight2(u2)), dim=1)
        return (
            w1, upcast(self.alpha1(u2)), upcast(self.beta1(u2)),
            w2, upcast(self.alpha2(u2)), upcast(self.beta2(u2)),
            self.occlusion(u2),
        )


class AdaCoFOutputs(NamedTuple):
    warped0: torch.Tensor  # frame0 warped toward the middle (B, 3, H, W)
    warped2: torch.Tensor  # frame2 warped toward the middle
    blended: torch.Tensor  # occlusion-blended prediction
    uncertainty: torch.Tensor  # flow-variance mask (B, 1, H, W), in [0, 1]
    occlusion: torch.Tensor  # (B, 1, H, W)
    mean_flow: Tuple[torch.Tensor, torch.Tensor]  # per frame (B, 2, H, W)
    var_flow: Tuple[torch.Tensor, torch.Tensor]
    # raw estimator outputs at the padded size, for the smoothness losses:
    # (w1, a1, b1, w2, a2, b2), each (B, F^2, Hp, Wp), and occlusion (B, 1, Hp, Wp)
    heads: Tuple[torch.Tensor, ...]
    occ_raw: torch.Tensor


def pad32_bands(bands):
    """Spatial bands of a frame with the /32 reflect tail AdaCoFNet adds on
    the last band (the rows of its heads); None for None."""
    return None if bands is None else bands.padded((32 - bands.height % 32) % 32)


def warp_max_offset(kernel_size: int, dilation: int, max_offset: int | None = 48):
    """The offset clamp the warp runs with: max_offset reduced to what the
    JAX package's TPU kernel can host, min(max_offset, (126-(F-1)d)//2), and
    unclamped (None) when that leaves less than 24 px or max_offset is None."""
    if max_offset is None:
        return None
    fit = (126 - (kernel_size - 1) * dilation) // 2
    return min(max_offset, fit) if fit >= 24 else None


class AdaCoFNet(nn.Module):
    """The full AdaCoF model: pads, estimates fields, warps, blends.

    `max_offset` clamps the warp's offsets (default 48 px, the contract the
    bundled weights were trained with); None runs the unclamped warp.  The
    warp goes through K1 on CUDA tensors and through its plain version on
    CPU tensors (ops/adacof_cuda.py).  A call's `compute_dtype` (bfloat16)
    runs the field estimation in that dtype; the frames, the fields and
    the warp stay float32."""

    def __init__(self, kernel_size: int = 5, dilation: int = 1, max_offset: int | None = 48):
        super().__init__()
        self.kernel_size = kernel_size
        self.dilation = dilation
        self.max_offset = warp_max_offset(kernel_size, dilation, max_offset)
        self.get_kernel = KernelEstimation(kernel_size)
        # the warp function; a check may swap in the plain version on CUDA
        self.warp = adacof_cuda.adacof_warp

    def _sharded_max_offset(self, h: int, b2: int, n_sp: int, n_b: int) -> int:
        """The offset clamp of the halo-exchange warp for a frame height h
        (padded to /32) over n_sp spatial bands and a warp batch b2 over n_b
        batch shares, or 0 where the halo path cannot reproduce the
        single-device clamped warp (port of the JAX model's
        `_sharded_max_offset`): 0 sends the warp to the UNCLAMPED warp of
        the gathered frame, JAX's exact gather warp, never a tightened
        clamp."""
        if h % n_sp or b2 % n_b:
            return 0
        kp = ((self.kernel_size - 1) * self.dilation) // 2
        r = self.max_offset  # min(max_offset, fit), None where fit < 24
        if r is None or h // n_sp - kp - 1 < r:
            return 0
        return r

    def _banded_warp(self, bands, xs, w, a, b):
        """The warp of the frames' bands (unpadded) under `bands`: the
        halo-exchange warp with the clamp `_sharded_max_offset` gives, where
        every band hosts its halo; else the warp of the gathered frame,
        clamped the same (bands of unequal rows can be shorter than JAX's
        equal shards) or, for 0, unclamped."""
        kp = ((self.kernel_size - 1) * self.dilation) // 2
        r = self._sharded_max_offset(bands.height, xs.shape[0] * bands.n_data, bands.n,
                                     bands.n_data)
        if r and min(bands.rows) >= r + kp + 1:
            return spatial.adacof_warp_tm_sharded(xs, w, a, b, self.dilation, max_offset=r,
                                                  warp=self.warp)
        return spatial.adacof_warp_gathered(xs, w, a, b, self.dilation, r or None, self.warp)

    def forward(
        self,
        frame0: torch.Tensor,
        frame2: torch.Tensor,
        with_stats: bool = True,
        stats_batch: int | None = None,
        compute_dtype=None,
    ):
        """frame0, frame2: (B, 3, H, W).  `with_stats=False` skips the flow
        mean/variance tail (zeros are returned in its place).
        `stats_batch=N` computes that tail for the first N batch entries only,
        so `uncertainty`, `mean_flow` and `var_flow` have N entries (the
        stream path batches a stats-free pass behind the main pair;
        fmvfi_tpu/models/adacof.py:344,441-450); None: the whole batch."""
        if frame0.shape != frame2.shape:
            raise ValueError(f"frame sizes do not match: {frame0.shape} vs {frame2.shape}")
        b, _, h0, w0 = frame0.shape
        bands = spatial.active()
        pad_h = (32 - (h0 if bands is None else bands.height) % 32) % 32
        pad_w = (32 - w0 % 32) % 32
        if bands is not None:  # the /32 tail of the frame is the last band's
            bands = pad32_bands(bands)
            pad_h = pad_h if bands.last else 0
            if any(r % 32 for r in bands.rows):
                raise ValueError(f"AdaCoF takes bands of a multiple of 32 rows after the /32 "
                                 f"pad, got {bands.rows}")
        if pad_h or pad_w:
            frame0 = F.pad(frame0, (0, pad_w, 0, pad_h), mode="reflect")
            frame2 = F.pad(frame2, (0, pad_w, 0, pad_h), mode="reflect")

        with spatial.running(bands):
            w1, a1, b1, w2, a2, b2, occ = self.get_kernel(
                module_normalize(frame0), module_normalize(frame2), compute_dtype
            )

        kp = ((self.kernel_size - 1) * self.dilation) // 2
        # one warp call for both frames: frames and fields stacked on the batch
        fields = (torch.cat([w1, w2], 0), torch.cat([a1, a2], 0), torch.cat([b1, b2], 0))
        if bands is None:
            xs = torch.cat([pad_replicate(frame0, kp), pad_replicate(frame2, kp)], 0)
            wboth = self.warp(xs, *fields, self.dilation, self.max_offset)
        else:
            with spatial.running(bands):
                wboth = self._banded_warp(bands, torch.cat([frame0, frame2], 0), *fields)
        warped0, warped2 = wboth[:b], wboth[b:]
        blended = occ * warped0 + (1.0 - occ) * warped2

        if with_stats:
            n = stats_batch
            mean1, var1 = flow_stats(w1[:n], a1[:n], b1[:n])
            mean2, var2 = flow_stats(w2[:n], a2[:n], b2[:n])
            # max of the summed variance components, clipped to [0, 20], to
            # [0, 1]; detached, as the JAX model's stop_gradient
            unc = torch.maximum(var1.sum(1, keepdim=True), var2.sum(1, keepdim=True))
            unc = (torch.clamp(unc, 0.0, 20.0) / 20.0).detach()
        else:
            mean1 = mean2 = var1 = var2 = frame0.new_zeros((b, 2) + frame0.shape[2:])
            unc = frame0.new_zeros((b, 1) + frame0.shape[2:])

        def crop(x):
            return x[:, :, :h0, :w0]

        return AdaCoFOutputs(
            warped0=crop(warped0),
            warped2=crop(warped2),
            blended=crop(blended),
            uncertainty=crop(unc),
            occlusion=crop(occ),
            mean_flow=(crop(mean1), crop(mean2)),
            var_flow=(crop(var1), crop(var2)),
            heads=(w1, a1, b1, w2, a2, b2),
            occ_raw=occ,
        )


def smoothness_penalties(w1, a1, b1, w2, a2, b2, occ, eps: float = 1e-3):
    """Training regularizers (g_Spatial, g_Occlusion): Charbonnier of the
    finite differences of the tap-mean weighted offset fields and of the
    occlusion map.  Fields (B, F^2, H, W), occ (B, 1, H, W).  Under active
    spatial bands (`pad32_bands` of the frame's: the heads' rows) the
    fields are a band of rows: each band's row differences take the first
    row of the band below through the halo exchange, and the terms are the
    band's shares, means over the whole frame's counts (H (W-1) and
    (H-1) W a sample)."""
    bands = spatial.active()
    height = None if bands is None else bands.height

    def charb(d, rows=None):
        return spatial.band_mean(torch.sqrt(d**2 + eps**2), rows)

    def row_diff(m):
        if bands is not None:
            m = spatial.extend_rows(m, 0, 1, None)[0]
        return m[:, :-1, :] - m[:, 1:, :]

    def grad_penalty(m):  # m: (B, H, W)
        return (charb(m[:, :, :-1] - m[:, :, 1:], height)
                + charb(row_diff(m), None if bands is None else height - 1))

    # mean (not sum) over the taps, as the reference's adacofnet.py:203-206
    g_spatial = (
        grad_penalty(torch.mean(w1 * a1, dim=1))
        + grad_penalty(torch.mean(w1 * b1, dim=1))
        + grad_penalty(torch.mean(w2 * a2, dim=1))
        + grad_penalty(torch.mean(w2 * b2, dim=1))
    )
    o = occ[:, 0]
    return g_spatial, grad_penalty(o)
