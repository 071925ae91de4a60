"""The AdaCoF warp on the card: K1, the forward (csrc/adacof_warp.cu,
replacing the Pallas kernel fmvfi_tpu/ops/adacof_pallas.py::_kernel), K2,
the field gradients (csrc/adacof_warp_bwd.cu, replacing ::_bwd_kernel), and
K3, the gradient contract around them (`AdaCoFWarp`, replacing
adacof_warp_fast[_tm] with its custom VJP, adacof_pallas.py:537-673).

`adacof_warp` takes the same arguments as the plain `ops.adacof.adacof_warp`
with offsets clamped to +-max_offset (None: unclamped), and is
differentiable in the fields.  The gradient contract, on every device:
  * dx is zero (None when x needs no gradient): the reference's CUDA module
    never computed it, and every trainer warps data frames;
  * dW, dalpha, dbeta are the true gradients of the clamped forward: dalpha
    and dbeta are zero where |offset| >= max_offset.
CUDA tensors go to K1 / K2 or raise; CPU tensors go to the plain versions
(`adacof_warp`, `adacof_warp_field_grads` of ops/adacof.py).

Each kernel's C entry point picks one of 6 instantiations (csrc/adacof_ring.cuh)
and reports it; `paths` / `bwd_paths` count them.  Where the instantiation
gathers from an RGBX copy of x (3 channels, F 5 or 11), K1 writes the copy
into a scratch tensor and returns it, and K2 takes it: K3 keeps it from the
forward for the backward.

PyTorch reaches both kernels through two registered operators, so that
`torch.export` records the warp as one node and a loaded program launches
K1 as the live pipeline does:
  * `fmvfi::adacof_warp_fwd(x, weight, offset_i, offset_j, dilation,
    max_offset) -> (out, x4)`: K1 on CUDA tensors, the plain warp on CPU
    tensors.  x4 is the RGBX scratch (`rgbx_scratch`), (B, H_in, W_in, 4)
    on a CUDA x where the instantiation gathers from one, and (0,) elsewhere
    (the CPU's plain warp has no use for it): K1 writes it and K2 reads it.
  * `fmvfi::adacof_warp_bwd(x, x4, weight, offset_i, offset_j, g, dilation,
    max_offset) -> (dW, dalpha, dbeta)`: K2 on CUDA tensors, the plain
    field gradients on CPU tensors.
Each has a fake implementation for tracing.  The counters move where the
CUDA implementations launch, whatever called the operator: K3, or a loaded
exported program.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch
from torch.autograd.function import once_differentiable

from .. import _build
from .adacof import adacof_warp as adacof_warp_plain
from .adacof import adacof_warp_field_grads, check_warp_shapes

NAME = "adacof_warp_fwd"
SOURCE = "fmvfi_tpu_torch/csrc/adacof_warp.cu"
REPLACES = "fmvfi_tpu/ops/adacof_pallas.py:54"
NAME_BWD = "adacof_warp_bwd"
SOURCE_BWD = "fmvfi_tpu_torch/csrc/adacof_warp_bwd.cu"
REPLACES_BWD = "fmvfi_tpu/ops/adacof_pallas.py:267"

launches = 0  # K1 launches since the last reset (set to 0 to reset)
bwd_launches = 0  # K2 launches since the last reset
# launches by instantiation (csrc/adacof_ring.cuh::path_code), since the last
# clear(): "f5c3" or "f11c3" (F and C fixed at compile time, RGBX gathers)
# or "any" (F and C at run time, planar x), then "/ring" (fields through the
# asynchronous-copy ring) or "/regs" (unaligned fields, loaded by the
# consumer threads themselves)
paths = Counter()  # K1
bwd_paths = Counter()  # K2
PATH_NAMES = tuple(
    f"{inst}/{route}" for inst in ("any", "f5c3", "f11c3") for route in ("regs", "ring")
)
RGBX_F = (5, 11)  # with 3 channels, the F whose instantiations gather from RGBX


def _check_device(kernel: str, tensors) -> None:
    """Raise ValueError unless the tensors lie on the CPU or on one CUDA
    device: nothing else has an implementation of the warp."""
    devices = {t.device for t in tensors}
    if len(devices) != 1 or next(iter(devices)).type not in ("cpu", "cuda"):
        raise ValueError(
            f"{kernel} takes tensors on the CPU or on one CUDA device, got "
            f"{[str(t.device) for t in tensors]}"
        )


def _check_cuda(kernel: str, tensors, dilation, max_offset):
    """Validate a kernel's inputs (x and the three fields first); return
    (F, H, W, R) with R = -1 for no clamp."""
    x = tensors[0]
    if any(t.device != x.device for t in tensors) or x.device.type != "cuda":
        raise ValueError(
            f"{kernel} takes tensors on one CUDA device, got {[str(t.device) for t in tensors]}"
        )
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{kernel} takes float32, got {[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{kernel} takes contiguous tensors")
    k, h, w = check_warp_shapes(*tensors[:4], dilation)
    check_int32(x.shape, tensors[1].shape)
    r = -1 if max_offset is None else int(max_offset)
    if max_offset is not None and (r != max_offset or r < 0):
        raise ValueError(f"max_offset must be a non-negative integer or None, got {max_offset}")
    return k, h, w, r


def check_int32(x_shape, field_shape) -> None:
    """The kernels index within an image with 32-bit offsets: raise
    ValueError unless every per-image tensor (x, the fields, the output and
    the cotangent) has fewer than 2^31 elements and H_in, W_in < 2^30."""
    _, c, h_in, w_in = x_shape
    _, f2, h, w = field_shape
    if max(c * h_in * w_in, f2 * h * w, c * h * w) >= 2**31 or max(h_in, w_in) >= 2**30:
        raise ValueError(
            f"x {tuple(x_shape)}, fields {tuple(field_shape)}: the kernels take per-image "
            f"tensors of fewer than 2^31 elements and H_in, W_in < 2^30 (32-bit offsets)"
        )


def rgbx_scratch(x: torch.Tensor, taps: int) -> torch.Tensor | None:
    """Scratch for the kernels' RGBX copy of x, (B, H_in, W_in, 4), where
    the instantiation for x's channels and F = `taps` gathers from one (3
    channels, F in RGBX_F); else None (the kernels then gather planar x)."""
    b, c, h_in, w_in = x.shape
    if c != 3 or taps not in RGBX_F:
        return None
    return torch.empty((b, h_in, w_in, 4), dtype=torch.float32, device=x.device)


def _launched(err: int, code: ctypes.c_int, kernel: str, counter: Counter) -> bool:
    """Raise if the launch failed; count the instantiation the C entry point
    reported in `code` and return True, or return False if it launched
    nothing (an empty tensor)."""
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")
    if code.value < 0:
        return False
    counter[PATH_NAMES[code.value]] += 1
    return True


def warp_fwd_cuda(x, weight, offset_i, offset_j, dilation, max_offset):
    """K1: the clamped warp of CUDA tensors.  Returns the warp (B, C, H, W)
    and the RGBX copy of x that K1 wrote (None where its instantiation
    gathers planar x), which warp_bwd_cuda takes for the same x and F."""
    global launches
    tensors = (x, weight, offset_i, offset_j)
    k, h, w, r = _check_cuda("K1", tensors, dilation, max_offset)
    b, c, h_in, w_in = x.shape
    lib = _build.library()
    out = torch.empty((b, c, h, w), dtype=torch.float32, device=x.device)
    x4 = rgbx_scratch(x, k)
    code = ctypes.c_int(-1)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.adacof_warp_fwd(
            x.data_ptr(), None if x4 is None else x4.data_ptr(),
            weight.data_ptr(), offset_i.data_ptr(),
            offset_j.data_ptr(), out.data_ptr(), stream, ctypes.byref(code),
            k, dilation, r, b, c, h, w, h_in, w_in,
        )
    if _launched(err, code, NAME, paths):
        launches += 1
    return out, x4


def warp_bwd_cuda(x, weight, offset_i, offset_j, g, dilation, max_offset, x4):
    """K2: the field gradients (dW, dalpha, dbeta) of the clamped warp of
    CUDA tensors for the output cotangent g (B, C, H, W), saturation mask
    applied; each (B, F*F, H, W).  `x4`: what warp_fwd_cuda returned beside
    the warp of this x with these fields' F (the RGBX copy of x, or None)."""
    global bwd_launches
    tensors = (x, weight, offset_i, offset_j, g)
    k, h, w, r = _check_cuda("K2", tensors, dilation, max_offset)
    b, c, h_in, w_in = x.shape
    if tuple(g.shape) != (b, c, h, w):
        raise ValueError(f"cotangent {tuple(g.shape)} is not the output shape {(b, c, h, w)}")
    want = None if c != 3 or k not in RGBX_F else ((b, h_in, w_in, 4), x.device)
    if want != (None if x4 is None else (tuple(x4.shape), x4.device)):
        raise ValueError("x4 must be the RGBX copy of x that warp_fwd_cuda returned for it")
    lib = _build.library()
    dw, da, db = (torch.empty_like(weight) for _ in range(3))
    code = ctypes.c_int(-1)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.adacof_warp_bwd(
            x.data_ptr(), None if x4 is None else x4.data_ptr(),
            weight.data_ptr(), offset_i.data_ptr(),
            offset_j.data_ptr(), g.data_ptr(), dw.data_ptr(), da.data_ptr(),
            db.data_ptr(), stream, ctypes.byref(code), k, dilation, r, b, c, h, w, h_in, w_in,
        )
    if _launched(err, code, NAME_BWD, bwd_paths):
        bwd_launches += 1
    return dw, da, db


def _no_scratch(x: torch.Tensor) -> torch.Tensor:
    return x.new_empty((0,))


def _warp_fwd_plain(x, weight, offset_i, offset_j, dilation, max_offset):
    check_warp_shapes(x, weight, offset_i, offset_j, dilation)
    out = adacof_warp_plain(x, weight, offset_i, offset_j, dilation, max_offset)
    return out, _no_scratch(x)


def _warp_fwd_k1(x, weight, offset_i, offset_j, dilation, max_offset):
    out, x4 = warp_fwd_cuda(x, weight, offset_i, offset_j, dilation, max_offset)
    return out, _no_scratch(x) if x4 is None else x4


def _warp_fwd_fake(x, weight, offset_i, offset_j, dilation, max_offset):
    k, h, w = check_warp_shapes(x, weight, offset_i, offset_j, dilation)
    x4 = rgbx_scratch(x, k) if x.device.type == "cuda" else None  # as the real kernels
    return x.new_empty((x.shape[0], x.shape[1], h, w)), _no_scratch(x) if x4 is None else x4


def _warp_bwd_plain(x, x4, weight, offset_i, offset_j, g, dilation, max_offset):
    return adacof_warp_field_grads(x, weight, offset_i, offset_j, g, dilation, max_offset)


def _warp_bwd_k2(x, x4, weight, offset_i, offset_j, g, dilation, max_offset):
    return warp_bwd_cuda(x, weight, offset_i, offset_j, g, dilation, max_offset,
                         None if x4.numel() == 0 else x4)


def _warp_bwd_fake(x, x4, weight, offset_i, offset_j, g, dilation, max_offset):
    return tuple(torch.empty_like(weight) for _ in range(3))


# The operators, defined through torch.library's low-level API: a kernel
# registered with torch.library.custom_op runs under torch._disable_dynamo,
# whose first call imports torch._dynamo, seconds of a process's cold start.
# Module-level: the registrations live as long as this object.
_LIB = torch.library.Library("fmvfi", "DEF")
_LIB.define("adacof_warp_fwd(Tensor x, Tensor weight, Tensor offset_i, Tensor offset_j, "
            "int dilation, int? max_offset) -> (Tensor, Tensor)")
_LIB.define("adacof_warp_bwd(Tensor x, Tensor x4, Tensor weight, Tensor offset_i, "
            "Tensor offset_j, Tensor g, int dilation, int? max_offset) -> (Tensor, Tensor, Tensor)")
for _name, _cpu, _cuda, _fake in (
    ("adacof_warp_fwd", _warp_fwd_plain, _warp_fwd_k1, _warp_fwd_fake),
    ("adacof_warp_bwd", _warp_bwd_plain, _warp_bwd_k2, _warp_bwd_fake),
):
    _LIB.impl(_name, _cpu, "CPU")
    _LIB.impl(_name, _cuda, "CUDA")
    torch.library.register_fake(f"fmvfi::{_name}", _fake, lib=_LIB)

# (out, x4): the clamped warp and the RGBX scratch (module docstring); on
# CPU tensors the plain warp
warp_fwd_op = torch.ops.fmvfi.adacof_warp_fwd
# (dW, dalpha, dbeta) for the cotangent g, with x4 what warp_fwd_op returned
# for this x and F; on CPU tensors the plain ones (x4 unread)
warp_bwd_op = torch.ops.fmvfi.adacof_warp_bwd


class AdaCoFWarp(torch.autograd.Function):
    """K3: the clamped warp with the gradient contract of the module
    docstring, through the two operators: K1 / K2 on CUDA tensors, the
    plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, x, weight, offset_i, offset_j, dilation, max_offset):
        _check_device("the AdaCoF warp", (x, weight, offset_i, offset_j))
        # x4: K1's RGBX copy of x, for K2
        out, ctx.x4 = warp_fwd_op(x, weight, offset_i, offset_j, dilation, max_offset)
        # the raw (unclamped) offsets: the saturation mask reads them
        ctx.save_for_backward(x, weight, offset_i, offset_j)
        ctx.dilation, ctx.max_offset = dilation, max_offset
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, weight, offset_i, offset_j = ctx.saved_tensors
        # g reaches the warp through slices and a crop: often not contiguous
        g = g.contiguous()
        x4, ctx.x4 = ctx.x4, None  # a graph may outlive its backward; the copy need not
        dw, da, db = warp_bwd_op(x, x4, weight, offset_i, offset_j, g, ctx.dilation,
                                 ctx.max_offset)
        dx = torch.zeros_like(x) if ctx.needs_input_grad[0] else None
        return dx, dw, da, db, None, None


def adacof_warp(
    x: torch.Tensor,
    weight: torch.Tensor,
    offset_i: torch.Tensor,
    offset_j: torch.Tensor,
    dilation: int = 1,
    max_offset: int | None = 48,
) -> torch.Tensor:
    """AdaCoF warp, offsets clamped to +-max_offset, differentiable in the
    fields.  x (B, C, H_in, W_in) pre-padded by (F-1)*dilation; fields
    (B, F*F, H, W); returns (B, C, H, W)."""
    return AdaCoFWarp.apply(x, weight, offset_i, offset_j, dilation, max_offset)
