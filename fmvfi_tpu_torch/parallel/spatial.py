"""Spatial (height) sharding for serving and training (port of
fmvfi_tpu/parallel/spatial.py).

The JAX package shards the image HEIGHT over a mesh axis and lets XLA's SPMD
partitioner insert the halo exchanges of the convolutions and gather the
rows before the FFT sections.  The port runs one process per device: each
process of a ("data", "spatial") mesh holds a band of rows of each frame,
for its share of the batch, and the exchanges are written by hand.

- `Bands` is the split of one frame height over the processes of the
  spatial axis, and this process's band in it: rows in units of
  BAND_UNIT = 32 (AdaCoF's total stride; FusionNet's, 8, divides it), the
  bands differing by one unit at most and the last one also holding the
  remainder, so that every band halves evenly down each net's levels.
- Inside `running(bands)` the halo-aware layers (models/conv.py's
  convolutions, FusionNet's reflect-padded ones, ops/resize.py's pools and
  2x upsamples) take a band and give exactly the rows that the layer gives
  on the whole frame, taking halo rows from the neighbouring bands, and
  AdaCoFNet warps through `adacof_warp_tm_sharded` (K1 on each band on
  the card).
- Sections that need whole frames (the pyramid's FFTs, PhaseNet, the
  uncertainty maps) gather the rows (`Bands.gather`), run on the process's
  batch share, the same on every process of the spatial axis, as the JAX
  package pins them to batch-only sharding, and take the band back
  (`Bands.take`).

Only all_reduce is used (dp.py's rule: gloo has no other collective on CUDA
tensors): a halo exchange writes each band's boundary rows into its slot of
a zero buffer, all-reduces it and reads the neighbours' slots; a gather
all-reduces a zero-filled whole frame that holds each band's rows.  A sum
with zeros is exact, on gloo and on NCCL.

Training (the spatial trainers, `adacof_spatial_trainer` and
`fusion_spatial_trainer`): the exchanges carry their backward.
`extend_rows` on a band that requires grad sends each halo row's cotangent
back to the band that owns the row, and a reflected edge row's to the row
it mirrors; `Bands.gather`'s backward all-reduces the whole frame's
cotangent and takes the band's rows; `spatial_sum` sums the cotangents.
Each is one all_reduce that every process of the group calls, also where
its own halo is empty, and each carries the number of its exchange beside
the cotangents, so that a backward pass that reaches the exchanges in
another order on another process raises instead of summing the wrong
buffers.  The loss convention is the SHARE: each process's objective is
its share of the global one, its band's sums over the global counts
(`band_mean`), and a value that every process of the spatial group
computes alike (a term of the gathered frames, or of `spatial_sum`s)
enters divided by the group's size (parallel/dp.py's `spatial_share`).
The shares of the spatial group sum to the batch share's objective, so the
parameter gradients are summed over the spatial axis and averaged over the
data axis (dp.py's `running(mesh, spatial_axis=)`), and so are the metrics.
The sharded warp's field gradients (K2 on each band) cross no band.
"""

from __future__ import annotations

import itertools
import math
from collections import Counter
from contextlib import contextmanager
from typing import Callable, NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops import adacof_cuda

BAND_UNIT = 32

# bytes of the buffers all-reduced on this process since the last clear(),
# by kind: halo exchanges ("halo"), gathers ("gather") and spatial sums
# ("sum"), and their backward ("halo_bwd", "gather_bwd", "sum_bwd")
exchanged = Counter()

# the number of each exchange made with gradient on this process, which its
# backward sends beside the cotangents (modulo 2**20: exact in float32)
_exchanges = itertools.count(1)
_STAMP_MOD = 1 << 20


def spatial_image_sharding(mesh, height: int, axis: str = "data"):
    """This process's block of NHWC frames `height` rows high with H split
    over the mesh axis `axis` and replicated over the others, as the index
    (every entry, its rows): the rows of `split_rows`, in units of
    BAND_UNIT rows, as `spatial_apply` places them."""
    bands = bands_of(mesh, axis, height)
    return slice(None), slice(bands.lo, bands.hi)


def data_spatial_sharding(mesh, batch: int, height: int, batch_axis: str = "data",
                          spatial_axis: str = "spatial"):
    """This process's block of an NHWC batch of `batch` frames `height` rows
    high with the batch split over `batch_axis` AND H over `spatial_axis`,
    as the index (its entries, its rows).  fusion_interpolate places the
    rows of the /8-padded height so, and the last band drops the pad."""
    share, _ = batch_share(mesh, batch_axis, batch)
    bands = bands_of(mesh, spatial_axis, height)
    return share, slice(bands.lo, bands.hi)


def _check_mesh(mesh, *axes) -> None:
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh) or not set(axes) <= set(mesh.mesh_dim_names or ()):
        raise ValueError(f"spatial_mesh must be a DeviceMesh with the axes {axes}, got {mesh!r}")


def split_rows(height: int, n: int, unit: int = BAND_UNIT) -> tuple:
    """The rows of each of n bands of a frame `height` rows high: whole units
    of `unit` rows, one unit more in the first bands where they do not
    divide, and the remainder in the last band."""
    units, rem = divmod(height, unit)
    if units < n:
        raise ValueError(f"a height of {height} rows cannot be split over {n} spatial bands: "
                         f"each band needs at least {unit} rows, the height at least {unit * n}")
    per, extra = divmod(units, n)
    rows = [(per + (i < extra)) * unit for i in range(n)]
    rows[-1] += rem
    return tuple(rows)


class Bands(NamedTuple):
    """A frame's rows split over the processes of a spatial group, and this
    process's band: `rows` are every band's rows at the frame's resolution,
    top to bottom, `index` is this process's.  A tensor at a coarser level
    of a net holds its band at that level (rows[index] // s rows for a
    level s times coarser)."""

    group: object  # the process group of the spatial axis
    index: int
    rows: tuple
    n_data: int = 1  # processes that split the batch (AdaCoFNet's warp routing)

    @property
    def n(self) -> int:
        return len(self.rows)

    @property
    def height(self) -> int:
        return sum(self.rows)

    @property
    def lo(self) -> int:
        return sum(self.rows[: self.index])

    @property
    def hi(self) -> int:
        return self.lo + self.rows[self.index]

    @property
    def last(self) -> bool:
        return self.index == self.n - 1

    def scale(self, h: int) -> int:
        """How many times coarser than the frame a band tensor of h rows is."""
        own = self.rows[self.index]
        s = own // h if h and own % h == 0 else 0
        if not s or any(r % s for r in self.rows):
            raise ValueError(f"a band of {h} rows is no level of the bands {self.rows}: "
                             f"every band must halve evenly down the net")
        return s

    def at(self, h: int):
        """(first row, height) of the band and the frame at the level where
        the band has h rows."""
        s = self.scale(h)
        return self.lo // s, self.height // s

    def padded(self, extra: int) -> "Bands":
        """These bands with `extra` rows added at the bottom of the last one
        (a reflect tail built from its own rows; negative: that many rows
        cropped from it)."""
        if extra and self.rows[-1] <= extra:
            raise ValueError(f"the last band of {self.rows[-1]} rows is too short for a "
                             f"reflect pad of {extra} rows: it needs more than {extra}")
        return self._replace(rows=self.rows[:-1] + (self.rows[-1] + extra,))

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """This band's rows of a whole-frame tensor (rows on dim -2)."""
        return x[..., self.lo : self.hi, :]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole frame of a band tensor at the frame's resolution, on
        every process of the group; with gradient, its backward is this
        band's rows of the cotangents summed over the group."""
        if x.shape[-2] != self.rows[self.index]:
            raise ValueError(f"gather takes the band's {self.rows[self.index]} rows, got "
                             f"{x.shape[-2]}")
        if self.n == 1:
            return x
        if torch.is_grad_enabled() and x.requires_grad:
            return _Gather.apply(x, self)
        return _gathered(self, x)

    def halo(self, x: torch.Tensor, up: int, down: int):
        """(above, below): the last `up` rows of the band above x's and the
        first `down` rows of the band below, at x's level; None at the
        frame's top and bottom.  Without gradient: `extend_rows` carries
        the exchange's backward."""
        if torch.is_grad_enabled() and x.requires_grad:
            raise ValueError("Bands.halo takes no gradient: exchange the rows of a tensor that "
                             "requires grad through spatial.extend_rows")
        s = self.scale(x.shape[-2])
        if min(self.rows) // s < max(up, down):
            raise ValueError(f"bands of {[r // s for r in self.rows]} rows at this level are "
                             f"shorter than the halo of {max(up, down)} rows")
        if self.n == 1:
            return None, None
        h = x.shape[-2]
        buf = x.new_zeros((self.n,) + x.shape[:-2] + (down + up, x.shape[-1]))
        buf[self.index, ..., :down, :] = x[..., :down, :]
        buf[self.index, ..., down:, :] = x[..., h - up :, :]
        _all_reduce(buf, self.group, "halo")
        above = buf[self.index - 1, ..., down:, :] if self.index > 0 else None
        below = buf[self.index + 1, ..., :down, :] if not self.last else None
        return above, below


def _all_reduce(buf: torch.Tensor, group, kind: str) -> None:
    exchanged[kind] += buf.numel() * buf.element_size()
    dist.all_reduce(buf, group=group)


def _gathered(bands: Bands, x: torch.Tensor) -> torch.Tensor:
    """Bands.gather's all_reduce of a zero whole frame holding x's rows."""
    buf = x.new_zeros(x.shape[:-2] + (bands.height, x.shape[-1]))
    buf[..., bands.lo : bands.hi, :] = x
    _all_reduce(buf, bands.group, "gather")
    return buf


def _summed(bands: Bands, x: torch.Tensor) -> torch.Tensor:
    """spatial_sum's all_reduce of a copy of x."""
    y = x.clone()
    _all_reduce(y, bands.group, "sum")
    return y


def _stamped(like: torch.Tensor, shape, bands: Bands, stamp: int):
    """(a flat zero buffer of like's dtype and device, its view of `shape`):
    the bands.n entries after the view hold each process's `stamp`, this
    process's set."""
    size = math.prod(shape)
    flat = like.new_zeros(size + bands.n)
    flat[size + bands.index] = stamp
    return flat, flat[:size].view(tuple(shape))


def _reduce_stamped(flat: torch.Tensor, bands: Bands, kind: str, stamp: int) -> None:
    """All-reduce a `_stamped` buffer over the group; raises where another
    process's backward undid another exchange at this collective."""
    _all_reduce(flat, bands.group, kind)
    seen = flat[flat.numel() - bands.n :].tolist()
    if any(s != stamp for s in seen):
        raise RuntimeError(
            f"spatial {kind}: the processes of the spatial group undid the exchanges {seen} "
            f"in one collective (this one {stamp}): their backward passes reach the exchanges "
            "in different orders (their autograd graphs differ)")


class _HaloRows(torch.autograd.Function):
    """`extend_rows` with gradient.  Forward: the exchange.  Backward: the
    cotangents of the rows taken from the band above go back to its last
    `up` rows, those from the band below to its first `down` rows, in one
    stamped all_reduce that every process of the group calls, and a
    reflected edge row's cotangent to the row it mirrors.  One node per
    exchange on every process, whatever its band's place, so the processes'
    backward graphs have the same shape."""

    @staticmethod
    def forward(ctx, x, bands, up, down, edge):
        ctx.bands, ctx.up, ctx.down, ctx.edge = bands, up, down, edge
        ctx.stamp = next(_exchanges) % _STAMP_MOD
        ext, ctx.n_up, ctx.n_down = _extend(bands, x, up, down, edge)
        return ext

    @staticmethod
    def backward(ctx, g):
        bands, up, down = ctx.bands, ctx.up, ctx.down
        h = g.shape[-2] - ctx.n_up - ctx.n_down
        gx = g[..., ctx.n_up : ctx.n_up + h, :].clone()
        g_above, g_below = g[..., : ctx.n_up, :], g[..., ctx.n_up + h :, :]
        top, bottom = bands.index == 0, bands.last
        if top and ctx.edge == "reflect":
            gx[..., 1 : up + 1, :] += g_above.flip(-2)
        if bottom and ctx.edge == "reflect":
            gx[..., h - down - 1 : h - 1, :] += g_below.flip(-2)
        if bands.n > 1:
            flat, buf = _stamped(g, (bands.n,) + g.shape[:-2] + (down + up, g.shape[-1]), bands,
                                 ctx.stamp)
            if not top:
                buf[bands.index - 1, ..., down:, :] = g_above
            if not bottom:
                buf[bands.index + 1, ..., :down, :] = g_below
            _reduce_stamped(flat, bands, "halo_bwd", ctx.stamp)
            gx[..., :down, :] += buf[bands.index, ..., :down, :]
            gx[..., h - up :, :] += buf[bands.index, ..., down:, :]
        return gx, None, None, None, None


class _Gather(torch.autograd.Function):
    """`Bands.gather` with gradient: the band's rows of the cotangents summed
    over the group (the whole frame is the same on every process, and each
    one's objective holds its share of what it computes from it)."""

    @staticmethod
    def forward(ctx, x, bands):
        ctx.bands, ctx.stamp = bands, next(_exchanges) % _STAMP_MOD
        return _gathered(bands, x)

    @staticmethod
    def backward(ctx, g):
        flat, buf = _stamped(g, g.shape, ctx.bands, ctx.stamp)
        buf.copy_(g)
        _reduce_stamped(flat, ctx.bands, "gather_bwd", ctx.stamp)
        return ctx.bands.take(buf), None


class _SpatialSum(torch.autograd.Function):
    """`spatial_sum` with gradient: the adjoint of a sum sums the cotangents."""

    @staticmethod
    def forward(ctx, x, bands):
        ctx.bands, ctx.stamp = bands, next(_exchanges) % _STAMP_MOD
        return _summed(bands, x)

    @staticmethod
    def backward(ctx, g):
        flat, buf = _stamped(g, g.shape, ctx.bands, ctx.stamp)
        buf.copy_(g)
        _reduce_stamped(flat, ctx.bands, "sum_bwd", ctx.stamp)
        return buf, None


_active: Optional[Bands] = None


@contextmanager
def running(bands: Optional[Bands]):
    """Make `bands` the active bands inside the block (None: none, the
    layers then take whole frames)."""
    global _active
    outer = _active
    _active = bands
    try:
        yield bands
    finally:
        _active = outer


def active() -> Optional[Bands]:
    """The active bands, or None."""
    return _active


def extend_rows(x: torch.Tensor, up: int, down: int, edge: Optional[str]):
    """x, a band of the active bands at some level, with `up` rows above and
    `down` below: the neighbours' rows, and at the frame's top and bottom
    `edge`: "zeros", "reflect" (the band's own rows mirrored, as
    F.pad(mode="reflect")), or None (no rows there).  Returns (the tensor,
    the rows added above, the rows added below).  Differentiable: the
    cotangents of the rows go back to the bands they came from."""
    if torch.is_grad_enabled() and x.requires_grad:
        bands = _active
        n_up = up if bands.index > 0 or edge else 0
        n_down = down if not bands.last or edge else 0
        return _HaloRows.apply(x, bands, up, down, edge), n_up, n_down
    return _extend(_active, x, up, down, edge)


def _extend(bands: Bands, x: torch.Tensor, up: int, down: int, edge: Optional[str]):
    """extend_rows without gradient, under `bands`."""
    above, below = bands.halo(x, up, down)
    h = x.shape[-2]
    if above is None and edge == "zeros":
        above = x.new_zeros(x.shape[:-2] + (up, x.shape[-1]))
    elif above is None and edge == "reflect":
        above = x[..., 1 : up + 1, :].flip(-2)
    if below is None and edge == "zeros":
        below = x.new_zeros(x.shape[:-2] + (down, x.shape[-1]))
    elif below is None and edge == "reflect":
        below = x[..., h - down - 1 : h - 1, :].flip(-2)
    parts = [t for t in (above, x, below) if t is not None]
    n_up = 0 if above is None else above.shape[-2]
    n_down = 0 if below is None else below.shape[-2]
    return torch.cat(parts, -2) if len(parts) > 1 else x, n_up, n_down


def band_mean(x: torch.Tensor, rows: Optional[int] = None) -> torch.Tensor:
    """The mean of x, a tensor whose rows (dim -2) are split over the active
    bands, `rows` rows in all (default: the bands' height, x then holding
    this band's rows): this process's share of it, its sum over the whole
    count, so that the shares of the group sum to the mean.  Without active
    bands, torch.mean(x)."""
    if _active is None:
        return torch.mean(x)
    if rows is None:
        if x.shape[-2] != _active.rows[_active.index]:
            raise ValueError(f"band_mean takes the band's {_active.rows[_active.index]} rows, "
                             f"got {x.shape[-2]}")
        rows = _active.height
    return torch.sum(x) / (x.numel() // x.shape[-2] * rows)


def spatial_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the processes of the active bands (x itself without
    active bands), differentiable; the result is the same on every
    process."""
    if _active is None or _active.n == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _SpatialSum.apply(x, _active)
    return _summed(_active, x)


def _require_active() -> Bands:
    if _active is None:
        raise ValueError("no active bands: run inside spatial.running(bands)")
    return _active


def adacof_warp_tm_sharded(x, weight, offset_i, offset_j, dilation: int = 1,
                           max_offset: int = 48, warp: Optional[Callable] = None) -> torch.Tensor:
    """Height-sharded AdaCoF warp with an explicit halo exchange (port of
    fmvfi_tpu/parallel/spatial.py::adacof_warp_tm_sharded): this process's
    band of the output, from its band of the UNPADDED frame x (B, C, h, W)
    and of the fields (B, F*F, h, W), under the active bands.

    The halo, max_offset + kp + 1 rows (kp = (F-1)*dilation/2: the largest
    vertical reach of a tap, clamped offset, centre displacement and the
    bilinear +1), comes from the neighbouring bands; at the frame's top and
    bottom the band replicates its own border rows, which is what the
    whole frame's replicate padding and index clamping give.  The block is
    padded by kp columns and warped by `warp`, ops/adacof_cuda.py's
    signature (None: its `adacof_warp`, K1 forward and K2 backward on CUDA
    tensors, the plain pair on CPU ones; AdaCoFNet passes its `warp`,
    which a check may swap for the plain one).  The warp takes x with
    (F-1)*dilation rows more than the fields, so the fields get
    p = halo - kp zero rows above and below: the
    band's row i is field row p + i, whose taps read block rows
    i + p + (t // F) dilation + offset, all inside the block (never
    clamped); the zero rows' outputs are cropped, 2 (max_offset + 1) rows
    of wasted warp work per band.  Offsets clamped to +-max_offset;
    gradients: the fields' (the clamped contract of K3), none for x (the
    frames are data).
    Bit-equal to the single-process warp of the whole frame.  Raises
    ValueError where a band is shorter than the halo (a single-neighbour
    exchange)."""
    bands = _require_active()
    k = math.isqrt(weight.shape[1])
    kp = ((k - 1) * dilation) // 2
    halo = max_offset + kp + 1
    h = weight.shape[2]
    if x.shape[-2] != h or h != bands.rows[bands.index]:
        raise ValueError(f"x {tuple(x.shape)} and fields {tuple(weight.shape)} are not this "
                         f"band's {bands.rows[bands.index]} rows")
    if min(bands.rows) < halo:
        raise ValueError(
            f"bands of {bands.rows} rows: the shortest is below the halo of {halo} rows "
            f"(single-neighbour exchange); lower max_offset (<= {min(bands.rows) - kp - 1}) "
            "or use fewer spatial bands")
    xd = x.detach()
    above, below = bands.halo(xd, halo, halo)
    if above is None:
        above = xd[:, :, :1].expand(-1, -1, halo, -1)
    if below is None:
        below = xd[:, :, -1:].expand(-1, -1, halo, -1)
    block = torch.cat([above, xd, below], 2)
    if kp:
        block = F.pad(block, (kp, kp, 0, 0), mode="replicate")
    p = halo - kp
    warp = warp or adacof_cuda.adacof_warp
    out = warp(block, *(F.pad(t, (0, 0, p, p)) for t in (weight, offset_i, offset_j)), dilation,
               max_offset)
    return out[:, :, p : p + h]


def adacof_warp_gathered(x, weight, offset_i, offset_j, dilation: int, max_offset,
                         warp: Callable) -> torch.Tensor:
    """This process's band of `warp` (ops/adacof_cuda.py's signature) of the
    whole frame, from its bands of the unpadded frame x and the fields,
    under the active bands: the frame
    gathered and replicate-padded, the fields zero-padded to its height,
    the output rows cropped.  Exact for any offsets (max_offset None:
    unclamped), and n times the band's warp work: for bands too short to
    host the halo, as the JAX package falls back to its gather warp."""
    bands = _require_active()
    k = math.isqrt(weight.shape[1])
    kp = ((k - 1) * dilation) // 2
    whole = bands.gather(x.detach())
    if kp:
        whole = F.pad(whole, (kp, kp, kp, kp), mode="replicate")
    rows = (0, 0, bands.lo, bands.height - bands.hi)
    out = warp(whole, *(F.pad(t, rows) for t in (weight, offset_i, offset_j)), dilation,
               max_offset)
    return out[:, :, bands.lo : bands.hi]


class Sharded(NamedTuple):
    """This process's block of an NHWC batch of frames split over a mesh:
    entries `batch` and rows `rows` of a batch of shape `shape`."""

    local: torch.Tensor
    batch: slice
    rows: slice
    shape: tuple
    groups: tuple  # the groups that split the rows, then the batch (None: not split)

    def gather(self) -> torch.Tensor:
        """The whole batch, on every process of the mesh."""
        if all(g is None for g in self.groups):
            return self.local
        buf = self.local.new_zeros(self.shape)
        buf[self.batch, self.rows] = self.local
        for g in self.groups:
            if g is not None:
                _all_reduce(buf, g, "gather")
        return buf


def _share(mesh, axis: str):
    """(process group, this process's index, processes) of a mesh axis."""
    group = mesh.get_group(axis)
    return group, dist.get_rank(group), dist.get_world_size(group)


def batch_share(mesh, axis: str, b: int):
    """(this process's entries of a batch of b split over the mesh axis, the
    axis's process group, None where one process holds the whole batch)."""
    group, i, n = _share(mesh, axis)
    if b % n:
        raise ValueError(f"batch {b} not divisible by the {n} processes of the {axis!r} axis")
    per = b // n
    return slice(i * per, (i + 1) * per), group if n > 1 else None


def bands_of(mesh, axis: str, height: int, n_data: int = 1) -> Bands:
    """This process's band of a frame `height` rows high split over the
    mesh axis (split_rows)."""
    group, i, n = _share(mesh, axis)
    return Bands(group, i, split_rows(height, n), n_data)


def spatial_apply(fn: Callable, mesh, axis: str = "data") -> Callable:
    """Wrap `out = fn(weights, frame1, frame2)` for height-sharded inference
    over the mesh axis `axis`: the wrapper takes the whole NHWC frames,
    which every process holds, passes fn this process's bands of rows
    (split_rows) and runs it under `running` and no_grad (serving), and
    returns the rank's band of fn's NHWC output as a `Sharded`
    (`.gather()` gives the whole frame).

    In the JAX package XLA partitions any function.  Here the result is
    exact only for functions built from the halo-aware layers (the nets'
    convolutions, pools and upsamples) and AdaCoFNet's routed warp; a
    section that needs whole frames (an FFT, PhaseNet) must gather them
    itself.  With one process on the axis, fn takes the whole frames."""
    _check_mesh(mesh, axis)

    def wrapper(weights, f1, f2):
        f1, f2 = torch.as_tensor(f1), torch.as_tensor(f2)
        b, h = f1.shape[:2]
        bands = bands_of(mesh, axis, h)
        rows = slice(bands.lo, bands.hi)
        split = bands.n > 1
        with torch.no_grad(), running(bands if split else None):
            out = fn(weights, f1[:, rows], f2[:, rows])
        return Sharded(out, slice(0, b), rows, (b, h) + tuple(out.shape[2:]),
                       (bands.group if split else None, None))

    return wrapper


def fusion_spatial_apply(models, mesh, batch_axis: str = "data", spatial_axis: str = "spatial",
                         **kw) -> Callable:
    """2-D (data x spatial) fusion inference: the batch split over
    `batch_axis`, the image height over `spatial_axis` (port of the JAX
    package's fusion_spatial_apply).  Returns fn(frame1, frame2): the whole
    NHWC frames, which every process holds, in; this process's block of the
    fused frames out, as a `Sharded` (with return_parts=True, also a dict of
    the parts as `Sharded`s).  The nets run on the bands with halo
    exchanges, the warp as `adacof_warp_tm_sharded` (K1 on each band); the
    pyramid, PhaseNet and the uncertainty maps on the gathered frames of
    the batch share.  `kw`: fusion_interpolate's (device, compute_dtype,
    return_parts, filters)."""
    from ..pipeline.interpolate import fusion_sharded

    _check_mesh(mesh, batch_axis, spatial_axis)

    def fn(frame1, frame2):
        with torch.no_grad():
            return fusion_sharded(models, frame1, frame2, mesh, batch_axis, spatial_axis, **kw)

    return fn


def block(mesh, batch: int, height: int, batch_axis: str = "data",
          spatial_axis: str = "spatial"):
    """(this process's entries of a batch of `batch` frames split over
    `batch_axis`, its `Bands` of their `height` rows split over
    `spatial_axis`, or None where one process holds every row): where the
    spatial trainers place a step's block."""
    share, _ = batch_share(mesh, batch_axis, batch)
    bands = bands_of(mesh, spatial_axis, height, batch // len(range(batch)[share]))
    return share, bands if bands.n > 1 else None


def adacof_spatial_trainer(mesh, batch_axis: str = "data", spatial_axis: str = "spatial", **kw):
    """2-D (data x spatial) AdaCoF training (port of the JAX package's
    adacof_spatial_trainer): train/trainer.py's make_adacof_trainer(**kw)
    with `spatial_mesh=mesh`.  Returns (state, step) as that factory does;
    `step(state, batch)` takes the WHOLE NHWC global batch, which every
    process holds, and runs on this process's block (`block`: its batch
    share, its band of the frame's rows, AdaCoF's /32 tail on the last
    band).  The U-Net exchanges halo rows forward and backward; the warp
    runs as AdaCoFNet routes it (`_sharded_max_offset`): the halo warp,
    K1 forward and K2 backward on each band's block on the card, or, for
    bands too short for its halo, the gathered frame's warp (the JAX
    package forces its gather warp here).  The gradients are summed over
    the spatial axis and averaged over the data axis before the optimizer,
    and the metrics are the global batch's, on every process.  With one
    process on each axis, the single-device step."""
    from ..train.trainer import make_adacof_trainer

    return make_adacof_trainer(spatial_mesh=mesh, batch_axis=batch_axis,
                               spatial_axis=spatial_axis, **kw)


def fusion_spatial_trainer(phase_net, adacof, mesh, batch_axis: str = "data",
                           spatial_axis: str = "spatial", **kw):
    """2-D (data x spatial) FusionNet training (port of the JAX package's
    fusion_spatial_trainer): train/trainer.py's make_fusion_trainer(
    phase_net, adacof, **kw) with `spatial_mesh=mesh`.  `step(state,
    batch)` takes the whole NHWC global batch, as `adacof_spatial_trainer`'s;
    sections 1-4 run without gradient on this process's block as
    `fusion_spatial_apply` runs them (the AdaCoF passes on the bands of the
    /8-padded rows, PhaseNet and the maps on the gathered frames of the
    batch share), FusionNet with gradient on the bands, the /8 pad cropped
    from the last band.  Gradients and metrics as `adacof_spatial_trainer`'s."""
    from ..train.trainer import make_fusion_trainer

    return make_fusion_trainer(phase_net, adacof, spatial_mesh=mesh, batch_axis=batch_axis,
                               spatial_axis=spatial_axis, **kw)
