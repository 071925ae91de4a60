"""Ahead-of-time export: one interpolation pipeline at a fixed (batch, H, W)
as a serving artifact in one file (port of fmvfi_tpu/utils/export.py).

The artifact is a `torch.export` program of `fusion_interpolate`,
`phase_interpolate` or `adacof_interpolate`, saved with
`torch.export.save`.  The networks' weights and the pyramid filter bank are
the program's state (parameters and buffers), so the file is all a server
needs; a JSON `meta.json` in its extra files holds the method, batch, H, W,
the platforms, the number of state tensors (`n_args`, as JAX counts its
weight and filter leaves) and the format version.

`platforms` mirrors JAX's per-backend baking: the AdaCoF warp is fixed at
trace time.
  * ("cpu",): the plain warp is traced, so the program holds aten operators
    only and `torch.export.load` alone runs it, in a process with torch and
    numpy and without this package.
  * ("cuda",) or ("cpu", "cuda"): the warp is traced as the registered
    operator `fmvfi::adacof_warp_fwd` (ops/adacof_cuda.py), which launches
    K1 on the card and runs the plain warp on the CPU.  Loading it needs the
    operator registered, that is fmvfi_tpu_torch importable:
    `load_exported` imports it, and K1 is built from the repository's
    sources at its first launch, as in the live pipeline.
Such an artifact can be built on a host without a card.  `load_exported`
refuses a device whose type the artifact was not exported for, and a CUDA
device when there is no card; nothing falls back to the CPU.

`seq_chunk` and `return_parts` stay off in the exported function.
"""

from __future__ import annotations

import dataclasses
import io
import json
from typing import Callable, Optional, Sequence

import torch
from torch.export.passes import move_to_device_pass

from ..ops import adacof_cuda  # noqa: F401  registers fmvfi::adacof_warp_fwd for load
from ..ops.adacof import adacof_warp as adacof_warp_plain
from ..ops.pyramid import PyramidFilters, make_filters, max_pyr_height
from ..pipeline.interpolate import (
    FusionModels,
    adacof_interpolate,
    fusion_interpolate,
    phase_interpolate,
)

FORMAT_VERSION = 1
META_FILE = "meta.json"
PLATFORMS = ("cpu", "cuda")
METHODS = ("fusion", "phase", "adacof")
_MASK_FIELDS = ("band_masks", "synth_masks", "lo_masks")


def _filter_tensors(filters: PyramidFilters):
    """The bank's tensors, in a fixed order: hi0, lo0, then each level's
    band, synthesis and low masks."""
    return [filters.hi0, filters.lo0] + [t for f in _MASK_FIELDS for t in getattr(filters, f)]


class _Pipeline(torch.nn.Module):
    """The exported function: fn(frame1, frame2) -> middle frame, with the
    networks as submodules and the filter bank as buffers."""

    def __init__(self, models: FusionModels, method: str, filters: Optional[PyramidFilters]):
        super().__init__()
        self.method = method
        if method in ("fusion", "phase"):
            self.phase_net = models.phase_net
        if method in ("fusion", "adacof"):
            self.adacof = models.adacof
        if method == "fusion":
            self.fusion_net = models.fusion_net
        self._filters = filters
        if filters is not None:
            for i, t in enumerate(_filter_tensors(filters)):
                self.register_buffer(f"filter_{i:03d}", t)

    def filters(self) -> Optional[PyramidFilters]:
        """The filter bank with this module's buffers (the program's state)."""
        if self._filters is None:
            return None
        ts = [getattr(self, f"filter_{i:03d}") for i in range(len(_filter_tensors(self._filters)))]
        n = len(self._filters.band_masks)
        masks = {f: tuple(ts[2 + j * n : 2 + (j + 1) * n]) for j, f in enumerate(_MASK_FIELDS)}
        return dataclasses.replace(self._filters, hi0=ts[0], lo0=ts[1], **masks)

    def forward(self, frame1: torch.Tensor, frame2: torch.Tensor) -> torch.Tensor:
        dev = frame1.device
        if self.method == "fusion":
            models = FusionModels(self.phase_net, self.adacof, self.fusion_net)
            return fusion_interpolate(models, frame1, frame2, device=dev, filters=self.filters())
        if self.method == "phase":
            return phase_interpolate(self.phase_net, frame1, frame2, device=dev,
                                     filters=self.filters())
        return adacof_interpolate(self.adacof, frame1, frame2, device=dev)


def _check_platforms(platforms) -> tuple:
    out = tuple(sorted(set(platforms)))
    if not out or set(out) - set(PLATFORMS):
        raise ValueError(f"platforms must be a non-empty subset of {PLATFORMS}, got {platforms}")
    return out


def export_pipeline(
    models: FusionModels,
    h: int,
    w: int,
    method: str = "fusion",
    *,
    batch: int = 1,
    kernel_size: int = 5,
    dilation: int = 1,
    variant: int = 0,
    uncertainty_maps: int = 3,
    platforms: Optional[Sequence[str]] = None,
) -> bytes:
    """Export one pipeline at a fixed (batch, h, w) as artifact bytes.

    `models`: the FusionModels the method needs (the others may be None),
    in eval mode, on one device; the program is traced there.  The kernel
    size, dilation, head variant and number of maps are the modules' own:
    the arguments of the same names (JAX's signature) are checked against
    them.  `platforms`: ("cpu",), ("cuda",) or ("cpu", "cuda"); None: the
    models' device type."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    needed = {"fusion": ("phase_net", "adacof", "fusion_net"), "phase": ("phase_net",),
              "adacof": ("adacof",)}[method]
    mods = [getattr(models, n) for n in needed]
    if any(m is None for m in mods):
        raise ValueError(f"method {method!r} needs {needed}")
    dev = next(mods[0].parameters()).device
    platforms = _check_platforms(platforms or (dev.type,))
    ada = models.adacof if method != "phase" else None
    if ada is not None and (ada.kernel_size, ada.dilation) != (kernel_size, dilation):
        raise ValueError(f"AdaCoF has F {ada.kernel_size}, d {ada.dilation}; asked for "
                         f"{kernel_size}, {dilation}")
    if method == "fusion" and (models.fusion_net.variant, models.fusion_net.uncertainty_maps) != (
            variant, uncertainty_maps):
        raise ValueError(f"FusionNet has variant {models.fusion_net.variant} and "
                         f"{models.fusion_net.uncertainty_maps} maps; asked for {variant}, "
                         f"{uncertainty_maps}")

    filters = None
    if method == "fusion":
        # fusion_interpolate reflect-pads off-/8 frames, so its filter bank
        # is the padded size's
        fh, fw = h + (-h) % 8, w + (-w) % 8
        filters = make_filters(fh, fw, max_pyr_height(fh, fw), device=dev)
    elif method == "phase":
        filters = make_filters(h, w, max_pyr_height(h, w), device=dev)

    module = _Pipeline(models, method, filters).eval()
    # two tensors: export would read one tensor passed twice as one input
    frames = tuple(torch.zeros((batch, h, w, 3), dtype=torch.float32, device=dev)
                   for _ in range(2))
    warp = None
    if ada is not None and "cuda" not in platforms:
        warp, ada.warp = ada.warp, adacof_warp_plain  # aten operators only
    try:
        program = torch.export.export(module, frames, strict=False)
    finally:
        if warp is not None:
            ada.warp = warp
    program.example_inputs = None  # the two zero frames: 50 MB at 1080p that no caller reads
    meta = dict(method=method, batch=batch, h=h, w=w, platforms=list(platforms),
                n_args=len(program.state_dict) + len(program.constants),
                version=FORMAT_VERSION)
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={META_FILE: json.dumps(meta)})
    return buf.getvalue()


def save_exported(path: str, blob: bytes) -> None:
    with open(path, "wb") as f:
        f.write(blob)


def load_exported(path_or_bytes, device="cuda") -> Callable:
    """Load an artifact onto `device`; returns `fn(frame1, frame2) -> middle
    frame`, (B, H, W, 3) float32 frames (arrays or tensors) in and an NHWC
    tensor on `device` out, with the artifact's meta dict as `fn.meta` and
    the ExportedProgram, moved to `device`, as `fn.program`.

    Raises ValueError if the artifact was not exported for `device`'s type,
    and RuntimeError for a CUDA device without a card."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to load on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    src = (io.BytesIO(path_or_bytes) if isinstance(path_or_bytes, (bytes, bytearray))
           else path_or_bytes)
    extra = {META_FILE: ""}
    program = torch.export.load(src, extra_files=extra)
    meta = json.loads(extra[META_FILE])
    if meta.get("version") != FORMAT_VERSION:
        raise ValueError(f"artifact format {meta.get('version')}, expected {FORMAT_VERSION}")
    if dev.type not in meta["platforms"]:
        raise ValueError(f"artifact exported for {meta['platforms']}, not {dev.type}")
    program = move_to_device_pass(program, dev)
    module = program.module()

    def fn(frame1, frame2):
        f1 = torch.as_tensor(frame1, dtype=torch.float32, device=dev)
        f2 = torch.as_tensor(frame2, dtype=torch.float32, device=dev)
        with torch.no_grad():
            return module(f1, f2)

    fn.meta = meta
    fn.program = program
    return fn
