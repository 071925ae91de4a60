"""Model registry: name -> constructor, with dynamic-import fallback (port
of fmvfi_tpu/models/registry.py over the port's torch modules).

Parity for the reference's dynamic loader (`Model(args)` importing
`args.model` and calling `make_model`, src/adacof/models/__init__.py:5-21) —
but with an explicit registry for the in-tree families and importlib only as
the extension escape hatch.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Dict

_REGISTRY: Dict[str, Callable[..., Any]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_model(name: str, **kwargs):
    """Build a model by registry name, or by dotted path to a module exposing
    `make_model(**kwargs)` (the reference's convention)."""
    if name in _REGISTRY:
        return _REGISTRY[name](**kwargs)
    if "." in name:
        mod = importlib.import_module(name)
        if hasattr(mod, "make_model"):
            return mod.make_model(**kwargs)
        raise AttributeError(f"{name} has no make_model()")
    raise KeyError(f"unknown model '{name}' (registered: {sorted(_REGISTRY)})")


@register("adacof")
def _adacof(kernel_size: int = 5, dilation: int = 1, **kw):
    from .adacof import AdaCoFNet

    return AdaCoFNet(kernel_size=kernel_size, dilation=dilation, **kw)


@register("phase_net")
def _phase_net(num_img: int = 2, nbands: int = 4, **kw):
    from .phase_net import PhaseNetCore

    if nbands != 4:  # JAX's field, which its block specs ignore: they assume 4
        raise ValueError(f"PhaseNetCore is built for 4 bands, got nbands={nbands}")
    return PhaseNetCore(num_img=num_img, **kw)


@register("fusion_net")
def _fusion_net(uncertainty_maps: int = 3, **kw):
    from .fusion_net import FusionNet

    return FusionNet(uncertainty_maps=uncertainty_maps, **kw)


@register("discriminator")
def _discriminator(gan_type: str = "GAN", **kw):
    from .discriminator import Discriminator

    return Discriminator(gan_type=gan_type, **kw)
