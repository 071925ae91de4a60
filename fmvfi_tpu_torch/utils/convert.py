"""Flax variable trees -> state dicts of the port's modules.

A flax tree here is nested dicts of numpy arrays ({'params': ...} and, for
PhaseNet, {'batch_stats': ...}), as utils/msgpack_io.py reads it from a
.msgpack file.  Conv kernels are HWIO in flax and OIHW in torch; BatchNorm
{scale, bias} + {mean, var} become {weight, bias, running_mean, running_var}.
Every returned state dict loads into its module with strict=True.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from . import msgpack_io


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32))


def _conv(out: Dict[str, torch.Tensor], key: str, kernel, bias) -> None:
    out[f"{key}.weight"] = _t(np.transpose(kernel, (3, 2, 0, 1)))
    out[f"{key}.bias"] = _t(bias)


def _convs(out: Dict[str, torch.Tensor], tree, prefix: str = "") -> None:
    """Every {kernel, bias} pair of a nested tree, keyed by its dotted path;
    `conv3_kernel`/`conv3_bias` pairs become a `conv3` conv."""
    for name, sub in tree.items():
        if name in ("kernel", "bias", "conv3_bias"):
            continue
        if name == "conv3_kernel":
            _conv(out, f"{prefix}conv3", sub, tree["conv3_bias"])
        elif set(sub) == {"kernel", "bias"}:
            _conv(out, f"{prefix}{name}", sub["kernel"], sub["bias"])
        else:
            _convs(out, sub, f"{prefix}{name}.")


def _params(tree):
    return tree.get("params", tree)


def adacof_from_flax(tree) -> Dict[str, torch.Tensor]:
    """AdaCoFNet variables -> models.adacof.AdaCoFNet state dict."""
    out: Dict[str, torch.Tensor] = {}
    _convs(out, _params(tree))
    return out


def fusion_net_from_flax(tree) -> Dict[str, torch.Tensor]:
    """FusionNet variables -> models.fusion_net.FusionNet state dict."""
    out: Dict[str, torch.Tensor] = {}
    _convs(out, _params(tree))
    return out


def phase_net_from_flax(tree) -> Dict[str, torch.Tensor]:
    """PhaseNetCore variables (params + batch_stats) ->
    models.phase_net.PhaseNetCore state dict."""
    params, stats = tree["params"], tree["batch_stats"]
    out: Dict[str, torch.Tensor] = {}
    for name in sorted(params, key=lambda n: int(n.removeprefix("block"))):
        i = int(name.removeprefix("block"))
        p, s = params[name], stats[name]["bn"]
        for conv in ("conv1", "conv2", "pred"):
            _conv(out, f"blocks.{i}.{conv}", p[conv]["kernel"], p[conv]["bias"])
        out[f"blocks.{i}.bn.weight"] = _t(p["bn"]["scale"])
        out[f"blocks.{i}.bn.bias"] = _t(p["bn"]["bias"])
        out[f"blocks.{i}.bn.running_mean"] = _t(s["mean"])
        out[f"blocks.{i}.bn.running_var"] = _t(s["var"])
        out[f"blocks.{i}.bn.num_batches_tracked"] = torch.tensor(0)
    return out


def load_adacof_weights(path) -> Dict[str, torch.Tensor]:
    """AdaCoFNet state dict from an fmvfi .msgpack file."""
    return adacof_from_flax(msgpack_io.load(path))


def load_fusion_weights(path) -> Dict[str, torch.Tensor]:
    """FusionNet state dict from an fmvfi .msgpack file; the head variant is
    models.fusion_net.infer_variant(state_dict)."""
    return fusion_net_from_flax(msgpack_io.load(path))
