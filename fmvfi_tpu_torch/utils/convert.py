"""Flax variable trees and the reference's PyTorch checkpoints -> state
dicts of the port's modules, and back to flax trees.

A flax tree here is nested dicts of numpy arrays ({'params': ...} and, for
PhaseNet, {'batch_stats': ...}), as utils/msgpack_io.py reads it from a
.msgpack file.  Conv kernels are HWIO (DHWIO in 3-D) in flax and OIHW
(OIDHW) in torch, Dense kernels (in, out) and Linear weights (out, in);
BatchNorm {scale, bias} + {mean, var} become {weight, bias, running_mean,
running_var}.
The reference's .pt files (phase_net.pt, fusion_net*.pt, AdaCoF's
ckpt.pth) are already in torch's layout: their keys are renamed, nothing
is transposed.  Every returned state dict loads into its module with
strict=True.

The inverses `adacof_to_flax`, `fusion_net_to_flax` and `phase_net_to_flax`
turn a port state dict back into the flax tree, bit for bit (BN running
statistics into 'batch_stats'; num_batches_tracked, which flax has not, is
dropped), with keys sorted at every level as flax's init makes them, so
that utils/checkpoint.py::save_msgpack writes the file the JAX package
would.  `merge_matching_params` warm-starts one port state dict from
another (fmvfi_tpu/utils/convert.py:189-210).
"""

from __future__ import annotations

import os
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


def _bn(out: Dict[str, torch.Tensor], key: str, params, stats) -> None:
    out[f"{key}.weight"] = _t(params["scale"])
    out[f"{key}.bias"] = _t(params["bias"])
    out[f"{key}.running_mean"] = _t(stats["mean"])
    out[f"{key}.running_var"] = _t(stats["var"])
    out[f"{key}.num_batches_tracked"] = torch.tensor(0)


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
        _bn(out, f"blocks.{i}.bn", p["bn"], s)
    return out


def discriminator_from_flax(tree, gan_type: str) -> Dict[str, torch.Tensor]:
    """A flax critic's variables (params, and batch_stats for the BN
    critics of GAN, WGAN and FI_GAN) -> the state dict of
    models.discriminator.make_critic(gan_type, ...).  The port's trunk
    permutes its features to NHWC before fc1, so fc1's kernel is only
    transposed."""
    params = _params(tree)
    stats = tree.get("batch_stats", {}).get("trunk", {})
    trunk = params["trunk"]
    out: Dict[str, torch.Tensor] = {}
    if gan_type == "T_WGAN_GP":
        for name in ("conv3d_0", "conv3d_1"):
            out[f"{name}.weight"] = _t(np.transpose(params[name]["kernel"], (4, 3, 0, 1, 2)))
            out[f"{name}.bias"] = _t(params[name]["bias"])
    for name, p in trunk.items():
        if name.startswith("conv"):
            out[f"trunk.{name}.weight"] = _t(np.transpose(p["kernel"], (3, 2, 0, 1)))
        elif name.startswith("bn"):
            _bn(out, f"trunk.{name}", p, stats[name])
        else:  # fc1, fc2
            out[f"trunk.{name}.weight"] = _t(np.transpose(p["kernel"]))
            out[f"trunk.{name}.bias"] = _t(p["bias"])
    return out


def vgg_from_flax(tree) -> Dict[str, torch.Tensor]:
    """VGGFeatures variables -> train.vgg.VGGFeatures state dict."""
    out: Dict[str, torch.Tensor] = {}
    _convs(out, _params(tree))
    return out


def _np(t) -> np.ndarray:
    return np.ascontiguousarray(t.detach().cpu().numpy(), dtype=np.float32)


def _sorted_tree(tree):
    """Keys sorted at every level, as flax's init orders a variable tree."""
    if not isinstance(tree, dict):
        return tree
    return {k: _sorted_tree(tree[k]) for k in sorted(tree)}


def _conv_flax(sd, key: str):
    """(kernel HWIO, bias) of the conv `key` of a state dict."""
    return np.ascontiguousarray(np.transpose(_np(sd[f"{key}.weight"]), (2, 3, 1, 0))), _np(
        sd[f"{key}.bias"])


def _convs_to_flax(sd) -> Dict[str, Any]:
    """The inverse of `_convs`: every conv of a state dict under its dotted
    path, `final.conv3` as the pair `conv3_kernel` / `conv3_bias` of
    `final`.  Raises ValueError on a key that is no conv's weight or bias."""
    params: Dict[str, Any] = {}
    convs = [k[: -len(".weight")] for k in sd if k.endswith(".weight")]
    left = set(sd) - {f"{c}.{p}" for c in convs for p in ("weight", "bias")}
    if left:
        raise ValueError(f"not conv weights or biases: {sorted(left)}")
    for conv in convs:
        *parents, name = conv.split(".")
        node = params
        for p in parents:
            node = node.setdefault(p, {})
        kernel, bias = _conv_flax(sd, conv)
        if parents[-1:] == ["final"] and name == "conv3":
            node["conv3_kernel"], node["conv3_bias"] = kernel, bias
        else:
            node[name] = {"kernel": kernel, "bias": bias}
    return _sorted_tree({"params": params})


def adacof_to_flax(sd) -> Dict[str, Any]:
    """models.adacof.AdaCoFNet state dict -> AdaCoFNet variables
    ({'params'}), the inverse of adacof_from_flax."""
    return _convs_to_flax(sd)


def fusion_net_to_flax(sd) -> Dict[str, Any]:
    """models.fusion_net.FusionNet state dict -> FusionNet variables
    ({'params'}), the inverse of fusion_net_from_flax."""
    return _convs_to_flax(sd)


def phase_net_to_flax(sd) -> Dict[str, Any]:
    """models.phase_net.PhaseNetCore state dict -> PhaseNetCore variables
    ({'params', 'batch_stats'}), the inverse of phase_net_from_flax."""
    n_blocks = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("blocks."))
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for i in range(n_blocks):
        key = f"blocks.{i}"
        block = {}
        for conv in ("conv1", "conv2", "pred"):
            kernel, bias = _conv_flax(sd, f"{key}.{conv}")
            block[conv] = {"kernel": kernel, "bias": bias}
        block["bn"] = {"scale": _np(sd[f"{key}.bn.weight"]), "bias": _np(sd[f"{key}.bn.bias"])}
        params[f"block{i}"] = block
        stats[f"block{i}"] = {"bn": {"mean": _np(sd[f"{key}.bn.running_mean"]),
                                     "var": _np(sd[f"{key}.bn.running_var"])}}
    return _sorted_tree({"params": params, "batch_stats": stats})


def merge_matching_params(new, old):
    """Cross-architecture warm start on state dicts: `new` with every tensor
    whose name and shape `old` shares replaced by `old`'s.  The rest stays
    fresh, e.g. the widened dec2 1x1 conv of a variant-2 (gated-blend)
    FusionNet warm-started from a variant-0 one.  Returns (merged, the
    names of the fresh tensors), in `new`'s order."""
    merged, fresh = {}, []
    for k, v in new.items():
        o = old.get(k)
        if o is not None and tuple(o.shape) == tuple(v.shape):
            merged[k] = o
        else:
            merged[k] = v
            fresh.append(k)
    return merged, fresh


def _load_state_dict(path_or_sd) -> Dict[str, torch.Tensor]:
    """A reference checkpoint (a path, or a loaded dict) -> its tensors by
    key: read with weights_only=True, unwrapped from AdaCoF's {'epoch',
    'state_dict'}, entries that are not tensors dropped
    (fmvfi_tpu/utils/convert.py:46-57)."""
    sd = path_or_sd
    if isinstance(sd, (str, bytes)) or hasattr(sd, "__fspath__"):
        sd = torch.load(sd, map_location="cpu", weights_only=True)
    if "state_dict" in sd and isinstance(sd["state_dict"], dict):
        sd = sd["state_dict"]
    return {k: torch.as_tensor(v).detach().to(torch.float32).contiguous().clone()
            for k, v in sd.items() if isinstance(v, (torch.Tensor, np.ndarray))}


def _renamed(sd, names: Dict[str, str]) -> Dict[str, torch.Tensor]:
    """{port key: sd[reference key]} for each (reference prefix -> port
    prefix) of `names`, the .weight and .bias of each."""
    return {f"{port}.{p}": sd[f"{ref}.{p}"] for ref, port in names.items()
            for p in ("weight", "bias")}


def phase_net_from_torch(path_or_sd) -> Dict[str, torch.Tensor]:
    """phase_net.pt (layers.{i}.feature_map.{0 conv, 1 BN, 3 conv} and
    layers.{i}.prediction_map.0) -> models.phase_net.PhaseNetCore state
    dict."""
    sd = _load_state_dict(path_or_sd)
    n_blocks = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("layers."))
    out: Dict[str, torch.Tensor] = {}
    for i in range(n_blocks):
        ref, port = f"layers.{i}", f"blocks.{i}"
        out.update(_renamed(sd, {f"{ref}.feature_map.0": f"{port}.conv1",
                                 f"{ref}.feature_map.3": f"{port}.conv2",
                                 f"{ref}.prediction_map.0": f"{port}.pred"}))
        for p in ("weight", "bias", "running_mean", "running_var"):
            out[f"{port}.bn.{p}"] = sd[f"{ref}.feature_map.1.{p}"]
        out[f"{port}.bn.num_batches_tracked"] = torch.tensor(0)
    return out


def fusion_net_from_torch(path_or_sd) -> Dict[str, torch.Tensor]:
    """fusion_net*.pt -> models.fusion_net.FusionNet state dict (the
    checkpoint's unused `net.*` keys are ignored)."""
    sd = _load_state_dict(path_or_sd)
    names = {f"encoder_layers.{i}": f"enc{i}" for i in range(3)}
    names.update({f"decoder_layers.{i}": f"dec{i}" for i in range(3)})
    names["bottleneck_layer"] = "bottleneck"
    return _renamed(sd, names)


def adacof_from_torch(path_or_sd) -> Dict[str, torch.Tensor]:
    """AdaCoF's ckpt.pth ({'epoch', 'state_dict'} or a bare state dict, keys
    with or without DataParallel's 'module.') -> models.adacof.AdaCoFNet
    state dict."""
    sd = {k.removeprefix("module."): v for k, v in _load_state_dict(path_or_sd).items()}
    g = "get_kernel"
    names = {}
    for ref, port in (("Conv", "conv"), ("Deconv", "deconv")):
        for n in range(1, 6):
            if ref == "Deconv" and n == 1:
                continue
            for j in range(3):  # Basic: convs at Sequential indices 0, 2, 4
                names[f"{g}.module{ref}{n}.{2 * j}"] = f"{g}.{port}{n}.conv{j}"
    for n in range(2, 6):
        names[f"{g}.moduleUpsample{n}.1"] = f"{g}.upsample{n}.conv"
    for head in ("Weight1", "Alpha1", "Beta1", "Weight2", "Alpha2", "Beta2"):
        ref, port = f"{g}.module{head}", f"{g}.{head.lower()}"
        names.update({f"{ref}.0": f"{port}.conv0", f"{ref}.2": f"{port}.conv1",
                      f"{ref}.4": f"{port}.final.conv2", f"{ref}.7": f"{port}.final.conv3"})
    for j, idx in enumerate((0, 2, 4, 7)):
        names[f"{g}.moduleOcclusion.{idx}"] = f"{g}.occlusion.conv{j}"
    return _renamed(sd, names)


def load_adacof_weights(path) -> Dict[str, torch.Tensor]:
    """AdaCoFNet state dict from an fmvfi .msgpack file or the reference's
    ckpt.pth (fmvfi_tpu/utils/convert.py:210-223).  The kernel size and
    dilation are the module's: a strict load checks the heads' shapes."""
    if os.fspath(path).endswith(".msgpack"):
        return adacof_from_flax(msgpack_io.load(path))
    return adacof_from_torch(path)


def load_fusion_weights(path) -> Dict[str, torch.Tensor]:
    """FusionNet state dict from an fmvfi .msgpack file or the reference's
    fusion_net*.pt (fmvfi_tpu/utils/convert.py:157-186); the head variant of
    a .msgpack is models.fusion_net.infer_variant(state_dict), the maps the
    module's (a strict load checks enc0's input channels)."""
    if os.fspath(path).endswith(".msgpack"):
        return fusion_net_from_flax(msgpack_io.load(path))
    return fusion_net_from_torch(path)
