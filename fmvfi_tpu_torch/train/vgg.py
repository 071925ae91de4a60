"""VGG16 perceptual loss, conv4_3 feature MSE (port of
fmvfi_tpu/train/vgg.py).

The weights come from a user-supplied torchvision vgg16 state dict
(`features.{0,2,5,...}.weight/bias`), read with torch.load; nothing is
downloaded.  torchvision's OIHW is this module's layout.  The network's
parameters carry no gradient: only the prediction's input gradient flows.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..pipeline.interpolate import _device

# conv layers up to conv4_3 (torchvision features indices 0..21)
_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512]
# the full vgg16 conv trunk through conv5_3 (torchvision features 0..29)
_CFG_FULL = _CFG + ["M", 512, 512, 512]
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)
# the conv counts (0-based) after whose ReLU LPIPS taps features:
# relu1_2, relu2_2, relu3_3, relu4_3, relu5_3
LPIPS_TAPS = (1, 3, 6, 9, 12)
# torchvision features indices of the conv layers (full vgg16)
_TORCH_CONV_IDX = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]


class VGGFeatures(nn.Module):
    """The VGG16 trunk on NCHW RGB in [0, 1], ImageNet-normalized per
    channel.  Default: the conv4_3 + ReLU features (the perceptual loss).
    `full` runs through conv5_3; `taps` returns the list of the features
    after each listed conv's ReLU instead (LPIPS_TAPS: the 5 LPIPS maps).
    Max-pooling is 2x2 with floor, as flax's VALID pool."""

    def __init__(self, full: bool = False, taps: tuple = ()):
        super().__init__()
        self.cfg = _CFG_FULL if full else _CFG
        self.taps = tuple(taps)
        c_in, i = 3, 0
        for v in self.cfg:
            if v != "M":
                setattr(self, f"conv{i}", nn.Conv2d(c_in, v, 3, padding=1))
                c_in, i = v, i + 1
        self.register_buffer("mean", torch.tensor(_MEAN)[:, None, None], persistent=False)
        self.register_buffer("std", torch.tensor(_STD)[:, None, None], persistent=False)

    def forward(self, x: torch.Tensor):
        x = (x - self.mean) / self.std
        i, tapped = 0, []
        for v in self.cfg:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                x = F.relu(getattr(self, f"conv{i}")(x))
                if i in self.taps:
                    tapped.append(x)
                i += 1
        return tapped if self.taps else x


def vgg16_params_from_torch(path: str, full: bool = False) -> Dict[str, torch.Tensor]:
    """A torchvision vgg16 state dict file -> a VGGFeatures(full) state dict."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    conv_idx = _TORCH_CONV_IDX if full else _TORCH_CONV_IDX[:10]
    out = {}
    for i, li in enumerate(conv_idx):
        out[f"conv{i}.weight"] = sd[f"features.{li}.weight"]
        out[f"conv{i}.bias"] = sd[f"features.{li}.bias"]
    return out


def load_vgg(path: str, device, full: bool = False, taps: tuple = ()) -> VGGFeatures:
    """VGGFeatures(full, taps) with the file's weights on `device`, frozen
    (no parameter gradient) and in eval mode."""
    try:
        sd = vgg16_params_from_torch(path, full)
    except FileNotFoundError as e:
        raise FileNotFoundError(
            "VGG perceptual loss needs a torchvision vgg16 checkpoint "
            "(no network egress to download one); pass its path"
        ) from e
    model = VGGFeatures(full, taps)
    model.load_state_dict(sd, strict=True)
    return model.to(_device(device)).eval().requires_grad_(False)


class VGGLoss:
    """loss = MSE(vgg(sr), vgg(hr)) on conv4_3 features, the target's
    features detached; NCHW batches on `device`."""

    def __init__(self, checkpoint_path: str, device="cuda"):
        self.model = load_vgg(checkpoint_path, device)

    def __call__(self, sr: torch.Tensor, hr: torch.Tensor) -> torch.Tensor:
        fs = self.model(sr)
        with torch.no_grad():
            fh = self.model(hr)
        return torch.mean((fs - fh) ** 2)
