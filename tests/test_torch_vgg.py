"""fmvfi_tpu_torch's VGG16 (train/vgg.py) and VGG LPIPS
(eval/metrics.py::make_vgg_lpips) against the JAX package's on the CPU.

Both sides load one seeded torchvision-format vgg16 state dict written to a
temporary .pth (no weights file is in the repo and nothing is downloaded).
Tolerance: 1e-4 relative to the largest feature or value (f32 convolutions
summed in another order through up to 13 layers); the perceptual loss's
input gradient 1e-4 of its largest.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fmvfi_tpu.eval import metrics as jx_metrics
from fmvfi_tpu.train import vgg as jx_vgg
from fmvfi_tpu_torch.eval import metrics as pt_metrics
from fmvfi_tpu_torch.train import vgg as pt_vgg
from fmvfi_tpu_torch.utils import convert

TOL = 1e-4
_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512]


def seeded_vgg16(path, seed=0):
    """A torchvision-format vgg16 `features.*` state dict, He-scaled normal
    weights and small normal biases, saved to `path`."""
    g = np.random.default_rng(seed)
    sd, idx, cin = {}, 0, 3
    for v in _CFG:
        if v == "M":
            idx += 1
            continue
        w = g.normal(size=(v, cin, 3, 3)) * np.sqrt(2.0 / (9 * cin))
        sd[f"features.{idx}.weight"] = torch.from_numpy(w.astype(np.float32))
        sd[f"features.{idx}.bias"] = torch.from_numpy((0.01 * g.normal(size=v)).astype(np.float32))
        cin, idx = v, idx + 2
    torch.save(sd, path)
    return path


@pytest.fixture(scope="module")
def vgg_path(tmp_path_factory):
    return str(seeded_vgg16(tmp_path_factory.mktemp("vgg") / "vgg16.pth"))


def _images(n, size, seed):
    return np.random.default_rng(seed).uniform(0, 1, (n, size, size, 3)).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _rel(ours, ref):
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(ours) - ref).max()) / max(float(np.abs(ref).max()), 1e-30)


@pytest.mark.parametrize("full,taps", [(False, ()), (True, ()), (False, (1, 3, 6, 9)),
                                       (True, jx_vgg.LPIPS_TAPS)],
                         ids=["conv4_3", "conv5_3", "taps4", "lpips_taps"])
def test_vgg_features_match_jax(vgg_path, full, taps):
    x = _images(2, 32, 0)
    variables = jx_vgg.vgg16_params_from_torch(vgg_path, full=full)
    ref = jx_vgg.VGGFeatures(full=full, taps=taps).apply(variables, jnp.asarray(x))
    model = pt_vgg.VGGFeatures(full, taps)
    sd = pt_vgg.vgg16_params_from_torch(vgg_path, full)
    model.load_state_dict(sd, strict=True)
    # and the flax tree converts to the same state dict
    for k, v in convert.vgg_from_flax(jax.tree.map(np.asarray, variables)).items():
        assert torch.equal(v, sd[k]), k
    ours = model(_nchw(x))
    refs, outs = (ref, ours) if taps else ([ref], [ours])
    assert len(outs) == len(refs) == max(len(taps), 1)
    for o, r in zip(outs, refs):
        o = np.moveaxis(o.detach().numpy(), 1, -1)
        assert o.shape == np.shape(r)
        assert _rel(o, r) <= TOL


def test_vgg_loss_and_its_input_gradient_match_jax(vgg_path):
    sr, hr = _images(2, 32, 1), _images(2, 32, 2)
    jloss = jx_vgg.VGGLoss(vgg_path)
    ref, ref_grad = jax.value_and_grad(jloss)(jnp.asarray(sr), jnp.asarray(hr))
    loss = pt_vgg.VGGLoss(vgg_path, device="cpu")
    sr_t = _nchw(sr).requires_grad_(True)
    ours = loss(sr_t, _nchw(hr))
    ours.backward()
    assert abs(float(ours) / float(ref) - 1.0) <= TOL
    assert _rel(np.moveaxis(sr_t.grad.numpy(), 1, -1), ref_grad) <= TOL
    assert all(not p.requires_grad and p.grad is None for p in loss.model.parameters())


def test_vgg_loss_without_its_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="torchvision vgg16 checkpoint"):
        pt_vgg.VGGLoss(str(tmp_path / "missing.pth"), device="cpu")


def test_vgg_lpips_matches_jax(vgg_path):
    a, b = _images(2, 48, 3)
    ref_fn = jx_metrics.make_vgg_lpips(vgg_path)
    ours_fn = pt_metrics.make_vgg_lpips(vgg_path, device="cpu")
    ref = float(ref_fn(jnp.asarray(a), jnp.asarray(b)))
    ours = ours_fn(torch.from_numpy(a), torch.from_numpy(b))
    assert ours.shape == () and abs(float(ours) / ref - 1.0) <= TOL
    assert float(ours_fn(torch.from_numpy(a), torch.from_numpy(a))) == 0.0
    # all_metrics picks it up per image of a batch, as JAX's does for one
    m = pt_metrics.all_metrics(torch.from_numpy(np.stack([a, b])),
                               torch.from_numpy(np.stack([b, b])), lpips_fn=ours_fn)
    assert m["lpips_vgg"].shape == (2,)
    assert abs(float(m["lpips_vgg"][0]) / ref - 1.0) <= TOL and float(m["lpips_vgg"][1]) == 0.0
    jm = jx_metrics.all_metrics(jnp.asarray(a), jnp.asarray(b), lpips_fn=ref_fn)
    assert abs(float(m["lpips_vgg"][0]) / float(jm["lpips_vgg"]) - 1.0) <= TOL
