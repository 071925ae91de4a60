"""fmvfi_tpu_torch.utils.convert's loaders of the reference's PyTorch
checkpoints against fmvfi_tpu/utils/convert.py on the CPU.

Seeded state dicts in the reference's layouts (AdaCoF's from
tests/test_convert_adacof.py, with DataParallel's 'module.' prefix and the
{'epoch', 'state_dict'} wrapper; PhaseNet's layers.{i}.feature_map /
prediction_map keys with non-trivial BN statistics; FusionNet's
encoder/bottleneck/decoder keys beside the unused net.* ones) are saved
as .pt files.  For each, the port's state dict must equal, bit for bit, the
port's flax converter applied to JAX's tree of the same file (a rename and
two exact transposes), and the port module's outputs must be within 1e-4 of
the JAX module's on the same numpy inputs.  The bundled .msgpack files load
as they did before the .pt path was added.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fmvfi_tpu.eval.synth import translation_triplet
from fmvfi_tpu.models import adacof as jx_adacof
from fmvfi_tpu.models import fusion_net as jx_fusion
from fmvfi_tpu.models import phase_net as jx_phase
from fmvfi_tpu.ops import decomp as jx_decomp
from fmvfi_tpu.ops import pyramid as jx_pyr
from fmvfi_tpu.utils import convert as jx_convert
from fmvfi_tpu_torch.models.adacof import AdaCoFNet
from fmvfi_tpu_torch.models.fusion_net import FusionNet
from fmvfi_tpu_torch.models.phase_net import PhaseNetCore
from fmvfi_tpu_torch.utils import convert, msgpack_io
from test_convert_adacof import _synthetic_adacof_sd

MODEL_TOL = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ADACOF_CKPT = os.path.join(ROOT, "checkpoints", "adacof_synth_demo.msgpack")
FUSION_CKPT = os.path.join(ROOT, "checkpoints", "fusion_synth_demo.msgpack")
_PHASE_KEYS = {"conv1": "feature_map.0", "bn": "feature_map.1", "conv2": "feature_map.3",
               "pred": "prediction_map.0"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """PyTorch's CPU ops in one thread: the suite runs in several processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def reference_phase_sd(seed: int = 0):
    """A seeded PhaseNet state dict in phase_net.pt's layout
    (layers.{i}.feature_map.{0,1,3}, layers.{i}.prediction_map.0), with BN
    affine parameters and running statistics away from identity."""
    gen = torch.Generator().manual_seed(seed)
    sd = PhaseNetCore().init_params(gen).state_dict()
    out = {}
    for key, v in sd.items():
        _, i, mod, p = key.split(".")
        if p == "num_batches_tracked":
            continue
        if mod == "bn":
            lo, hi = {"weight": (0.5, 1.5), "bias": (-0.1, 0.1), "running_mean": (-0.1, 0.1),
                      "running_var": (0.5, 2.0)}[p]
            v = lo + (hi - lo) * torch.rand(v.shape, generator=gen)
        out[f"layers.{i}.{_PHASE_KEYS[mod]}.{p}"] = v
    return out


def _reference_fusion_sd(maps: int, seed: int = 0):
    """A seeded FusionNet state dict in fusion_net.pt's layout, with the
    unused `net.*` keys the published files carry."""
    gen = torch.Generator().manual_seed(seed)
    names = {f"enc{i}": f"encoder_layers.{i}" for i in range(3)}
    names.update({f"dec{i}": f"decoder_layers.{i}" for i in range(3)})
    names["bottleneck"] = "bottleneck_layer"
    out = {}
    for key, v in FusionNet(uncertainty_maps=maps).state_dict().items():
        mod, p = key.split(".")
        out[f"{names[mod]}.{p}"] = 0.1 * torch.randn(v.shape, generator=gen)
    out["net.0.weight"] = torch.zeros(4, 4)
    return out


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _close(ours, ref, tol=MODEL_TOL):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), rtol=0, atol=tol)


def _assert_same_sd(ours, want):
    assert sorted(ours) == sorted(want)
    for k, v in ours.items():
        assert v.dtype == want[k].dtype and v.shape == want[k].shape, k
        assert torch.equal(v, want[k]), k


def _save(tmp_path, obj, name):
    path = str(tmp_path / name)
    torch.save(obj, path)
    return path


@pytest.mark.parametrize("wrap", ["bare", "module", "epoch_module"])
def test_adacof_from_torch_equals_jax_tree_through_the_flax_converter(tmp_path, wrap):
    sd = _synthetic_adacof_sd(seed=1, prefix="" if wrap == "bare" else "module.")
    obj = {"epoch": 7, "state_dict": sd} if wrap == "epoch_module" else sd
    path = _save(tmp_path, obj, "ckpt.pth")
    ours = convert.load_adacof_weights(path)
    _assert_same_sd(ours, convert.adacof_from_flax(jx_convert.load_adacof_weights(path)))
    _assert_same_sd(convert.adacof_from_torch(obj), ours)  # a loaded dict as well as a path
    AdaCoFNet().load_state_dict(ours, strict=True)


def test_adacof_from_torch_module_matches_jax(tmp_path):
    sd = _synthetic_adacof_sd(seed=2, prefix="module.")
    path = _save(tmp_path, {"epoch": 1, "state_dict": sd}, "ckpt.pth")
    port = AdaCoFNet(max_offset=None).eval()  # JAX warps unclamped on the CPU
    port.load_state_dict(convert.load_adacof_weights(path), strict=True)
    f0, _, f2 = (x[None] for x in translation_triplet(64, 64, dx=2.0, dy=1.0, seed=3))
    ref = jax.jit(jx_adacof.AdaCoFNet(kernel_size=5, dilation=1).apply)(
        jx_convert.adacof_from_torch(path), jnp.asarray(f0), jnp.asarray(f2))
    with torch.no_grad():
        ours = port(_nchw(f0), _nchw(f2))
    for name in ("warped0", "warped2", "blended", "occlusion"):
        _close(_nhwc(getattr(ours, name)), getattr(ref, name))


def test_phase_net_from_torch_matches_jax(tmp_path):
    path = _save(tmp_path, reference_phase_sd(seed=4), "phase_net.pt")
    ours = convert.phase_net_from_torch(path)
    tree = jx_convert.phase_net_from_torch(path)
    _assert_same_sd(ours, convert.phase_net_from_flax(tree))
    port = PhaseNetCore().eval()
    port.load_state_dict(ours, strict=True)

    rng = np.random.default_rng(5)
    h = w = 96  # 8 band levels: every block, block 7 reused once
    img = rng.uniform(0, 1, (6, h, w)).astype(np.float32)
    vals = jx_pyr.decompose(jnp.asarray(img),
                            jx_pyr.make_filters(h, w, jx_pyr.max_pyr_height(h, w)))
    low, phases, amps = jx_decomp.concat_for_net(jx_decomp.split_frames(vals, 2))
    lown, pn, an, _ = jx_phase.normalize_inputs(low, phases, amps)
    ref_low, ref_ph, ref_amp = jax.jit(jx_phase.PhaseNetCore(num_img=2).apply)(
        jax.tree.map(jnp.asarray, tree), lown, pn, an)
    with torch.no_grad():
        low_p, ph_p, amp_p = port(_nchw(lown), [_nchw(p) for p in pn], [_nchw(a) for a in an])
    _close(_nhwc(low_p), ref_low)
    for a, b in zip(ph_p + amp_p, list(ref_ph) + list(ref_amp)):
        _close(_nhwc(a), b)


@pytest.mark.parametrize("maps", [3, 0])
def test_fusion_net_from_torch_matches_jax(tmp_path, maps):
    name = "fusion_net.pt" if maps else "fusion_net_nouncertainty.pt"
    path = _save(tmp_path, _reference_fusion_sd(maps, seed=6), name)
    ours = convert.load_fusion_weights(path)
    tree = jx_convert.load_fusion_weights(path, uncertainty_maps=maps)
    _assert_same_sd(ours, convert.fusion_net_from_flax(tree))
    port = FusionNet(uncertainty_maps=maps, variant=0).eval()
    port.load_state_dict(ours, strict=True)
    rng = np.random.default_rng(7)
    base, ada, ph = (rng.uniform(0, 1, (2, 24, 32, 3)).astype(np.float32) for _ in range(3))
    other = rng.uniform(0, 1, (2, 24, 32, 6)).astype(np.float32)
    m = rng.uniform(0, 1, (2, 24, 32, maps)).astype(np.float32) if maps else None
    ref = jax.jit(lambda *a: jx_fusion.FusionNet(uncertainty_maps=maps).apply(
        jax.tree.map(jnp.asarray, tree), *a, variant=0))(base, ada, ph, other, m)
    with torch.no_grad():
        out = port(_nchw(base), _nchw(ada), _nchw(ph), _nchw(other), _nchw(m) if maps else None)
    _close(_nhwc(out), ref)


def test_bundled_msgpack_loads_as_before():
    """load_*_weights of the bundled .msgpack files: the flax converters
    over the port's msgpack reader (which tests/test_torch_isolation.py
    holds against flax's), loading strictly into the modules."""
    ada = convert.load_adacof_weights(ADACOF_CKPT)
    _assert_same_sd(ada, convert.adacof_from_flax(msgpack_io.load(ADACOF_CKPT)))
    AdaCoFNet().load_state_dict(ada, strict=True)
    fusion = convert.load_fusion_weights(FUSION_CKPT)
    _assert_same_sd(fusion, convert.fusion_net_from_flax(msgpack_io.load(FUSION_CKPT)))
    FusionNet(variant=2).load_state_dict(fusion, strict=True)
