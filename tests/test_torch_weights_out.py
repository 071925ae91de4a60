"""Weights out of the port: utils/msgpack_io.py's writer, utils/checkpoint.py's
save_msgpack / load_msgpack, the inverse converters of utils/convert.py and
merge_matching_params, against flax and the JAX package on the CPU.

- `dumps` writes what flax.serialization.to_bytes writes, byte for byte, on
  the bundled trees, a PhaseNet tree with BN statistics and a tree of odd
  dtypes and sizes (every msgpack length form the writer has);
- `*_to_flax(*_from_flax(t))` is t, bit for bit and in flax's key order,
  for AdaCoF, FusionNet and PhaseNet (BN statistics included);
- a port state dict written with save_msgpack reads in JAX's loaders, and
  JAX's modules give the port modules' outputs within 1e-4 (float32
  convolutions summed in another order through a deep U-Net);
- merge_matching_params of a variant-0 FusionNet into a variant-2 one gives
  JAX's fresh set;
- weights trained with the port's make_adacof_trainer / make_fusion_trainer
  go out as .msgpack and come back bit for bit through load_adacof_weights /
  load_fusion_weights and the command line's --adacof_checkpoint.
"""

import os

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from fmvfi_tpu.models import adacof as jx_adacof
from fmvfi_tpu.models import fusion_net as jx_fusion
from fmvfi_tpu.models import phase_net as jx_phase
from fmvfi_tpu.utils import checkpoint as jx_checkpoint
from fmvfi_tpu.utils import convert as jx_convert
from fmvfi_tpu_torch import cli as pt_cli
from fmvfi_tpu_torch.eval.synth import translation_triplet
from fmvfi_tpu_torch.models.adacof import AdaCoFNet
from fmvfi_tpu_torch.models.fusion_net import FusionNet
from fmvfi_tpu_torch.models.phase_net import PhaseNetCore
from fmvfi_tpu_torch.pipeline.interpolate import adacof_interpolate
from fmvfi_tpu_torch.pipeline.video import quantize
from fmvfi_tpu_torch.train.trainer import make_adacof_trainer, make_fusion_trainer
from fmvfi_tpu_torch.utils import convert, msgpack_io
from fmvfi_tpu_torch.utils.checkpoint import load_msgpack, save_msgpack
from fmvfi_tpu_torch.utils.imageio import imread

MODEL_TOL = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPTS = {
    "adacof": os.path.join(ROOT, "checkpoints", "adacof_synth_demo.msgpack"),
    "fusion": os.path.join(ROOT, "checkpoints", "fusion_synth_demo.msgpack"),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """PyTorch's CPU ops in one thread: the suite runs in several processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _leaves(tree, pre=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, pre + (k,))
        else:
            yield pre + (k,), v


def _phase_tree():
    """A fixed-key flax PhaseNetCore (8 blocks) with BN affine parameters
    and running statistics away from identity."""
    low = jnp.zeros((1, 4, 4, 2))
    lev = [jnp.zeros((1, 4, 4, 8))] * 7
    tree = jax.tree.map(np.asarray, jax.jit(
        lambda k: jx_phase.PhaseNetCore(num_img=2).init(k, low, lev, lev))(jax.random.key(0)))
    rng = np.random.default_rng(11)
    for name, blk in tree["params"].items():
        c = blk["bn"]["scale"].shape
        blk["bn"]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        blk["bn"]["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
        st = tree["batch_stats"][name]["bn"]
        st["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
        st["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
    return tree


def _tree(name):
    if name == "phase":
        return _phase_tree()
    with open(CKPTS[name], "rb") as f:
        return serialization.msgpack_restore(f.read())


def _odd_tree():
    """Every length form of the writer: fixmap and map16, fixstr and str8,
    bin8/16/32, fixext and ext8/16/32, shapes from 0-d to 16-d, every
    dtype kind flax files may hold."""
    rng = np.random.default_rng(0)
    return {
        "z": {"b": np.arange(3, dtype=np.int64), "a": rng.random((2, 3)).astype(np.float32)},
        "big": rng.random((300, 300)).astype(np.float32),
        "scalar": np.ones((), np.float64),
        "bool": np.array([True, False]),
        "k" * 40: {str(i): np.full((i,), i, np.uint16) for i in range(20)},
        "empty": np.zeros((0, 4), np.float32),
        "wide": np.zeros((70000,), np.uint8),
        "deep": np.zeros((2,) * 16, np.int8),
        "one": np.zeros((1,), np.int8),
        "huge": np.zeros((1, 70000, 200), np.uint8),
    }


@pytest.mark.parametrize("name", ["adacof", "fusion", "phase", "odd"])
def test_dumps_matches_flax_to_bytes(name, tmp_path):
    tree = _odd_tree() if name == "odd" else _tree(name)
    data = msgpack_io.dumps(tree)
    assert data == serialization.to_bytes(tree)
    path = tmp_path / "tree.msgpack"  # dump: the same bytes, in a file
    msgpack_io.dump(str(path), tree)
    assert path.read_bytes() == data
    path.unlink()
    if name in CKPTS:  # the bundled file itself, read and written back
        with open(CKPTS[name], "rb") as f:
            raw = f.read()
        assert msgpack_io.dumps(msgpack_io.loads(raw)) == raw
    back = msgpack_io.loads(data)
    assert [k for k, _ in _leaves(back)] == [k for k, _ in _leaves(tree)]
    for (k, a), (_, b) in zip(_leaves(back), _leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b)


def test_dumps_rejects_what_flax_files_never_hold():
    for bad in ({1: np.zeros(1)}, {"a": [np.zeros(1)]}, {"a": np.zeros(1, np.complex64)},
                {"a": np.float32(1.0)}):
        with pytest.raises(msgpack_io.MsgpackError):
            msgpack_io.dumps(bad)


_TO_FLAX = {
    "adacof": (convert.adacof_from_flax, convert.adacof_to_flax),
    "fusion": (convert.fusion_net_from_flax, convert.fusion_net_to_flax),
    "phase": (convert.phase_net_from_flax, convert.phase_net_to_flax),
}


@pytest.mark.parametrize("name", ["adacof", "fusion", "phase"])
def test_to_flax_inverts_from_flax(name):
    from_flax, to_flax = _TO_FLAX[name]
    tree = _tree(name)
    back = to_flax(from_flax(tree))
    assert [k for k, _ in _leaves(back)] == [k for k, _ in _leaves(tree)]  # flax's order
    for (k, a), (_, b) in zip(_leaves(back), _leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape and a.flags.c_contiguous, k
        np.testing.assert_array_equal(a, b)
    assert msgpack_io.dumps(back) == serialization.to_bytes(tree)


def test_to_flax_refuses_keys_it_cannot_place():
    sd = convert.fusion_net_from_flax(_tree("fusion"))
    sd["enc0.running_mean"] = torch.zeros(3)
    with pytest.raises(ValueError, match="enc0.running_mean"):
        convert.fusion_net_to_flax(sd)


def _seeded_port(name):
    """A port module with random weights (BN statistics away from identity
    for PhaseNet, a non-zero gated head for the variant-2 FusionNet)."""
    torch.manual_seed(5)
    if name == "adacof":
        return AdaCoFNet(max_offset=None).eval()  # the JAX AdaCoF on the CPU: unclamped
    if name == "fusion":
        m = FusionNet(variant=2).eval()
        with torch.no_grad():
            m.dec2.weight.normal_(0, 0.5)
        return m
    m = PhaseNetCore().init_params(torch.Generator().manual_seed(5)).eval()
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for blk in m.blocks:
            blk.bn.running_mean.uniform_(-0.1, 0.1, generator=gen)
            blk.bn.running_var.uniform_(0.5, 2.0, generator=gen)
            blk.bn.weight.uniform_(0.5, 1.5, generator=gen)
    return m


@pytest.mark.parametrize("name", ["adacof", "fusion", "phase"])
def test_port_weights_read_in_jax(tmp_path, name):
    """A port state dict written with save_msgpack loads through JAX's
    loaders (load_adacof_weights / load_fusion_weights, or load_msgpack
    against PhaseNetCore's template), and JAX's module gives the port
    module's output within 1e-4."""
    port = _seeded_port(name)
    path = str(tmp_path / f"{name}.msgpack")
    save_msgpack(path, _TO_FLAX[name][1](port.state_dict()))
    rng = np.random.default_rng(7)
    if name == "adacof":
        tree = jx_convert.load_adacof_weights(path)
        f0, _, f2 = translation_triplet(64, 64, dx=2.0, dy=1.0, seed=0)
        ref = jax.jit(jx_adacof.AdaCoFNet(kernel_size=5, dilation=1).apply)(
            tree, jnp.asarray(f0[None]), jnp.asarray(f2[None])).blended
        with torch.no_grad():
            ours = port(_nchw(f0[None]), _nchw(f2[None])).blended
    elif name == "fusion":
        tree = jx_convert.load_fusion_weights(path)
        assert jx_fusion.infer_variant(tree) == 2
        base, ada, ph = (rng.uniform(0, 1, (2, 24, 32, 3)).astype(np.float32) for _ in range(3))
        other = rng.uniform(0, 1, (2, 24, 32, 6)).astype(np.float32)
        m = rng.uniform(0, 1, (2, 24, 32, 3)).astype(np.float32)
        ref = jax.jit(lambda *a: jx_fusion.FusionNet(uncertainty_maps=3).apply(
            tree, *a, variant=2))(base, ada, ph, other, m)
        with torch.no_grad():
            ours = port(*(_nchw(a) for a in (base, ada, ph, other, m)))
    else:
        low = jnp.zeros((1, 4, 4, 2))
        lev = [jnp.zeros((1, 4, 4, 8))] * 7
        template = jax.jit(lambda k: jx_phase.PhaseNetCore(num_img=2).init(k, low, lev, lev))(
            jax.random.key(1))
        tree = jx_checkpoint.load_msgpack(path, template)
        lown = rng.normal(0, 1, (2, 6, 6, 2)).astype(np.float32)
        pn = [rng.normal(0, 1, (2, 6 + 2 * i, 6 + 2 * i, 8)).astype(np.float32) for i in range(8)]
        an = [rng.uniform(0, 1, p.shape).astype(np.float32) for p in pn]
        ref = jax.jit(jx_phase.PhaseNetCore(num_img=2).apply)(tree, lown, pn, an)[1][-1]
        with torch.no_grad():
            ours = port(_nchw(lown), [_nchw(p) for p in pn], [_nchw(a) for a in an])[1][-1]
    np.testing.assert_allclose(_nhwc(ours), np.asarray(ref), rtol=0, atol=MODEL_TOL)


def test_merge_matching_params_matches_jax():
    """A variant-2 FusionNet warm-started from a variant-0 one: only the
    widened dec2 head stays fresh, on both sides."""
    z = jnp.zeros((1, 16, 16, 3))

    def init(variant, key):
        return jax.tree.map(np.asarray, jax.jit(lambda k: jx_fusion.FusionNet().init(
            k, z, z, z, jnp.zeros((1, 16, 16, 6)), jnp.zeros((1, 16, 16, 3)), variant))(
            jax.random.key(key)))

    old, new = init(0, 0), init(2, 1)
    jx_merged, jx_fresh = jx_convert.merge_matching_params(new, old)
    pt_old, pt_new = convert.fusion_net_from_flax(old), convert.fusion_net_from_flax(new)
    merged, fresh = convert.merge_matching_params(pt_new, pt_old)
    names = {"kernel": "weight", "bias": "bias"}
    jx_names = sorted(".".join(p.strip("[]'") for p in k.split("][")[1:-1]) + "."
                      + names[k.split("'")[-2]] for k in jx_fresh)
    assert sorted(fresh) == jx_names == ["dec2.bias", "dec2.weight"]
    assert list(merged) == list(pt_new)
    for k, v in convert.fusion_net_from_flax(jx_merged).items():
        assert torch.equal(merged[k], v), k
    assert merged["enc0.weight"] is pt_old["enc0.weight"]


def test_load_msgpack_checks_its_template(tmp_path):
    tree = {"params": {"a": np.zeros((2, 3), np.float32), "b": np.ones(4, np.float32)}}
    path = str(tmp_path / "sub" / "t.msgpack")
    save_msgpack(path, tree)  # makes the directory
    assert os.listdir(tmp_path / "sub") == ["t.msgpack"]  # no temporary left
    back = load_msgpack(path)
    np.testing.assert_array_equal(back["params"]["b"], tree["params"]["b"])
    like = {"params": {"b": np.zeros(4, np.float32)}}
    assert list(load_msgpack(path, like)["params"]) == ["b"]
    with pytest.raises(ValueError, match="not in the file"):
        load_msgpack(path, {"params": {"c": np.zeros(1)}})
    with pytest.raises(ValueError, match="the template"):
        load_msgpack(path, {"params": {"a": np.zeros((3, 2))}})
    # JAX's reader takes the file too
    got = jx_checkpoint.load_msgpack(path, tree)
    np.testing.assert_array_equal(got["params"]["a"], tree["params"]["a"])


def _batch(size, n):
    items = [translation_triplet(size, size, dx=2.0 + i, dy=1.0, seed=i) for i in range(n)]
    return tuple(np.stack([it[j] for it in items]) for j in range(3))


def test_port_trained_weights_go_out_as_msgpack(tmp_path):
    """One AdaCoF and one FusionNet training step on the port, written as
    .msgpack: load_adacof_weights / load_fusion_weights give the trained
    tensors back bit for bit, and `interpolate --adacof_checkpoint` with
    that file writes the PNG the trained model gives in memory."""
    state, step = make_adacof_trainer(device="cpu", h=32, w=32)
    state, _ = step(state, _batch(32, 2))
    trained = state.model.eval()
    ada_path = str(tmp_path / "adacof.msgpack")
    save_msgpack(ada_path, convert.adacof_to_flax(trained.state_dict()))
    back = convert.load_adacof_weights(ada_path)
    for k, v in trained.state_dict().items():
        assert torch.equal(back[k], v), k

    phase = PhaseNetCore().init_params(torch.Generator().manual_seed(0)).eval()
    fstate, fstep = make_fusion_trainer(phase, trained, variant=2, device="cpu")
    fstate, _ = fstep(fstate, _batch(32, 1))
    fusion_path = str(tmp_path / "fusion.msgpack")
    save_msgpack(fusion_path, convert.fusion_net_to_flax(fstate.model.state_dict()))
    fback = convert.load_fusion_weights(fusion_path)
    for k, v in fstate.model.state_dict().items():
        assert torch.equal(fback[k], v), k

    f1, _, f2 = translation_triplet(32, 32, dx=2.0, dy=1.0, seed=9)
    for name, f in (("a.png", f1), ("b.png", f2)):
        cv2.imwrite(str(tmp_path / name), cv2.cvtColor(quantize(f), cv2.COLOR_RGB2BGR))
    pt_cli.main(["interpolate", "--first_frame", str(tmp_path / "a.png"), "--second_frame",
                 str(tmp_path / "b.png"), "--output_frame", str(tmp_path / "out.png"),
                 "--method", "adacof", "--adacof_checkpoint", ada_path, "--device", "cpu"])
    a, b = (imread(str(tmp_path / n)).astype(np.float32) / 255.0 for n in ("a.png", "b.png"))
    want = quantize(adacof_interpolate(trained, a[None], b[None], device="cpu")[0].numpy())
    np.testing.assert_array_equal(imread(str(tmp_path / "out.png")), want)
