"""bfloat16 serving (`compute_dtype`) of fmvfi_tpu_torch against the JAX
package's `dtype=jnp.bfloat16`, on the CPU, from the same numpy inputs and
weights carried with utils/convert.py.

JAX runs jitted, compiled with XLA's `xla_allow_excess_precision` off: by
default XLA:CPU may drop a bfloat16 rounding wherever a fusion keeps the
float32 value, so the default compile rounds at places of the compiler's
choosing, not where the flax program says.  With it off, `test_phase_block_rounds_as_flax` holds a PhaseNet
block through 1x1 convolutions bit-equal to the port's, layer by layer.

What remains is float32 accumulation order: XLA's and torch's convolutions
sum a 3x3x64 window in different orders, and a sum that lands on the other
side of a bfloat16 rounding edge (~2e-4 of a 3x3 layer's outputs) moves by
one unit there.  Through PhaseNet's chain of 3x3 blocks such units spread
level by level (0.6% of the elements differ at the first 3x3 level, 30-40%
at the finest), so a few elements of the deep levels reach 0.55-0.72 of
JAX's own bfloat16-vs-float32 gap in max abs, one unit of a prediction in
[0.5, 1) (and FusionNet v0's output 0.72).  Per model (AdaCoF with the
bundled weights, a seeded PhaseNetCore with seeded BN statistics, FusionNet
variants 0 and 2), on the 64x64 translation scene's own inputs, each tensor
is therefore held at half of JAX's gap in RMS and within JAX's gap in max
abs, and away from the port's float32 output; the layer test holds the
rounding points themselves.
- Forward hooks: every Conv2d of the three nets takes bfloat16 under
  compute_dtype=torch.bfloat16 and float32 without; the warp's frames and
  fields are float32 either way.
- The pipeline against JAX's (>= 40 dB), the bfloat16 quality guard of
  tests/test_golden.py on the port (128x128), seq_chunk and the stream in
  bfloat16 against bfloat16 per pair, and the values compute_dtype refuses.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from fmvfi_tpu.eval.synth import translation_triplet
from fmvfi_tpu.models import adacof as jx_ada
from fmvfi_tpu.models import fusion_net as jx_fusion
from fmvfi_tpu.models import phase_net as jx_phase
from fmvfi_tpu.ops import color as jx_color
from fmvfi_tpu.ops import decomp as jx_decomp
from fmvfi_tpu.ops import pyramid as jx_pyr
from fmvfi_tpu.pipeline import interpolate as jx_pipe
from fmvfi_tpu_torch.models.adacof import AdaCoFNet
from fmvfi_tpu_torch.models.fusion_net import FusionNet
from fmvfi_tpu_torch.models.phase_net import PhaseNetCore
from fmvfi_tpu_torch.pipeline import interpolate as pt_pipe
from fmvfi_tpu_torch.utils import convert

BF16 = jnp.bfloat16
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ADACOF_CKPT = os.path.join(ROOT, "checkpoints", "adacof_synth_demo.msgpack")
FUSION_CKPT = os.path.join(ROOT, "checkpoints", "fusion_synth_demo.msgpack")
SIZE = 64
GAP_SHARE = 0.5  # the port's bf16 against JAX's bf16, of JAX's bf16-vs-fp32 gap (RMS)
FLIP_SHARE = 2e-3  # of one layer's outputs, that float32 noise may move by one unit
PIPE_DB = 40.0  # the port's bf16 pipeline against JAX's
GUARD_DB, GUARD_LOSS_DB = 35.0, 0.35  # tests/test_golden.py's bf16 guard
SAME_PATH_DB = 40.0  # seq_chunk and the stream in bf16 against bf16 per pair
SMALL = 32  # the hooks, seq_chunk and the stream


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's small CPU work: beside the
    suite's other workers, spinning thread pools cost more than they give."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _exact_jit(fn):
    """jax.jit(fn), compiled with XLA's excess precision off: bfloat16
    values are rounded where the program rounds them."""
    jitted = jax.jit(fn)
    return lambda *a: jitted.lower(*a).compile(
        compiler_options={"xla_allow_excess_precision": False})(*a)


def _restore(path):
    with open(path, "rb") as f:
        return serialization.msgpack_restore(f.read())


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else -10.0 * np.log10(mse)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a, np.float32), -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.detach().float().numpy(), 1, -1)


def _phase_tree():
    """A fixed-key flax init of the 8 blocks with seeded BN affine parameters
    and running statistics (an identity BN would hide its rounding)."""
    low = jnp.zeros((1, 4, 4, 2))
    lev = [jnp.zeros((1, 4, 4, 8))] * 7
    tree = jax.jit(lambda k: jx_phase.PhaseNetCore(num_img=2).init(k, low, lev, lev))(
        jax.random.key(0))
    tree = jax.tree.map(np.asarray, tree)
    rng = np.random.default_rng(11)
    for name, blk in tree["params"].items():
        c = blk["bn"]["scale"].shape
        blk["bn"]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        blk["bn"]["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
        st = tree["batch_stats"][name]["bn"]
        st["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
        st["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
    return tree


def _fusion_v0_tree():
    z = jnp.zeros((1, 16, 16, 3))
    init = jax.jit(lambda k: jx_fusion.FusionNet().init(k, z, z, z, jnp.zeros((1, 16, 16, 6)), z))
    return jax.tree.map(np.asarray, init(jax.random.key(1)))


@pytest.fixture(scope="module")
def weights():
    """(JAX FusionWeights, port FusionModels, FusionNet v0 flax tree, port v0):
    the bundled AdaCoF and variant-2 FusionNet, the seeded PhaseNet."""
    phase_tree, ada_tree, fusion_tree = _phase_tree(), _restore(ADACOF_CKPT), _restore(FUSION_CKPT)
    jx = jx_pipe.FusionWeights(phase_net=phase_tree, adacof=ada_tree, fusion_net=fusion_tree)
    phase = PhaseNetCore().eval()
    phase.load_state_dict(convert.phase_net_from_flax(phase_tree))
    ada = AdaCoFNet(max_offset=None).eval()  # the JAX AdaCoF on the CPU warps unclamped
    ada.load_state_dict(convert.load_adacof_weights(ADACOF_CKPT))
    fusion = FusionNet(uncertainty_maps=3, variant=2).eval()
    fusion.load_state_dict(convert.load_fusion_weights(FUSION_CKPT))
    v0_tree = _fusion_v0_tree()
    v0 = FusionNet(uncertainty_maps=3, variant=0).eval()
    v0.load_state_dict(convert.fusion_net_from_flax(v0_tree))
    return jx, pt_pipe.FusionModels(phase, ada, fusion), v0_tree, v0


@pytest.fixture(scope="module")
def scene():
    f1, mid, f2 = translation_triplet(SIZE, SIZE, dx=2.0, dy=1.0, seed=0)
    return f1[None], mid[None], f2[None]


def _gaps(name, jx32, jx16, pt32, pt16):
    """Per tensor, printed: the RMS and max-abs gaps of JAX bf16 against JAX
    fp32 and of the port's bf16 against JAX bf16, and the port's bf16
    against its fp32 (max abs)."""
    out = []
    for i, (a, b, c, d) in enumerate(zip(jx32, jx16, pt32, pt16)):
        a, b, c, d = (np.asarray(t, np.float64) for t in (a, b, c, d))
        gap, port, own = (float(np.abs(x - y).max()) for x, y in ((b, a), (d, b), (d, c)))
        gap_rms, port_rms = (float(np.sqrt(np.mean((x - y) ** 2))) for x, y in ((b, a), (d, b)))
        print(f"{name}[{i}] JAX bf16-fp32 max {gap:.3e} rms {gap_rms:.3e}; port-JAX bf16 "
              f"max {port:.3e} ({port / gap:.3f}) rms {port_rms:.3e} ({port_rms / gap_rms:.3f}), "
              f"{(d != b).mean():.4f} of {d.size} differ; port bf16-fp32 max {own:.3e}")
        out.append((gap, port, own, gap_rms, port_rms))
    return out


def _adacof(jx, pt, scene):
    f1, _, f2 = scene

    def run(dt):
        return _exact_jit(lambda a, b: jx_ada.AdaCoFNet(dtype=dt).apply(jx.adacof, a, b).blended)

    with torch.no_grad():
        p32 = pt.adacof(_nchw(f1), _nchw(f2)).blended
        p16 = pt.adacof(_nchw(f1), _nchw(f2), compute_dtype=torch.bfloat16).blended
    return _gaps("adacof.blended", [run(None)(f1, f2)], [run(BF16)(f1, f2)], [_nhwc(p32)],
                 [_nhwc(p16)])


def _phase_inputs(scene):
    """PhaseNet's normalized inputs for the scene's pair, as the pipeline
    builds them (Lab channel batch, pyramid, concat, normalize)."""
    f1, _, f2 = scene
    lab = [jx_pipe._to_chan_batch(jx_color.rgb_to_lab(jnp.asarray(f))) for f in (f1, f2)]
    filters = jx_pyr.make_filters(SIZE, SIZE, jx_pyr.max_pyr_height(SIZE, SIZE))
    vals = jx_pyr.decompose(jnp.concatenate(lab, 0), filters)
    low, phases, amps = jx_decomp.concat_for_net(jx_decomp.split_frames(vals, 2))
    lown, pn, an, _ = jx_phase.normalize_inputs(low, phases, amps)
    return np.asarray(lown), [np.asarray(p) for p in pn], [np.asarray(a) for a in an]


def _phase(jx, pt, scene):
    lown, pn, an = _phase_inputs(scene)

    def run(dt):
        return _exact_jit(lambda lo, p, a: jx_phase.PhaseNetCore(num_img=2, dtype=dt).apply(
            jx.phase_net, lo, p, a))(lown, pn, an)

    def flat(out):
        return [out[0]] + list(out[1]) + list(out[2])

    j32, j16 = flat(run(None)), flat(run(BF16))
    args = (_nchw(lown), [_nchw(p) for p in pn], [_nchw(a) for a in an])
    with torch.no_grad():
        p32 = [_nhwc(t) for t in flat(pt.phase_net(*args))]
        p16 = [_nhwc(t) for t in flat(pt.phase_net(*args, compute_dtype=torch.bfloat16))]
    return _gaps("phase_net[low, phases, amps]", j32, j16, p32, p16)


@pytest.fixture(scope="module")
def fusion_inputs(weights, scene):
    """FusionNet's inputs for the scene, from JAX's float32 pipeline: base,
    adacof, phase, the Lab frames and the three maps."""
    jx = weights[0]
    f1, _, f2 = scene
    _, parts = jax.jit(lambda a, b: jx_pipe.fusion_interpolate(
        jx, a, b, variant=2, return_parts=True))(f1, f2)
    other = jnp.concatenate([jx_color.rgb_to_lab(jnp.asarray(f)) for f in (f1, f2)], -1)
    return [np.asarray(t) for t in (parts["baseline"], parts["adacof"], parts["phase"], other,
                                    parts["maps"])]


def _fusion(tree, port, variant, inputs):
    def run(dt):
        return _exact_jit(lambda *a: jx_fusion.FusionNet(dtype=dt).apply(
            tree, *a, variant=variant))(*inputs)

    args = [_nchw(a) for a in inputs]
    with torch.no_grad():
        p32, p16 = port(*args), port(*args, compute_dtype=torch.bfloat16)
    return _gaps(f"fusion_net v{variant}", [run(None)], [run(BF16)], [_nhwc(p32)], [_nhwc(p16)])


@pytest.mark.parametrize("model", ["adacof", "phase_net", "fusion_v0", "fusion_v2"])
def test_models_round_where_flax_rounds(weights, scene, fusion_inputs, model):
    jx, pt, v0_tree, v0 = weights
    if model == "adacof":
        gaps = _adacof(jx, pt, scene)
    elif model == "phase_net":
        gaps = _phase(jx, pt, scene)
    elif model == "fusion_v0":
        gaps = _fusion(v0_tree, v0, 0, fusion_inputs)
    else:
        gaps = _fusion(jx.fusion_net, pt.fusion_net, 2, fusion_inputs)
    for i, (gap, port, own, gap_rms, port_rms) in enumerate(gaps):
        assert gap > 0 and own > 0, f"{model}[{i}]: bf16 is not applied ({gap}, {own})"
        assert port_rms <= GAP_SHARE * gap_rms, (
            f"{model}[{i}]: port bf16 {port_rms:.3e} (RMS) from JAX bf16, over {GAP_SHARE} of "
            f"JAX's own bf16-vs-fp32 gap {gap_rms:.3e}")
        assert port <= gap, f"{model}[{i}]: port bf16 {port:.3e} from JAX bf16 > its gap {gap:.3e}"


@pytest.mark.parametrize("kernel,c_in", [(1, 81), (3, 88)])
def test_phase_block_rounds_as_flax(kernel, c_in):
    """One PhaseNet block in bf16 (conv, BN on running statistics, ELU,
    conv, ELU, 1x1 conv, tanh), each layer on flax's own input to it: ELU
    and tanh bit-equal; a layer with float32 work before its rounding (a
    convolution's sum, BN's rsqrt and multiply-add) at most FLIP_SHARE of
    its outputs apart, each by one bfloat16 unit (where the float32 value
    sits at a rounding edge and the two libraries' last float32 bit
    differ)."""
    import torch.nn.functional as F

    from fmvfi_tpu_torch.models import flax_bn
    from fmvfi_tpu_torch.models.phase_net import PhaseNetBlock

    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (3, 12, 12, c_in)).astype(np.float32)
    blk = jx_phase.PhaseNetBlock(64, 8, kernel, BF16)
    tree = jax.tree.map(np.asarray, jax.jit(blk.init)(jax.random.key(0), x))
    st, prm = tree["batch_stats"]["bn"], tree["params"]["bn"]
    st["mean"], st["var"] = rng.normal(0, 0.2, 64).astype(np.float32), rng.uniform(0.5, 1.5, 64).astype(np.float32)
    prm["scale"], prm["bias"] = rng.uniform(0.5, 1.5, 64).astype(np.float32), rng.normal(0, 0.1, 64).astype(np.float32)
    apply = jax.jit(lambda v, a: blk.apply(v, a, capture_intermediates=True))
    (feat, pred), inter = apply.lower(tree, x).compile(
        compiler_options={"xla_allow_excess_precision": False})(tree, x)
    inter = inter["intermediates"]

    port = PhaseNetBlock(c_in, 64, 8, kernel).eval()
    sd = {f"{n}.{k}": torch.from_numpy(np.asarray(v)) for n, k, v in
          [(n, "weight", np.transpose(tree["params"][n]["kernel"], (3, 2, 0, 1))) for n in ("conv1", "conv2", "pred")]
          + [(n, "bias", tree["params"][n]["bias"]) for n in ("conv1", "conv2", "pred")]}
    sd.update({"bn.weight": torch.from_numpy(prm["scale"]), "bn.bias": torch.from_numpy(prm["bias"]),
               "bn.running_mean": torch.from_numpy(st["mean"]), "bn.running_var": torch.from_numpy(st["var"]),
               "bn.num_batches_tracked": torch.tensor(0)})
    port.load_state_dict(sd)

    def ref(name):
        return torch.from_numpy(np.moveaxis(np.asarray(inter[name]["__call__"][0].astype(jnp.float32)),
                                            -1, 1)).to(torch.bfloat16)

    def rpad(z):
        p = port.pad
        return F.pad(z, (p, p, p, p), mode="reflect") if p else z

    with torch.no_grad():
        layers = {
            "conv1": port.conv1(rpad(_nchw(x).to(torch.bfloat16))),
            "bn": flax_bn.normalize(ref("conv1"), port.bn, False),
            "conv2": port.conv2(rpad(F.elu(ref("bn")))),
            "pred": port.pred(F.elu(ref("conv2"))),
        }
        layers["feat"], layers["tanh"] = F.elu(ref("conv2")), torch.tanh(ref("pred"))
    want = {"feat": feat, "tanh": pred}
    for name, got in layers.items():
        exp = (ref(name) if name not in want else
               torch.from_numpy(np.moveaxis(np.asarray(want[name].astype(jnp.float32)), -1, 1)).to(torch.bfloat16))
        assert got.dtype == torch.bfloat16, name
        diff = got.float() != exp.float()
        spacing = torch.abs(exp.float()) * 2.0**-7 + 2.0**-126  # one bfloat16 unit, bounded above
        flips = name in ("conv1", "bn", "conv2", "pred")
        share = float(diff.float().mean())
        print(f"block k{kernel} {name}: {share:.2e} of {diff.numel()} differ")
        if not flips:
            assert share == 0.0, f"{name}: {share:.2e} of the outputs differ from flax's"
        else:
            assert share <= FLIP_SHARE, f"{name}: {share:.2e} of the outputs differ"
            assert bool(((got.float() - exp.float()).abs() <= spacing).all()), name


def test_convs_take_the_compute_dtype(weights):
    _, pt, _, _ = weights
    f1, _, f2 = (f[None] for f in translation_triplet(SMALL, SMALL, dx=2.0, dy=1.0, seed=0))
    seen, fields = [], []

    def hook(module, inputs):
        seen.append(inputs[0].dtype)

    def recording_warp(x, w, a, b, *rest):
        fields.append({x.dtype, w.dtype, a.dtype, b.dtype})
        return warp(x, w, a, b, *rest)

    warp = pt.adacof.warp
    convs = [m for net in pt for m in net.modules() if isinstance(m, torch.nn.Conv2d)]
    handles = [m.register_forward_pre_hook(hook) for m in convs]
    pt.adacof.warp = recording_warp
    try:
        for dt, want in ((torch.bfloat16, torch.bfloat16), (None, torch.float32)):
            seen.clear()
            fields.clear()
            out = pt_pipe.fusion_interpolate(pt, f1, f2, device="cpu", compute_dtype=dt)
            assert out.dtype == torch.float32
            assert set(seen) == {want} and len(seen) >= len(convs), (dt, set(seen), len(seen))
            assert len(fields) == 3 and all(s == {torch.float32} for s in fields), (dt, fields)
    finally:
        pt.adacof.warp = warp
        for h in handles:
            h.remove()


def test_fusion_interpolate_bf16_matches_jax(weights, scene):
    jx, pt, _, _ = weights
    f1, mid, f2 = scene
    ref = jax.jit(lambda a, b: jx_pipe.fusion_interpolate(
        jx, a, b, variant=2, compute_dtype=BF16))(f1, f2)
    ours = pt_pipe.fusion_interpolate(pt, f1, f2, device="cpu", compute_dtype=torch.bfloat16)
    db = _psnr(ours.numpy(), ref)
    print(f"pipeline bf16 port vs JAX {db:.2f} dB")
    assert ours.dtype == torch.float32 and ours.shape == (1, SIZE, SIZE, 3)
    assert db >= PIPE_DB


def test_bf16_quality_guard(weights):
    """tests/test_golden.py's guard of the bf16 pipeline, on the port: the
    bundled weights, the seeded PhaseNet, the 128x128 translation scene."""
    _, pt, _, _ = weights
    f1, mid, f2 = translation_triplet(128, 128, dx=2.0, dy=1.0, seed=0)
    fp32 = pt_pipe.fusion_interpolate(pt, f1[None], f2[None], device="cpu")[0].numpy()
    bf16 = pt_pipe.fusion_interpolate(pt, f1[None], f2[None], device="cpu",
                                      compute_dtype=torch.bfloat16)[0].numpy()
    agree, loss = _psnr(bf16, fp32), _psnr(fp32, mid) - _psnr(bf16, mid)
    print(f"guard: bf16 vs fp32 {agree:.2f} dB, loss to the truth {loss:.4f} dB")
    assert agree >= GUARD_DB
    assert loss < GUARD_LOSS_DB


def test_seq_chunk_and_stream_bf16_match_per_pair(weights):
    _, pt, _, _ = weights
    bf = torch.bfloat16
    clip = [translation_triplet(SMALL, SMALL, dx=2.0 * i, dy=1.0 * i, seed=0)[0] for i in range(3)]
    per_pair = [pt_pipe.fusion_interpolate(pt, a[None], b[None], device="cpu", compute_dtype=bf)[0]
                for a, b in zip(clip, clip[1:])]
    chunked = pt_pipe.fusion_interpolate(pt, np.stack(clip[:-1]), np.stack(clip[1:]), device="cpu",
                                         compute_dtype=bf, seq_chunk=1)
    carry = pt_pipe.fusion_stream_init(clip[0][None], device="cpu")
    carry, outs = pt_pipe.fusion_stream_scan(pt, carry, np.stack(clip[1:] + clip[-1:])[:, None],
                                             device="cpu", compute_dtype=bf)
    for name, got in (("seq_chunk", list(chunked)), ("stream", [outs[1][0], outs[2][0]])):
        dbs = [_psnr(g.numpy(), p.numpy()) for g, p in zip(got, per_pair)]
        print(f"{name} bf16 vs per pair bf16: {dbs} dB")
        assert min(dbs) >= SAME_PATH_DB, (name, dbs)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float32, "bfloat16"])
def test_compute_dtype_refuses_other_values(weights, dtype):
    _, pt, _, _ = weights
    f = np.zeros((1, 16, 16, 3), np.float32)
    with pytest.raises(ValueError, match="compute_dtype"):
        pt_pipe.fusion_interpolate(pt, f, f, device="cpu", compute_dtype=dtype)
    carry = pt_pipe.fusion_stream_init(f, device="cpu")
    with pytest.raises(ValueError, match="compute_dtype"):
        pt_pipe.fusion_stream_step(pt, carry, f, device="cpu", compute_dtype=dtype)
    with pytest.raises(ValueError, match="compute_dtype"):
        pt_pipe.fusion_stream_scan(pt, carry, f[None], device="cpu", compute_dtype=dtype)
    with pytest.raises(ValueError, match="spatial_mesh must be a DeviceMesh"):
        pt_pipe.fusion_interpolate(pt, f, f, device="cpu", spatial_mesh=object())
