"""fmvfi_tpu_torch.parallel.spatial's trainers on the CPU: spatially sharded
training on a 4-process gloo group (tests/torch_spatial_train_worker.py, each
rank a subprocess with one torch thread and a timeout of its own), meshes
(data 2 x spatial 2) and (1 x 4), against the port's single-process
trainers and the JAX package's single-device ones.  The JAX package's own
sharded-trainer tests (tests/test_parallel.py) are `slow`; they hold its
sharded step equal to its single-device step, which is what the port is
held against here.

Tolerances:
- each halo-aware layer's input gradient on the bands against the whole
  frame's autograd: 1e-6 of the largest entry (the band's and the frame's
  convolutions and interpolations sum in other orders); the parameter
  gradients summed over the ranks: 1e-5 (each entry a float32 sum of 2560
  products of random signs, split in 2 or 4 partial sums);
- the gather's and the spatial sum's backward, the smoothness penalties'
  shares and gradients: 1e-6 (relative to the largest);
- the trainers, one step from the same weights and batch: the reported
  metrics within 1e-5 relative of the port's single process and of JAX's
  single-device step; the clipped gradient before the optimizer within
  2e-4 of each tensor's largest entry; after a plain SGD step (lr 1e-3)
  the parameters within 2e-5 (tests/test_parallel.py's bound for JAX's
  sharded step against its single device); the fusion step's gradient
  against FusionNet's (the port's and JAX's) on the spatial step's own
  inputs to it within 2e-4, and end to end against the port's single
  process within 1e-3: the frozen sections' float noise moves the adacof
  artifact map's histogram median by a bin at a few pixels (ROADMAP Q3-3),
  which moves FusionNet's gradient by up to ~2e-4 (1.98e-4 measured for
  case f22_s23, 1.1e-2 of the map at its worst pixel), as chip_smoke.py's
  train_fusion holds its two warp routes (1e-3 end to end);
- the (1, 1) mesh: bit-equal to the single-device trainers.
The JAX AdaCoF on the CPU warps unclamped: its parity needs the offsets
under the clamps of both routes, which the seeded init gives (asserted).
The fusion step is held against JAX's trainer by its loss (case f22_s23
at JAX_TRAINER_LOSS_TOL: a pyramid entry at the phase's branch cut, see
there), and by the gradient of JAX's FusionNet (the net that trains) on the
spatial step's inputs to it: end to end JAX's sections move the artifact
map by a histogram bin (Q3-3; 1.1e-2 at 541 pixels of case f22's batch),
which moves JAX's gradient by 2.05e-4 of a tensor's largest from the port's
single process and its spatial step alike (printed).
"""

import copy
import functools
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
from flax import serialization

import torch_spatial_train_worker as worker
from fmvfi_tpu.models.fusion_net import FusionNet as JaxFusionNet
from fmvfi_tpu.train import trainer as jx_trainer
from fmvfi_tpu_torch.models.adacof import AdaCoFNet, smoothness_penalties
from fmvfi_tpu_torch.models.phase_net import PhaseNetCore
from fmvfi_tpu_torch.parallel import distributed, spatial
from fmvfi_tpu_torch.parallel.mesh import make_mesh
from fmvfi_tpu_torch.pipeline.interpolate import FusionInputs
from fmvfi_tpu_torch.train.losses import parse_loss_spec
from fmvfi_tpu_torch.train.trainer import fusion_loss, make_adacof_trainer, make_fusion_trainer
from fmvfi_tpu_torch.utils import convert
from test_torch_vgg import seeded_vgg16

LAYER_TOL = 1e-6  # of the largest entry
ROUTE_GRAD_TOL = 1e-3  # the fusion step's gradient end to end (Q3-3)
PARAM_GRAD_TOL = 1e-5  # of the largest entry, a layer's parameter gradients
METRIC_TOL = 1e-5  # relative
GRAD_TOL = 2e-4  # of each tensor's largest entry
PARAM_TOL = 2e-5
# the critic's float32 gradient: leaky-ReLU kinks that float noise moves a
# pre-activation across change it by up to ~5e-2 of a tensor's largest
# (chip_smoke.py's gan_vs_cpu, on the CPU as on the card)
CRITIC_GRAD_TOL = 5e-2
WORKER_TIMEOUT = 240  # seconds, per rank
WORLD = 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FUSION_CKPT = os.path.join(ROOT, "checkpoints", "fusion_synth_demo.msgpack")
ADACOF_CKPT = os.path.join(ROOT, "checkpoints", "adacof_synth_demo.msgpack")
N_DATA = {"22": 2, "14": 1}
# the fusion cases held against JAX's FusionNet on the spatial step's inputs
JAX_CASES = ("f22", "f22_s23", "f14")
# the fusion cases held against JAX's single-device trainer end to end, by
# their loss (relative).  On case f22_s23's batch one band entry of the
# pyramid (level 4, channel batch 21, band 3, pixel (8, 7)) lies 1.28e-7 rad
# from the phase's branch cut at -pi in float64; JAX's jitted pipeline
# rounds it to +pi, the port (as float64 and JAX run eagerly) to -pi.
# PhaseNet reads phase / pi, so that one entry moves JAX's PhaseNet
# prediction by 1.83e-4 at 531 pixels of one sample; flipping it in the
# port's input reproduces JAX's prediction within 8.9e-7
# (tools/phase_branch_cut.py; ROADMAP Q3-5).  JAX's trainer loss is then
# 1.6e-5 relative from the port's single process and 2.2e-5 from its
# spatial step (5.9e-7 from the single process); the bound is twice 2.2e-5.
JAX_TRAINER_LOSS_TOL = {"f22": METRIC_TOL, "f22_s23": 4.4e-5}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _restore(path):
    with open(path, "rb") as f:
        return serialization.msgpack_restore(f.read())


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(the weights file the workers load, the vgg16 file)."""
    d = tmp_path_factory.mktemp("w")
    torch.manual_seed(0)
    seeded = AdaCoFNet()
    phase = PhaseNetCore().init_params(torch.Generator().manual_seed(0))
    torch.save({"adacof": seeded.state_dict(), "phase": phase.state_dict()}, d / "weights.pt")
    return str(d / "weights.pt"), str(seeded_vgg16(d / "vgg16.pth"))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_references(weights_path):
    """JAX's single-device steps: make_adacof_trainer(use_pallas=False,
    optimizer="sgd") from the port's seeded init on each AdaCoF case's
    batch (loss, params); make_fusion_trainer from the bundled weights on
    case f22's (loss, Adam's first moment)."""
    refs = {}
    state0, _ = make_adacof_trainer(optimizer="sgd", device="cpu")
    tree = convert.adacof_to_flax(state0.model.state_dict())
    done = {}
    for name, (_, h, w, b, _, seed) in worker.ADACOF_CASES.items():
        if (h, w, b, seed) not in done:
            state, step = jx_trainer.make_adacof_trainer(jax.random.key(0), h, w,
                                                         use_pallas=False, optimizer="sgd")
            state = state._replace(params=jax.tree.map(jnp.asarray, tree["params"]))
            state, m = jax.jit(step)(state, worker.batch(h, w, b, seed))
            done[(h, w, b, seed)] = dict(loss=float(m["loss"]),
                                         params=jax.tree.map(np.asarray, state.params))
        refs[name] = done[(h, w, b, seed)]
    models, _ = _worker_models(weights_path)
    _, h, w, b, _, _, kw, _ = worker.FUSION_CASES["f22"]
    state0, step = jx_trainer.make_fusion_trainer(
        jax.random.key(0), h, w, convert.phase_net_to_flax(models.phase_net.state_dict()),
        _restore(ADACOF_CKPT), **kw)
    state0 = state0._replace(params=jax.tree.map(jnp.asarray, _restore(FUSION_CKPT)["params"]))
    step = jax.jit(step)
    for name in JAX_TRAINER_LOSS_TOL:  # the same configuration on other batches: one compile
        assert worker.FUSION_CASES[name][:4] + worker.FUSION_CASES[name][5:] == \
            worker.FUSION_CASES["f22"][:4] + worker.FUSION_CASES["f22"][5:]
        state, m = step(state0, worker.batch(h, w, b, worker.FUSION_CASES[name][4]))
        mu = [s for s in jax.tree_util.tree_leaves(state.opt_state,
                                                    is_leaf=lambda x: hasattr(x, "mu"))
              if hasattr(s, "mu")][0].mu
        refs[name] = dict(loss=float(m["loss"]), mu=jax.tree.map(np.asarray, mu))
    return refs


@functools.lru_cache(maxsize=None)
def _jax_fusion_grad():
    """jit(value_and_grad) of the plain L1 of JAX's FusionNet (variant 2)."""
    net = JaxFusionNet(uncertainty_maps=3)

    def l1(params, inputs, target):
        return jnp.mean(jnp.abs(net.apply({"params": params}, *inputs, variant=2) - target))

    return jax.jit(jax.value_and_grad(l1))


def _jax_fusion_moment(inputs, target):
    """(the plain L1, 0.1 x the clipped gradient: Adam's first moment after
    one step) of JAX's FusionNet (variant 2, the bundled weights) on these
    NCHW inputs."""
    nhwc = tuple(jnp.asarray(t.permute(0, 2, 3, 1).numpy()) for t in inputs)
    loss, grads = _jax_fusion_grad()(_restore(FUSION_CKPT)["params"], nhwc, target)
    norm = jnp.sqrt(sum(jnp.sum(g**2) for g in jax.tree_util.tree_leaves(grads)))
    return float(loss), jax.tree.map(lambda g: np.asarray(0.1 * g / jnp.maximum(norm, 1.0)),
                                     grads)


def _port_fusion_moment(net, inputs, target, kw):
    """The same with the port's FusionNet `net` and the trainer's loss."""
    pred = net(*inputs)
    total, _ = fusion_loss(pred, target, (inputs.adacof, inputs.phase), kw.get("distill", 0.0),
                           kw.get("loss_balance", False), kw.get("loss_psnr", False))
    names, params = zip(*net.named_parameters())
    grads = torch.autograd.grad(total, params)
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    return {k: 0.1 * g / torch.clamp(norm, min=1.0) for k, g in zip(names, grads)}


def _worker_models(weights_path):
    import torch_spatial_worker

    return torch_spatial_worker.models(weights_path)


@pytest.fixture(scope="module")
def ranks(weights, tmp_path_factory):
    """(each rank's arrays (npz), each rank's report (json), JAX's
    references, computed while the workers run)."""
    out = tmp_path_factory.mktemp("spatial_train")
    coord = f"localhost:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    script = os.path.join(ROOT, "tests", "torch_spatial_train_worker.py")
    procs = [subprocess.Popen([sys.executable, script, coord, str(r), str(WORLD),
                               str(out / str(r)), *weights],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(WORLD)]
    logs = []
    try:
        refs = _jax_references(weights[0])
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and "RESULT" in log, f"rank {r}:\n{log[-3000:]}"
    return ([dict(np.load(out / f"{r}.npz")) for r in range(WORLD)],
            [json.loads((out / f"{r}.json").read_text()) for r in range(WORLD)], refs)


def _assemble(arrays, name, shape):
    """The whole NCHW tensor from every rank's block of it (a block kept by
    several ranks must be equal on each)."""
    whole = np.full(shape, np.nan, np.float32)
    for a in arrays:
        blk, (b0, r0) = a[name], a[name + "@index"]
        idx = (slice(b0, b0 + blk.shape[0]), slice(None), slice(r0, r0 + blk.shape[2]))
        seen = whole[idx]
        assert np.isnan(seen).all() or np.array_equal(seen, blk), name
        whole[idx] = blk
    assert not np.isnan(whole).any(), name
    return whole


def _rel_gap(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def _worst(pairs):
    """(the largest _rel_gap over {name: (got, want)}, its name)."""
    gaps = {k: _rel_gap(*v) for k, v in pairs.items()}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def _rel_close(ours, ref, rtol):
    assert abs(float(ours) - float(ref)) <= rtol * max(abs(float(ref)), 1e-12), (ours, ref)


@pytest.mark.parametrize("key", list(worker.BANDS))
@pytest.mark.parametrize("layer", worker.LAYERS)
def test_layer_gradients_on_bands_match_the_whole_frame(ranks, key, layer):
    """Each halo-aware layer on the unequal bands of a 64-row frame, the
    edge ranks included (reflected and zero rows at the frame's top and
    bottom): the input's gradient against the whole frame's, and the
    parameters' summed over the ranks against the whole frame's."""
    arrays, _, _ = ranks
    fn = worker.layers()[layer]
    params = list(fn.parameters()) if isinstance(fn, torch.nn.Module) else []
    x = torch.from_numpy(worker.layer_input()).requires_grad_()
    y = fn(x)
    c = torch.from_numpy(worker.cotangent(tuple(y.shape), 5))
    grads = torch.autograd.grad((y * c).sum(), [x] + params)
    got = _assemble(arrays, f"lg{key}_{layer}", x.shape)
    gaps = [_rel_gap(got, grads[0])]
    for i, g in enumerate(grads[1:]):
        gaps.append(_rel_gap(sum(a[f"lg{key}_{layer}_p{i}"].astype(np.float64) for a in arrays), g))
    print(f"{key} {layer}: input {gaps[0]:.3g}, params {gaps[1:]}")
    assert gaps[0] <= LAYER_TOL and max(gaps[1:], default=0) <= PARAM_GRAD_TOL, gaps


def test_gather_and_spatial_sum_backward(ranks):
    """Rank r's objective sum(gather(x) * c_r) + sum(spatial_sum(sum x**2
    per sample) * k_r): each band's gradient is its rows of the sum over
    the ranks, sum_r c_r + 2 x sum_r k_r; the exchanges' forward and
    backward bytes are counted."""
    arrays, reports, _ = ranks
    x = worker.layer_input().astype(np.float64)
    c = sum(worker.cotangent(worker.LAYER_SHAPE, 100 + r) for r in range(WORLD))
    k = sum(np.array([1.0 + r, -0.5 * r]) for r in range(WORLD))
    want = c + 2 * x * k[:, None, None, None]
    assert _rel_gap(_assemble(arrays, "gather_grad", x.shape), want) <= LAYER_TOL
    for a in arrays:
        np.testing.assert_array_equal(a["gather_whole"], worker.layer_input())
        assert _rel_gap(a["gather_sums"], (x**2).sum(axis=(1, 2, 3))) <= LAYER_TOL
    for rep in reports:
        assert all(rep["exchanged"]["gather"][k] > 0 for k in ("gather", "gather_bwd", "sum",
                                                                 "sum_bwd"))


def test_backward_out_of_order_raises(ranks):
    """Two exchanges undone in another order on one rank: the stamps the
    backward sends beside its cotangents make every rank raise, where the
    sums of mismatched buffers would pass silently."""
    _, reports, _ = ranks
    for rep in reports:
        assert "different orders" in rep["raised"].get("order", ""), rep["raised"]


@pytest.mark.parametrize("key", list(worker.BANDS))
def test_smoothness_penalties_across_bands(ranks, key):
    """The penalties' shares summed over the spatial axis (and averaged over
    the data axis) are the whole batch's penalties; their gradients on the
    bands, the row differences across band edges included, the whole
    frame's (times the data axis's processes: each data rank's objective
    is its batch share's)."""
    arrays, _, _ = ranks
    heads = [torch.from_numpy(t).requires_grad_() for t in worker.fields()]
    g_s, g_o = smoothness_penalties(*heads)
    grads = torch.autograd.grad(g_s + 3.0 * g_o, heads)
    shares = sum(a[f"smooth{key}"].astype(np.float64) for a in arrays) / N_DATA[key]
    assert _rel_gap(shares, [g_s.item(), g_o.item()]) <= LAYER_TOL
    for i, g in enumerate(grads):
        got = _assemble(arrays, f"smooth{key}_g{i}", g.shape) / N_DATA[key]
        assert _rel_gap(got, g) <= LAYER_TOL, i


def _port_step(state, step, data):
    """One step on the whole batch in this process: (metrics, the recorded
    gradient by name, the state)."""
    opt = worker.RecordingSGD(state.model.parameters(), lr=worker.LR)
    opt.param_groups[0]["updates"] = 0
    state, m = step(state._replace(optimizer=opt), data)
    names = [k for k, _ in state.model.named_parameters()]
    return {k: float(v) for k, v in m.items()}, dict(zip(names, opt.grads)), state


def _worker_grads(arrays, name, names):
    return {k: torch.from_numpy(arrays[0][f"{name}/{k}"]) for k in names}


def _check_ranks_agree(reports, name):
    digests = {rep["digest"][name] for rep in reports}
    assert len(digests) == 1, f"{name}: the ranks' parameters differ after the step"
    return digests.pop()


@pytest.mark.parametrize("name", list(worker.ADACOF_CASES))
def test_adacof_spatial_trainer_matches_single_device(ranks, name):
    """adacof_spatial_trainer's step (plain SGD) on the mesh against the
    port's single-process step and JAX's single-device step on the same
    batch: the route each band's warp took, the ranks' parameters equal,
    the metrics, the gradient and the parameters after the step."""
    arrays, reports, refs = ranks
    key, h, w, b, r, seed = worker.ADACOF_CASES[name]
    route = "adacof_warp_tm_sharded" if r == 24 else "adacof_warp_gathered"
    for rep in reports:
        assert rep["routes"][name] == {route: [r if r == 24 else None]}, rep["routes"][name]
        assert rep["exchanged"][name]["halo"] > 0 and rep["exchanged"][name]["halo_bwd"] > 0
    digest = _check_ranks_agree(reports, name)

    data = worker.batch(h, w, b, seed)
    state, step = make_adacof_trainer(optimizer="sgd", device="cpu")
    state.model.max_offset = r
    start = {k: v.clone() for k, v in state.model.state_dict().items()}
    with torch.no_grad():  # the offsets under both routes' clamps: JAX's warp is unclamped
        out = state.model(*(torch.from_numpy(t).permute(0, 3, 1, 2) for t in data[::2]))
    assert max(float(t.abs().max()) for t in out.heads[1:3] + out.heads[4:6]) < 24
    metrics, grads, _ = _port_step(state, step, data)
    ours = _worker_grads(arrays, name, grads)
    gap, worst = _worst({k: (ours[k], g) for k, g in grads.items()})
    print(f"{name}: gradient {gap:.3g} of a tensor's largest from one process ({worst})")
    assert gap <= GRAD_TOL
    for k, v in reports[0]["metrics"][name].items():
        _rel_close(v, metrics[k], METRIC_TOL)
    _rel_close(reports[0]["metrics"][name]["loss"], refs[name]["loss"], METRIC_TOL)

    # the ranks' parameters: the start, one SGD step with the worker's gradient
    model = AdaCoFNet()
    model.load_state_dict(start)
    opt = torch.optim.SGD(model.parameters(), lr=worker.LR)
    for k, p in model.named_parameters():
        p.grad = ours[k]
    opt.step()
    assert worker.digest(model) == digest
    jx = convert.adacof_from_flax({"params": refs[name]["params"]})
    one = {k: start[k] - worker.LR * g for k, g in grads.items()}
    for k, p in model.named_parameters():
        torch.testing.assert_close(p.detach(), jx[k], rtol=0, atol=PARAM_TOL, msg=k)
        torch.testing.assert_close(p.detach(), one[k], rtol=0, atol=PARAM_TOL, msg=k)


@pytest.mark.parametrize("name", list(worker.FUSION_CASES))
def test_fusion_spatial_trainer_matches_single_device(ranks, weights, name):
    """fusion_spatial_trainer's step on the mesh against the port's
    single-process step from the same weights and batch: the metric
    (plain L1) and the clipped gradient (Adam's first moment), on the
    step's own inputs and end to end; cases f22, f22_s23 and f14 also
    against JAX's FusionNet on the same inputs, and f22 and f22_s23 against
    JAX's single-device trainer (its loss; its gradient printed).  loss_balance, distill and
    loss_psnr hold the loss convention: their per-sample terms come from
    sums over the spatial axis, and a gradient counted once per rank of
    the axis would read twice the single process's."""
    arrays, reports, refs = ranks
    key, h, w, b, seed, r, kw, bundled = worker.FUSION_CASES[name]
    route = "adacof_warp_tm_sharded" if r else "adacof_warp_gathered"
    for rep in reports:
        assert rep["routes"][name] == {route: [r] * 3}, rep["routes"][name]
    _check_ranks_agree(reports, name)
    phase, ada, fusion_sd = worker.fusion_models(weights[0])
    ada.max_offset = r
    state, step = make_fusion_trainer(phase, ada, device="cpu", **kw)
    if bundled:
        state.model.load_state_dict(fusion_sd)
    start = copy.deepcopy(state.model)
    data = worker.batch(h, w, b, seed)
    state, m = step(state, data)
    _rel_close(reports[0]["metrics"][name]["loss"], float(m["loss"]), METRIC_TOL)
    ours = {k: arrays[0][f"{name}/{k}"] for k, _ in state.model.named_parameters()}
    one = _worst({k: (ours[k], state.optimizer.state[p]["exp_avg"])
                  for k, p in state.model.named_parameters()})
    inputs = FusionInputs(*(
        torch.from_numpy(_assemble(arrays, f"{name}_in_{k}",
                                   (b, arrays[0][f"{name}_in_{k}"].shape[1], h, w)))
        if f"{name}_in_{k}" in arrays[0] else None for k in FusionInputs._fields))
    target = torch.from_numpy(data[1]).permute(0, 3, 1, 2)
    shared = _worst({k: (ours[k], g) for k, g in
                     _port_fusion_moment(start, inputs, target, kw).items()})
    print(f"{name}: gradient {shared[0]:.3g} of a tensor's largest from one process on the same "
          f"inputs ({shared[1]}), {one[0]:.3g} end to end ({one[1]})")
    assert shared[0] <= GRAD_TOL and one[0] <= ROUTE_GRAD_TOL
    if name in JAX_CASES:  # JAX's FusionNet on the same inputs, and its trainer
        jax_loss, jax_moment = _jax_fusion_moment(inputs, data[1])
        _rel_close(reports[0]["metrics"][name]["loss"], jax_loss, METRIC_TOL)
        want = convert.fusion_net_from_flax({"params": jax_moment})
        gap = _worst({k: (ours[k], want[k]) for k in want})
        print(f"{name}: gradient {gap[0]:.3g} of a tensor's largest from JAX's FusionNet on the "
              f"same inputs ({gap[1]})")
        assert gap[0] <= GRAD_TOL
    if name in refs:
        print(f"{name}: loss {reports[0]['metrics'][name]['loss']!r} against JAX's trainer "
              f"{refs[name]['loss']!r}")
        _rel_close(reports[0]["metrics"][name]["loss"], refs[name]["loss"],
                   JAX_TRAINER_LOSS_TOL[name])
        mu = convert.fusion_net_from_flax({"params": refs[name]["mu"]})
        gap = _worst({k: (ours[k], mu[k]) for k in mu})
        print(f"{name}: gradient {gap[0]:.3g} from JAX's trainer end to end ({gap[1]})")


@pytest.mark.parametrize("name", list(worker.GAN_CASES))
def test_adversarial_and_vgg_terms_match_single_device(ranks, weights, name):
    """The AdaCoF trainer with +0.01*VGG+0.005*T_WGAN_GP on the mesh: the
    critic and VGG on the gathered frames, one critic on every rank (its
    parameters equal after its update), the metrics (d_loss included), the
    generator's gradient through the gather's backward and the critic's
    gradient against the port's single process."""
    arrays, reports, _ = ranks
    key, h, w, b, r, seed = worker.GAN_CASES[name]
    _check_ranks_agree(reports, name)
    _check_ranks_agree(reports, name + "_critic")
    for rep in reports:
        assert rep["exchanged"][name]["gather_bwd"] > 0
    state, step = make_adacof_trainer(loss_spec=parse_loss_spec(worker.GAN_SPEC),
                                      vgg_checkpoint=weights[1], h=h, w=w, optimizer="sgd",
                                      device="cpu")
    metrics, grads, state = _port_step(state, step, worker.batch(h, w, b, seed))
    assert set(reports[0]["metrics"][name]) == set(metrics)
    for k, v in reports[0]["metrics"][name].items():
        _rel_close(v, metrics[k], METRIC_TOL)
    ours = _worker_grads(arrays, name, grads)
    gap, worst = _worst({k: (ours[k], g) for k, g in grads.items()})
    critic = state.extra
    critic_gap, critic_worst = _worst({
        k: (arrays[0][f"{name}/critic/{k}"], critic.optimizer.state[p]["exp_avg"])
        for k, p in critic.critic.named_parameters()})
    print(f"{name}: generator gradient {gap:.3g} ({worst}), critic gradient {critic_gap:.3g} "
          f"({critic_worst})")
    assert gap <= GRAD_TOL and critic_gap <= CRITIC_GRAD_TOL


@pytest.fixture(scope="module")
def group():
    """A 1-process gloo group for this module's in-process checks."""
    distributed.initialize(backend="gloo")
    yield
    dist.destroy_process_group()


def test_one_process_mesh_is_the_single_device_trainer(ranks, weights, group):
    """On a (1, 1) mesh both spatial trainers are the single-device
    trainers, bit for bit: metrics and parameters after a step."""
    mesh = make_mesh(1, ("data", "spatial"), (1, 1))
    data = worker.batch(64, 32, 2, 29)
    runs = []
    for factory in (make_adacof_trainer, spatial.adacof_spatial_trainer):
        state, step = (factory(device="cpu") if factory is make_adacof_trainer
                       else factory(mesh, device="cpu"))
        state, m = step(state, data)
        runs.append((m, state.model.state_dict()))
    phase, ada, fusion_sd = worker.fusion_models(weights[0])
    for factory in (make_fusion_trainer, spatial.fusion_spatial_trainer):
        args = (phase, ada) if factory is make_fusion_trainer else (phase, ada, mesh)
        state, step = factory(*args, variant=2, device="cpu")
        state.model.load_state_dict(fusion_sd)
        state, m = step(state, data)
        runs.append((m, state.model.state_dict()))
    for (m0, sd0), (m1, sd1) in (runs[:2], runs[2:]):
        assert set(m0) == set(m1) and all(float(m0[k]) == float(m1[k]) for k in m0)
        for k, v in sd0.items():
            assert torch.equal(v, sd1[k]), k
