"""fmvfi_tpu_torch.parallel on the CPU: the mesh and batch helpers on a
1-process gloo group (the counterparts of tests/test_parallel.py's), and a
2-process gloo group (tests/torch_dp_worker.py, each rank a subprocess
with its own timeout) whose data_parallel steps equal the port's 1-process
step on the global batch: AdaCoF, PhaseNet (global BN statistics), AdaCoF
with FI_GAN (a critic with BN) and with WGAN_GP (the penalty's epsilon
drawn for the global batch).  A phase step whose BN sees only its own rows
is held to miss, so that the sync is tested, not assumed.  The 1-process
steps are themselves held against JAX's by tests/test_torch_train*.py.
"""

import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_dp_worker as worker
from fmvfi_tpu_torch.models.adacof import AdaCoFNet
from fmvfi_tpu_torch.parallel import distributed, dp
from fmvfi_tpu_torch.parallel.mesh import (
    batch_sharding,
    make_mesh,
    replicate,
    replicated,
    shard_batch,
)
from fmvfi_tpu_torch.train.adversarial import draw_eps

DP_TOL = 2e-5  # of each tensor's largest entry, and relative on the metrics
# The phase and FI_GAN steps are noisier than that in float32 (the same step
# with the batch's halves swapped moves some of their gradients by more, as
# printed); there each array is held at FLOOR_SHARE x that floor
# (tests/test_torch_train_phase_grads.py and tests/test_torch_adversarial.py
# hold those trainers against JAX in float64)
FLOOR_SHARE = 2.0
FLOOR_REGIMES = ("phase", "fi_gan")
WORKER_TIMEOUT = 120  # seconds, per rank
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's small CPU work: beside the
    suite's other workers, spinning thread pools cost more than they give."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def group():
    """A 1-process gloo group for this module's in-process checks."""
    distributed.initialize(backend="gloo")
    yield
    dist.destroy_process_group()


def test_mesh_and_helpers_single_process(group):
    distributed.initialize()  # idempotent
    mesh = make_mesh()
    assert mesh.size() == 1 and mesh.mesh_dim_names == ("data",) and mesh.device_type == "cpu"
    assert batch_sharding(mesh) == (torch.distributed.tensor.Shard(0),)
    assert replicated(mesh) == (torch.distributed.tensor.Replicate(),)
    assert make_mesh(1, ("data", "spatial"), (1, 1)).ndim == 2
    with pytest.raises(ValueError, match="explicit shape"):
        make_mesh(1, ("data", "spatial"))
    with pytest.raises(ValueError, match="!= 1 devices"):
        make_mesh(1, ("data", "spatial"), (2, 1))
    with pytest.raises(ValueError, match="over 1 processes"):
        make_mesh(8)
    assert distributed.local_batch_slice(8) == (0, 8)
    arr = np.arange(8 * 4, dtype=np.float32).reshape(8, 4)
    g = distributed.global_batch_array(mesh, arr)
    assert torch.is_tensor(g) and g.shape == (8, 4)
    np.testing.assert_array_equal(g.numpy(), arr)
    assert shard_batch(mesh, arr) is not None and shard_batch(mesh, (arr, arr))[1].shape == (8, 4)
    net = torch.nn.Linear(3, 2)
    before = [p.detach().clone() for p in net.parameters()]
    assert replicate(mesh, net) is net
    assert all(torch.equal(a, b) for a, b in zip(before, net.parameters()))


def test_data_parallel_apply_single_process(group):
    mesh = make_mesh()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(2)
        net = AdaCoFNet(kernel_size=3).eval()
    f1, _, f2 = worker.global_batch()

    def infer(model, a, b):
        with torch.no_grad():
            return model(a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2)).blended

    a, b = torch.from_numpy(f1), torch.from_numpy(f2)
    out = dp.data_parallel_apply(infer, mesh)(net, a, b)
    assert torch.equal(out, infer(net, a, b))


def test_fit_keeps_the_wrapper_across_m_rises(tmp_path):
    """fit(wrap_step=) wraps the first step and every m rebuild (JAX's fit
    once dropped its data-parallel wrapper there)."""
    from fmvfi_tpu_torch.train.loop import fit
    from fmvfi_tpu_torch.train.trainer import TrainState

    net = torch.nn.Linear(2, 2)
    state = TrainState(net, torch.optim.SGD(net.parameters(), lr=0.1), 0)
    built, wrapped, calls = [], [], []

    def make_step(m):
        built.append(m)

        def step(s, batch):
            calls.append(("raw", m))
            return s._replace(step=s.step + 1), {"loss": torch.tensor(float(m))}

        return step

    def wrap(step_fn):
        wrapped.append(step_fn)

        def outer(s, batch):
            calls.append(("wrapped", None))
            return step_fn(s, batch)

        return outer

    batches = iter([None] * 6)
    fit(state, None, batches, str(tmp_path), epochs=1, steps_per_epoch=6, log_every=1,
        make_step=make_step, m_init=2, m_update=2, m_max=4, wrap_step=wrap)
    assert built == [2, 3, 4] and len(wrapped) == 3
    raw = [c for c in calls if c[0] == "raw"]
    assert len(raw) == 6 and calls[0::2] == [("wrapped", None)] * 6
    assert [m for _, m in raw] == [2, 2, 3, 3, 4, 4]


def test_cli_train_data_parallel_single_process(group, tmp_path):
    """`train --data_parallel` on a 1-process group (what it forms without
    torchrun): the same parameters as without it, one metrics file, its
    loss curve, one checkpoint."""
    from fmvfi_tpu_torch import cli
    from fmvfi_tpu_torch.utils.checkpoint import Checkpointer

    def run(out, *extra):
        cli.main(["train", "--regime", "adacof", "--device", "cpu", "--kernel_size", "3",
                  "--crop", "32", "--batch_size", "2", "--steps_per_epoch", "2",
                  "--out_dir", str(out), *extra])
        ckpt = Checkpointer(str(out / "checkpoint"))
        written = sorted(os.listdir(out)), os.listdir(out / "checkpoint")
        payload = torch.load(ckpt._path(ckpt.latest()), weights_only=True)
        shutil.rmtree(out / "checkpoint")  # ~250 MB each: AdaCoF's weights and Adamax state
        return written, payload

    written, dp_ckpt = run(tmp_path / "dp", "--data_parallel")
    _, plain_ckpt = run(tmp_path / "plain")
    assert written == (["checkpoint", "config.json", "train_curve.png", "train_metrics.jsonl"],
                       ["step_00000002"])
    assert all(torch.equal(dp_ckpt["params"][k], v) for k, v in plain_ckpt["params"].items())


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Each rank's report and arrays from tests/torch_dp_worker.py on a
    2-process gloo group."""
    out = tmp_path_factory.mktemp("dp")
    coord = f"localhost:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    script = os.path.join(ROOT, "tests", "torch_dp_worker.py")
    procs = [subprocess.Popen([sys.executable, script, coord, str(r), "2", str(out / str(r))],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
             for r in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and "RESULT" in log, f"rank {r}:\n{log[-3000:]}"
    reports = [json.loads((out / f"{r}.json").read_text()) for r in (0, 1)]
    return reports, [dict(np.load(out / f"{r}.npz")) for r in (0, 1)]


def _bound(regime, rec, key):
    """max(DP_TOL, FLOOR_SHARE x the gap of the 1-process step with the
    batch's halves swapped), the float32 summation-order floor, for a
    regime whose step is the same math in any row order (no per-row draws)."""
    return max(DP_TOL, FLOOR_SHARE * rec["floor"][key]) if regime in FLOOR_REGIMES else DP_TOL


def _zero_in_exact_arithmetic(key):
    """A PhaseNet conv1 bias feeds train-mode BN, which subtracts the batch
    mean: its gradient is zero but for float noise."""
    return "grad.blocks." in key and key.endswith("conv1.bias")


@pytest.mark.parametrize("regime", ["adacof", "phase", "fi_gan", "wgan_gp"])
def test_two_process_step_equals_global_batch_step(two_ranks, regime):
    (r0, r1), _ = two_ranks
    rec = r0[regime]
    assert rec["digest"] == r1[regime]["digest"]  # the ranks agree exactly
    assert rec["gap"] and set(rec["gap"]) == set(rec["floor"])
    over = {}
    for k, g in rec["gap"].items():
        if _zero_in_exact_arithmetic(k):
            assert rec["absmax"][k] <= 1e-3 * rec["largest_grad"], k
        elif g > _bound(regime, rec, k):
            over[k] = (g, _bound(regime, rec, k))
    keys = [k for k in rec["gap"] if not _zero_in_exact_arithmetic(k)]
    worst = max(keys, key=lambda k: rec["gap"][k] / _bound(regime, rec, k))
    floor = max(rec["floor"][k] for k in keys) if regime in FLOOR_REGIMES else None
    print(f"{regime}: largest gap {rec['gap'][worst]:.2e} at {worst} (bound "
          f"{_bound(regime, rec, worst):.2e}); largest floor {floor}")
    assert not over, over


def test_unsynchronised_bn_would_not_match(two_ranks):
    """The phase step with per-process BN moments: its BN running statistics
    miss the global batch's step by more than 10x the bound, and the two
    processes disagree."""
    (r0, r1), _ = two_ranks
    planted, synced = r0["phase_local_bn"], r0["phase"]
    running = [k for k in planted["gap"] if ".running_" in k]
    ratio = max(planted["gap"][k] / _bound("phase", synced, k) for k in running)
    print(f"phase with per-process BN: running statistics {ratio:.1f}x the bound")
    assert ratio > 10
    assert any(planted["digest"][k] != r1["phase_local_bn"]["digest"][k] for k in running)


def test_global_draws_and_apply(two_ranks):
    """Each rank's epsilon is its rows of the global batch's draw, and
    data_parallel_apply hands every rank the global batch's output."""
    _, arrays = two_ranks
    eps = draw_eps(torch.Generator().manual_seed(0), torch.from_numpy(worker.global_batch()[0]))
    np.testing.assert_array_equal(np.concatenate([r["eps"] for r in arrays]), eps.numpy())
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(2)
        net = AdaCoFNet(kernel_size=3).eval()
    f1, _, f2 = worker.global_batch()
    with torch.no_grad():
        want = net(torch.from_numpy(f1).permute(0, 3, 1, 2),
                   torch.from_numpy(f2).permute(0, 3, 1, 2)).blended.numpy()
    for r in arrays:
        assert r["apply"].shape == want.shape
        assert worker.gap(r["apply"], want) <= DP_TOL
