"""One rank of the 2-process data-parallel check of
tests/test_torch_parallel.py (not collected by pytest: no test_ prefix).

    python tests/torch_dp_worker.py HOST:PORT RANK WORLD OUT

Joins a gloo group of WORLD CPU processes through
fmvfi_tpu_torch.parallel.distributed.initialize, loads only its
local_batch_slice of the seeded global batch (GLOBAL_BATCH triplets of
SIZE x SIZE), and runs one data_parallel step of each regime from the same
seeds, with momentum SGD in place of the trainers' Adam / Adamax (and the
critic's Adam): its step is linear in the gradient and its buffer after one
step is the gradient, where Adam's first step, lr * sign(g), turns float
noise at a near-zero gradient entry into a 2 lr difference.  Writes to
OUT.json a digest of each updated parameter, buffer and gradient and the
metrics, and on rank 0 the gap of each array to the 1-process step on the
whole global batch (`single_step`) and to that step with the batch's halves
swapped (the float32 floor of the comparison); to OUT.npz the gradient
penalty's epsilon drawn for its rows and a data_parallel_apply output.
`phase_local_bn` is the phase step with the BN moments left per process
(the sync planted out), which must not match the global batch's step.
"""

import hashlib
import json
import sys

import numpy as np
import torch

GLOBAL_BATCH, SIZE = 8, 32
LR = 1e-2
REGIMES = ("adacof", "phase", "phase_local_bn", "fi_gan", "wgan_gp")


def global_batch():
    """The seeded global batch: (frame1, target, frame2), each (8, 32, 32, 3)."""
    full = np.random.default_rng(0).uniform(0, 1, (3, GLOBAL_BATCH, SIZE, SIZE, 3))
    return tuple(full.astype(np.float32))


def _sgd(module):
    opt = torch.optim.SGD(module.parameters(), lr=LR, momentum=0.9)
    opt.param_groups[0]["updates"] = 0  # the AdaCoF trainer's count of applied updates
    return opt


def trainer(regime):
    """(state, step) of a regime on the CPU, from fixed seeds, with momentum
    SGD for the model (and the critic)."""
    from fmvfi_tpu_torch.train import trainer as T
    from fmvfi_tpu_torch.train.losses import parse_loss_spec

    if regime == "adacof":
        state, step = T.make_adacof_trainer(kernel_size=3, device="cpu", seed=1)
    elif regime in ("fi_gan", "wgan_gp"):
        gan = {"fi_gan": "FI_GAN", "wgan_gp": "WGAN_GP"}[regime]
        spec = parse_loss_spec(f"{T.DEFAULT_LOSS}+0.005*{gan}")
        state, step = T.make_adacof_trainer(kernel_size=3, device="cpu", seed=1, loss_spec=spec,
                                            h=SIZE, w=SIZE, lr=LR)
        state = state._replace(extra=state.extra._replace(optimizer=_sgd(state.extra.critic)))
    else:
        state, step, _, _ = T.make_phase_trainer(SIZE, SIZE, device="cpu", seed=1)
    return state._replace(optimizer=_sgd(state.model)), step


def state_arrays(state):
    """The step's parameters, buffers and gradients (the critic's too), by
    name."""
    nets = [("model", state.model, state.optimizer)]
    if state.extra is not None:
        nets.append(("critic", state.extra.critic, state.extra.optimizer))
    out = {}
    for name, net, opt in nets:
        out.update({f"{name}.{k}": v.detach().numpy().copy() for k, v in net.state_dict().items()})
        out.update({f"{name}.grad.{k}": opt.state[p]["momentum_buffer"].numpy().copy()
                    for k, p in net.named_parameters()})
    return out


def single_step(regime, order=None):
    """The 1-process step of a regime on the whole global batch (its rows in
    `order`): (state_arrays, metrics)."""
    state, step = trainer(regime)
    batch = global_batch()
    state, metrics = step(state, batch if order is None else tuple(b[order] for b in batch))
    return state_arrays(state), {k: float(v) for k, v in metrics.items()}


def gap(a, b):
    """max |a - b| over max |b| (of b's largest entry)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-30))


def main(coordinator, rank, world, out):
    torch.set_num_threads(1)
    from fmvfi_tpu_torch.models import flax_bn
    from fmvfi_tpu_torch.models.adacof import AdaCoFNet
    from fmvfi_tpu_torch.parallel import distributed, dp
    from fmvfi_tpu_torch.parallel.mesh import make_mesh, replicate
    from fmvfi_tpu_torch.train.adversarial import draw_eps

    distributed.initialize(coordinator, num_processes=world, process_id=rank, backend="gloo")
    mesh = make_mesh()
    assert mesh.size() == world and distributed.process_count() == world
    lo, hi = distributed.local_batch_slice(GLOBAL_BATCH)
    local = tuple(distributed.global_batch_array(mesh, f[lo:hi]) for f in global_batch())
    assert local[0].shape[0] == GLOBAL_BATCH // world

    result, report = {}, {}
    for regime in REGIMES:
        state, step = trainer(regime)
        state = replicate(mesh, state)
        if regime == "phase_local_bn":  # the planted fault: BN sees its own rows only
            synced = flax_bn.dp
            flax_bn.dp = type("LocalBN", (), {"world_size": staticmethod(lambda: 1)})
        try:
            state, metrics = dp.data_parallel(step, mesh)(state, local)
        finally:
            if regime == "phase_local_bn":
                flax_bn.dp = synced
        arrays = state_arrays(state)
        rec = report[regime] = dict(
            digest={k: hashlib.sha256(v.tobytes()).hexdigest() for k, v in arrays.items()},
            metrics={k: float(v) for k, v in metrics.items()})
        if rank == 0:  # against the 1-process step, and its halves-swapped floor
            ref_regime = "phase" if regime == "phase_local_bn" else regime
            ref, ref_m = single_step(ref_regime)
            swapped, swapped_m = single_step(
                ref_regime, np.roll(np.arange(GLOBAL_BATCH), GLOBAL_BATCH // 2))
            rec["gap"] = {k: gap(arrays[k], v) for k, v in ref.items()}
            rec["gap"].update({f"metric.{k}": gap(rec["metrics"][k], v) for k, v in ref_m.items()})
            rec["floor"] = {k: gap(swapped[k], v) for k, v in ref.items()}
            rec["floor"].update({f"metric.{k}": gap(swapped_m[k], v) for k, v in ref_m.items()})
            rec["absmax"] = {k: float(np.abs(v).max()) for k, v in arrays.items()}
            rec["largest_grad"] = max(float(np.abs(v).max()) for k, v in ref.items()
                                      if ".grad." in k)

    with dp.running(mesh):
        result["eps"] = draw_eps(torch.Generator().manual_seed(0), local[0]).numpy()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(2)
        net = AdaCoFNet(kernel_size=3).eval()
    replicate(mesh, net)

    def infer(model, a, b):
        with torch.no_grad():
            return model(a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2)).blended

    result["apply"] = dp.data_parallel_apply(infer, mesh)(net, local[0], local[2]).numpy()
    np.savez(out + ".npz", **result)
    with open(out + ".json", "w") as f:
        json.dump(report, f)
    print(f"RESULT rank={rank} regimes={len(REGIMES)}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
