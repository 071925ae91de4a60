"""One rank of the spatial-training check of tests/test_torch_spatial_train.py
(not collected by pytest: no test_ prefix).

    python tests/torch_spatial_train_worker.py HOST:PORT RANK WORLD OUT WEIGHTS VGG

Joins a gloo group of WORLD (4) CPU processes, builds ("data", "spatial")
meshes of (2, 2) and (1, 4), and runs, on its block of the seeded inputs
(the test makes the same):
  - each halo-aware layer's gradient (`LAYERS`: its input's and its
    parameters') on unequal bands, (40, 24) of the 64-row frame over the
    (2, 2) mesh's spatial axis and (24, 16, 16, 8) over (1, 4), the
    objective sum(layer(x) * cotangent) on the band's rows;
  - Bands.gather's and spatial_sum's backward, each rank's objective its
    own (a cotangent of its own), and a backward pass that undoes two
    exchanges in another order on rank 0 (it must raise on every rank);
  - smoothness_penalties' shares and gradients on the same bands;
  - `ADACOF_CASES` (adacof_spatial_trainer, plain SGD recording its
    gradient), `FUSION_CASES` (fusion_spatial_trainer, Adam: its first
    moment is 0.1 x the clipped gradient; and the step's FusionNet inputs
    on the band, computed once more) and `GAN_CASES` (the AdaCoF trainer
    with the VGG and T_WGAN_GP terms): one step each from fixed weights,
    the warp's routes recorded.
Rank 0 writes the gradients to OUT.npz; every rank writes its metrics, the
routes, a digest of its parameters after the step (and the critic's), the
exchanged bytes and the raised messages to OUT.json.
"""

import hashlib
import json
import sys

import numpy as np
import torch

LAYER_SHAPE = (2, 4, 64, 20)
BANDS = {"22": (40, 24), "14": (24, 16, 16, 8)}  # the layer checks' bands of 64 rows
LAYERS = ("conv3", "tapconv", "rconv5", "rconv3", "rconv1", "avg_pool2", "max_pool2",
          "up_false", "up_true", "up_true_s8")
FIELDS_SHAPE = (2, 25, 64, 20)
LR = 1e-3  # the recording SGD's, make_adacof_trainer's default
GAN_SPEC = "1*Charb+0.01*g_Spatial+0.005*g_Occlusion+0.01*VGG+0.005*T_WGAN_GP"
# name: (mesh, h, w, batch, max_offset, seed of the batch)
ADACOF_CASES = {
    "a22_r24": ("22", 64, 64, 4, 24, 13),  # 32-row bands host R = 24's halo: the halo warp
    "a22_r48": ("22", 64, 64, 4, 48, 13),  # not R = 48's: the gathered frame's, unclamped
    "a14_r24": ("14", 144, 32, 2, 24, 17),  # bands (32, 32, 32, 48), the last + 16 /32 rows
}
# name: (mesh, h, w, batch, seed of the batch, AdaCoF's max_offset, trainer
# options, start from the bundled FusionNet)
FUSION_CASES = {
    # unclamped: the gathered frame's warp, as the JAX package's CPU warp
    "f22": ("22", 64, 64, 4, 0, None, dict(variant=2), True),
    # a pyramid entry of this batch at the phase's branch cut (the test's
    # JAX_TRAINER_LOSS_TOL)
    "f22_s23": ("22", 64, 64, 4, 23, None, dict(variant=2), True),
    # 32-row bands host R = 24's halo: the halo warp in all three passes
    "f14": ("14", 128, 32, 2, 23, 24, dict(variant=2), True),
    "f22_balance": ("22", 64, 32, 4, 23, None, dict(variant=2, loss_balance=True), True),
    "f22_distill": ("22", 64, 32, 4, 23, None, dict(variant=2, distill=1.0), True),
    "f22_psnr": ("22", 64, 32, 4, 23, None, dict(variant=2, loss_psnr=True), True),
    "f22_v1_no_maps": ("22", 64, 32, 4, 23, None, dict(variant=1, uncertainty_maps=0), False),
}
GAN_CASES = {"g22": ("22", 64, 64, 4, 48, 19)}


def layer_input():
    return np.random.default_rng(1).normal(0, 1, LAYER_SHAPE).astype(np.float32)


def cotangent(shape, seed):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def fields(seed=2):
    """w1, a1, b1, w2, a2, b2 (B, 25, H, W) and occ (B, 1, H, W): softmax
    weights, offsets of sigma 3, an occlusion map in (0, 1)."""
    r = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        logits = r.normal(0, 1, FIELDS_SHAPE)
        e = np.exp(logits - logits.max(1, keepdims=True))
        out += [e / e.sum(1, keepdims=True)] + [r.normal(0, 3, FIELDS_SHAPE) for _ in range(2)]
    occ = 1 / (1 + np.exp(-r.normal(0, 1, FIELDS_SHAPE[:1] + (1,) + FIELDS_SHAPE[2:])))
    return [t.astype(np.float32) for t in out + [occ]]


def batch(h, w, b, seed):
    """A seeded NHWC (frame1, target, frame2) batch of b translation triplets."""
    from fmvfi_tpu_torch.eval.synth import translation_triplet

    items = [translation_triplet(h, w, dx=2.0 + i, dy=1.0 - i, seed=seed + i) for i in range(b)]
    return tuple(np.stack([it[j] for it in items]) for j in range(3))


def layers(seed=3):
    """The halo-aware layers in float32, seeded: name -> fn(x NCHW)."""
    import torch_spatial_worker

    fns = torch_spatial_worker.layers(seed)
    return {k: fns[k] for k in LAYERS}


def fusion_models(weights_path):
    """(the seeded PhaseNet, the bundled AdaCoF, the bundled FusionNet's
    state dict)."""
    import torch_spatial_worker

    models, _ = torch_spatial_worker.models(weights_path)
    return models.phase_net, models.adacof, models.fusion_net.state_dict()


class RecordingSGD(torch.optim.SGD):
    """torch.optim.SGD that keeps the gradients of its last step."""

    def step(self, closure=None):
        self.grads = [p.grad.clone() for g in self.param_groups for p in g["params"]]
        return super().step(closure)


def digest(module):
    """A digest of a module's parameters and buffers, bit for bit."""
    h = hashlib.sha256()
    for t in module.state_dict().values():
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def main(coordinator, rank, world, out_path, weights_path, vgg_path):
    torch.set_num_threads(1)
    sys.path.insert(0, __file__.rsplit("/", 1)[0])
    from fmvfi_tpu_torch.models.adacof import smoothness_penalties
    from fmvfi_tpu_torch.parallel import distributed, spatial
    from fmvfi_tpu_torch.parallel.mesh import make_mesh
    from fmvfi_tpu_torch.pipeline.interpolate import FusionModels, _block_inputs
    from fmvfi_tpu_torch.train.losses import parse_loss_spec

    distributed.initialize(coordinator, num_processes=world, process_id=rank, backend="gloo")
    meshes = {"22": make_mesh(world, ("data", "spatial"), (2, 2)),
              "14": make_mesh(world, ("data", "spatial"), (1, 4))}
    arrays, report = {}, {"raised": {}, "metrics": {}, "routes": {}, "digest": {},
                          "exchanged": {}}

    def keep(name, x, batch_slice=slice(None), rows=slice(None)):
        arrays[name] = x.detach().numpy()
        arrays[name + "@index"] = np.array([batch_slice.start or 0, rows.start or 0])

    def bands_for(key, rows):
        """(this rank's share of a batch of 2, its Bands of `rows`)."""
        mesh = meshes[key]
        share, _ = spatial.batch_share(mesh, "data", LAYER_SHAPE[0])
        group, i, _ = spatial._share(mesh, "spatial")
        return share, spatial.Bands(group, i, rows)

    # the layers' gradients
    x = torch.from_numpy(layer_input())
    fns = layers()
    for key, rows_each in BANDS.items():
        share, bands = bands_for(key, rows_each)
        rows = slice(bands.lo, bands.hi)
        for name, fn in fns.items():
            params = list(fn.parameters()) if isinstance(fn, torch.nn.Module) else []
            with torch.no_grad():
                whole_rows = fn(x).shape[-2]
            out_lo = bands.lo * whole_rows // x.shape[-2]
            xb = x[share, :, rows].clone().requires_grad_()
            with spatial.running(bands):
                y = fn(xb)
            c = torch.from_numpy(cotangent((x.shape[0], y.shape[1], whole_rows, y.shape[-1]), 5))
            c = c[share, :, out_lo : out_lo + y.shape[-2]]
            grads = torch.autograd.grad((y * c).sum(), [xb] + params)
            keep(f"lg{key}_{name}", grads[0], share, rows)
            for i, g in enumerate(grads[1:]):
                arrays[f"lg{key}_{name}_p{i}"] = g.numpy()

    # Bands.gather's and spatial_sum's backward: rank r's objective
    # sum(gathered * c_r) + sum(spatial_sum(per-sample sums of x**2) * k_r)
    share, bands = bands_for("14", BANDS["14"])
    rows = slice(bands.lo, bands.hi)
    spatial.exchanged.clear()
    xb = x[:, :, rows].clone().requires_grad_()
    c = torch.from_numpy(cotangent(LAYER_SHAPE, 100 + bands.index))
    with spatial.running(bands):
        whole = bands.gather(xb)
        sums = spatial.spatial_sum((xb**2).sum(dim=(1, 2, 3)))
    k = torch.tensor([1.0 + bands.index, -0.5 * bands.index])
    g, = torch.autograd.grad((whole * c).sum() + (sums * k).sum(), xb)
    keep("gather_grad", g, rows=rows)
    keep("gather_whole", whole)
    keep("gather_sums", sums)
    report["exchanged"]["gather"] = dict(spatial.exchanged)

    # two exchanges undone in another order on rank 0: raises on every rank
    share, bands = bands_for("14", (16,) * 4)
    xo = x[:, :, bands.lo : bands.hi].clone().requires_grad_()
    with spatial.running(bands):
        ya, yb = (spatial.extend_rows(t, 1, 1, "zeros")[0] for t in (xo, 2 * xo))
    order = (ya, yb) if rank == 0 else (yb, ya)
    try:
        for y in order:
            torch.autograd.grad(y.sum(), xo, retain_graph=True)
    except RuntimeError as e:
        report["raised"]["order"] = str(e)

    # smoothness_penalties: shares and gradients on the bands
    heads = [torch.from_numpy(t) for t in fields()]
    for key, rows_each in BANDS.items():
        share, bands = bands_for(key, rows_each)
        rows = slice(bands.lo, bands.hi)
        hb = [t[share, :, rows].clone().requires_grad_() for t in heads]
        with spatial.running(bands):
            g_s, g_o = smoothness_penalties(*hb)
        grads = torch.autograd.grad(g_s + 3.0 * g_o, hb)
        arrays[f"smooth{key}"] = np.array([g_s.item(), g_o.item()])
        for i, gi in enumerate(grads):
            keep(f"smooth{key}_g{i}", gi, share, rows)

    # the trainers
    real = {k: getattr(spatial, k) for k in ("adacof_warp_tm_sharded", "adacof_warp_gathered")}
    routes = {}

    def counted(name):
        def warp(*args, **kw):
            routes.setdefault(name, []).append(kw["max_offset"] if "max_offset" in kw else args[5])
            return real[name](*args, **kw)
        return warp

    def run(name, state, step, data, params_of=None):
        routes.clear()
        for k in real:
            setattr(spatial, k, counted(k))
        spatial.exchanged.clear()
        try:
            state, metrics = step(state, data)
        finally:
            for k, fn in real.items():
                setattr(spatial, k, fn)
        report["metrics"][name] = {k: float(v) for k, v in metrics.items()}
        report["routes"][name] = dict(routes)
        report["exchanged"][name] = dict(spatial.exchanged)
        report["digest"][name] = digest(state.model)
        return state

    for name, (key, h, w, b, r, seed) in ADACOF_CASES.items():
        state, step = spatial.adacof_spatial_trainer(meshes[key], optimizer="sgd", device="cpu")
        state.model.max_offset = r
        opt = RecordingSGD(state.model.parameters(), lr=LR)
        opt.param_groups[0]["updates"] = 0
        state = run(name, state._replace(optimizer=opt), step, batch(h, w, b, seed))
        if rank == 0:
            for (k, _), g in zip(state.model.named_parameters(), opt.grads):
                arrays[f"{name}/{k}"] = g.numpy()

    phase, ada, fusion_sd = fusion_models(weights_path)
    for name, (key, h, w, b, seed, r, kw, bundled) in FUSION_CASES.items():
        ada.max_offset = r
        state, step = spatial.fusion_spatial_trainer(phase, ada, meshes[key], device="cpu", **kw)
        if bundled:
            state.model.load_state_dict(fusion_sd)
        data = batch(h, w, b, seed)
        state = run(name, state, step, data)
        if rank == 0:
            for k, p in state.model.named_parameters():
                arrays[f"{name}/{k}"] = state.optimizer.state[p]["exp_avg"].numpy()
        with torch.no_grad():
            inputs, share, bands, _ = _block_inputs(FusionModels(phase, ada, state.model),
                                                    data[0], data[2], torch.device("cpu"),
                                                    meshes[key])
        for k, v in inputs._asdict().items():
            if v is not None:
                keep(f"{name}_in_{k}", v, share, slice(bands.lo, bands.hi))

    for name, (key, h, w, b, r, seed) in GAN_CASES.items():
        state, step = spatial.adacof_spatial_trainer(
            meshes[key], loss_spec=parse_loss_spec(GAN_SPEC), vgg_checkpoint=vgg_path, h=h, w=w,
            optimizer="sgd", device="cpu")
        opt = RecordingSGD(state.model.parameters(), lr=LR)
        opt.param_groups[0]["updates"] = 0
        state = run(name, state._replace(optimizer=opt), step, batch(h, w, b, seed))
        report["digest"][name + "_critic"] = digest(state.extra.critic)
        if rank == 0:
            for (k, _), g in zip(state.model.named_parameters(), opt.grads):
                arrays[f"{name}/{k}"] = g.numpy()
            # Adam with b1 = 0: the first moment is the critic's gradient
            for k, p in state.extra.critic.named_parameters():
                arrays[f"{name}/critic/{k}"] = state.extra.optimizer.state[p]["exp_avg"].numpy()

    np.savez(out_path + ".npz", **arrays)
    with open(out_path + ".json", "w") as f:
        json.dump(report, f)
    print("RESULT", rank, flush=True)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5], sys.argv[6])
