"""One rank of the spatial-sharding check of tests/test_torch_spatial.py (not
collected by pytest: no test_ prefix).

    python tests/torch_spatial_worker.py HOST:PORT RANK WORLD OUT WEIGHTS

Joins a gloo group of WORLD (4) CPU processes through
fmvfi_tpu_torch.parallel.distributed.initialize, builds a ("data",
"spatial") mesh of (2, 2) and one of (1, 4), and runs, on its share of the
seeded inputs (`inputs()`, the test makes the same):
  - `adacof_warp_tm_sharded` on hand-made equal bands: R = 12 on the
    (2, 2) mesh, R = 5 on (1, 4), forward and the field gradients of
    sum(out ** 2); R = 12 on (1, 4), whose 8-row bands cannot host the
    15-row halo, must raise ValueError;
  - each halo-aware layer on unequal bands (24, 16, 16, 8) of a 64-row
    frame over (1, 4), and the align_corners=True upsample of a band
    upsampled as an image of its own (the fault the band weights avoid);
  - AdaCoFNet (the test's seeded weights) on its band of the 64x32 batch
    of 4 under the (2, 2) mesh's bands, max_offset 24 (the halo warp) and
    48 (the gathered, unclamped warp), the routes counted;
  - fusion_interpolate(spatial_mesh=) on (2, 2) at 64x64, batch 4 (the
    bundled AdaCoF and FusionNet, the test's seeded PhaseNet) with
    return_parts, and at 75x44, batch 2, with max_offset 24, where the /8
    and /32 pads land on the last band; phase_interpolate(spatial_mesh=)
    at 64x64, batch 4;
  - a height that cannot be split over the spatial axis.
Each block goes to OUT.npz with its batch and row indices; routes, halo
bytes and the raised messages to OUT.json.
"""

import json
import sys

import numpy as np
import torch

F_TAPS, WARP_SHAPE = 5, (4, 3, 32, 24)  # B, C, H, W
LAYER_ROWS = (24, 16, 16, 8)  # the layer check's bands of a 64-row frame
LAYER_SHAPE = (2, 4, 64, 20)


def warp_inputs():
    """x (B, C, H, W) and the fields (B, F*F, H, W): softmax weights and
    offsets of sigma 9, beyond the clamps R = 5 and 12."""
    r = np.random.default_rng(0)
    b, c, h, w = WARP_SHAPE
    x = r.random((b, c, h, w), dtype=np.float32)
    logits = r.normal(0, 1, (b, F_TAPS**2, h, w)).astype(np.float32)
    e = np.exp(logits - logits.max(1, keepdims=True))
    wgt = (e / e.sum(1, keepdims=True)).astype(np.float32)
    a, be = (r.normal(0, 9.0, (b, F_TAPS**2, h, w)).astype(np.float32) for _ in range(2))
    return x, wgt, a, be


def layer_input():
    return np.random.default_rng(1).normal(0, 1, LAYER_SHAPE).astype(np.float32)


def frames(h, w, b, seed):
    """b translation triplets' first and second frames, (b, h, w, 3) each."""
    from fmvfi_tpu_torch.eval.synth import translation_triplet

    pairs = [translation_triplet(h, w, dx=2.0 + i, dy=1.0, seed=seed + i) for i in range(b)]
    return np.stack([p[0] for p in pairs]), np.stack([p[2] for p in pairs])


def layers(seed=3):
    """The halo-aware layers, seeded: name -> fn(x NCHW) -> NCHW."""
    from fmvfi_tpu_torch.models.conv import Conv2d, TapConv2d
    from fmvfi_tpu_torch.models.fusion_net import _RConv
    from fmvfi_tpu_torch.ops.resize import avg_pool2, max_pool2, upsample2x

    torch.manual_seed(seed)
    c = LAYER_SHAPE[1]
    conv, tap = Conv2d(c, 6, 3, padding=1), TapConv2d(c, 6)
    rconv = {k: _RConv(c, 5, k) for k in (5, 3, 1)}
    bf = lambda f: (lambda x: f(x.bfloat16()).float())
    fns = {
        "conv3": conv, "conv3_bf16": bf(conv), "tapconv": tap, "tapconv_bf16": bf(tap),
        "avg_pool2": avg_pool2, "max_pool2": max_pool2,
        "up_false": lambda x: upsample2x(x, align_corners=False),
        "up_true": lambda x: upsample2x(x, align_corners=True),
        "up_false_bf16": bf(lambda x: upsample2x(x, align_corners=False)),
        "up_true_bf16": bf(lambda x: upsample2x(x, align_corners=True)),
        # at the 8x coarser level (bands of 3, 2, 2, 1 rows)
        "up_true_s8": lambda x: upsample2x(x[..., ::8, :], align_corners=True),
        "up_true_s8_bf16": bf(lambda x: upsample2x(x[..., ::8, :], align_corners=True)),
    }
    fns.update({f"rconv{k}": m for k, m in rconv.items()})
    return fns


def models(weights_path, device="cpu"):
    """(FusionModels with the bundled AdaCoF / FusionNet and the seeded
    PhaseNet, the seeded AdaCoFNet of the routing check)."""
    import os

    from fmvfi_tpu_torch.models.adacof import AdaCoFNet
    from fmvfi_tpu_torch.models.fusion_net import FusionNet, infer_variant
    from fmvfi_tpu_torch.models.phase_net import PhaseNetCore
    from fmvfi_tpu_torch.pipeline.interpolate import FusionModels
    from fmvfi_tpu_torch.utils.convert import load_adacof_weights, load_fusion_weights

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sd = torch.load(weights_path, weights_only=True)
    phase = PhaseNetCore().eval()
    phase.load_state_dict(sd["phase"])
    ada = AdaCoFNet().eval()
    ada.load_state_dict(load_adacof_weights(os.path.join(root, "checkpoints",
                                                         "adacof_synth_demo.msgpack")))
    fsd = load_fusion_weights(os.path.join(root, "checkpoints", "fusion_synth_demo.msgpack"))
    fusion = FusionNet(uncertainty_maps=3, variant=infer_variant(fsd)).eval()
    fusion.load_state_dict(fsd)
    seeded = AdaCoFNet().eval()
    seeded.load_state_dict(sd["adacof"])
    return FusionModels(phase, ada, fusion), seeded


def main(coordinator, rank, world, out_path, weights_path):
    torch.set_num_threads(1)
    from fmvfi_tpu_torch.parallel import distributed, spatial
    from fmvfi_tpu_torch.parallel.mesh import make_mesh
    from fmvfi_tpu_torch.pipeline.interpolate import fusion_interpolate, phase_interpolate

    distributed.initialize(coordinator, num_processes=world, process_id=rank, backend="gloo")
    mesh22 = make_mesh(world, ("data", "spatial"), (2, 2))
    mesh14 = make_mesh(world, ("data", "spatial"), (1, 4))
    arrays, report = {}, {"raised": {}}

    def keep(name, x, batch=slice(None), rows=slice(None)):
        arrays[name] = x.detach().numpy()
        arrays[name + "@index"] = np.array([batch.start or 0, rows.start or 0])

    def raised(name, fn):
        try:
            fn()
        except ValueError as e:
            report["raised"][name] = str(e)

    # the halo warp, on equal bands as the JAX package's shards
    x, wgt, a, b = (torch.from_numpy(t) for t in warp_inputs())
    for name, mesh, r in (("warp_r12", mesh22, 12), ("warp_r5", mesh14, 5)):
        share, _ = spatial.batch_share(mesh, "data", x.shape[0])
        group, i, n = spatial._share(mesh, "spatial")
        rows_each = x.shape[2] // n
        bands = spatial.Bands(group, i, (rows_each,) * n, x.shape[0] // (share.stop - share.start))
        rows = slice(bands.lo, bands.hi)
        fields = [t[share, :, rows].clone().requires_grad_() for t in (wgt, a, b)]
        with spatial.running(bands):
            o = spatial.adacof_warp_tm_sharded(x[share, :, rows], *fields, 1, max_offset=r)
        (o**2).sum().backward()
        keep(name, o, share, rows)
        for k, f in zip(("dw", "da", "db"), fields):
            keep(f"{name}_{k}", f.grad, share, rows)
    group, i, n = spatial._share(mesh14, "spatial")
    bands = spatial.Bands(group, i, (8,) * 4)
    with spatial.running(bands):
        raised("short_band", lambda: spatial.adacof_warp_tm_sharded(
            x[:, :, bands.lo:bands.hi], *(t[:, :, bands.lo:bands.hi] for t in (wgt, a, b)), 1,
            max_offset=12))

    # the layers, on unequal bands
    bands = spatial.Bands(group, i, LAYER_ROWS)
    xl = torch.from_numpy(layer_input())
    rows = slice(bands.lo, bands.hi)
    with torch.no_grad():
        for name, fn in layers().items():
            with spatial.running(bands):
                y = fn(xl[:, :, rows])
            scale = 2 if name.startswith("up") else 0.5 if "pool" in name else 1
            s = 8 if name.startswith("up_true_s8") else 1
            keep("layer_" + name, y, rows=slice(int(bands.lo // s * scale), None))
        own = torch.nn.functional.interpolate(xl[:, :, rows], scale_factor=2, mode="bilinear",
                                              align_corners=True)
        keep("layer_up_true_as_image", own, rows=slice(2 * bands.lo, None))

    # AdaCoFNet under the (2, 2) mesh's bands: the halo warp and the gathered one
    pipeline_models, seeded = models(weights_path)
    f1, f2 = (torch.from_numpy(f).permute(0, 3, 1, 2) for f in frames(64, 32, 4, seed=5))
    share, _ = spatial.batch_share(mesh22, "data", 4)
    bands = spatial.bands_of(mesh22, "spatial", 64, n_data=2)
    rows = slice(bands.lo, bands.hi)
    routes = {}
    real = {k: getattr(spatial, k) for k in ("adacof_warp_tm_sharded", "adacof_warp_gathered")}

    def counted(name):
        def warp(*args, **kw):
            routes.setdefault(name, []).append(kw["max_offset"] if "max_offset" in kw else args[5])
            return real[name](*args, **kw)
        return warp

    for r in (24, 48):
        seeded.max_offset = r
        routes.clear()
        for name in real:
            setattr(spatial, name, counted(name))
        try:
            with torch.no_grad(), spatial.running(bands):
                o = seeded(f1[share, :, rows], f2[share, :, rows])
        finally:
            for name, fn in real.items():
                setattr(spatial, name, fn)
        keep(f"adacof_r{r}", o.blended.permute(0, 2, 3, 1), share, rows)
        report[f"adacof_r{r}_routes"] = dict(routes)
    seeded.max_offset = 24
    applied = spatial.spatial_apply(
        lambda m, a, b: m(a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2)).blended.permute(0, 2, 3, 1),
        mesh22, axis="spatial")
    with torch.no_grad():
        res = applied(seeded, f1[:2].permute(0, 2, 3, 1), f2[:2].permute(0, 2, 3, 1))
    keep("spatial_apply", res.local, res.batch, res.rows)
    report["placements"] = [
        spatial.spatial_image_sharding(mesh22, 64, "spatial")[1] == res.rows,
        spatial.data_spatial_sharding(mesh22, 4, 64) == (share, rows)]
    keep("spatial_apply_gathered", res.gather())

    # the fused pipeline and phase_interpolate under the meshes
    spatial.exchanged.clear()
    f1, f2 = frames(64, 64, 4, seed=7)
    out, parts = fusion_interpolate(pipeline_models, f1, f2, return_parts=True, device="cpu",
                                    spatial_mesh=mesh22)
    keep("fusion64", out)
    for k, v in parts.items():
        keep(f"fusion64_{k}", v)
    report["exchanged"] = dict(spatial.exchanged)
    pipeline_models.adacof.max_offset = 24
    f1, f2 = frames(75, 44, 2, seed=9)
    keep("fusion75", fusion_interpolate(pipeline_models, f1, f2, device="cpu",
                                        spatial_mesh=mesh22))
    pipeline_models.adacof.max_offset = 48
    f1, f2 = frames(64, 64, 4, seed=11)
    keep("phase64", phase_interpolate(pipeline_models.phase_net, f1, f2, device="cpu",
                                      spatial_mesh=mesh22))
    f1, f2 = frames(40, 40, 2, seed=13)
    raised("height", lambda: fusion_interpolate(pipeline_models, f1, f2, device="cpu",
                                                spatial_mesh=mesh22))

    np.savez(out_path + ".npz", **arrays)
    with open(out_path + ".json", "w") as f:
        json.dump(report, f)
    print("RESULT", rank, flush=True)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
