#!/usr/bin/env python3
"""How closely PhaseNet training can match the JAX package at all, on the CPU.

    python3 tools/phase_train_conditioning.py

Prints one JSON line per measurement:
  - "trainer": the JAX phase trainer (jitted, jax.random.key(0) init) and
    fmvfi_tpu_torch's from the same init, 3 steps on a seeded 64x64 batch of
    2, at lr 1e-3 (the default) and 1e-5; after each step the largest
    relative metric difference and the count of params and running
    statistics off by more than 1e-4, for the port against JAX and for JAX
    against itself with the batch moved up by one ulp (np.nextafter).  The
    conv1 biases, whose gradient is zero in exact arithmetic (train-mode BN
    follows them), are counted apart.
  - "trainer_gradients": one step of each phase-trainer case of
    tests/test_torch_train_phase_grads.py (32x32, batch 2): the largest
    gap of each parameter tensor's gradient (Adam's first moment), relative
    to the tensor's largest entry, of the port in float32 and of JAX in
    float32 against JAX in float64, with the tensor where it is largest
    (the conv1 biases, zero in exact arithmetic, and tensors without
    gradient left out).
  - "core_train_mode": PhaseNetCore in train mode at 128x128 (8 levels),
    flax against the port in float32 and both against the port in float64,
    on well-conditioned random inputs and on the normalized pyramid of
    noise frames: the largest output differences and the count of outputs
    off by more than 1e-5.
Needs jax and flax (the reference); no card.
"""

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    from flax import serialization

    from fmvfi_tpu.models import phase_net as jx_phase
    from fmvfi_tpu.train import trainer as jx_trainer
    from fmvfi_tpu_torch.eval.synth import translation_triplet
    from fmvfi_tpu_torch.models.adacof import AdaCoFNet
    from fmvfi_tpu_torch.models.phase_net import PhaseNetCore, normalize_inputs
    from fmvfi_tpu_torch.ops import decomp
    from fmvfi_tpu_torch.ops.pyramid import decompose, make_filters, max_pyr_height
    from fmvfi_tpu_torch.train.trainer import make_phase_trainer
    from fmvfi_tpu_torch.utils import convert

    torch.set_num_threads(1)
    items = [translation_triplet(64, 64, dx=3.0 + i, dy=1.0 - i, seed=i) for i in range(2)]
    batch = tuple(np.stack([it[j] for it in items]) for j in range(3))
    nudged = tuple(np.nextafter(b, np.float32(2)) for b in batch)

    def sd_of(state):
        return convert.phase_net_from_flax({"params": jax.tree.map(np.asarray, state.params),
                                            "batch_stats": jax.tree.map(np.asarray, state.extra)})

    def off(sd, ref):
        """(entries off by > 1e-4 but conv1 biases, of how many, conv1 bias max diff)."""
        n = total = 0
        bias = 0.0
        for k, v in sd.items():
            if k not in ref or "num_batches" in k:
                continue
            d = (v - ref[k]).abs()
            if k.endswith("conv1.bias"):
                bias = max(bias, float(d.max()))
                continue
            n += int((d > 1e-4).sum())
            total += d.numel()
        return n, total, bias

    for lr in (1e-3, 1e-5):
        state, step, _, _ = jx_trainer.make_phase_trainer(jax.random.key(0), 64, 64, lr=lr)
        fn = jax.jit(step)
        ours, ours_step, _, _ = make_phase_trainer(64, 64, lr=lr, device="cpu")
        ours.model.load_state_dict(sd_of(state), strict=False)
        moved = state
        for i in range(3):
            state, met = fn(state, batch)
            moved, met_moved = fn(moved, nudged)
            ours, met_ours = ours_step(ours, batch)
            ref = sd_of(state)
            rel = lambda m: max(abs(float(m[k]) / float(met[k]) - 1) for k in met)  # noqa: E731
            p_off, n, p_bias = off(ours.model.state_dict(), ref)
            j_off, _, j_bias = off(sd_of(moved), ref)
            print(json.dumps(dict(measure="trainer", lr=lr, step=i + 1, entries=n,
                                  port_metric_rel=rel(met_ours), port_entries_off=p_off,
                                  port_conv1_bias_max=p_bias, jax_nudged_metric_rel=rel(met_moved),
                                  jax_nudged_entries_off=j_off, jax_nudged_conv1_bias_max=j_bias)),
                  flush=True)

    with open(os.path.join(ROOT, "checkpoints", "adacof_synth_demo.msgpack"), "rb") as f:
        ada_tree = serialization.msgpack_restore(f.read())
    items = [translation_triplet(32, 32, dx=3.0 + i, dy=1.0 - i, seed=i) for i in range(2)]
    small = tuple(np.stack([it[j] for it in items]) for j in range(3))

    def f64(tree):
        return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64)
                            if jnp.asarray(a).dtype == jnp.float32 else a, tree)

    def jax_mu(kw, m, x64):
        """(float32 init tree, Adam's first moment after one step)."""
        with jax.enable_x64(x64):
            ada = f64(ada_tree) if x64 else ada_tree
            state, step, _, make_step = jx_trainer.make_phase_trainer(
                jax.random.key(0), 32, 32, adacof_vars=ada if kw else None, **kw)
            init = {"params": jax.tree.map(np.asarray, state.params),
                    "batch_stats": jax.tree.map(np.asarray, state.extra)}
            batch = small
            if x64:
                state = state._replace(params=f64(state.params), extra=f64(state.extra),
                                       opt_state=f64(state.opt_state))
                batch = tuple(np.asarray(b, np.float64) for b in small)
            state, _ = jax.jit(step if m is None else make_step(m))(state, batch)
            mu = [s for s in jax.tree_util.tree_leaves(state.opt_state,
                                                       is_leaf=lambda x: hasattr(x, "mu"))
                  if hasattr(s, "mu")][0].mu
            return init, convert.phase_net_from_flax(
                {"params": jax.tree.map(np.asarray, mu), "batch_stats": init["batch_stats"]})

    def worst(grads, ref):
        gaps = {k: float((g.double() - ref[k].double()).abs().max() / ref[k].abs().max())
                for k, g in grads.items() if not k.endswith("conv1.bias") and ref[k].abs().max() > 0}
        k = max(gaps, key=gaps.get)
        return gaps[k], k

    for name, m, kw in (("phase", None, {}), ("phase_m3", 3, {}),
                        ("fusion_v0", None, dict(mode="fusion", model_variant=0)),
                        ("fusion_v1", None, dict(mode="fusion", model_variant=1)),
                        ("high_level", None, dict(high_level=True))):
        init, exact = jax_mu(kw, m, True)
        _, single = jax_mu(kw, m, False)
        ada = None
        if kw:
            ada = AdaCoFNet(max_offset=None)
            ada.load_state_dict(convert.adacof_from_flax(ada_tree))
        ours, ours_step, _, make_step = make_phase_trainer(32, 32, adacof=ada, **kw, device="cpu")
        ours.model.load_state_dict(convert.phase_net_from_flax(init), strict=False)
        ours, _ = (ours_step if m is None else make_step(m))(ours, small)
        port = {k: ours.optimizer.state[p]["exp_avg"] for k, p in ours.model.named_parameters()
                if k in exact}
        (p_gap, p_at), (j_gap, j_at) = worst(port, exact), worst(
            {k: single[k] for k in port}, exact)
        print(json.dumps(dict(measure="trainer_gradients", case=name, size=32,
                              port_f32_vs_jax_f64=p_gap, port_worst_tensor=p_at,
                              jax_f32_vs_jax_f64=j_gap, jax_worst_tensor=j_at)), flush=True)

    core = jx_phase.PhaseNetCore(num_img=2)
    low0, lev0 = jnp.zeros((1, 4, 4, 2)), [jnp.zeros((1, 4, 4, 8))] * 7
    tree = jax.tree.map(np.asarray, jax.jit(core.init)(jax.random.key(2), low0, lev0, lev0))
    filters = make_filters(128, 128, max_pyr_height(128, 128))
    rng = np.random.default_rng(128)

    def to_t(a):
        return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))

    def to_np(t):
        return np.moveaxis(t.detach().double().numpy(), 1, -1)

    random_in = (rng.normal(size=(6, *filters.low_shape, 2)).astype(np.float32),
                 [rng.uniform(-1, 1, (6, *s, 8)).astype(np.float32)
                  for s in filters.level_shapes[::-1]],
                 [rng.uniform(0, 1, (6, *s, 8)).astype(np.float32)
                  for s in filters.level_shapes[::-1]])
    frames = [torch.from_numpy(rng.uniform(0, 1, (6, 128, 128)).astype(np.float32))
              for _ in range(2)]
    low, ph, am, _ = normalize_inputs(*decomp.concat_for_net([decompose(f, filters)
                                                              for f in frames]))
    pyramid_in = (to_np(low).astype(np.float32), [to_np(p).astype(np.float32) for p in ph],
                  [to_np(a).astype(np.float32) for a in am])
    apply = jax.jit(lambda v, *a: core.apply(v, *a, train=True, mutable=["batch_stats"])[0])
    for name, (lo, phs, ams) in (("random", random_in), ("pyramid", pyramid_in)):
        flax_out = apply(tree, lo, phs, ams)
        outs = {}
        for dtype in (torch.float32, torch.float64):
            net = PhaseNetCore().to(dtype)
            net.load_state_dict(convert.phase_net_from_flax(tree))
            got = net(to_t(lo).to(dtype), [to_t(p).to(dtype) for p in phs],
                      [to_t(a).to(dtype) for a in ams], train=True)
            outs[dtype] = [to_np(t) for t in (got[0], *got[1], *got[2])]
        ref = [np.asarray(t, np.float64) for t in (flax_out[0], *flax_out[1], *flax_out[2])]
        exact = outs[torch.float64]
        print(json.dumps(dict(
            measure="core_train_mode", inputs=name, size=128, levels=len(phs),
            outputs=int(sum(r.size for r in ref)),
            port_vs_flax_max=max(float(np.abs(a - b).max()) for a, b in zip(outs[torch.float32], ref)),
            port_vs_flax_over_1e5=int(sum((np.abs(a - b) > 1e-5).sum()
                                          for a, b in zip(outs[torch.float32], ref))),
            flax_vs_float64_max=max(float(np.abs(a - b).max()) for a, b in zip(ref, exact)),
            port_vs_float64_max=max(float(np.abs(a - b).max())
                                    for a, b in zip(outs[torch.float32], exact)))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
