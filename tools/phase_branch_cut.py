#!/usr/bin/env python3
"""Where the fusion pipeline's PhaseNet prediction leaves the JAX package's on
a batch, on the CPU.

    python3 tools/phase_branch_cut.py [SEED ...]   (default: 23 0)

For each seed, the batch of tests/torch_spatial_train_worker.py::batch
(4 translation triplets of 64x64) and the PhaseNet of
tests/test_torch_spatial_train.py (PhaseNetCore().init_params(seed 0)):
  - "prediction": the pipeline's PhaseNet prediction (RGB) of the JAX
    package (its fusion_interpolate jitted, and eagerly) and of
    fmvfi_tpu_torch, each against a float64 reference (the decomposition in
    numpy float64 on the port's filter bank, PhaseNet in float64): the
    largest difference and the pixels off by more than 1e-5;
  - "branch_cut": the band entries of the float64 decomposition nearest
    the phase's branch cut at +-pi, and for each the port's float32 phase
    there, and what flipping that one entry by 2 pi in the port's input
    does: the prediction's largest difference from the float64 reference
    and from the JAX package's jitted prediction.
PhaseNet reads phase / pi, which jumps from 1 to -1 across the cut, so an
entry within float32 rounding of it lands on either side in two correct
float32 programs.
Needs jax and flax (the reference); no card.
"""

import copy
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = W = 64
BATCH = 4
NEAREST = 4  # branch-cut entries reported per seed


def main(seeds) -> int:
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch
    from flax import serialization

    import torch_spatial_train_worker as worker
    from fmvfi_tpu.ops import color as jc
    from fmvfi_tpu.ops import pyramid as jp
    from fmvfi_tpu.pipeline import interpolate as ji
    from fmvfi_tpu_torch.models import phase_net as ppn
    from fmvfi_tpu_torch.ops import color as pc
    from fmvfi_tpu_torch.ops import decomp as pd
    from fmvfi_tpu_torch.ops import pyramid as pp
    from fmvfi_tpu_torch.utils import convert

    torch.set_num_threads(4)
    net = ppn.PhaseNetCore().init_params(torch.Generator().manual_seed(0)).eval()
    net64 = copy.deepcopy(net).double()
    flt = pp.make_filters(H, W, pp.max_pyr_height(H, W))

    def restore(name):
        with open(os.path.join(ROOT, "checkpoints", name), "rb") as f:
            return serialization.msgpack_restore(f.read())

    weights = ji.FusionWeights(phase_net=convert.phase_net_to_flax(net.state_dict()),
                               adacof=restore("adacof_synth_demo.msgpack"),
                               fusion_net=restore("fusion_synth_demo.msgpack"))

    def jax_phase(f1, f2):
        return ji.fusion_interpolate(weights, f1, f2, variant=2, uncertainty_maps=3,
                                     return_parts=True)[1]["phase"]

    def decompose64(img):
        """pyramid.decompose in numpy float64 on the port's filter bank."""
        def f64(t):
            return t.numpy().astype(np.float64)

        def fft2s(x):
            return np.fft.fftshift(np.fft.fft2(x), axes=(-2, -1))

        def ifft2s(x):
            return np.fft.ifft2(np.fft.ifftshift(x, axes=(-2, -1)))

        dft = fft2s(img)
        high = ifft2s(dft * f64(flt.hi0)).real
        lodft = dft * f64(flt.lo0)
        cf = (0 - 1j) ** (flt.nbands - 1)
        phases, amps = [], []
        for lvl in range(flt.height - 2):
            band = ifft2s(lodft[:, None] * f64(flt.band_masks[lvl])[None]) * cf
            amps.append(np.abs(band))
            phases.append(np.arctan2(band.imag, band.real))
            r0, r1, c0, c1 = flt.crops[lvl]
            lodft = lodft[:, r0:r1, c0:c1] * f64(flt.lo_masks[lvl])
        t = torch.from_numpy
        return pd.Decomp(high=t(high), low=t(ifft2s(lodft).real), phase=tuple(map(t, phases)),
                         amplitude=tuple(map(t, amps)))

    def predict(vals, model):
        """The pipeline's PhaseNet section from a decomposition: (B, 3, H, W) RGB."""
        v1, v2 = pd.split_frames(vals, 2)
        lown, pn, an, norm = ppn.normalize_inputs(*pd.concat_for_net([v1, v2]))
        with torch.no_grad():
            dec = ppn.predictions_to_decomp(*model(lown, pn, an), norm, torch.zeros_like(v1.high))
        dec = pd.Decomp(high=dec.high.float(), low=dec.low.float(),
                        phase=tuple(p.float() for p in dec.phase),
                        amplitude=tuple(a.float() for a in dec.amplitude))
        lab = pp.reconstruct(dec, flt).reshape(BATCH, 3, H, W)
        return torch.clamp(pc.lab_to_rgb(lab), 0.0, 1.0).double()

    def gap(a, b):
        d = (a - b).abs()
        return dict(max=float(d.max()), px_over_1e5=int((d.amax(1) > 1e-5).sum()))

    for seed in seeds:
        f1, _, f2 = worker.batch(H, W, BATCH, seed)
        n1, n2 = (torch.from_numpy(f).permute(0, 3, 1, 2) for f in (f1, f2))

        def lab(dtype):
            return torch.cat([pc.rgb_to_lab(n.to(dtype)).reshape(-1, H, W) for n in (n1, n2)])

        v64, v32 = decompose64(lab(torch.float64).numpy()), pp.decompose(lab(torch.float32), flt)
        ref = predict(v64, net64)
        port = predict(v32, net)
        jaxed = {}
        for mode, fn in (("jit", jax.jit(jax_phase)), ("eager", jax_phase)):
            out = np.asarray(fn(jnp.asarray(f1), jnp.asarray(f2)), np.float64)
            jaxed[mode] = torch.from_numpy(out).permute(0, 3, 1, 2)
        print(json.dumps(dict(seed=seed, prediction=dict(
            port=gap(port, ref), jax_jit=gap(jaxed["jit"], ref), jax_eager=gap(jaxed["eager"], ref),
            jax_jit_vs_port=gap(jaxed["jit"], port)))), flush=True)
        near = sorted((float(np.pi - abs(p[i])), lvl, i) for lvl, p in
                      enumerate(t.numpy() for t in v64.phase)
                      for i in zip(*np.nonzero(np.pi - np.abs(p) < 1e-4)))
        cut = []
        for dist, lvl, idx in near[:NEAREST]:
            phases = list(v32.phase)
            p = phases[lvl].clone()
            p[idx] -= 2 * np.pi * np.sign(float(p[idx]))
            phases[lvl] = p
            moved = predict(v32._replace(phase=tuple(phases)), net)
            cut.append(dict(level=lvl, entry=[int(i) for i in idx], rad_from_cut_f64=dist,
                            f64=float(v64.phase[lvl][idx]), port_f32=float(v32.phase[lvl][idx]),
                            flipped_vs_f64=gap(moved, ref), flipped_vs_jax_jit=gap(moved, jaxed["jit"])))
        print(json.dumps(dict(seed=seed, branch_cut=cut)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main([int(a) for a in sys.argv[1:]] or [23, 0]))
