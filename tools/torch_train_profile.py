#!/usr/bin/env python3
"""Where the time of one training step of fmvfi_tpu_torch goes on a CUDA
card, for each regime asked for.

    python3 tools/torch_train_profile.py [--regime adacof adacof_gan phase fusion]

Builds the port's trainer of each regime with random weights from seed 0,
fp32 with TF32 off, at the training shapes of chip_smoke.py: AdaCoF at batch
4 (the default loss, Adamax), AdaCoF with the VGG and T_WGAN_GP terms
(adacof_gan: the default loss + 0.01*VGG + 0.005*T_WGAN_GP, a seeded
vgg16 state dict, batch 4), PhaseNet at batch 8 (height 12, Adam),
FusionNet at batch 4 (variant 2 behind a random AdaCoF and PhaseNet), all at
256x256.  It takes 3 warm-up steps on a seeded synthetic batch, then traces
5 steps with torch.profiler and prints one JSON line per regime: the host
ms per step (the steps end in a synchronize), the device's kernel ms per
step, its idle share and its kernel launches per step, the kernel time of
K1, K2, the convolutions and cuFFT per step, and the top kernels.  For
adacof_gan it also times, with CUDA events and on their own at the step's
shapes, the VGG term (forward on prediction and target, backward to the
prediction), the adversarial step (critic update and generator loss,
backward to the fake) and the same step without the gradient penalty.
Exits non-zero without a card.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

STEPS, CROP = 5, 256
BATCH = dict(adacof=4, adacof_gan=4, phase=8, fusion=4)
GAN_SPEC = "+0.01*VGG+0.005*T_WGAN_GP"  # added to the default loss in adacof_gan
CONV_MARKS = ("conv", "cudnn", "xmma", "implicit_gemm", "wgrad", "dgrad", "fprop", "winograd")


def _device_us(avg) -> float:
    """Self device time of a profiler average, across torch versions."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(avg, name):
            return float(getattr(avg, name))
    return 0.0


def _trainer(regime, torch, vgg_path):
    from fmvfi_tpu_torch.models.adacof import AdaCoFNet
    from fmvfi_tpu_torch.models.phase_net import PhaseNetCore
    from fmvfi_tpu_torch.train.losses import parse_loss_spec
    from fmvfi_tpu_torch.train.trainer import (
        DEFAULT_LOSS,
        make_adacof_trainer,
        make_fusion_trainer,
        make_phase_trainer,
    )

    if regime == "adacof":
        return make_adacof_trainer(device="cuda")
    if regime == "adacof_gan":
        return make_adacof_trainer(loss_spec=parse_loss_spec(DEFAULT_LOSS + GAN_SPEC),
                                   vgg_checkpoint=vgg_path, h=CROP, w=CROP, device="cuda")
    if regime == "phase":
        state, step, _, _ = make_phase_trainer(CROP, CROP, device="cuda")
        return state, step
    torch.manual_seed(0)
    phase = PhaseNetCore().init_params(torch.Generator().manual_seed(0)).cuda()
    return make_fusion_trainer(phase, AdaCoFNet().cuda(), variant=2, device="cuda")


def _event_ms(torch, fn, reps=5):
    """Median of `reps` CUDA-event timings of fn, after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def _gan_components(torch, state, batch, vgg_path) -> dict:
    """The VGG term and the adversarial step of adacof_gan, each timed on
    its own at the step's shapes."""
    from fmvfi_tpu_torch.train.adversarial import Adversarial
    from fmvfi_tpu_torch.train.vgg import VGGLoss

    f1, target, f2 = (torch.from_numpy(np.moveaxis(a, -1, 1).copy()).cuda() for a in batch)
    pred = (0.5 * (f1 + f2)).requires_grad_(True)
    vgg = VGGLoss(vgg_path, "cuda")
    adv = Adversarial("T_WGAN_GP", (CROP, CROP), device="cuda")
    adv_state = state.extra

    def vgg_term():
        torch.autograd.grad(vgg(pred, target), pred)

    def adv_step():
        g_loss, _, _ = adv.step(adv_state, pred, target, (f1, f2))
        torch.autograd.grad(g_loss, pred)

    out = dict(vgg_term_ms=_event_ms(torch, vgg_term),
               adversarial_step_ms=_event_ms(torch, adv_step))
    adv.gp = False  # the same step without the gradient penalty
    out["adversarial_step_without_gp_ms"] = _event_ms(torch, adv_step)
    return out


def profile_regime(regime, smi) -> dict:
    build = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:  # the seeded vgg16 file
        vgg_path = None
        if regime == "adacof_gan":
            from chip_smoke import _seeded_vgg16

            vgg_path = _seeded_vgg16(os.path.join(tmp, "vgg16.pth"))
        return _profile_regime(regime, smi, vgg_path)


def _profile_regime(regime, smi, vgg_path) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fmvfi_tpu_torch.eval.synth import translation_triplet
    from fmvfi_tpu_torch.ops import adacof_cuda
    from fmvfi_tpu_torch.train.data import augment_triplet

    rng = np.random.default_rng(0)
    size = CROP + 16
    items = [
        augment_triplet(translation_triplet(size, size, dx=2.0 + i, dy=1.0, seed=i), rng,
                        crop=CROP)
        for i in range(BATCH[regime])
    ]
    batch = tuple(np.stack([it[j] for it in items]) for j in range(3))
    state, step = _trainer(regime, torch, vgg_path)
    for _ in range(3):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    adacof_cuda.launches = adacof_cuda.bwd_launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # device work only: kernels and copies have no host time of their own;
    # operators and annotated ranges (Optimizer.step#...) do
    kernels, launches = {}, 0
    for avg in prof.key_averages():
        us = _device_us(avg)
        if us > 0 and avg.cpu_time_total == 0 and "#" not in avg.key:
            kernels[avg.key] = kernels.get(avg.key, 0.0) + us
            launches += avg.count
    busy_ms = sum(kernels.values()) / 1e3
    per_step = lambda ms: ms / STEPS  # noqa: E731

    def group(pred):
        return per_step(sum(us for k, us in kernels.items() if pred(k.lower())) / 1e3)

    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    peak = torch.cuda.max_memory_allocated()
    components = _gan_components(torch, state, batch, vgg_path) if regime == "adacof_gan" else {}
    return dict(
        nvidia_smi=smi, torch=torch.__version__, regime=regime, batch=BATCH[regime], crop=CROP,
        steps=STEPS, k1_launches=adacof_cuda.launches, k2_launches=adacof_cuda.bwd_launches,
        host_ms_per_step=per_step(wall_ms),
        device_ms_per_step=per_step(busy_ms) if busy_ms > 0 else None,
        device_idle_share=(1.0 - busy_ms / wall_ms) if busy_ms > 0 else None,
        device_launches_per_step=launches / STEPS,
        k1_ms_per_step=group(lambda k: "adacof_warp_fwd" in k),
        k2_ms_per_step=group(lambda k: "adacof_warp_bwd" in k),
        conv_ms_per_step=group(lambda k: any(m in k for m in CONV_MARKS)),
        # cuFFT's kernels (the pyramid, the maps), not cuDNN's FFT convolutions
        fft_ms_per_step=group(lambda k: "fft" in k and not any(m in k for m in CONV_MARKS)),
        top_kernels_ms_per_step=[[k[:120], per_step(us / 1e3)] for k, us in top],
        peak_memory_bytes=peak, **components,
    )


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--regime", nargs="+", choices=sorted(BATCH), default=["adacof"])
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    for regime in args.regime:
        print(json.dumps(profile_regime(regime, smi)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
