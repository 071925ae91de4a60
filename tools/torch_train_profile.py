#!/usr/bin/env python3
"""Where the time of one training step of fmvfi_tpu_torch goes on a CUDA
card, for each regime asked for.

    python3 tools/torch_train_profile.py [--regime adacof phase fusion]

Builds the port's trainer of each regime with random weights from seed 0,
fp32 with TF32 off, at the training shapes of chip_smoke.py: AdaCoF at batch
4 (the default loss, Adamax), PhaseNet at batch 8 (height 12, Adam),
FusionNet at batch 4 (variant 2 behind a random AdaCoF and PhaseNet), all at
256x256.  It takes 3 warm-up steps on a seeded synthetic batch, then traces
5 steps with torch.profiler and prints one JSON line per regime: the host
ms per step (the steps end in a synchronize), the device's kernel ms per
step, its idle share and its kernel launches per step, the kernel time of
K1, K2, the convolutions and cuFFT per step, and the top kernels.  Exits non-zero
without a card.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

STEPS, CROP = 5, 256
BATCH = dict(adacof=4, phase=8, fusion=4)
CONV_MARKS = ("conv", "cudnn", "xmma", "implicit_gemm", "wgrad", "dgrad", "fprop", "winograd")


def _device_us(avg) -> float:
    """Self device time of a profiler average, across torch versions."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(avg, name):
            return float(getattr(avg, name))
    return 0.0


def _trainer(regime, torch):
    from fmvfi_tpu_torch.models.adacof import AdaCoFNet
    from fmvfi_tpu_torch.models.phase_net import PhaseNetCore
    from fmvfi_tpu_torch.train.trainer import (
        make_adacof_trainer,
        make_fusion_trainer,
        make_phase_trainer,
    )

    if regime == "adacof":
        return make_adacof_trainer(device="cuda")
    if regime == "phase":
        state, step, _, _ = make_phase_trainer(CROP, CROP, device="cuda")
        return state, step
    torch.manual_seed(0)
    phase = PhaseNetCore().init_params(torch.Generator().manual_seed(0)).cuda()
    return make_fusion_trainer(phase, AdaCoFNet().cuda(), variant=2, device="cuda")


def profile_regime(regime, smi) -> dict:
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
    state, step = _trainer(regime, torch)
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
        peak_memory_bytes=torch.cuda.max_memory_allocated(),
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
