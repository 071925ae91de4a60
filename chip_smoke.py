#!/usr/bin/env python3
"""Smoke run of fmvfi_tpu_torch, the PyTorch/CUDA port, on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line with its seconds:
  1. card   - the card's name and power limit (nvidia-smi);
  2. build  - nvcc builds the package's CUDA kernels (K1, the AdaCoF warp,
              and K2, its field gradients), one nvcc per source in parallel;
  3. k1     - K1 against its plain PyTorch version on the card (max abs error
              <= 1e-5, f32) over every instantiation (F 5 and 11 with C 3;
              F and C at run time, here F 7 and F 3 with C 5), each through
              the asynchronous-copy ring (W % 4 == 0) and without it (the
              unaligned 37x53 cases), d in {1, 2}, offsets to +-60 with
              max_offset 48 and None, the training launch and the main
              path's 1080p launches, with the kernel's and the plain
              version's times and the byte bound;
  k2        - K2 against its plain version (autograd of the plain warp plus
              the saturation mask; max abs error <= 1e-4) over K1's cases,
              on the RGBX copy of x that K1 wrote, as on the training path,
              with times and bounds at the training launch and at the
              4-image 1080p launch;
  stress    - K1 and K2 launched back to back STRESS_LAUNCHES times each at
              the 2- and 4-image 1080p launches: every result bit-equal to
              the first, and the first within 1e-5 / 1e-4 of the plain
              version (a race in the ring would show as a difference);
  4. golden - adacof_interpolate with the bundled weights on the 128x128
              translation scene through K1: 42.967 +- 0.05 dB;
  fields    - K1 and K2 timed (and held against their plain versions) on
              the fields the bundled AdaCoF gives for the golden scene
              rendered at 1080x1920 (both frames: a 2-image launch), beside
              the same launch on uniform +-3 px offsets;
  5. serve  - fusion_interpolate at 1080x1920, batch 1, with the bundled
              AdaCoF and FusionNet weights and a seeded PhaseNet: 1 warm-up
              and 3 timed requests on seeded synthetic pairs; K1 must launch
              exactly 3 times per request, through the asynchronous-copy
              F5C3 instantiation, the output must be finite and in
              [0, 1], and the output through K1 must agree with the output
              through the plain warp at >= 60 dB PSNR;
  video     - double_frame_rate on translation_video(5, 1080, 1920) with the
              serve phase's models, each mode after a warm-up on 3 frames:
              per pair, stream (windows 8 and 2), batch 2 with seq_chunk 1
              and unchunked (on 4 frames: 3 pairs, the tail padded).  Each
              run gives 2N-1 frames with the originals bit-equal at the even
              positions, finite and in [0, 1], each interpolated frame >= 60
              dB against per pair; K1 launches exactly as many times, on as
              many images each, as the mode's structure says (per pair 2, 4,
              2 per pair; stream 4, 4 per step, one step per frame; batch 2:
              4, 8, 4 per dispatch, with seq_chunk 1: 4, then 4, 2 per
              chunk), all through the asynchronous-copy F5C3 instantiation,
              and K2 not at all; the seq_chunk=1 peak memory is below the
              unchunked one; the stream through K1 agrees with the stream
              through the plain warp at >= 60 dB.  Also: how many host
              synchronizations one request makes
              (torch.cuda.set_sync_debug_mode), and multiply_frame_rate 4x
              (adacof, 3 frames of 256x256) giving 4N-3 frames whose even
              positions are the 2x sequence;
  eval      - evaluate_suite on synthetic_sets(256, 4) (8 sets, 2 triplets
              each) for fusion, adacof, phase and baseline: finite means, a
              summary.json, K1 launched 5 times per set (3 + 1 + 0 + 1), a
              rerun served from the cache with the same numbers, and per-set
              fusion PSNR within 0.05 dB of the same suite through the plain
              warp;
  train     - AdaCoF training from the bundled weights: make_adacof_trainer
              and fit over batch_iterator(SyntheticTriplets(n=32, h=272,
              w=272), 4, crop=256), fp32, TF32 off, 1 warm-up and 20 timed
              steps; K1 and K2 must each launch exactly once per step,
              through the asynchronous-copy F5C3 instantiation, every
              loss must be finite, a checkpoint must be written and a second
              fit must resume from it, and one step's parameter gradients
              through K1/K2 must agree with the same step through the plain
              warp and its plain gradients (deterministic cuDNN) within 1e-4
              of each tensor's largest gradient;
  train_phase - PhaseNet training: make_phase_trainer at 256x256, height 12,
              batch 8 through fit over batch_iterator(SyntheticTriplets(n=32,
              h=272, w=272), 8, crop=256), 1 warm-up and 10 timed steps: finite
              losses, no K1 or K2, the BN running statistics moved (train
              mode), a checkpoint restored with them and resumed; fit's
              m-schedule (m_init 3, m_update 2) built and logged as it says;
              one step each in mode fusion (variants 0 and 1) and with
              high_level from the bundled AdaCoF, each launching K1 once on
              16 images through F5C3 with the ring and K2 never; one step at
              128x128 (lr 1e-5) on the card against the same step on the CPU:
              metrics within 1e-4 relative, params and statistics within
              1e-4, the gradient within 2e-2 of each tensor's largest;
  train_fusion - FusionNet training: make_fusion_trainer from the bundled
              variant-2 FusionNet behind the bundled AdaCoF and a seeded
              PhaseNet, batch 4 at 256x256 through fit over the mixed diet
              (SyntheticTriplets(mixed=True)), 1 warm-up and 10 timed steps,
              then one step each with loss_balance, distill, loss_psnr,
              loss_psnr + distill, weight_decay and a fresh variant-0 net
              without maps: K1 exactly 3 launches a step on 8, 16 and 8
              images through F5C3 with the ring, K2 none, finite losses, the
              frozen nets unchanged and without gradients, a checkpoint
              resumed; FusionNet's inputs through K1 within 1e-5 of the
              plain warp's (base, adacof, phase, and the artifact map before
              its 50x50 histogram median, which turns float noise at a bin
              edge into up to ~1e-2 at a few pixels: ROADMAP Q3-3); one
              step's FusionNet gradients against the plain warp's with the
              K1 route's maps and loss cotangent on both within 1e-4 of
              each tensor's largest, end to end within 1e-3, and a K1 with
              its last tap dropped over 1e-3.
Then the nvidia-smi line, the `kernels` JSON line and, last, the result line
{"ok": true, "device": {...}}.  Any failed check raises (non-zero exit).
Without CUDA, or without the package beside this file, it exits non-zero
and prints no result.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
RING_PATH = "f5c3/ring"  # the instantiation of every launch on the main paths
DESIGN = (  # of K1 and K2, for the kernels line
    "8x64 tiles; fields through a 4-stage shared-memory ring of bulk async copies "
    "(cp.async.bulk, mbarriers, L2 evict-first) fed by a producer warp; RGBX corner "
    "gathers for C=3 and F 5 or 11 (K2 reuses K1's RGBX copy); tap loop unrolled for F 5 and 11"
)
K1_TOL = 1e-5
K2_TOL = 1e-4
GRAD_TOL = 1e-4  # of each parameter tensor's largest gradient
TRAIN_STEPS = 20  # timed, after one warm-up step
REGIME_STEPS = 10  # timed phase and fusion training steps, after one warm-up step
PHASE_BATCH, FUSION_BATCH, CROP = 8, 4, 256
STEP_TOL = 1e-4  # a training step on the card against the same step on the CPU
PARITY_LR = 1e-5  # of that step: Adam moves noise-level gradient entries by ~lr
# that step's gradient, of each tensor's largest entry: twice float32's
# reach for the phase trainer, which tests/test_torch_train_phase_grads.py
# bounds at 1e-2 of the float64 gradient on the CPU (4.9e-3 measured there;
# JAX's float32 gradient is 5.7e-2 off), for card and CPU each
PHASE_GRAD_TOL = 2e-2
# FusionNet's gradients through K1 against the plain warp, each route with
# its own uncertainty maps: the maps' histogram median turns float noise at
# a bin edge into a jump (ROADMAP Q3-3), measured at 8.2e-5 to 1.45e-4 of
# the largest over four runs; a K1 that drops its last tap reads far over
ROUTE_GRAD_TOL = 1e-3
STRESS_LAUNCHES = 1000  # per kernel and launch shape
GOLDEN_DB, GOLDEN_TOL = 42.967, 0.05
PLAIN_AGREEMENT_DB = 60.0
MODE_AGREEMENT_DB = 60.0  # each video mode against per pair
EVAL_PLAIN_DB = 0.05  # per-set fusion PSNR, through K1 and through the plain warp
EVAL_METHODS = ("fusion", "adacof", "phase", "baseline")
EVAL_K1_PER_SET = 3 + 1 + 0 + 1  # fusion, adacof, phase, baseline: one dispatch each
H_FULL, W_FULL = 1080, 1920


def _line(**kw):
    print(json.dumps(kw), flush=True)


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else -10.0 * np.log10(mse)


def _cuda_ms(fn, reps, inner=10):
    """Median over `reps` of the mean time of `inner` back-to-back calls of
    fn, timed with CUDA events (back to back, so that the host's work per
    call overlaps the device's, as on the main paths)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(inner):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / inner)
    return float(np.median(times))


def _k1_case(gen, b, c, h, w, f, d, off):
    import torch

    hin, win = h + (f - 1) * d, w + (f - 1) * d
    x = torch.rand((b, c, hin, win), generator=gen, device="cuda")
    # weights sum to 1 over the taps, as the model's softmax heads give them
    logits = torch.randn((b, f * f, h, w), generator=gen, device="cuda")
    wgt = torch.softmax(2.0 * logits, dim=1)
    a = (torch.rand((b, f * f, h, w), generator=gen, device="cuda") * 2 - 1) * off
    be = (torch.rand((b, f * f, h, w), generator=gen, device="cuda") * 2 - 1) * off
    return x, wgt, a, be


def _k1_bound_ms(b, c, h, w, f, d):
    """Least time for one launch: every input read once and the output
    written once over the memory rate, or its float32 operations (per tap:
    9 for the clamp/trunc/weights, 8 per channel for the 4-corner blend and
    the weighted add) over the float32 rate; the larger of the two."""
    hin, win = h + (f - 1) * d, w + (f - 1) * d
    nbytes = 4 * (b * c * hin * win + 3 * b * f * f * h * w + b * c * h * w)
    ops = b * h * w * f * f * (9 + 8 * c)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _k2_bound_ms(b, c, h, w, f, d):
    """Least time for one K2 launch: x and the cotangent read once, the three
    fields read and the three gradients written once, over the memory rate;
    or its float32 operations (per tap: 11 for the clamp/trunc/weights and
    the two products with W, 20 per channel for the blend and the two corner
    differences, each weighted by g) over the float32 rate."""
    hin, win = h + (f - 1) * d, w + (f - 1) * d
    nbytes = 4 * (b * c * hin * win + b * c * h * w + 6 * b * f * f * h * w)
    ops = b * h * w * f * f * (11 + 20 * c)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _plain_warp(warp_plain, field_grads):
    """The AdaCoF warp through the plain versions on CUDA tensors, with K3's
    gradient contract: the route the training check compares K1/K2 with.
    Only this script runs the plain versions on the card."""
    import torch

    class PlainWarp(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, weight, offset_i, offset_j, dilation, max_offset):
            ctx.save_for_backward(x, weight, offset_i, offset_j)
            ctx.dilation, ctx.max_offset = dilation, max_offset
            return warp_plain(x, weight, offset_i, offset_j, dilation, max_offset)

        @staticmethod
        def backward(ctx, g):
            x, weight, offset_i, offset_j = ctx.saved_tensors
            grads = field_grads(x, weight, offset_i, offset_j, g.contiguous(),
                                ctx.dilation, ctx.max_offset)
            return (None, *grads, None, None)  # dx: the frames are data

    def warp(x, weight, offset_i, offset_j, dilation=1, max_offset=48):
        return PlainWarp.apply(x, weight, offset_i, offset_j, dilation, max_offset)

    return warp


def main() -> int:
    t_all = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; no CUDA card", file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    try:
        from fmvfi_tpu_torch import _build
        from fmvfi_tpu_torch.eval.evaluate import evaluate_suite, synthetic_sets
        from fmvfi_tpu_torch.eval.synth import translation_triplet, translation_video
        from fmvfi_tpu_torch.models.adacof import AdaCoFNet
        from fmvfi_tpu_torch.models.fusion_net import FusionNet, infer_variant
        from fmvfi_tpu_torch.models.phase_net import PhaseNetCore
        from fmvfi_tpu_torch.ops import adacof_cuda
        from fmvfi_tpu_torch.ops.pyramid import make_filters, max_pyr_height
        from fmvfi_tpu_torch.ops.adacof import adacof_warp as warp_plain
        from fmvfi_tpu_torch.ops.adacof import adacof_warp_field_grads
        from fmvfi_tpu_torch.pipeline.interpolate import (
            FusionModels,
            _nchw,
            adacof_freq_diff,
            adacof_interpolate,
            fusion_inputs,
            fusion_interpolate,
        )
        from fmvfi_tpu_torch.pipeline.video import (
            _interp_fn,
            double_frame_rate,
            multiply_frame_rate,
            to_device,
        )
        from fmvfi_tpu_torch.train.data import SyntheticTriplets, batch_iterator
        from fmvfi_tpu_torch.train.loop import fit
        from fmvfi_tpu_torch.train.losses import parse_loss_spec
        from fmvfi_tpu_torch.train.trainer import (
            DEFAULT_LOSS,
            adacof_loss,
            fusion_loss,
            make_adacof_trainer,
            make_fusion_trainer,
            make_phase_trainer,
        )
        from fmvfi_tpu_torch.utils.checkpoint import Checkpointer
        from fmvfi_tpu_torch.utils.convert import load_adacof_weights, load_fusion_weights
    except ImportError as e:
        print(f"chip_smoke: the fmvfi_tpu_torch package is missing beside {__file__}: {e}",
              file=sys.stderr)
        return 2
    ckpt = os.path.join(repo, "checkpoints")
    ada_path = os.path.join(ckpt, "adacof_synth_demo.msgpack")
    fusion_path = os.path.join(ckpt, "fusion_synth_demo.msgpack")
    for p in (ada_path, fusion_path):
        if not os.path.exists(p):
            print(f"chip_smoke: bundled checkpoint {p} is missing", file=sys.stderr)
            return 2

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())

    # 1. the card
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    _line(phase="card", seconds=time.perf_counter() - t0, nvidia_smi=smi,
          kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
          python=sys.version.split()[0], torch=torch.__version__, cuda=torch.version.cuda)

    # 2. the build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    _line(phase="build", seconds=time.perf_counter() - t0, nvcc_seconds=_build.build_seconds,
          library=os.path.relpath(lib_path, repo))

    # 3. K1 against its plain version, over every instantiation
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [
        # (b, c, h, w, F, d, max |offset|, max_offset); W = 53 runs without
        # the ring (fields rows not 16-byte aligned), W % 4 == 0 through it
        (2, 3, 37, 53, 5, 1, 60.0, 48),
        (2, 3, 37, 53, 5, 2, 60.0, 48),
        (1, 3, 37, 53, 11, 1, 60.0, 48),
        (1, 3, 37, 53, 11, 2, 60.0, 48),
        (2, 3, 37, 53, 5, 1, 60.0, None),
        (2, 3, 37, 53, 7, 2, 60.0, 48),  # F at run time (planar x)
        (1, 5, 37, 53, 3, 2, 4.0, 10),  # F and C at run time, C in two passes
        (2, 3, 37, 52, 5, 1, 60.0, 48),  # ragged tiles at both edges
        (2, 3, 40, 64, 5, 2, 60.0, None),
        (1, 3, 40, 136, 11, 1, 60.0, 48),
        (1, 3, 40, 64, 11, 2, 60.0, None),
        (2, 3, 37, 52, 7, 1, 60.0, 48),
        (1, 5, 40, 64, 3, 1, 4.0, 10),
    ]

    def took(counter, fn):
        """fn's result and the instantiation its one launch took."""
        before = dict(counter)
        out = fn()
        new = [k for k in counter if counter[k] != before.get(k, 0)]
        if len(new) != 1:
            raise AssertionError(f"expected one launch, the counts moved for {new}")
        return out, new[0]

    errs, k1_seen = [], set()
    for b, c, h, w, f, d, off, r in cases:
        x, wgt, a, be = _k1_case(gen, b, c, h, w, f, d, off)
        got, path = took(adacof_cuda.paths, lambda: adacof_cuda.adacof_warp(x, wgt, a, be, d, r))
        torch.cuda.synchronize()
        err = float((got - warp_plain(x, wgt, a, be, d, r)).abs().max())
        k1_seen.add(path)
        errs.append(dict(shape=[b, c, h, w], F=f, d=d, offset=off, max_offset=r, path=path,
                         max_abs_err=err))
    timings = []
    # the training launch (both frames of a batch of 4 at 256x256), then the
    # main path's 1080p launches: 2B and 4B images for B = 1 (AdaCoF pads
    # 1080 to /32), and 4B for B = 2, the batched video's middle launch
    for b, h, w in ((8, 256, 256), (2, 1088, 1920), (4, 1088, 1920), (8, 1088, 1920)):
        x, wgt, a, be = _k1_case(gen, b, 3, h, w, 5, 1, 3.0)
        k_ms = _cuda_ms(lambda: adacof_cuda.adacof_warp(x, wgt, a, be, 1, 48), 10)
        p_ms = _cuda_ms(lambda: warp_plain(x, wgt, a, be, 1, 48), 3, inner=1)
        # checked after the timed launches
        got, path = took(adacof_cuda.paths, lambda: adacof_cuda.adacof_warp(x, wgt, a, be, 1, 48))
        want = warp_plain(x, wgt, a, be, 1, 48)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        errs.append(dict(shape=[b, 3, h, w], F=5, d=1, offset=3.0, max_offset=48, path=path,
                         max_abs_err=err))
        del got, want
        bound_ms, bound_by = _k1_bound_ms(b, 3, h, w, 5, 1)
        timings.append(dict(images=b, x=list(x.shape), fields=list(wgt.shape), ms=k_ms,
                            plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by,
                            share_of_bound=bound_ms / k_ms))
        del x, wgt, a, be
    torch.cuda.empty_cache()
    max_err = max(e["max_abs_err"] for e in errs)
    _line(phase="k1", seconds=time.perf_counter() - t0, tol=K1_TOL, max_abs_err=max_err,
          instantiations=sorted(k1_seen), cases=errs, timings=timings)
    bad = [e for e in errs if not e["max_abs_err"] <= K1_TOL]
    if bad:
        raise AssertionError(f"K1 disagrees with its plain version beyond {K1_TOL}: {bad}")
    if k1_seen != set(adacof_cuda.PATH_NAMES):
        missed = set(adacof_cuda.PATH_NAMES) - k1_seen
        raise AssertionError(f"K1 cases missed instantiations {missed}")

    # k2: K2 against its plain version
    t0 = time.perf_counter()
    k2_errs, k2_timings, k2_seen = [], [], set()

    def k2_case(b, c, h, w, f, d, off):
        x, wgt, a, be = _k1_case(gen, b, c, h, w, f, d, off)
        return x, wgt, a, be, torch.randn((b, c, h, w), generator=gen, device="cuda")

    def k2_err(args, d, r):
        x4 = adacof_cuda.warp_fwd_cuda(*args[:4], d, r)[1]  # K1's RGBX copy, as K3 keeps it
        got, path = took(adacof_cuda.bwd_paths,
                         lambda: adacof_cuda.warp_bwd_cuda(*args, d, r, x4))
        want = adacof_warp_field_grads(*args, d, r)
        torch.cuda.synchronize()
        k2_seen.add(path)
        return max(float((k - p).abs().max()) for k, p in zip(got, want)), path

    for b, c, h, w, f, d, off, r in cases:
        err, path = k2_err(k2_case(b, c, h, w, f, d, off), d, r)
        k2_errs.append(dict(shape=[b, c, h, w], F=f, d=d, offset=off, max_offset=r, path=path,
                            max_abs_err=err))
    # the training launch, then the 4-image 1080p launch, for the kernel table
    for b, h, w in ((8, 256, 256), (4, 1088, 1920)):
        args = k2_case(b, 3, h, w, 5, 1, 3.0)
        x4 = adacof_cuda.warp_fwd_cuda(*args[:4], 1, 48)[1]
        k_ms = _cuda_ms(lambda: adacof_cuda.warp_bwd_cuda(*args, 1, 48, x4=x4), 10)
        p_ms = _cuda_ms(lambda: adacof_warp_field_grads(*args, 1, 48), 3, inner=1)
        err, path = k2_err(args, 1, 48)  # checked after the timed launches
        k2_errs.append(dict(shape=[b, 3, h, w], F=5, d=1, offset=3.0, max_offset=48, path=path,
                            max_abs_err=err))
        bound_ms, bound_by = _k2_bound_ms(b, 3, h, w, 5, 1)
        k2_timings.append(dict(images=b, x=list(args[0].shape), fields=list(args[1].shape),
                               ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by,
                               share_of_bound=bound_ms / k_ms))
        del args, x4
    torch.cuda.empty_cache()
    k2_max_err = max(e["max_abs_err"] for e in k2_errs)
    _line(phase="k2", seconds=time.perf_counter() - t0, tol=K2_TOL, max_abs_err=k2_max_err,
          instantiations=sorted(k2_seen), cases=k2_errs, timings=k2_timings)
    bad = [e for e in k2_errs if not e["max_abs_err"] <= K2_TOL]
    if bad:
        raise AssertionError(f"K2 disagrees with its plain version beyond {K2_TOL}: {bad}")
    if k2_seen != set(adacof_cuda.PATH_NAMES):
        missed = set(adacof_cuda.PATH_NAMES) - k2_seen
        raise AssertionError(f"K2 cases missed instantiations {missed}")

    # stress: many back-to-back launches of K1 and K2 at the 1080p launches
    t0 = time.perf_counter()
    stress = []
    for b in (2, 4):
        args = k2_case(b, 3, 1088, 1920, 5, 1, 3.0)
        first, x4 = adacof_cuda.warp_fwd_cuda(*args[:4], 1, 48)
        first_g = adacof_cuda.warp_bwd_cuda(*args, 1, 48, x4=x4)
        k1_err = float((first - warp_plain(*args[:4], 1, 48)).abs().max())
        k2_err_ = max(float((k - p).abs().max())
                      for k, p in zip(first_g, adacof_warp_field_grads(*args, 1, 48)))
        k1_diff = torch.zeros((), dtype=torch.int64, device="cuda")
        k2_diff = torch.zeros((), dtype=torch.int64, device="cuda")
        for _ in range(STRESS_LAUNCHES):  # no host synchronization in the loop
            k1_diff += (adacof_cuda.warp_fwd_cuda(*args[:4], 1, 48)[0] != first).any()
        for _ in range(STRESS_LAUNCHES):
            got = adacof_cuda.warp_bwd_cuda(*args, 1, 48, x4=x4)
            k2_diff += torch.stack([(k != f).any() for k, f in zip(got, first_g)]).any()
        stress.append(dict(images=b, launches=STRESS_LAUNCHES, k1_max_abs_err=k1_err,
                           k2_max_abs_err=k2_err_, k1_launches_differing=int(k1_diff),
                           k2_launches_differing=int(k2_diff)))
        del args, first, x4, first_g, got
    torch.cuda.empty_cache()
    _line(phase="stress", seconds=time.perf_counter() - t0, cases=stress)
    bad = [s for s in stress if s["k1_launches_differing"] or s["k2_launches_differing"]
           or not (s["k1_max_abs_err"] <= K1_TOL and s["k2_max_abs_err"] <= K2_TOL)]
    if bad:
        raise AssertionError(f"repeated launches differ or disagree with the plain versions: {bad}")

    # 4. the held number: bundled AdaCoF on the golden scene, through K1
    t0 = time.perf_counter()
    ada = AdaCoFNet().to(dev).eval()
    ada.load_state_dict(load_adacof_weights(ada_path))
    f1, mid, f2 = translation_triplet(128, 128, dx=2.0, dy=1.0, seed=0)
    adacof_cuda.launches = 0
    pred = adacof_interpolate(ada, f1[None], f2[None], device=dev)
    torch.cuda.synchronize()
    if adacof_cuda.launches != 1:
        raise AssertionError(f"golden scene: {adacof_cuda.launches} K1 launches, expected 1")
    golden = _psnr(pred[0].cpu().numpy(), mid)
    _line(phase="golden", seconds=time.perf_counter() - t0, psnr_db=golden,
          expected_db=GOLDEN_DB, tol_db=GOLDEN_TOL)
    if not abs(golden - GOLDEN_DB) <= GOLDEN_TOL:
        raise AssertionError(f"golden scene {golden:.4f} dB, expected {GOLDEN_DB} +- {GOLDEN_TOL}")

    # fields: K1 and K2 on the fields the bundled AdaCoF gives for the golden
    # scene rendered at 1080x1920, beside uniform +-3 px offsets
    t0 = time.perf_counter()
    g1, _, g2 = translation_triplet(H_FULL, W_FULL, dx=2.0, dy=1.0, seed=0)
    captured = []

    def capture(*args):
        captured.append(args)
        return adacof_cuda.adacof_warp(*args)

    ada.warp = capture
    try:
        adacof_interpolate(ada, g1[None], g2[None], device=dev)
    finally:
        ada.warp = adacof_cuda.adacof_warp
    (x, wgt, a, be, d, r), = captured
    cot = torch.randn((x.shape[0], 3) + tuple(wgt.shape[2:]), generator=gen, device="cuda")
    x4 = adacof_cuda.warp_fwd_cuda(x, wgt, a, be, d, r)[1]
    model = dict(
        images=x.shape[0], fields=list(wgt.shape),
        mean_abs_offset=[float(a.abs().mean()), float(be.abs().mean())],
        k1_ms=_cuda_ms(lambda: adacof_cuda.adacof_warp(x, wgt, a, be, d, r), 10),
        k2_ms=_cuda_ms(lambda: adacof_cuda.warp_bwd_cuda(x, wgt, a, be, cot, d, r, x4=x4), 10),
        k1_max_abs_err=float((adacof_cuda.adacof_warp(x, wgt, a, be, d, r)
                              - warp_plain(x, wgt, a, be, d, r)).abs().max()),
        k2_max_abs_err=max(float((k - p).abs().max()) for k, p in zip(
            adacof_cuda.warp_bwd_cuda(x, wgt, a, be, cot, d, r, x4=x4),
            adacof_warp_field_grads(x, wgt, a, be, cot, d, r))),
    )
    del x, x4, wgt, a, be, cot, captured
    ux, uw, ua, ub, ug = k2_case(model["images"], 3, *model["fields"][2:], 5, 1, 3.0)
    ux4 = adacof_cuda.warp_fwd_cuda(ux, uw, ua, ub, 1, 48)[1]
    uniform = dict(
        k1_ms=_cuda_ms(lambda: adacof_cuda.adacof_warp(ux, uw, ua, ub, 1, 48), 10),
        k2_ms=_cuda_ms(lambda: adacof_cuda.warp_bwd_cuda(ux, uw, ua, ub, ug, 1, 48, x4=ux4), 10),
    )
    del ux, ux4, uw, ua, ub, ug
    torch.cuda.empty_cache()
    _line(phase="fields", seconds=time.perf_counter() - t0, scene=[H_FULL, W_FULL, 2.0, 1.0, 0],
          model=model, uniform_3px=uniform)
    if not (model["k1_max_abs_err"] <= K1_TOL and model["k2_max_abs_err"] <= K2_TOL):
        raise AssertionError(f"K1/K2 on the model's fields beyond {K1_TOL}/{K2_TOL}: {model}")

    # 5. serving: fusion_interpolate at 1080p, batch 1
    t0 = time.perf_counter()
    fusion_sd = load_fusion_weights(fusion_path)
    fusion = FusionNet(uncertainty_maps=3, variant=infer_variant(fusion_sd)).to(dev).eval()
    fusion.load_state_dict(fusion_sd)
    phase = PhaseNetCore().init_params(torch.Generator().manual_seed(0)).to(dev).eval()
    models = FusionModels(phase_net=phase, adacof=ada, fusion_net=fusion)
    with ThreadPoolExecutor(max_workers=4) as ex:  # numpy releases the GIL
        requests = list(ex.map(
            lambda i: translation_triplet(H_FULL, W_FULL, dx=4.0 + i, dy=2.0, seed=i), range(4)
        ))
    t_setup = time.perf_counter() - t0

    adacof_cuda.launches = adacof_cuda.bwd_launches = 0  # the serving path's run
    adacof_cuda.paths.clear()
    lat_ms, psnrs, outs = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for i, (r1, rmid, r2) in enumerate(requests):
        before = adacof_cuda.launches
        torch.cuda.synchronize()
        t_req = time.perf_counter()
        out = fusion_interpolate(models, r1[None], r2[None], device=dev)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t_req)
        if adacof_cuda.launches - before != 3:
            raise AssertionError(
                f"request {i}: {adacof_cuda.launches - before} K1 launches, expected 3"
            )
        o = out[0].cpu().numpy()
        if o.shape != (H_FULL, W_FULL, 3) or not np.isfinite(o).all():
            raise AssertionError(f"request {i}: output {o.shape} not finite/right shape")
        if o.min() < 0.0 or o.max() > 1.0:
            raise AssertionError(f"request {i}: output outside [0, 1]")
        psnrs.append(_psnr(o, rmid))
        lat_ms.append(ms)
        outs.append(o)
    k1_launches = adacof_cuda.launches  # read just after the serving path's run
    serve_paths = dict(adacof_cuda.paths)
    if serve_paths != {RING_PATH: k1_launches}:
        raise AssertionError(f"serving: K1 launches by instantiation {serve_paths}, "
                             f"expected all {k1_launches} through {RING_PATH}")
    if adacof_cuda.bwd_launches != 0:
        raise AssertionError(f"serving launched K2 {adacof_cuda.bwd_launches} times")
    peak = torch.cuda.max_memory_allocated()

    # the same first request with the warp routed to the plain version
    ada.warp = warp_plain
    try:
        plain_out = fusion_interpolate(models, requests[0][0][None], requests[0][2][None],
                                       device=dev)[0].cpu().numpy()
    finally:
        ada.warp = adacof_cuda.adacof_warp
    agree = _psnr(outs[0], plain_out)
    _line(phase="serve", seconds=time.perf_counter() - t0, setup_seconds=t_setup,
          size=[H_FULL, W_FULL], batch=1, variant=fusion.variant, warmup_ms=lat_ms[0],
          ms_per_frame=float(np.mean(lat_ms[1:])), ms_requests=lat_ms[1:],
          peak_memory_bytes=peak, psnr_vs_true_middle_db=psnrs,
          k1_launches=k1_launches, k1_paths=serve_paths, k1_vs_plain_psnr_db=agree)
    if not agree >= PLAIN_AGREEMENT_DB:
        raise AssertionError(f"K1 and plain pipelines agree at {agree:.2f} dB < {PLAIN_AGREEMENT_DB}")
    if k1_launches == 0:
        raise AssertionError("the main path launched K1 no time")

    # video: double_frame_rate at 1080p in every mode, on the serve phase's models
    t0 = time.perf_counter()
    del outs
    t_clip = time.perf_counter()
    clip = translation_video(5, H_FULL, W_FULL, step=2.0, seed=0)
    clip_seconds = time.perf_counter() - t_clip
    n_pairs = len(clip) - 1
    images = []  # images of each K1 launch, recorded around the model's warp

    def recording_warp(x, *args):
        images.append(x.shape[0])
        return adacof_cuda.adacof_warp(x, *args)

    # (name, frames, options, images of each K1 launch in order)
    modes = [
        ("per_pair", clip, {}, [2, 4, 2] * n_pairs),
        ("stream8", clip, dict(stream=True), [4, 4] * len(clip)),
        ("stream2", clip, dict(stream=True, stream_window=2), [4, 4] * len(clip)),
        ("batch2_chunk1", clip[:4], dict(batch=2, seq_chunk=1), [4, 4, 2, 4, 2] * 2),
        ("batch2", clip[:4], dict(batch=2), [4, 8, 4] * 2),
    ]
    video, runs = {}, {}
    video_k1 = 0
    ada.warp = recording_warp
    try:
        for name, frames, kw, want_images in modes:
            list(double_frame_rate(frames[:3], models, **kw, device=dev))  # warm-up
            torch.cuda.synchronize()
            adacof_cuda.launches = adacof_cuda.bwd_launches = 0  # this mode's run
            adacof_cuda.paths.clear()
            images.clear()
            torch.cuda.reset_peak_memory_stats()
            t_run = time.perf_counter()
            out = list(double_frame_rate(frames, models, **kw, device=dev))
            torch.cuda.synchronize()
            run_ms = 1e3 * (time.perf_counter() - t_run)
            launches, paths = adacof_cuda.launches, dict(adacof_cuda.paths)  # read just after
            k2 = adacof_cuda.bwd_launches
            video_k1 += launches
            runs[name] = out
            video[name] = dict(frames=len(frames), options=kw, ms_per_frame=run_ms / (len(frames) - 1),
                               ms=run_ms, peak_memory_bytes=torch.cuda.max_memory_allocated(),
                               k1_launches=launches, k1_paths=paths, k1_images=list(images),
                               k2_launches=k2)
            if len(out) != 2 * len(frames) - 1:
                raise AssertionError(f"video {name}: {len(out)} frames from {len(frames)}")
            if not all(np.array_equal(out[2 * i], frames[i]) for i in range(len(frames))):
                raise AssertionError(f"video {name}: the originals are not at the even positions")
            mids = np.stack(out[1::2])
            if mids.shape[1:] != (H_FULL, W_FULL, 3) or not np.isfinite(mids).all():
                raise AssertionError(f"video {name}: frames {mids.shape} not finite/right shape")
            if mids.min() < 0.0 or mids.max() > 1.0:
                raise AssertionError(f"video {name}: frames outside [0, 1]")
            if images != want_images or launches != len(want_images):
                raise AssertionError(f"video {name}: K1 launches on {images} images "
                                     f"({launches} counted), expected {want_images}")
            if paths != {RING_PATH: launches} or k2 != 0:
                raise AssertionError(f"video {name}: K1 launches by instantiation {paths}, "
                                     f"K2 launches {k2}; expected all through {RING_PATH}, no K2")
        ada.warp = warp_plain  # the first stream run through the plain warp
        plain_stream = list(double_frame_rate(clip, models, stream=True, device=dev))
    finally:
        ada.warp = adacof_cuda.adacof_warp
    ref = runs["per_pair"]
    for name, out in runs.items():
        pairs = list(zip(out[1::2], ref[1::2]))
        video[name]["psnr_vs_per_pair_db"] = [_psnr(a, b) for a, b in pairs]
        video[name]["max_abs_diff_vs_per_pair"] = max(float(np.abs(a - b).max()) for a, b in pairs)
    stream_plain_db = [_psnr(a, b) for a, b in zip(runs["stream8"][1::2], plain_stream[1::2])]
    del runs, ref, plain_stream

    # host synchronizations inside one per-pair request, on frames already on
    # the card, and how long the host takes to queue the request against how
    # long the request takes: the prefetch overlaps only what the host queues
    # ahead of the card
    a, b = (to_device(clip[i : i + 1], dev) for i in (0, 1))
    request = _interp_fn(models, "fusion", device=dev)
    request(a, b)
    torch.cuda.synchronize()
    t_req = time.perf_counter()
    request(a, b)
    enqueue_ms = 1e3 * (time.perf_counter() - t_req)
    torch.cuda.synchronize()
    request_ms = 1e3 * (time.perf_counter() - t_req)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            request(a, b)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    syncs = [f"{os.path.relpath(w.filename, repo)}:{w.lineno}: {str(w.message)[:120]}"
             for w in caught if "called a synchronizing" in str(w.message)]
    del a, b

    # multiply_frame_rate: 4x through two doublings
    small = translation_video(3, 256, 256, step=2.0, seed=1)
    twice = list(double_frame_rate(small, models, "adacof", device=dev))
    four = list(multiply_frame_rate(small, models, "adacof", factor=4, device=dev))
    multiply_diff = max(float(np.abs(four[2 * i] - f).max()) for i, f in enumerate(twice))
    del clip
    torch.cuda.empty_cache()
    _line(phase="video", seconds=time.perf_counter() - t0, clip_seconds=clip_seconds,
          size=[H_FULL, W_FULL], modes=video, stream_vs_plain_warp_psnr_db=stream_plain_db,
          request_host_syncs=len(syncs), request_sync_sites=sorted(set(syncs)),
          request_enqueue_ms=enqueue_ms, request_ms=request_ms,
          multiply=dict(frames=len(four), expected=4 * len(small) - 3,
                        max_abs_diff_even_vs_2x=multiply_diff))
    for name, v in video.items():
        if not min(v["psnr_vs_per_pair_db"]) >= MODE_AGREEMENT_DB:
            raise AssertionError(f"video {name} against per pair: {v['psnr_vs_per_pair_db']} dB")
    if not min(stream_plain_db) >= PLAIN_AGREEMENT_DB:
        raise AssertionError(f"stream through K1 and the plain warp: {stream_plain_db} dB")
    if not video["batch2_chunk1"]["peak_memory_bytes"] < video["batch2"]["peak_memory_bytes"]:
        raise AssertionError("seq_chunk=1 did not lower the peak memory of batch 2")
    if len(four) != 4 * len(small) - 3 or not multiply_diff <= 1e-6:
        raise AssertionError(f"multiply_frame_rate: {len(four)} frames, even positions "
                             f"{multiply_diff} from the 2x sequence")
    if video_k1 == 0:
        raise AssertionError("the video path launched K1 no time")

    # eval: evaluate_suite on the synthetic sets, four methods
    t0 = time.perf_counter()
    sets = synthetic_sets(dim=256, n_frames=4)
    t_setup = time.perf_counter() - t0
    os.makedirs(os.path.join(repo, "build"), exist_ok=True)
    eval_dir = tempfile.mkdtemp(prefix="chip_smoke_eval_", dir=os.path.join(repo, "build"))
    try:
        adacof_cuda.launches = adacof_cuda.bwd_launches = 0  # the evaluation path's run
        adacof_cuda.paths.clear()
        t_run = time.perf_counter()
        summary = evaluate_suite(models, os.path.join(eval_dir, "k1"), sets=sets,
                                 methods=EVAL_METHODS, dim=256, device=dev)
        run_seconds = time.perf_counter() - t_run
        eval_k1, eval_k2 = adacof_cuda.launches, adacof_cuda.bwd_launches  # read just after
        eval_paths = dict(adacof_cuda.paths)
        has_summary = os.path.exists(os.path.join(eval_dir, "k1", "summary.json"))
        rerun = evaluate_suite(models, os.path.join(eval_dir, "k1"), sets=sets,
                               methods=EVAL_METHODS, dim=256, device=dev)
        rerun_k1 = adacof_cuda.launches - eval_k1
        ada.warp = warp_plain  # its own directory: the weights digest is the same
        try:
            plain = evaluate_suite(models, os.path.join(eval_dir, "plain"), sets=sets,
                                   methods=("fusion",), dim=256, device=dev)
        finally:
            ada.warp = adacof_cuda.adacof_warp
    finally:
        shutil.rmtree(eval_dir, ignore_errors=True)
    plain_gap = {k: abs(summary[k]["fusion"]["psnr"] - plain[k]["fusion"]["psnr"]) for k in sets}
    _line(phase="eval", seconds=time.perf_counter() - t0, setup_seconds=t_setup,
          run_seconds=run_seconds, dim=256, n_frames=4, sets=len(sets),
          psnr={k: {m: summary[k][m]["psnr"] for m in EVAL_METHODS} for k in sets},
          ssim={k: {m: summary[k][m]["ssim"] for m in EVAL_METHODS} for k in sets},
          k1_launches=eval_k1, k1_paths=eval_paths, k2_launches=eval_k2,
          rerun_k1_launches=rerun_k1, fusion_psnr_gap_vs_plain_warp_db=plain_gap)
    means = [v for k in sets for m in EVAL_METHODS for v in summary[k][m].values()]
    if not np.isfinite(means).all() or not has_summary:
        raise AssertionError(f"eval: finite means {np.isfinite(means).all()}, "
                             f"summary.json {has_summary}")
    if rerun != summary or rerun_k1 != 0:
        raise AssertionError(f"eval: the rerun launched K1 {rerun_k1} times or differs")
    if eval_k1 != EVAL_K1_PER_SET * len(sets) or eval_paths != {RING_PATH: eval_k1} or eval_k2:
        raise AssertionError(f"eval: K1 {eval_k1} launches ({eval_paths}), K2 {eval_k2}; expected "
                             f"{EVAL_K1_PER_SET * len(sets)} through {RING_PATH} and no K2")
    if not max(plain_gap.values()) <= EVAL_PLAIN_DB:
        raise AssertionError(f"eval: fusion through K1 and the plain warp differ {plain_gap} dB")

    # train: AdaCoF training at 256x256, batch 4, through K1 and K2
    t0 = time.perf_counter()
    del models, fusion, phase
    torch.cuda.empty_cache()
    state, step_fn = make_adacof_trainer(device=dev)
    state.model.load_state_dict(load_adacof_weights(ada_path))
    batches = batch_iterator(SyntheticTriplets(n=32, h=272, w=272), 4, crop=256)
    step_ms, losses, per_step = [], [], []

    def timed_step(st, batch):
        before = (adacof_cuda.launches, adacof_cuda.bwd_launches)
        torch.cuda.synchronize()
        t = time.perf_counter()
        st, m = step_fn(st, batch)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t))
        losses.append(float(m["loss"]))
        per_step.append([adacof_cuda.launches - before[0], adacof_cuda.bwd_launches - before[1]])
        return st, m

    os.makedirs(os.path.join(repo, "build"), exist_ok=True)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_train_", dir=os.path.join(repo, "build"))
    try:
        t_setup = time.perf_counter() - t0
        adacof_cuda.launches = adacof_cuda.bwd_launches = 0  # the training path's run
        adacof_cuda.paths.clear()
        adacof_cuda.bwd_paths.clear()
        torch.cuda.reset_peak_memory_stats()
        state = fit(state, timed_step, batches, out_dir, epochs=1,
                    steps_per_epoch=TRAIN_STEPS + 1, log_every=1, ckpt_every=TRAIN_STEPS + 1)
        train_k1, train_k2 = adacof_cuda.launches, adacof_cuda.bwd_launches  # read just after
        train_paths = [dict(adacof_cuda.paths), dict(adacof_cuda.bwd_paths)]
        if train_paths != [{RING_PATH: train_k1}, {RING_PATH: train_k2}]:
            raise AssertionError(f"training: K1, K2 launches by instantiation {train_paths}, "
                                 f"expected all through {RING_PATH}")
        train_peak = torch.cuda.max_memory_allocated()
        if state.step != TRAIN_STEPS + 1 or any(n != [1, 1] for n in per_step):
            raise AssertionError(f"training: step {state.step}, K1/K2 launches per step {per_step}")
        if not np.isfinite(losses).all():
            raise AssertionError(f"training: non-finite losses {losses}")

        # the checkpoint: restore it into a fresh trainer, then let fit resume
        ckpt = Checkpointer(os.path.join(out_dir, "checkpoint"))
        fresh, fresh_step = make_adacof_trainer(device=dev)
        fresh = ckpt.restore(fresh)
        trained = state.model.state_dict()
        restored_equal = fresh.step == state.step and all(
            torch.equal(v, trained[k]) for k, v in fresh.model.state_dict().items()
        )
        resumed = fit(fresh, fresh_step, batches, out_dir, epochs=1,
                      steps_per_epoch=TRAIN_STEPS + 2, log_every=1)
        if not restored_equal or resumed.step != TRAIN_STEPS + 2 or ckpt.latest() != resumed.step:
            raise AssertionError(
                f"checkpoint: restored equal {restored_equal}, resumed to step {resumed.step}, "
                f"latest {ckpt.latest()}"
            )
        del fresh, resumed

        # one step's parameter gradients through K1/K2 and through the plain warp
        batch = [_nchw(a, dev) for a in next(batches)]
        model, spec = state.model, parse_loss_spec(DEFAULT_LOSS)

        def param_grads(warp):
            model.warp = warp
            loss, _ = adacof_loss(model, spec, *batch)
            return torch.autograd.grad(loss, list(model.parameters()))

        torch.backends.cudnn.deterministic = True
        try:
            g_kernel = param_grads(adacof_cuda.adacof_warp)
            g_plain = param_grads(_plain_warp(warp_plain, adacof_warp_field_grads))
        finally:
            model.warp = adacof_cuda.adacof_warp
            torch.backends.cudnn.deterministic = False
        grad_ratio = max(
            float((k - p).abs().max()) / max(float(p.abs().max()), 1e-30)
            for k, p in zip(g_kernel, g_plain)
        )
    finally:
        batches.close()
        shutil.rmtree(out_dir, ignore_errors=True)
    _line(phase="train", seconds=time.perf_counter() - t0, setup_seconds=t_setup,
          batch=4, crop=256, steps=TRAIN_STEPS, warmup_ms=step_ms[0],
          ms_per_step=float(np.median(step_ms[1:])), ms_steps=step_ms[1:],
          peak_memory_bytes=train_peak, loss_first=losses[0], loss_last=losses[-1],
          k1_launches=train_k1, k2_launches=train_k2, k1_k2_paths=train_paths,
          checkpoint_resumed=True,
          grad_max_rel_diff=grad_ratio, grad_tol=GRAD_TOL)
    if not grad_ratio <= GRAD_TOL:
        raise AssertionError(f"gradients through K1/K2 and plain differ by {grad_ratio:.3g} "
                             f"of the largest gradient > {GRAD_TOL}")

    # train_phase: PhaseNet training at 256x256, batch 8, height 12
    t0 = time.perf_counter()
    del state, model, g_kernel, g_plain
    torch.cuda.empty_cache()
    height = max_pyr_height(CROP, CROP)
    images.clear()

    def regime_step(step_fn, rec):
        """step_fn timed (host clock around a synchronized step), with its
        loss, its K1 / K2 launches and the images of each K1 launch."""

        def run(st, batch):
            before = (adacof_cuda.launches, adacof_cuda.bwd_launches, len(images))
            torch.cuda.synchronize()
            t = time.perf_counter()
            st, m = step_fn(st, batch)
            torch.cuda.synchronize()
            rec["ms"].append(1e3 * (time.perf_counter() - t))
            rec["loss"].append(float(m["loss"]))
            rec["launches"].append([adacof_cuda.launches - before[0],
                                    adacof_cuda.bwd_launches - before[1]])
            rec["images"].append(images[before[2]:])
            return st, m

        return run

    def new_rec():
        return dict(ms=[], loss=[], launches=[], images=[])

    def reset_counts():
        adacof_cuda.launches = adacof_cuda.bwd_launches = 0
        adacof_cuda.paths.clear()
        adacof_cuda.bwd_paths.clear()

    def counts():
        return dict(k1=adacof_cuda.launches, k2=adacof_cuda.bwd_launches,
                    k1_paths=dict(adacof_cuda.paths), k2_paths=dict(adacof_cuda.bwd_paths))

    def check_launches(name, c, rec, per_step):
        """Every step launched K1 on exactly the images per_step lists, all
        through the ring, and K2 never."""
        want = [per_step] * len(rec["images"])
        if rec["images"] != want or c["k1"] != sum(map(len, want)):
            raise AssertionError(f"{name}: K1 images per step {rec['images']}, expected {want}")
        if c["k1_paths"] != {RING_PATH: c["k1"]} or c["k2"] != 0:
            raise AssertionError(f"{name}: K1 by instantiation {c['k1_paths']}, K2 {c['k2']}; "
                                 f"expected all through {RING_PATH} and no K2")
        if not np.isfinite(rec["loss"]).all():
            raise AssertionError(f"{name}: non-finite losses {rec['loss']}")

    phase_out = tempfile.mkdtemp(prefix="chip_smoke_train_phase_", dir=os.path.join(repo, "build"))
    batches = batch_iterator(SyntheticTriplets(n=32, h=CROP + 16, w=CROP + 16), PHASE_BATCH,
                             crop=CROP)
    ada = AdaCoFNet().to(dev)  # frozen, for the fusion-mode and high_level steps
    ada.load_state_dict(load_adacof_weights(ada_path))
    ada.warp = recording_warp
    try:
        t_setup = time.perf_counter() - t0
        state, step_fn, _, make_step = make_phase_trainer(CROP, CROP, device=dev)
        init_stats = {k: v.clone() for k, v in state.model.state_dict().items() if "running" in k}
        rec = new_rec()
        reset_counts()  # the phase-training path's run
        torch.cuda.reset_peak_memory_stats()
        state = fit(state, regime_step(step_fn, rec), batches, phase_out, epochs=1,
                    steps_per_epoch=REGIME_STEPS + 1, log_every=1, ckpt_every=REGIME_STEPS + 1)
        phase_counts = counts()
        phase_peak = torch.cuda.max_memory_allocated()
        if phase_counts["k1"] or phase_counts["k2"] or not np.isfinite(rec["loss"]).all():
            raise AssertionError(f"train_phase: {phase_counts}, losses {rec['loss']}")
        moved = {k: float((v - init_stats[k]).abs().max()) for k, v in
                 state.model.state_dict().items() if "running" in k}
        if min(moved[f"blocks.{i}.bn.running_var"] for i in range(8)) == 0.0:
            raise AssertionError(f"train_phase: running statistics did not move: {moved}")

        # the checkpoint restores the BN buffers, and fit resumes from it
        ckpt = Checkpointer(os.path.join(phase_out, "checkpoint"))
        fresh, fresh_step, _, _ = make_phase_trainer(CROP, CROP, seed=1, device=dev)
        fresh = ckpt.restore(fresh)
        trained = state.model.state_dict()
        phase_restored = fresh.step == state.step and all(
            torch.equal(v, trained[k]) for k, v in fresh.model.state_dict().items())
        resumed = fit(fresh, fresh_step, batches, phase_out, epochs=1,
                      steps_per_epoch=REGIME_STEPS + 2, log_every=1)
        if not phase_restored or resumed.step != REGIME_STEPS + 2:
            raise AssertionError(f"train_phase checkpoint: restored equal {phase_restored}, "
                                 f"resumed to step {resumed.step}")

        # fit's hierarchical-m schedule: m rises every 2 batches from 3
        seen_m = []

        def recording_make_step(m):
            seen_m.append(m)
            return make_step(m)

        m_out = os.path.join(phase_out, "m")
        fit(make_phase_trainer(CROP, CROP, device=dev)[0], None, batches, m_out, epochs=1,
            steps_per_epoch=5, log_every=1, make_step=recording_make_step, m_init=3, m_update=2)
        with open(os.path.join(m_out, "train_metrics.jsonl")) as f:
            logged_m = [json.loads(line)["m"] for line in f]
        if seen_m != [3, 4, 5] or logged_m != [3, 3, 4, 4, 5]:
            raise AssertionError(f"m schedule: built {seen_m}, logged {logged_m}")

        # one step each in mode fusion (variants 0 and 1) and with high_level,
        # from the bundled AdaCoF: K1 once per step on the 2B frames, no K2
        modes = {}
        for name, kw in (("fusion_v0", dict(mode="fusion", model_variant=0)),
                         ("fusion_v1", dict(mode="fusion", model_variant=1)),
                         ("high_level", dict(high_level=True))):
            st, fn, _, _ = make_phase_trainer(CROP, CROP, adacof=ada, device=dev, **kw)
            mrec = new_rec()
            reset_counts()  # this mode's run
            st, _ = regime_step(fn, mrec)(st, next(batches))
            c = counts()
            check_launches(f"train_phase {name}", c, mrec, [2 * PHASE_BATCH])
            modes[name] = dict(ms=mrec["ms"][0], loss=mrec["loss"][0], k1_launches=c["k1"],
                               k1_images=mrec["images"][0], k1_paths=c["k1_paths"],
                               k2_launches=c["k2"])
            del st, fn
        phase_mode_k1 = sum(v["k1_launches"] for v in modes.values())

        # one step on the card against the same step on the CPU (lr 1e-5)
        pair = translation_triplet(128, 128, dx=3.0, dy=1.0, seed=0), \
            translation_triplet(128, 128, dx=-2.0, dy=2.0, seed=1)
        small = tuple(np.stack([it[j] for it in pair]) for j in range(3))
        card_st, card_fn, _, _ = make_phase_trainer(128, 128, lr=PARITY_LR, device=dev)
        cpu_st, cpu_fn, _, _ = make_phase_trainer(128, 128, lr=PARITY_LR, device="cpu")
        cpu_st.model.load_state_dict(card_st.model.state_dict())
        card_st, card_m = card_fn(card_st, small)
        cpu_st, cpu_m = cpu_fn(cpu_st, small)
        cpu_sd = cpu_st.model.state_dict()
        # the step's gradient on each side: Adam's first moment, 0.1 x it;
        # a conv1 bias (zero gradient in exact arithmetic: train-mode BN
        # follows it) is held against the net's largest gradient
        grads = [{k: st.optimizer.state[p]["exp_avg"].cpu() for k, p in
                  st.model.named_parameters()} for st in (card_st, cpu_st)]
        net_top = max(float(g.abs().max()) for g in grads[1].values())
        grad_gap = {k: float((g - grads[1][k]).abs().max()) / (
            net_top if k.endswith("conv1.bias") else max(float(grads[1][k].abs().max()), 1e-30))
            for k, g in grads[0].items()}
        worst_grad = max(grad_gap, key=grad_gap.get)
        phase_cpu = dict(
            loss_rel=max(abs(float(card_m[k]) / float(cpu_m[k]) - 1.0) for k in cpu_m),
            max_abs_diff=max(float((v.cpu() - cpu_sd[k]).abs().max())
                             for k, v in card_st.model.state_dict().items()),
            stats_max_abs_diff=max(float((v.cpu() - cpu_sd[k]).abs().max()) for k, v in
                                   card_st.model.state_dict().items() if "running" in k),
            grad_max_rel_diff=grad_gap[worst_grad], grad_worst_tensor=worst_grad)
        del card_st, cpu_st, grads
    finally:
        ada.warp = adacof_cuda.adacof_warp
        batches.close()
        shutil.rmtree(phase_out, ignore_errors=True)
    _line(phase="train_phase", seconds=time.perf_counter() - t0, setup_seconds=t_setup,
          batch=PHASE_BATCH, crop=CROP, height=height, steps=REGIME_STEPS, warmup_ms=rec["ms"][0],
          ms_per_step=float(np.median(rec["ms"][1:])), ms_steps=rec["ms"][1:],
          peak_memory_bytes=phase_peak, loss_first=rec["loss"][0], loss_last=rec["loss"][-1],
          k1_launches=phase_counts["k1"], k2_launches=phase_counts["k2"],
          running_stats_moved=min(moved.values()), checkpoint_resumed=True,
          m_built=seen_m, m_logged=logged_m, modes=modes, step_vs_cpu=phase_cpu,
          step_vs_cpu_tol=STEP_TOL, step_vs_cpu_lr=PARITY_LR, step_vs_cpu_grad_tol=PHASE_GRAD_TOL)
    if not (phase_cpu["loss_rel"] <= STEP_TOL and phase_cpu["max_abs_diff"] <= STEP_TOL
            and phase_cpu["grad_max_rel_diff"] <= PHASE_GRAD_TOL):
        raise AssertionError(f"train_phase: the card's step against the CPU's {phase_cpu}")

    # train_fusion: FusionNet training at 256x256, batch 4, behind the frozen
    # bundled AdaCoF and a seeded PhaseNet
    t0 = time.perf_counter()
    fusion_out = tempfile.mkdtemp(prefix="chip_smoke_train_fusion_", dir=os.path.join(repo, "build"))
    batches = batch_iterator(SyntheticTriplets(n=32, h=CROP + 16, w=CROP + 16, mixed=True),
                             FUSION_BATCH, crop=CROP)
    phase = PhaseNetCore().init_params(torch.Generator().manual_seed(0)).to(dev)
    frozen = [{k: v.clone() for k, v in m.state_dict().items()} for m in (phase, ada)]
    fusion_sd = load_fusion_weights(fusion_path)
    per_step = [2 * FUSION_BATCH, 4 * FUSION_BATCH, 2 * FUSION_BATCH]
    ada.warp = recording_warp
    try:
        t_setup = time.perf_counter() - t0
        state, step_fn = make_fusion_trainer(phase, ada, variant=2, device=dev)
        state.model.load_state_dict(fusion_sd)
        rec = new_rec()
        reset_counts()  # the fusion-training path's run
        torch.cuda.reset_peak_memory_stats()
        state = fit(state, regime_step(step_fn, rec), batches, fusion_out, epochs=1,
                    steps_per_epoch=REGIME_STEPS + 1, log_every=1, ckpt_every=REGIME_STEPS + 1)
        fusion_counts = counts()
        fusion_peak = torch.cuda.max_memory_allocated()
        check_launches("train_fusion", fusion_counts, rec, per_step)

        ckpt = Checkpointer(os.path.join(fusion_out, "checkpoint"))
        fresh, fresh_step = make_fusion_trainer(phase, ada, variant=2, seed=1, device=dev)
        fresh = ckpt.restore(fresh)
        trained = state.model.state_dict()
        fusion_restored = fresh.step == state.step and all(
            torch.equal(v, trained[k]) for k, v in fresh.model.state_dict().items())
        resumed = fit(fresh, fresh_step, batches, fusion_out, epochs=1,
                      steps_per_epoch=REGIME_STEPS + 2, log_every=1)
        if not fusion_restored or resumed.step != REGIME_STEPS + 2:
            raise AssertionError(f"train_fusion checkpoint: restored equal {fusion_restored}, "
                                 f"resumed to step {resumed.step}")
        del fresh, resumed

        # one step in each loss mode, and a fresh variant-0 net without maps
        loss_modes = {}
        for name, kw in (("loss_balance", dict(loss_balance=True)),
                         ("distill", dict(distill=1.0)),
                         ("loss_psnr", dict(loss_psnr=True)),
                         ("loss_psnr_distill", dict(loss_psnr=True, distill=1.0)),
                         ("weight_decay", dict(weight_decay=1e-4)),
                         ("fresh_v0_no_maps", dict(variant=0, uncertainty_maps=0))):
            st, fn = make_fusion_trainer(phase, ada, **{"variant": 2, **kw}, device=dev)
            if kw.get("variant") is None:
                st.model.load_state_dict(fusion_sd)
            mrec = new_rec()
            reset_counts()  # this mode's run
            st, _ = regime_step(fn, mrec)(st, next(batches))
            c = counts()
            check_launches(f"train_fusion {name}", c, mrec, per_step)
            loss_modes[name] = dict(ms=mrec["ms"][0], loss=mrec["loss"][0], k1_launches=c["k1"],
                                    k1_images=mrec["images"][0])
            del st, fn
        fusion_mode_k1 = sum(v["k1_launches"] for v in loss_modes.values())
        frozen_same = all(torch.equal(v, m.state_dict()[k])
                          for m, sd in zip((phase, ada), frozen) for k, v in sd.items())
        frozen_grads = [n for m in (phase, ada) for n, p in m.named_parameters()
                        if p.grad is not None]
        if not frozen_same or frozen_grads:
            raise AssertionError(f"train_fusion: frozen nets changed {not frozen_same}, "
                                 f"gradients on {frozen_grads[:4]}")

        # one step's FusionNet gradients through K1 and through the plain warp
        batch = next(batches)
        models = FusionModels(phase, ada, state.model)
        target = _nchw(batch[1], dev)

        def route_inputs(warp):
            ada.warp = warp
            with torch.no_grad():
                return fusion_inputs(models, batch[0], batch[2], dev)[0]

        def fusion_grads(inputs, cot=None):
            """(FusionNet's parameter gradients, the loss's cotangent of its
            prediction); with `cot` given, that cotangent is pulled back
            instead of the one the prediction's own L1 gives."""
            pred = state.model(*inputs)
            if cot is None:
                loss, _ = fusion_loss(pred, target)
                cot, = torch.autograd.grad(loss, pred, retain_graph=True)
            return torch.autograd.grad(pred, list(state.model.parameters()), cot), cot

        def grad_ratio_of(ga, gb):
            return max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                       for a, b in zip(ga, gb))

        def last_tap_dropped(x, weight, *args):
            """A planted K1 fault: a tap loop that stops one tap short."""
            return adacof_cuda.adacof_warp(x, weight * (torch.arange(
                weight.shape[1], device=weight.device) < weight.shape[1] - 1)[:, None, None],
                *args)

        torch.backends.cudnn.deterministic = True
        try:
            in_kernel = route_inputs(adacof_cuda.adacof_warp)
            in_plain = route_inputs(_plain_warp(warp_plain, adacof_warp_field_grads))
            g_kernel, cot_kernel = fusion_grads(in_kernel)
            g_plain, cot_plain = fusion_grads(in_plain)
            g_plain_shared, _ = fusion_grads(in_plain._replace(maps=in_kernel.maps), cot_kernel)
            planted_ratio = grad_ratio_of(fusion_grads(route_inputs(last_tap_dropped))[0], g_plain)
        finally:
            torch.backends.cudnn.deterministic = False
        input_diff = {k: float((a - b).abs().max()) for k, a, b in
                      zip(in_kernel._fields, in_kernel, in_plain)}
        maps_px = [int(((in_kernel.maps - in_plain.maps).abs()[:, i] > 1e-3).sum())
                   for i in range(3)]
        # the artifact map before its 50x50 histogram median, on each route
        filters = make_filters(CROP, CROP, height, device=dev)
        pre_median_diff = float((adacof_freq_diff(in_kernel.adacof, in_kernel.phase, filters)
                                 - adacof_freq_diff(in_plain.adacof, in_plain.phase, filters))
                                .abs().max())
        fusion_grad_ratio = grad_ratio_of(g_kernel, g_plain)
        shared_ratio = grad_ratio_of(g_kernel, g_plain_shared)
        l1_sign_flips = int((cot_kernel != cot_plain).sum())
    finally:
        ada.warp = adacof_cuda.adacof_warp
        batches.close()
        shutil.rmtree(fusion_out, ignore_errors=True)
    _line(phase="train_fusion", seconds=time.perf_counter() - t0, setup_seconds=t_setup,
          batch=FUSION_BATCH, crop=CROP, variant=2, steps=REGIME_STEPS, warmup_ms=rec["ms"][0],
          ms_per_step=float(np.median(rec["ms"][1:])), ms_steps=rec["ms"][1:],
          peak_memory_bytes=fusion_peak, loss_first=rec["loss"][0], loss_last=rec["loss"][-1],
          k1_launches=fusion_counts["k1"], k1_images_per_step=per_step,
          k1_paths=fusion_counts["k1_paths"], k2_launches=fusion_counts["k2"],
          checkpoint_resumed=True, loss_modes=loss_modes, frozen_unchanged=frozen_same,
          grad_max_rel_diff_shared_maps_cotangent=shared_ratio, grad_tol=GRAD_TOL,
          grad_max_rel_diff=fusion_grad_ratio, grad_tol_own_maps=ROUTE_GRAD_TOL,
          l1_sign_flips=l1_sign_flips, pred_elements=cot_kernel.numel(),
          grad_max_rel_diff_planted_fault=planted_ratio, input_max_abs_diff=input_diff,
          maps_px_over_1e3=maps_px, pre_median_max_abs_diff=pre_median_diff)
    # K1 moves base and adacof by float noise; the artifact map's histogram
    # median turns such noise at a bin edge into up to ~1e-2 at a few pixels
    # (ROADMAP Q3-3), and the L1 loss flips its sign where the prediction
    # meets the target, so the routes' gradients are held at GRAD_TOL with
    # the K1 route's maps and loss cotangent on both, and at ROUTE_GRAD_TOL
    # end to end
    if not max(input_diff["base"], input_diff["adacof"], input_diff["phase"]) <= K1_TOL:
        raise AssertionError(f"FusionNet inputs through K1 and plain differ: {input_diff}")
    if not pre_median_diff <= K1_TOL:
        raise AssertionError(f"the pre-median map through K1 and plain differs by "
                             f"{pre_median_diff:.3g} > {K1_TOL}")
    if not shared_ratio <= GRAD_TOL:
        raise AssertionError(f"FusionNet gradients through K1 and plain differ by "
                             f"{shared_ratio:.3g} of the largest gradient > {GRAD_TOL}")
    if not fusion_grad_ratio <= ROUTE_GRAD_TOL:
        raise AssertionError(f"FusionNet gradients through K1 and plain, each with its own "
                             f"maps, differ by {fusion_grad_ratio:.3g} > {ROUTE_GRAD_TOL}")
    if not planted_ratio > ROUTE_GRAD_TOL:
        raise AssertionError(f"a K1 without its last tap moves the gradients by only "
                             f"{planted_ratio:.3g}: the check at {ROUTE_GRAD_TOL} cannot see it")
    regime_k1 = dict(train_phase=phase_mode_k1, train_fusion=fusion_counts["k1"] + fusion_mode_k1)

    k1_1080, k1_1080_8 = timings[2], timings[3]  # the 4-image and the batched 8-image launch
    k2_train = k2_timings[0]  # the training launch
    _line(phase="total", seconds=time.perf_counter() - t_all)
    print(smi, flush=True)
    _line(kernels=[dict(
        name=adacof_cuda.NAME, route="cuda", source=adacof_cuda.SOURCE,
        replaces=adacof_cuda.REPLACES,
        launches=k1_launches + video_k1 + eval_k1 + train_k1 + sum(regime_k1.values()),
        max_abs_err=max_err,
        ms=k1_1080["ms"], plain_ms=k1_1080["plain_ms"], bound_ms=k1_1080["bound_ms"],
        bound_by=k1_1080["bound_by"], library_ms=None, design=DESIGN,
        train_launch_ms=timings[0]["ms"],
        launch_8_images_ms=k1_1080_8["ms"], launch_8_images_plain_ms=k1_1080_8["plain_ms"],
        launch_8_images_bound_ms=k1_1080_8["bound_ms"],
        launches_by_path=dict(serve=k1_launches, video=video_k1, eval=eval_k1, train=train_k1,
                              **regime_k1),
    ), dict(
        name=adacof_cuda.NAME_BWD, route="cuda", source=adacof_cuda.SOURCE_BWD,
        replaces=adacof_cuda.REPLACES_BWD, launches=train_k2, max_abs_err=k2_max_err,
        ms=k2_train["ms"], plain_ms=k2_train["plain_ms"], bound_ms=k2_train["bound_ms"],
        bound_by=k2_train["bound_by"], library_ms=None, design=DESIGN,
        launch_1080p_ms=k2_timings[1]["ms"],
        launches_by_path=dict(serve=0, video=0, eval=0, train=train_k2, train_phase=0,
                              train_fusion=0),
    )])
    _line(ok=True, device=dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                               count=torch.cuda.device_count()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
