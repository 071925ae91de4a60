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
              max_offset 48 and None, also at 256x512 and 512x768 (more
              blocks than the card holds at once: the ring's consumers lag
              its producer), the training launch and the main
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
  serve_bf16 - the same pairs and models with compute_dtype=torch.bfloat16,
              1 warm-up and 3 timed requests (ms and peak memory beside
              fp32's): K1 exactly 3 launches per request on 2, 4 and 2
              images through F5C3 with the ring, every frame and field it
              takes float32, no K2; the output float32, finite, in [0, 1]
              and >= 35 dB against the fp32 request on the same pair; the
              bf16 guard of tests/test_golden.py (the 128x128 translation
              scene: >= 35 dB against fp32, < 0.35 dB lost to the truth);
              fusion_stream_scan in bf16 on 3 frames of 1080p >= 35 dB
              against the fp32 stream, pair by pair;
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
              warp; the suite draws (visualize=True): 2 panels per set of
              1650x660 and <set>.avi read back with utils/avi.py (2 MJPG
              frames at 2 fps, each its panel's JPEG byte for byte and
              decoded by native/jpeg.cpp >= 18 dB against it: the panels
              show pixel noise, which 4:2:0 chroma averages), the seconds
              drawing panels and writing the AVI apart from the seconds
              scoring and from the native library's g++ build;
  train     - AdaCoF training from the bundled weights: make_adacof_trainer
              and fit over batch_iterator(SyntheticTriplets(n=32, h=272,
              w=272), 4, crop=256), fp32, TF32 off, 1 warm-up and 20 timed
              steps; K1 and K2 must each launch exactly once per step,
              through the asynchronous-copy F5C3 instantiation, every
              loss must be finite, fit must draw train_curve.png at
              800x400, a checkpoint must be written and a second
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
  lpips     - (after eval) make_vgg_lpips from a seeded torchvision-format
              vgg16 state dict (written to a temporary file; no weights are
              downloaded) on the card against the CPU on a 256x256 pair
              within 1e-4 relative, then evaluate_suite on the eval phase's
              sets (adacof and baseline) with it: every set's lpips_vgg
              finite, K1 once per set and method, through F5C3 with the
              ring;
  photo     - (after lpips; lines photo_data, photo_eval, photo_train) the
              JPEG decoder on grace_hopper.jpg, its sha256 equal to the
              digest of PIL's decode (HOPPER_SHA256, held by the CPU test),
              and its ms; the JPEG writer's bytes equal to cv2's (the
              digests of JPEG_PINS, held by the CPU test) on the photo, its
              green channel and a pattern at the panel size, at quality 95
              and 75, and the photo's quality-95 file decoded >= 35 dB
              against it; photo_sources() cold, each source within 1e-6 of
              JAX's statistics (PHOTO_SOURCE_STATS); evaluate_suite on
              synthetic_sets(512, 4, include_photo=True)["photo"] with the
              serve models for adacof and fusion (visualize=False): K1 1 + 3 launches via
              F5C3 with the ring, no K2, each fused triplet >= 60 dB
              against the same request through the plain warp; AdaCoF
              training from the bundled weights, 1 + 5 steps at batch 4 on
              256x256 crops of MixedSynthStream(n=64, h=288, w=448,
              photo_frac=0.5): K1 and K2 once a step via F5C3 with the
              ring, the first step's K1 launch within 1e-5 and K2 (seeded
              cotangent) within 1e-4 of their plain versions on its
              inputs, finite losses, the stream's build seconds, ms a step;
              `cli video --method adacof` on a directory of 3 copies of
              grace_hopper.jpg (5 PNGs, the originals exact, K1 once a
              pair) and `cli evaluate --test_sets synthetic+photo --dim
              128 --max_num 1 --methods adacof` (JAX's 9 set keys, K1 once
              a set); where ffmpeg and ffprobe are on PATH (nothing is
              installed);
  cli       - (after train_fusion) the command line on PNG files: the serve phase's
              first pair and the video phase's 5-frame clip written with
              the port's imwrite, read back bit-equal, and the C++ row
              unfilter held bit-equal to its numpy oracle on each (read and
              write ms, median of the clip's 5); `python3 -m
              fmvfi_tpu_torch.cli interpolate --method fusion` as a process
              of its own (the bundled AdaCoF, the demo FusionNet and a
              seeded PhaseNet written in phase_net.pt's layout), its cold
              start (process start to PNG written) on a line of its own
              beside a process that only imports torch and the CLI and
              makes the card's context, its
              PNG within 1 LSB of the same request run here on the decoded
              frames, which launches K1 3 times through F5C3 with the ring;
              then through cli.main: `video` per pair and --batch 2 (9
              PNGs, the originals exact at the even positions, K1 [2, 4, 2]
              per pair and [4, 8, 4] per dispatch, batch 2 within 1 LSB of
              per pair), `evaluate` on a 2-scene middlebury layout of
              256x256 PNGs for fusion,adacof (its result JSONs, finite
              PSNR, K1 [2, 4, 2] and [2] per scene), `evaluate` on a
              4-frame 64x64 PNG directory for adacof (K1 [4], results.png
              1320x440), and `train` on a
              4-triplet Vimeo90k layout of 288x448 PNGs at crop 256, batch
              4: adacof 3 steps (K1 and K2 once a step), phase and fusion 2
              steps (no K1; K1 [8, 16, 8] a step), finite losses, batches
              through the native loader, a checkpoint and config.json;
  export    - (after cli) `python3 -m fmvfi_tpu_torch.cli export --method
              fusion --size 1080x1920 --platforms cuda` as a process of its
              own (the cli phase's weights), its seconds, the artifact's MB
              and the filter bank's share; the artifact loaded in a fresh
              process (load_exported, K1 built from the sources as in the
              live pipeline) answering the serve phase's first pair, 1
              warm-up and 3 timed requests: >= 60 dB against the same
              request live in this process (1 warm-up, 3 timed), K1
              launched through the registered operator on [2, 4, 2] images
              via f5c3/ring, no K2, warm ms per request of both (median
              of 3); a ("cpu",) adacof artifact at 64x64 answering within
              2e-5 of the live CPU pipeline in a process outside the
              repository where fmvfi_tpu_torch cannot be imported; 2
              AdaCoF training steps on the card (K1 and K2 once a step)
              written with save_msgpack(adacof_to_flax(...)), read back
              with load_adacof_weights: parameters and one pair's output
              bit-equal; profiling.timed of one 1080p request beside the
              serve phase's host-clock ms, and one request's
              profiling.trace file;
  train_gan - AdaCoF training with the VGG and T_WGAN_GP terms (the default
              loss + 0.01*VGG + 0.005*T_WGAN_GP, the seeded vgg16, a critic
              built for 256x256) from the bundled weights through fit over
              batch_iterator(SyntheticTriplets(n=32, h=272, w=272), 4,
              crop=256), 1 warm-up and 10 timed steps: K1 and K2 once a
              step through F5C3 with the ring, finite losses and d_loss, a
              critic that moved, a checkpoint whose generator, critic (with
              its BN statistics), critic Adam and draw generator restore
              exactly; then one step each with GAN, WGAN, WGAN_GP and
              FI_GAN at the same size;
  gan_vs_cpu - each of the five adversarial steps at 64x64, batch 2, on
              the card against the CPU from one critic and one epsilon
              (plain SGD that records the critic's gradient), in float64:
              losses within 1e-4 relative, the critic's and the fake's
              gradients within 1e-4 of each tensor's largest (cuDNN's
              double backward of the gradient penalty), and the penalty
              weighted 0 reading over those bounds; the float32 gaps are
              printed, not held (leaky-ReLU kinks that float noise moves a
              pre-activation across change a float32 gradient by up to
              ~5e-2 of a tensor's largest at this size, on the CPU as on
              the card);
  native    - the C++ augmentation library builds (its g++ seconds),
              batch_iterator over a MixedSynthStream takes the native path
              (its path counter), and its batches equal the numpy path's
              within 1e-6;
  dp        - data parallelism: (a) `python -m fmvfi_tpu_torch.cli train
              --regime adacof --data_parallel` (a 1-process NCCL group),
              3 steps of batch 4 at 256x256, as a process of its own
              beside the same command without --data_parallel
              and the same command once more (deterministic cuDNN in
              all three): K1 and K2 once a step via F5C3 with the ring,
              the parameters after the 3 steps within 1e-5 (F.interpolate's
              bilinear backward adds with atomics on CUDA: no two runs
              are bit-equal, and torch has no deterministic version; the
              plain command's gap against itself is printed), the
              data-parallel run writing one metrics file, one checkpoint
              directory and config.json; (b) two processes
              on the one card in a gloo group (NCCL refuses two ranks on
              one device), each stepping its half of a global batch 4 at
              256x256 through data_parallel for 2 steps of the adacof and
              the phase regimes (momentum SGD in place of Adam/Adamax,
              whose first steps turn float noise at a near-zero gradient
              into +-lr): the ranks bit-equal, the parameters within 1e-5
              of the 1-process steps on the global batch here and the
              losses within 1e-6 relative, or within 3x the largest gap
              of those steps with the batch's rows rolled by 1, 2 and 3
              (the same math in other orders), K1/K2 per rank as on one
              process; the ms of each step, 1 process against 2 ranks;
  spatial   - height sharding for serving (last), two gloo ranks on the one
              card as a ("data", "spatial") mesh of (1, 2), the kernels
              built here first: (a) adacof_warp_tm_sharded at the serve
              launch (2 images of 1080x1920, 540-row bands, R = 48): the
              bands within 1e-5 of the plain warp on the whole frame here
              and within 1e-6 of K1 there, their field gradients (K2)
              within 1e-4 of the plain field gradients and of K2's, K1 and
              K2 once per rank; (b) fusion_spatial_apply on the serve
              models at 1080x1920, batch 1, 1 warm-up and 2 requests: the
              ranks' gathered frames equal and >= 60 dB against
              fusion_interpolate here with the plain warp, K1 [2, 4, 2]
              images per rank per request via f5c3/ring, no K2; ms per
              request, peak memory, halo and gather bytes per rank (two
              ranks share one card and gloo reduces through host memory:
              the collectives' cost, not a speed-up); (c) on a 1-process
              NCCL group, (1, 1) mesh, fusion_spatial_apply bit-equal to
              fusion_interpolate;
  spatial_train - (last) the spatial trainers on two gloo ranks sharing the
              card, (data 1 x spatial 2), each regime from the bundled
              weights (and the seeded PhaseNet) on seeded translation
              batches, against the same steps in this one process: (a)
              adacof_spatial_trainer, batch 4 of 256x256, 1 warm-up and 5
              timed steps, K1 and K2 once a step per rank on 8 images of
              230 x 260 (128-row bands + 51 halo rows each side) via
              f5c3/ring; (b) fusion_spatial_trainer (variant 2), the same
              batches' shape, K1 [8, 16, 8] on 230-row blocks, no K2; (c)
              fusion_spatial_trainer at 1080x1920, batch 1, 1 warm-up and
              2 steps, K1 [2, 4, 2] on 646-row blocks; (d) AdaCoF with
              +0.01*VGG+0.005*T_WGAN_GP, the compared step and 2 timed,
              K1 and K2 once a step, the critic on the trainer's Adam.
              Gates: every K1 launch of the first step on the bands
              against the plain warp (1e-5), and K2 on the same inputs with
              a seeded cotangent against the plain field gradients (1e-4);
              the first step's loss within 1e-5 relative of one process's
              ((d): the terms that precede the critic's update, since the
              loss reads the critic after Adam's lr * sign(g) step), (a)
              and (d) its clipped gradient (the optimizer's first moment /
              0.1) within 2e-4 of each tensor's largest, (b) FusionNet's
              gradient on the ranks' own inputs within 5e-5 and end to end
              within 1e-3 (ROADMAP Q3-3), (d) d_loss within 1e-5, each or
              within twice one process's own spread (its first step run
              twice); the ranks' parameters (and critic) bit-equal; halo
              bytes forward and backward every step; ms per step, peak
              memory and bytes exchanged by kind per rank.
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
    "(cp.async.bulk, mbarriers, L2 evict-first) fed by a producer warp, each stage released "
    "behind a generic-to-async proxy fence; RGBX corner "
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
EVAL_PANELS = 2  # synthetic_sets(256, 4): 2 triplets a set
EVAL_PANEL_SHAPE = (660, 330 * (len(EVAL_METHODS) + 1), 3)  # figsize (3 (n + 1), 6) at 110 dpi
# each MJPG frame, decoded, against its panel: the frames are cv2's JPEG
# (quality 95, 4:2:0) of panels whose synthetic frames are pixel noise; on
# the CPU these 16 frames decode at 19.64-23.38 dB (cv2's own encoding of
# them is the same bytes); that a frame is its panel's JPEG is checked byte
# for byte
EVAL_AVI_DB = 18.0
H_FULL, W_FULL = 1080, 1920
GAN_TYPES = ("GAN", "WGAN", "WGAN_GP", "FI_GAN", "T_WGAN_GP")
GAN_TERMS = "+0.01*VGG+0.005*{}"  # added to the default AdaCoF loss
GAN_STEPS = 10  # timed adversarial training steps, after one warm-up step
GAN_CPU_SIZE, GAN_CPU_BATCH, GAN_CPU_LR = 64, 2, 1e-3
# losses (relative) and gradients (of each tensor's largest), in float64
GAN_CPU_TOL = 1e-4
LPIPS_TOL = 1e-4  # relative, card against CPU
NATIVE_TOL = 1e-6  # native batches against the numpy path: x * (1/255) against x / 255
CLI_LSB = 1  # a PNG written by a command against the same frame computed in this process
EXPORT_CPU_TOL = 2e-5  # a ("cpu",) artifact against the live CPU pipeline
BF16_DB, BF16_LOSS_DB = 35.0, 0.35  # bf16 against fp32; PSNR to the truth lost (test_golden.py)
DP_BATCH, DP_STEPS, DP_CLI_STEPS, DP_LR = 4, 2, 3, 1e-2  # global batch at CROP x CROP
# --data_parallel against the plain command, params abs, and 2 gloo ranks against
# 1 process, params abs and loss rel.  The backward of F.interpolate's bilinear
# modes and of reflection padding adds with atomics on CUDA, so no two runs of
# a step are bit-equal (torch has no deterministic version of them): 1e-5 is
# a hundredth of one Adamax update at lr 1e-3, far over that spread
DP_PARAM_TOL, DP_LOSS_TOL = 1e-5, 1e-6
# ... or, for the 2 ranks, FLOOR_SHARE x the largest gap of the same steps with
# the batch's rows rolled by 1, 2, 3: the phase regime's float32 gradients
# move with the summation order (tests/test_torch_parallel.py prints how far),
# and the ranks' arithmetic differs from one process's in more than the order
# (BN moments from two halves' sums, the gradient as the mean of two halves')
FLOOR_SHARE = 3.0
VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512]
# photo: grace_hopper.jpg decoded (600, 512, 3) uint8 RGB as PIL decodes it,
# and JAX's photo_sources() per source (shape, float64 sum, pixels [0, 0],
# [h // 2, w // 2], [h - 1, w - 1]); tests/test_torch_photo.py holds both
# against PIL and fmvfi_tpu on the CPU
HOPPER_SHA256 = "f7f982de68dd296af67ee51b2a95a2e5658f7bf064c6536520b66bae8d01fc34"
# the JPEG writer (native/jpeg_enc.cpp, built on the card's host) held to
# cv2's bytes: the sha256 of cv2.imencode('.jpg') of each of
# _jpeg_pin_images at IMWRITE_JPEG_QUALITY q, which
# tests/test_torch_jpeg_write.py computes with cv2 on the CPU; and
# grace_hopper's quality-95 file, decoded by native/jpeg.cpp, against its
# pixels (47.35 dB on the CPU)
JPEG_PINS = {
    ("hopper", 95): "7778ee6ffa24b97b5e6d68ec5f98cebda3e8be7090b43d21f2b118ddb71d1f47",
    ("hopper", 75): "2a930f977837adefefc67e5bf86cd46a9d9c3f05d79e2cb4f986440bad197e81",
    ("hopper_green", 95): "96c7bb91ac19d01d07ee27de32a6d0f0d468887ef56f8acdcdf0eac938ad52e2",
    ("hopper_green", 75): "319cc1fe5468fc792868850196a7ab80218984f62461e2875bdc77093524f970",
    ("pattern", 95): "dd56e5f3d433ceaa8bad02b7d7a9d4a4683a9aa4c2ff645c7884430f24f69e65",
    ("pattern", 75): "521961ef2da86098409a4dc4465890948c135b1a19aa0c0d50687997ec05787b",
}
JPEG_HOPPER_DB = 35.0
PHOTO_SOURCE_STATS = [
    ((600, 512, 3), 290742.50440738397,
     [[0.08235294371843338, 0.0941176488995552, 0.3019607961177826],
      [0.8470588326454163, 0.5333333611488342, 0.40392157435417175],
      [0.054901961237192154, 0.05098039284348488, 0.07450980693101883]]),
    ((300, 256, 3), 72597.84075098624,
     [[0.08235294371843338, 0.0941176488995552, 0.3019607961177826],
      [0.027450980618596077, 0.03921568766236305, 0.16078431904315948],
      [0.7686274647712708, 0.4431372582912445, 0.30980393290519714]]),
    ((400, 342, 3), 134370.20283807535,
     [[0.5137255191802979, 0.2980392277240753, 0.18039216101169586],
      [0.0313725508749485, 0.03529411926865578, 0.05098039284348488],
      [0.054901961237192154, 0.05098039284348488, 0.07450980693101883]]),
    ((300, 256, 3), 96145.89218260208,
     [[0.027450980618596077, 0.03921568766236305, 0.16078431904315948],
      [0.8470588326454163, 0.5333333611488342, 0.40392157435417175],
      [0.0313725508749485, 0.0313725508749485, 0.0784313753247261]]),
    ((344, 403, 3), 174312.78154696524,
     [[0.22654232382774353, 0.5612523555755615, 0.5385386347770691],
      [0.3841860592365265, 0.7525913715362549, 0.5043869018554688],
      [0.04125696048140526, 0.04252732917666435, 0.603724479675293]]),
    ((91, 120, 3), 15083.768950724043,
     [[0.00696258619427681, 0.0, 0.27925559878349304],
      [0.11661694198846817, 0.3970998227596283, 0.0956043154001236],
      [0.46771299839019775, 0.5060732960700989, 0.1378677934408188]]),
    ((256, 256, 3), 35345.44185687974,
     [[0.0, 0.0, 0.0],
      [0.4372093081474304, 0.4372093081474304, 0.4372093081474304],
      [0.0, 0.0, 0.0]]),
]
PHOTO_TOL = 1e-6  # the sources' sums (relative) and pixels: float shading on another CPU
PHOTO_DIM, PHOTO_FRAMES = 512, 4  # synthetic_sets(512, 4, include_photo=True)["photo"]
PHOTO_METHODS = ("adacof", "fusion")
PHOTO_K1 = dict(adacof=1, fusion=3)  # one dispatch per method, as the eval phase counts
PHOTO_STEPS = 5  # timed photo_frac training steps, after the compared first one
PHOTO_STREAM = dict(n=64, h=288, w=448, photo_frac=0.5)
PHOTO_CLI_FRAMES = 3  # copies of grace_hopper.jpg as a JPEG frame directory


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


def _seeded_vgg16(path):
    """A torchvision-format vgg16 `features.*` state dict from seed 0
    (He-scaled normal weights, small biases), saved to `path`: no vgg16
    weights are in the repository and nothing is downloaded."""
    import torch

    gen = torch.Generator().manual_seed(0)
    sd, idx, cin = {}, 0, 3
    for v in VGG16_CFG:
        if v == "M":
            idx += 1
            continue
        sd[f"features.{idx}.weight"] = torch.randn(v, cin, 3, 3, generator=gen) * (
            2.0 / (9 * cin)) ** 0.5
        sd[f"features.{idx}.bias"] = 0.01 * torch.randn(v, generator=gen)
        cin, idx = v, idx + 2
    torch.save(sd, path)
    return path


def _eval_figures(out_dir, sets):
    """The eval phase's figures: per set, EVAL_PANELS panels of the panel
    size, and <set>.avi read back with utils/avi.py: as many MJPG frames,
    the stream's size and rate, each frame the quality-95 JPEG of its panel
    (native/jpeg_enc.cpp, byte for byte) and decoded by native/jpeg.cpp at
    >= EVAL_AVI_DB against it.  Raises on any miss; returns the minimum
    PSNR and the AVI bytes per set."""
    from fmvfi_tpu_torch import native
    from fmvfi_tpu_torch.utils import avi, imageio

    avi_db, avi_bytes = [], {}
    for name in sets:
        pdir = os.path.join(out_dir, f"panels_{name}")
        names = sorted(os.listdir(pdir)) if os.path.isdir(pdir) else []
        if names != [f"panel_{i:03d}.png" for i in range(EVAL_PANELS)]:
            raise AssertionError(f"eval: panels of {name}: {names}")
        panels = [imageio.imread(os.path.join(pdir, n)) for n in names]
        if any(p.shape != EVAL_PANEL_SHAPE for p in panels):
            raise AssertionError(f"eval: panel shapes {[p.shape for p in panels]}, "
                                 f"expected {EVAL_PANEL_SHAPE}")
        path = os.path.join(out_dir, f"{name}.avi")
        video = avi.read(path)
        h, w = EVAL_PANEL_SHAPE[:2]
        head = (video.avih["total_frames"], video.avih["width"], video.avih["height"],
                video.strh["handler"], video.strh["rate"] / video.strh["scale"], len(video.frames),
                len(video.index))
        if head != (EVAL_PANELS, w, h, b"MJPG", 2.0, EVAL_PANELS, EVAL_PANELS):
            raise AssertionError(f"eval: {name}.avi (frames, width, height, codec, fps, chunks, "
                                 f"index) = {head}")
        for frame, panel in zip(video.frames, panels):
            if frame != native.jpeg_encode(panel, 95):
                raise AssertionError(f"eval: a frame of {name}.avi is not its panel's JPEG")
            db = _psnr(native.jpeg_decode(frame).astype(np.float64) / 255,
                       panel.astype(np.float64) / 255)
            avi_db.append(db)
        avi_bytes[name] = os.path.getsize(path)
    if not min(avi_db) >= EVAL_AVI_DB:
        raise AssertionError(f"eval: AVI frames against their panels {min(avi_db)} dB")
    return dict(panels_per_set=EVAL_PANELS, panel_shape=list(EVAL_PANEL_SHAPE),
                avi_frame_min_db=min(avi_db), avi_bytes=avi_bytes)


def _jpeg_pin_images(hopper):
    """The images of JPEG_PINS from grace_hopper.jpg's pixels: the photo,
    its green channel as a grey image, and an integer pattern at the eval
    panels' size (sides that are no multiple of 16)."""
    h, w = EVAL_PANEL_SHAPE[:2]
    y, x = np.mgrid[:h, :w].astype(np.int64)
    pattern = np.stack([(x * 5 + y * 3) % 256, (x * y // 7) % 256, (x ^ y) & 255], -1)
    return {"hopper": hopper, "hopper_green": np.ascontiguousarray(hopper[..., 1]),
            "pattern": pattern.astype(np.uint8)}


def _jpeg_pins(hopper):
    """native.jpeg_encode of each of _jpeg_pin_images against its digest of
    cv2's bytes, and grace_hopper's quality-95 file decoded by
    native/jpeg.cpp against its pixels."""
    import hashlib

    from fmvfi_tpu_torch import native

    images = _jpeg_pin_images(hopper)
    t = time.perf_counter()
    equal = {f"{name}_q{q}": hashlib.sha256(native.jpeg_encode(images[name], q)).hexdigest()
             == digest for (name, q), digest in JPEG_PINS.items()}
    seconds = time.perf_counter() - t
    db = _psnr(native.jpeg_decode(native.jpeg_encode(hopper, 95)).astype(np.float64) / 255,
               hopper.astype(np.float64) / 255)
    return dict(cv2_bytes_equal=equal, encode_seconds=seconds, hopper_q95_db=float(db),
                ok=bool(all(equal.values()) and db >= JPEG_HOPPER_DB))


def _reset_counts():
    from fmvfi_tpu_torch.ops import adacof_cuda

    adacof_cuda.launches = adacof_cuda.bwd_launches = 0
    adacof_cuda.paths.clear()
    adacof_cuda.bwd_paths.clear()


def _counts():
    from fmvfi_tpu_torch.ops import adacof_cuda

    return dict(k1=adacof_cuda.launches, k2=adacof_cuda.bwd_launches,
                k1_paths=dict(adacof_cuda.paths), k2_paths=dict(adacof_cuda.bwd_paths))


def _work_dir(repo):
    """A temporary directory under the repository's git-ignored build/."""
    os.makedirs(os.path.join(repo, "build"), exist_ok=True)
    return tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=os.path.join(repo, "build"))


def phase_lpips(dev, repo, models, sets):
    """make_vgg_lpips on the card against the CPU, then evaluate_suite with it;
    returns the path's K1 launches."""
    with _work_dir(repo) as work_dir:
        return _lpips(dev, models, sets, _seeded_vgg16(os.path.join(work_dir, "vgg16.pth")),
                      work_dir)


def _lpips(dev, models, sets, vgg_path, work_dir):
    import torch
    from fmvfi_tpu_torch.eval.evaluate import evaluate_suite
    from fmvfi_tpu_torch.eval.metrics import make_vgg_lpips

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(0)
    a, b = (torch.rand(CROP, CROP, 3, generator=gen) for _ in range(2))
    card_fn = make_vgg_lpips(vgg_path, device=dev)
    card = float(card_fn(a.to(dev), b.to(dev)))
    cpu = float(make_vgg_lpips(vgg_path, device="cpu")(a, b))
    same = float(card_fn(a.to(dev), a.to(dev)))
    rel = abs(card / cpu - 1.0)
    methods = ("adacof", "baseline")
    _reset_counts()  # the lpips evaluation path's run
    t_run = time.perf_counter()
    summary = evaluate_suite(models, os.path.join(work_dir, "lpips"), sets=sets, methods=methods,
                             dim=CROP, visualize=False, lpips_fn=card_fn, device=dev)
    run_seconds = time.perf_counter() - t_run
    c = _counts()
    lpips = {k: {m: summary[k][m].get("lpips_vgg") for m in methods} for k in sets}
    _line(phase="lpips", seconds=time.perf_counter() - t0, size=[CROP, CROP], card=card, cpu=cpu,
          rel_diff=rel, tol=LPIPS_TOL, same_pair=same, suite_run_seconds=run_seconds,
          lpips_vgg=lpips, k1_launches=c["k1"], k1_paths=c["k1_paths"], k2_launches=c["k2"])
    if not rel <= LPIPS_TOL or not same == 0.0:
        raise AssertionError(f"lpips: card {card} against CPU {cpu} ({rel:.3g}), a pair with "
                             f"itself {same}")
    vals = [v for row in lpips.values() for v in row.values()]
    if None in vals or not np.isfinite(vals).all():
        raise AssertionError(f"lpips: evaluate_suite's lpips_vgg {lpips}")
    if c["k1"] != 2 * len(sets) or c["k1_paths"] != {RING_PATH: c["k1"]} or c["k2"]:
        raise AssertionError(f"lpips: K1 {c['k1_paths']}, K2 {c['k2']}; expected one K1 launch "
                             f"per set and method through {RING_PATH}")
    return c["k1"]


def phase_photo(dev, repo, models, ada_path):
    """JPEG frames and the natural-photo sources on the card: the decoder
    against PIL's digest, photo_sources against JAX's statistics, the photo
    set's evaluation and photo_frac AdaCoF training through K1/K2, and the
    command line on JPEG frames; returns the path's K1 and K2 launches."""
    with _work_dir(repo) as work:
        return _photo(dev, repo, models, ada_path, work)


def _photo(dev, repo, models, ada_path, work):
    import contextlib
    import hashlib
    import io

    import torch
    from fmvfi_tpu_torch import cli
    from fmvfi_tpu_torch.eval import synth
    from fmvfi_tpu_torch.eval.evaluate import evaluate_suite, synthetic_sets
    from fmvfi_tpu_torch.ops import adacof_cuda
    from fmvfi_tpu_torch.ops.adacof import adacof_warp as warp_plain
    from fmvfi_tpu_torch.ops.adacof import adacof_warp_field_grads
    from fmvfi_tpu_torch.pipeline.interpolate import fusion_interpolate
    from fmvfi_tpu_torch.train.data import MixedSynthStream, batch_iterator
    from fmvfi_tpu_torch.train.trainer import make_adacof_trainer
    from fmvfi_tpu_torch.utils import imageio
    from fmvfi_tpu_torch.utils.convert import load_adacof_weights

    t0 = time.perf_counter()
    hopper = os.path.join(synth.SAMPLE_DATA, "grace_hopper.jpg")
    t = time.perf_counter()
    img = imageio.read_jpeg(hopper)  # the first decode (phase eval built the library)
    first_ms = 1e3 * (time.perf_counter() - t)
    decode_ms = []
    for _ in range(5):
        t = time.perf_counter()
        imageio.read_jpeg(hopper)
        decode_ms.append(1e3 * (time.perf_counter() - t))
    digest = hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()
    jpeg = dict(shape=list(img.shape), sha256=digest, expected=HOPPER_SHA256,
                first_call_ms=first_ms, decode_ms=float(np.median(decode_ms)))

    t = time.perf_counter()
    sources = synth.photo_sources()
    sources_seconds = time.perf_counter() - t
    src_gaps = []
    for s, (shape, total, pixels) in zip(sources, PHOTO_SOURCE_STATS):
        h, w = shape[:2]
        got = [s[0, 0], s[h // 2, w // 2], s[h - 1, w - 1]] if s.shape == shape else []
        src_gaps.append(dict(
            shape=list(s.shape),
            sum_rel=abs(float(np.sum(s, dtype=np.float64)) / total - 1.0),
            pixel_abs=max((float(np.abs(np.asarray(g, np.float64) - p).max())
                           for g, p in zip(got, pixels)), default=float("inf"))))
    tools = {k: shutil.which(k) for k in ("ffmpeg", "ffprobe")}
    jpeg_write = _jpeg_pins(img)
    _line(phase="photo_data", seconds=time.perf_counter() - t0, jpeg=jpeg,
          jpeg_write=jpeg_write, sources_seconds=sources_seconds, sources=src_gaps,
          tol=PHOTO_TOL, which=tools)
    if digest != HOPPER_SHA256 or img.shape != (600, 512, 3):
        raise AssertionError(f"photo: grace_hopper.jpg decodes to {jpeg}, not PIL's digest")
    if not jpeg_write["ok"]:
        raise AssertionError(f"photo: the JPEG writer against cv2's bytes: {jpeg_write}")
    if len(sources) != len(PHOTO_SOURCE_STATS) or not all(
            g["sum_rel"] <= PHOTO_TOL and g["pixel_abs"] <= PHOTO_TOL for g in src_gaps):
        raise AssertionError(f"photo: photo_sources against JAX's statistics {src_gaps}")

    # the photo set through evaluate_suite, then each fused prediction
    # against the same request through the plain warp
    t0 = time.perf_counter()
    sets = {"photo": synthetic_sets(PHOTO_DIM, PHOTO_FRAMES, include_photo=True)["photo"]}
    set_seconds = time.perf_counter() - t0
    _reset_counts()  # the photo evaluation path's run
    t_run = time.perf_counter()
    summary = evaluate_suite(models, os.path.join(work, "eval"), sets=sets,
                             methods=PHOTO_METHODS, dim=PHOTO_DIM, device=dev, visualize=False)
    run_seconds = time.perf_counter() - t_run
    eval_c = _counts()
    frames = sets["photo"]
    plain_db = []
    for i in range(len(frames) - 2):
        k1_out = fusion_interpolate(models, frames[i][None], frames[i + 2][None], device=dev)
        models.adacof.warp = warp_plain
        try:
            plain_out = fusion_interpolate(models, frames[i][None], frames[i + 2][None],
                                           device=dev)
        finally:
            models.adacof.warp = adacof_cuda.adacof_warp
        plain_db.append(_psnr(k1_out.cpu().numpy(), plain_out.cpu().numpy()))
    want_k1 = sum(PHOTO_K1[m] for m in PHOTO_METHODS)
    _line(phase="photo_eval", seconds=time.perf_counter() - t0, set_seconds=set_seconds,
          run_seconds=run_seconds, dim=PHOTO_DIM, n_frames=PHOTO_FRAMES,
          psnr={m: summary["photo"][m]["psnr"] for m in PHOTO_METHODS},
          ssim={m: summary["photo"][m]["ssim"] for m in PHOTO_METHODS},
          k1_launches=eval_c["k1"], k1_paths=eval_c["k1_paths"], k2_launches=eval_c["k2"],
          fusion_vs_plain_warp_db=plain_db)
    if eval_c["k1"] != want_k1 or eval_c["k1_paths"] != {RING_PATH: want_k1} or eval_c["k2"]:
        raise AssertionError(f"photo eval: K1 {eval_c['k1_paths']}, K2 {eval_c['k2']}; "
                             f"expected {want_k1} K1 launches through {RING_PATH}, no K2")
    means = [v for m in PHOTO_METHODS for v in summary["photo"][m].values()]
    if not np.isfinite(means).all() or not min(plain_db) >= PLAIN_AGREEMENT_DB:
        raise AssertionError(f"photo eval: means {summary}, fused against the plain warp "
                             f"{plain_db} dB")

    # photo_frac training: AdaCoF from the bundled weights on the mixed
    # stream, K1 and K2 once a step; the first step's launches held against
    # the plain versions on the same inputs afterwards
    t0 = time.perf_counter()
    stream = MixedSynthStream(**PHOTO_STREAM)
    stream_seconds = time.perf_counter() - t0
    state, step_fn = make_adacof_trainer(device=dev)
    state.model.load_state_dict(load_adacof_weights(ada_path))
    batches = batch_iterator(stream, FUSION_BATCH, crop=CROP)
    captured = []

    def recording_warp(*args):
        if not captured:
            captured.append(tuple(a.detach().clone() if torch.is_tensor(a) else a
                                  for a in args))
        return adacof_cuda.adacof_warp(*args)

    state.model.warp = recording_warp
    step_ms, losses, per_step = [], [], []
    try:
        _reset_counts()  # the photo training path's run
        for _ in range(PHOTO_STEPS + 1):
            batch = next(batches)
            before = (adacof_cuda.launches, adacof_cuda.bwd_launches)
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, m = step_fn(state, batch)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t))
            per_step.append([adacof_cuda.launches - before[0],
                             adacof_cuda.bwd_launches - before[1]])
        train_c = _counts()  # read just after
    finally:
        batches.close()
        state.model.warp = adacof_cuda.adacof_warp
    (x, wgt, a, be, d, r), = captured
    cot = torch.randn((x.shape[0], x.shape[1]) + tuple(wgt.shape[2:]),
                      generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    k1_out, x4 = adacof_cuda.warp_fwd_cuda(x, wgt, a, be, d, r)
    k1_err = float((k1_out - warp_plain(x, wgt, a, be, d, r)).abs().max())
    k2_err = max(float((k - p).abs().max()) for k, p in zip(
        adacof_cuda.warp_bwd_cuda(x, wgt, a, be, cot, d, r, x4=x4),
        adacof_warp_field_grads(x, wgt, a, be, cot, d, r)))
    photo_items = sum(1 for i in range(len(stream))
                      if np.random.default_rng(1000 + i).random() < PHOTO_STREAM["photo_frac"])
    del state, captured, x, wgt, a, be, cot, k1_out, x4
    torch.cuda.empty_cache()

    # the command line on JPEG frames: video over a directory of copies of
    # grace_hopper.jpg, and evaluate --test_sets synthetic+photo
    t_cli = time.perf_counter()
    clip = os.path.join(work, "jpeg_clip")
    os.makedirs(clip)
    for i in range(PHOTO_CLI_FRAMES):
        shutil.copy(hopper, os.path.join(clip, f"{i:05d}.jpg"))
    _reset_counts()  # the command line's run
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["video", "--input", clip, "--output_dir", os.path.join(work, "video"),
                  "--method", "adacof", "--device", dev.type])
    video_c = _counts()
    written = sorted(os.listdir(os.path.join(work, "video")))
    originals = all(np.array_equal(imageio.imread(os.path.join(work, "video", written[2 * i])),
                                   img) for i in range(PHOTO_CLI_FRAMES))
    _reset_counts()
    with contextlib.redirect_stdout(io.StringIO()):  # the command prints its summary
        cli.main(["evaluate", "--test_sets", "synthetic+photo", "--out_dir",
                  os.path.join(work, "cli_eval"), "--dim", "128", "--max_num", "1",
                  "--methods", "adacof", "--device", dev.type])
    cli_eval_c = _counts()
    with open(os.path.join(work, "cli_eval", "summary.json")) as f:
        cli_keys = list(json.load(f))
    cli_seconds = time.perf_counter() - t_cli
    want_keys = list(synthetic_sets(16, 3, include_photo=True))
    _line(phase="photo_train", seconds=time.perf_counter() - t0, stream=PHOTO_STREAM,
          stream_build_seconds=stream_seconds, photo_items=photo_items, batch=FUSION_BATCH,
          crop=CROP, steps=PHOTO_STEPS, first_step_ms=step_ms[0],
          ms_per_step=float(np.median(step_ms[1:])), ms_steps=step_ms[1:], loss=losses,
          k1_launches=train_c["k1"], k2_launches=train_c["k2"],
          k1_k2_paths=[train_c["k1_paths"], train_c["k2_paths"]],
          first_step_k1_max_abs_err=k1_err, first_step_k2_max_abs_err=k2_err,
          cli_seconds=cli_seconds, cli_video=dict(frames_written=len(written),
                                                  originals_exact=originals,
                                                  k1_launches=video_c["k1"],
                                                  k1_paths=video_c["k1_paths"]),
          cli_evaluate=dict(sets=cli_keys, k1_launches=cli_eval_c["k1"],
                            k1_paths=cli_eval_c["k1_paths"]))
    n = PHOTO_STEPS + 1
    if (per_step != [[1, 1]] * n or train_c["k1_paths"] != {RING_PATH: n}
            or train_c["k2_paths"] != {RING_PATH: n}):
        raise AssertionError(f"photo training: K1/K2 per step {per_step}, by instantiation "
                             f"{train_c['k1_paths']} {train_c['k2_paths']}")
    if not (k1_err <= K1_TOL and k2_err <= K2_TOL) or not np.isfinite(losses).all():
        raise AssertionError(f"photo training: first step K1 {k1_err:.3g}, K2 {k2_err:.3g} "
                             f"against the plain versions; losses {losses}")
    if not 0 < photo_items < len(stream):
        raise AssertionError(f"photo training: {photo_items} photo scenes of {len(stream)}")
    if len(written) != 2 * PHOTO_CLI_FRAMES - 1 or not originals or video_c["k1"] != (
            PHOTO_CLI_FRAMES - 1) or video_c["k1_paths"] != {RING_PATH: video_c["k1"]}:
        raise AssertionError(f"photo cli video: {written}, originals exact {originals}, "
                             f"K1 {video_c['k1_paths']}")
    if cli_keys != want_keys or cli_eval_c["k1"] != len(want_keys) or cli_eval_c["k2"]:
        raise AssertionError(f"photo cli evaluate: sets {cli_keys} (expected {want_keys}), "
                             f"K1 {cli_eval_c['k1_paths']}, K2 {cli_eval_c['k2']}")
    return (eval_c["k1"] + train_c["k1"] + video_c["k1"] + cli_eval_c["k1"],
            train_c["k2"] + video_c["k2"] + cli_eval_c["k2"])


def phase_train_gan(dev, repo, ada_path):
    """AdaCoF training with the VGG and T_WGAN_GP terms through fit, its
    checkpoint, and one step of each other gan type; returns the K1 and K2
    launches of the T_WGAN_GP run and of the other types' steps."""
    with _work_dir(repo) as work_dir:
        return _train_gan(dev, ada_path, _seeded_vgg16(os.path.join(work_dir, "vgg16.pth")),
                          work_dir)


def _train_gan(dev, ada_path, vgg_path, work_dir):
    import torch
    from fmvfi_tpu_torch.ops import adacof_cuda
    from fmvfi_tpu_torch.train.data import SyntheticTriplets, batch_iterator
    from fmvfi_tpu_torch.train.loop import fit
    from fmvfi_tpu_torch.train.losses import parse_loss_spec
    from fmvfi_tpu_torch.train.trainer import DEFAULT_LOSS, make_adacof_trainer
    from fmvfi_tpu_torch.utils.checkpoint import Checkpointer
    from fmvfi_tpu_torch.utils.convert import load_adacof_weights

    t0 = time.perf_counter()

    def trainer(gan, seed=0):
        spec = parse_loss_spec(DEFAULT_LOSS + GAN_TERMS.format(gan))
        st, fn = make_adacof_trainer(loss_spec=spec, vgg_checkpoint=vgg_path, h=CROP, w=CROP,
                                     seed=seed, device=dev)
        st.model.load_state_dict(load_adacof_weights(ada_path))
        return st, fn

    def timed(step_fn, rec):
        def run(st, batch):
            before = (adacof_cuda.launches, adacof_cuda.bwd_launches)
            torch.cuda.synchronize()
            t = time.perf_counter()
            st, m = step_fn(st, batch)
            torch.cuda.synchronize()
            rec["ms"].append(1e3 * (time.perf_counter() - t))
            rec["loss"].append(float(m["loss"]))
            rec["d_loss"].append(float(m["d_loss"]))
            rec["launches"].append([adacof_cuda.launches - before[0],
                                    adacof_cuda.bwd_launches - before[1]])
            return st, m

        return run

    def check(name, c, rec):
        if any(n != [1, 1] for n in rec["launches"]) or c["k1_paths"] != {RING_PATH: c["k1"]} \
                or c["k2_paths"] != {RING_PATH: c["k2"]}:
            raise AssertionError(f"{name}: K1/K2 launches per step {rec['launches']}, by "
                                 f"instantiation {c['k1_paths']} {c['k2_paths']}")
        if not np.isfinite(rec["loss"] + rec["d_loss"]).all():
            raise AssertionError(f"{name}: losses {rec['loss']}, d_loss {rec['d_loss']}")

    def new_rec():
        return dict(ms=[], loss=[], d_loss=[], launches=[])

    state, step_fn = trainer("T_WGAN_GP")
    critic0 = {k: v.clone() for k, v in state.extra.critic.state_dict().items()}
    batches = batch_iterator(SyntheticTriplets(n=32, h=CROP + 16, w=CROP + 16), FUSION_BATCH,
                             crop=CROP)
    out_dir = os.path.join(work_dir, "train_gan")
    try:
        t_setup = time.perf_counter() - t0
        rec = new_rec()
        _reset_counts()  # the adversarial training path's run
        torch.cuda.reset_peak_memory_stats()
        state = fit(state, timed(step_fn, rec), batches, out_dir, epochs=1,
                    steps_per_epoch=GAN_STEPS + 1, log_every=1, ckpt_every=GAN_STEPS + 1)
        counts = _counts()
        peak = torch.cuda.max_memory_allocated()
        check("train_gan", counts, rec)
        moved = max(float((v - critic0[k]).abs().max())
                    for k, v in state.extra.critic.state_dict().items())
        if state.step != GAN_STEPS + 1 or not moved > 0:
            raise AssertionError(f"train_gan: step {state.step}, critic moved {moved}")

        # the checkpoint restores the adversarial state exactly
        fresh, _ = trainer("T_WGAN_GP", seed=1)
        fresh = Checkpointer(os.path.join(out_dir, "checkpoint")).restore(fresh)
        pairs = [(fresh.model.state_dict(), state.model.state_dict()),
                 (fresh.extra.critic.state_dict(), state.extra.critic.state_dict())]
        opt_a, opt_b = (s.extra.optimizer.state_dict()["state"] for s in (fresh, state))
        pairs += [(opt_a[i], opt_b[i]) for i in opt_b]
        # (Adam's step counts stay on the host in a trained state and come
        # back on the card from a checkpoint mapped there: compare on the host)
        restored = fresh.step == state.step and len(opt_a) == len(opt_b) > 0 and all(
            torch.equal(v.cpu(), b[k].cpu()) for a, b in pairs for k, v in a.items()
        ) and torch.equal(fresh.extra.generator.get_state(), state.extra.generator.get_state())
        if not restored:
            raise AssertionError("train_gan: the checkpoint did not restore the adversarial state")
        del fresh, state, pairs, opt_a, opt_b

        # one step of each other gan type at the same size
        types, types_k1, types_k2 = {}, 0, 0
        for gan in GAN_TYPES[:-1]:
            st, fn = trainer(gan)
            trec = new_rec()
            _reset_counts()  # this type's run
            st, _ = timed(fn, trec)(st, next(batches))
            c = _counts()
            check(f"train_gan {gan}", c, trec)
            types_k1, types_k2 = types_k1 + c["k1"], types_k2 + c["k2"]
            types[gan] = dict(ms=trec["ms"][0], loss=trec["loss"][0], d_loss=trec["d_loss"][0])
            del st, fn
            torch.cuda.empty_cache()
    finally:
        batches.close()
    _line(phase="train_gan", seconds=time.perf_counter() - t0, setup_seconds=t_setup,
          loss=DEFAULT_LOSS + GAN_TERMS.format("T_WGAN_GP"), batch=FUSION_BATCH, crop=CROP,
          steps=GAN_STEPS, warmup_ms=rec["ms"][0], ms_per_step=float(np.median(rec["ms"][1:])),
          ms_steps=rec["ms"][1:], peak_memory_bytes=peak, loss_first=rec["loss"][0],
          loss_last=rec["loss"][-1], d_loss_first=rec["d_loss"][0],
          d_loss_last=rec["d_loss"][-1], critic_moved=moved, k1_launches=counts["k1"],
          k2_launches=counts["k2"], k1_k2_paths=[counts["k1_paths"], counts["k2_paths"]],
          checkpoint_restored=restored, other_types=types)
    return counts["k1"], counts["k2"], types_k1, types_k2


def phase_gan_vs_cpu(dev):
    """Each adversarial step on the card against the same step on the CPU,
    from one critic and one epsilon, held in float64 (the float32 gaps are
    reported: there they come from leaky-ReLU kinks that float noise moves
    a pre-activation across, on the CPU as on the card)."""
    import torch
    from fmvfi_tpu_torch.train import adversarial as adv_mod

    t0 = time.perf_counter()

    class RecordingSGD(torch.optim.SGD):
        def step(self, closure=None):
            self.grads = [p.grad.clone() for g in self.param_groups for p in g["params"]]
            return super().step(closure)

    gen = torch.Generator().manual_seed(0)
    shape = (GAN_CPU_BATCH, 3, GAN_CPU_SIZE, GAN_CPU_SIZE)
    fake, real, f0, f2, eps = (torch.rand(shape, generator=gen) for _ in range(5))

    def run(gan, device, dtype):
        adv = adv_mod.Adversarial(gan, GAN_CPU_SIZE, device=device)
        st = adv.init_state()  # the same seeded critic on both sides
        st.critic.to(dtype)
        st = st._replace(optimizer=RecordingSGD(st.critic.parameters(), lr=GAN_CPU_LR))
        x = fake.to(device, dtype).requires_grad_(True)
        frames = (f0.to(device, dtype), f2.to(device, dtype))
        g_loss, st, aux = adv.step(st, x, real.to(device, dtype), frames)
        dfake, = torch.autograd.grad(g_loss, x)
        return (float(g_loss.detach()), float(aux["d_loss"]), [dfake.cpu()],
                [g.cpu() for g in st.optimizer.grads])

    def gap(card, cpu):
        def rel_max(xs, ys):
            return max(float((x - y).abs().max()) / max(float(y.abs().max()), 1e-300)
                       for x, y in zip(xs, ys))
        return dict(loss=max(abs(card[0] / cpu[0] - 1.0), abs(card[1] / cpu[1] - 1.0)),
                    dfake=rel_max(card[2], cpu[2]), critic_grad=rel_max(card[3], cpu[3]))

    draw, gp_weight = adv_mod.draw_eps, adv_mod.GP_WEIGHT
    adv_mod.draw_eps = lambda generator, like: eps.to(like.device, like.dtype)
    torch.backends.cudnn.deterministic = True
    try:
        gaps, gaps_f32, cpu_runs = {}, {}, {}
        for gan in GAN_TYPES:
            cpu_runs[gan] = run(gan, "cpu", torch.float64)
            gaps[gan] = gap(run(gan, dev, torch.float64), cpu_runs[gan])
            gaps_f32[gan] = gap(run(gan, dev, torch.float32), run(gan, "cpu", torch.float32))
        adv_mod.GP_WEIGHT = 0.0  # a planted fault: the gradient penalty dropped on the card
        planted = gap(run("WGAN_GP", dev, torch.float64), cpu_runs["WGAN_GP"])
    finally:
        adv_mod.draw_eps, adv_mod.GP_WEIGHT = draw, gp_weight
        torch.backends.cudnn.deterministic = False
    _line(phase="gan_vs_cpu", seconds=time.perf_counter() - t0, size=GAN_CPU_SIZE,
          batch=GAN_CPU_BATCH, dtype="float64", tol=GAN_CPU_TOL, gaps=gaps,
          planted_gp_weight_0=planted, float32_gaps_not_held=gaps_f32)
    worst = max(v for g in gaps.values() for v in g.values())
    if not worst <= GAN_CPU_TOL:
        raise AssertionError(f"gan_vs_cpu: the card's steps against the CPU's {gaps}")
    if not (planted["loss"] > GAN_CPU_TOL and planted["critic_grad"] > GAN_CPU_TOL):
        raise AssertionError(f"gan_vs_cpu: a dropped gradient penalty reads {planted}")


def phase_native():
    """The native augmentation library builds, batch_iterator takes its path
    over a MixedSynthStream, and its batches equal the numpy path's."""
    from fmvfi_tpu_torch import native
    from fmvfi_tpu_torch.train import data

    t0 = time.perf_counter()
    native.library()  # builds it, or raises with the compiler's error
    build_seconds = native.build_seconds
    n = 2 * FUSION_BATCH
    stream = data.MixedSynthStream(n=n, h=CROP + 16, w=CROP + 48, workers=4)
    data.paths.clear()
    t_run = time.perf_counter()
    fast = list(data.batch_iterator(stream, FUSION_BATCH, seed=0, crop=CROP, epochs=2))
    native_seconds = time.perf_counter() - t_run
    paths = dict(data.paths)
    t_run = time.perf_counter()
    plain = list(data.batch_iterator(stream, FUSION_BATCH, seed=0, crop=CROP, epochs=2,
                                     use_native=False))
    numpy_seconds = time.perf_counter() - t_run
    diff = max(float(np.abs(a - b).max()) for x, y in zip(fast, plain) for a, b in zip(x, y))
    _line(phase="native", seconds=time.perf_counter() - t0, build_seconds=build_seconds,
          batches=len(fast), paths=paths, native_seconds=native_seconds,
          numpy_seconds=numpy_seconds, max_abs_diff=diff, tol=NATIVE_TOL)
    if paths != {"native": len(fast)} or len(fast) != len(plain) or len(fast) != 4:  # 2 epochs
        raise AssertionError(f"native: batches by path {paths}, {len(fast)} native and "
                             f"{len(plain)} numpy batches")
    if not diff <= NATIVE_TOL:
        raise AssertionError(f"native: batches differ from the numpy path's by {diff:.3g}")


def _reference_phase_pt(path, seed=0):
    """A seeded PhaseNet saved in phase_net.pt's layout (layers.{i}
    .feature_map.{0,1,3}, layers.{i}.prediction_map.0): no published
    PhaseNet weights are in the repository."""
    import torch
    from fmvfi_tpu_torch.models.phase_net import PhaseNetCore

    names = {"conv1": "feature_map.0", "bn": "feature_map.1", "conv2": "feature_map.3",
             "pred": "prediction_map.0"}
    sd = PhaseNetCore().init_params(torch.Generator().manual_seed(seed)).state_dict()
    torch.save({f"layers.{k.split('.')[1]}.{names[k.split('.')[2]]}.{k.split('.')[3]}": v
                for k, v in sd.items() if not k.endswith("num_batches_tracked")}, path)
    return path


def phase_cli(dev, repo, ada_path, fusion_path, pair, clip):
    """The command line on PNG files of a 1080p `pair` of frames and a
    1080p `clip`, float in [0, 1]; returns its K1 and K2 launches."""
    with _work_dir(repo) as work_dir:
        return _cli(dev, repo, ada_path, fusion_path, pair, clip, work_dir)


def _cli(dev, repo, ada_path, fusion_path, pair, clip, work):
    import torch
    from fmvfi_tpu_torch import cli, native
    from fmvfi_tpu_torch.eval.synth import translation_triplet, translation_video
    from fmvfi_tpu_torch.models.adacof import AdaCoFNet
    from fmvfi_tpu_torch.models.fusion_net import FusionNet, infer_variant
    from fmvfi_tpu_torch.models.phase_net import PhaseNetCore
    from fmvfi_tpu_torch.ops import adacof_cuda
    from fmvfi_tpu_torch.pipeline.interpolate import FusionModels, fusion_interpolate
    from fmvfi_tpu_torch.pipeline.video import quantize
    from fmvfi_tpu_torch.train import data, loop
    from fmvfi_tpu_torch.utils import imageio
    from fmvfi_tpu_torch.utils.convert import (
        load_adacof_weights,
        load_fusion_weights,
        phase_net_from_torch,
    )

    t0 = time.perf_counter()
    native.library()

    # the codec on the card's host: 1080p frames written, read back
    # bit-equal, and the C++ unfilter against its numpy oracle
    os.makedirs(os.path.join(work, "clip"))
    frames = {os.path.join(work, "a.png"): quantize(pair[0]),
              os.path.join(work, "b.png"): quantize(pair[1])}
    frames.update({os.path.join(work, "clip", f"{i:03d}.png"): quantize(f)
                   for i, f in enumerate(clip)})
    write_ms, read_ms, filter_types, t_oracle = [], [], np.zeros(5, np.int64), 0.0
    for path, u8 in frames.items():
        t = time.perf_counter()
        imageio.imwrite(path, u8)
        write_ms.append(1e3 * (time.perf_counter() - t))
    for path, u8 in frames.items():
        t = time.perf_counter()
        back = imageio.imread(path)
        read_ms.append(1e3 * (time.perf_counter() - t))
        if not np.array_equal(back, u8):
            raise AssertionError(f"cli: {path} does not read back as written")
        raw = imageio.read_raw(path)
        t = time.perf_counter()
        oracle = imageio.unfilter_numpy(raw.rows, raw.height, raw.rows.shape[1] - 1, raw.bpp)
        t_oracle += time.perf_counter() - t
        if not np.array_equal(native.png_unfilter(raw.rows, raw.height, raw.rows.shape[1] - 1,
                                                  raw.bpp), oracle):
            raise AssertionError(f"cli: the C++ unfilter and its numpy oracle differ on {path}")
        filter_types += np.bincount(raw.rows[:, 0], minlength=5)
    png_bytes = os.path.getsize(os.path.join(work, "a.png"))

    phase_pt = _reference_phase_pt(os.path.join(work, "phase_net.pt"))
    images = []
    real_warp = adacof_cuda.adacof_warp

    def recording_warp(x, *args):
        images.append(x.shape[0])
        return real_warp(x, *args)

    # interpolate: a process of its own, cold, with the bundled AdaCoF, the
    # demo FusionNet (the default file is absent) and the seeded PhaseNet
    out_png = os.path.join(work, "mid.png")
    t_start, t = time.time(), time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "fmvfi_tpu_torch.cli", "interpolate", "--first_frame",
         os.path.join(work, "a.png"), "--second_frame", os.path.join(work, "b.png"),
         "--output_frame", out_png, "--method", "fusion", "--phase_checkpoint", phase_pt],
        cwd=repo, capture_output=True, text=True, timeout=600)
    process_s = time.perf_counter() - t
    if proc.returncode != 0:
        raise AssertionError(f"cli interpolate exited {proc.returncode}: {proc.stderr[-3000:]}")
    cold_start_s = os.path.getmtime(out_png) - t_start
    # the part of it that is not the command's: a process that imports torch
    # and the CLI module and makes the card's context, and nothing else
    t = time.perf_counter()
    subprocess.run([sys.executable, "-c", "import torch, fmvfi_tpu_torch.cli; "
                    "torch.zeros(1, device='cuda'); torch.cuda.synchronize()"],
                   cwd=repo, check=True, capture_output=True, timeout=600)
    bare_s = time.perf_counter() - t
    _line(phase="cli_interpolate_cold_start", seconds=cold_start_s, process_seconds=process_s,
          import_and_context_seconds=bare_s, size=list(pair[0].shape[:2]),
          stderr=proc.stderr.strip().splitlines())

    # the same request in this process, on the decoded frames
    ada = AdaCoFNet().to(dev).eval()
    ada.load_state_dict(load_adacof_weights(ada_path))
    fusion_sd = load_fusion_weights(fusion_path)
    fusion = FusionNet(variant=infer_variant(fusion_sd)).to(dev).eval()
    fusion.load_state_dict(fusion_sd)
    phase = PhaseNetCore().to(dev).eval()
    phase.load_state_dict(phase_net_from_torch(phase_pt))
    f1, f2 = (imageio.imread(os.path.join(work, n)).astype(np.float32) / 255.0
              for n in ("a.png", "b.png"))
    ada.warp = recording_warp
    try:
        _reset_counts()
        images.clear()
        want = quantize(fusion_interpolate(FusionModels(phase, ada, fusion), f1[None], f2[None],
                                           device=dev)[0].cpu().numpy())
        interp_counts, interp_images = _counts(), list(images)
    finally:
        ada.warp = real_warp
    del ada, fusion, phase
    got = imageio.imread(out_png)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    interp = dict(max_lsb=int(diff.max()), share_differing=float((diff > 0).mean()),
                  k1_launches=interp_counts["k1"], k1_images=interp_images,
                  k1_paths=interp_counts["k1_paths"], k2_launches=interp_counts["k2"])
    if interp["max_lsb"] > CLI_LSB:
        raise AssertionError(f"cli interpolate against the in-process pipeline: {interp}")
    if interp_images != [2, 4, 2] or interp_counts["k1_paths"] != {RING_PATH: 3}:
        raise AssertionError(f"cli: the in-process request's K1 launches {interp}")

    # video, evaluate and train through cli.main in this process, K1 and K2
    # counted around each command; the models the commands build take the
    # recording warp from adacof_cuda
    runs, k1, k2 = {}, 0, 0

    def run(name, argv, want_images, want_k2=0):
        nonlocal k1, k2
        adacof_cuda.adacof_warp = recording_warp
        try:
            _reset_counts()  # this command's run
            images.clear()
            torch.cuda.synchronize()
            t = time.perf_counter()
            cli.main(argv)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t)
            c = _counts()  # read just after
        finally:
            adacof_cuda.adacof_warp = real_warp
        k1 += c["k1"]
        k2 += c["k2"]
        runs[name] = dict(ms=ms, k1_launches=c["k1"], k1_images=list(images),
                          k1_paths=c["k1_paths"], k2_launches=c["k2"])
        if images != want_images or c["k1"] != len(want_images) or c["k2"] != want_k2:
            raise AssertionError(f"cli {name}: K1 images {images} ({c['k1']} launches), K2 "
                                 f"{c['k2']}; expected {want_images} and {want_k2}")
        if [c["k1_paths"], c["k2_paths"]] != [{RING_PATH: n} if n else {} for n in (c["k1"], c["k2"])]:
            raise AssertionError(f"cli {name}: launches by instantiation {c}")
        return runs[name]

    clip_dir = os.path.join(work, "clip")
    n_frames = len(clip)
    n_pairs = n_frames - 1
    for name, extra, want_images in (("video_per_pair", [], [2, 4, 2] * n_pairs),
                                     ("video_batch2", ["--batch", "2"], [4, 8, 4] * (n_pairs // 2))):
        out_dir = os.path.join(work, name)
        r = run(name, ["video", "--input", clip_dir, "--output_dir", out_dir, "--phase_checkpoint",
                       phase_pt, *extra], want_images)
        names = sorted(os.listdir(out_dir))
        r["ms_per_interpolated_frame"] = r["ms"] / n_pairs
        r["ms_per_output_frame"] = r["ms"] / len(names)
        if names != [f"{i:05d}.png" for i in range(2 * n_frames - 1)]:
            raise AssertionError(f"cli {name}: wrote {names}")
        src = sorted(os.listdir(clip_dir))
        for i, n in enumerate(src):
            if not np.array_equal(imageio.imread(os.path.join(out_dir, names[2 * i])),
                                  imageio.imread(os.path.join(clip_dir, n))):
                raise AssertionError(f"cli {name}: original {n} is not at position {2 * i}")
    batch_lsb = max(int(np.abs(
        imageio.imread(os.path.join(work, "video_per_pair", n)).astype(np.int16)
        - imageio.imread(os.path.join(work, "video_batch2", n)).astype(np.int16)).max())
        for n in sorted(os.listdir(os.path.join(work, "video_batch2"))))
    if batch_lsb > CLI_LSB:
        raise AssertionError(f"cli video: --batch 2 against per pair differs by {batch_lsb} LSB")

    # evaluate: a 2-scene middlebury layout of 256x256 PNGs, two methods
    mb = os.path.join(work, "mb")
    for k, scene in enumerate(("Grove", "Urban")):
        a, mid, b = translation_triplet(CROP, CROP, dx=2.0 + k, dy=1.0, seed=30 + k)
        for sub, name, f in (("in", "frame10.png", a), ("in", "frame11.png", b),
                             ("gt", "frame10i11.png", mid)):
            os.makedirs(os.path.join(mb, sub, scene), exist_ok=True)
            imageio.imwrite(os.path.join(mb, sub, scene, name), quantize(f))
    eval_dir = os.path.join(work, "eval")
    run("evaluate", ["evaluate", "--test_sets", f"middlebury:{mb}/in:{mb}/gt", "--methods",
                     "fusion,adacof", "--out_dir", eval_dir, "--phase_checkpoint", phase_pt],
        [2, 4, 2] * 2 + [2] * 2)
    psnr = {}
    for method in ("fusion", "adacof"):
        with open(os.path.join(eval_dir, f"result_middlebury_{method}.json")) as f:
            res = json.load(f)
        psnr[method] = {k: v["psnr"] for k, v in res.items()}
        if sorted(res) != ["Grove", "Urban", "average"] or not np.isfinite(
                list(psnr[method].values())).all():
            raise AssertionError(f"cli evaluate {method}: {res}")
    runs["evaluate"]["psnr"] = psnr

    # evaluate on a plain frame directory (streamed: no panels): the
    # summary and the results.png bar chart of psnr and ssim
    small = os.path.join(work, "small_clip")
    os.makedirs(small)
    for i, f in enumerate(translation_video(4, 64, 64)):
        imageio.imwrite(os.path.join(small, f"{i:03d}.png"), quantize(f))
    chart_dir = os.path.join(work, "eval_chart")
    r = run("evaluate_chart", ["evaluate", "--test_sets", small, "--methods", "adacof", "--dim",
                               "64", "--out_dir", chart_dir, "--phase_checkpoint", phase_pt], [4])
    chart = os.path.join(chart_dir, "results.png")
    r["results_png"] = list(imageio.imread(chart).shape) if os.path.exists(chart) else None
    if r["results_png"] != [440, 660 * 2, 3]:
        raise AssertionError(f"cli evaluate: results.png {r['results_png']}, expected 440x1320")

    # train: Vimeo90k layout of 288x448 PNGs; fit recorded step by step
    vimeo = os.path.join(work, "vimeo")
    for k in range(4):
        d = os.path.join(vimeo, "sequences", "00001", f"{k + 1:04d}")
        os.makedirs(d)
        for i, f in enumerate(translation_triplet(288, 448, dx=2.0 + k, dy=1.0, seed=40 + k)):
            imageio.imwrite(os.path.join(d, f"im{i + 1}.png"), quantize(f))
    real_fit = loop.fit
    per_step = []

    def recording_fit(state, step_fn, batches, out_dir, **kw):
        def step(st, batch):
            before = (adacof_cuda.launches, adacof_cuda.bwd_launches)
            st, m = step_fn(st, batch)
            per_step.append([adacof_cuda.launches - before[0], adacof_cuda.bwd_launches - before[1],
                             float(m["loss"])])
            return st, m
        return real_fit(state, step, batches, out_dir, **kw)

    loop.fit = recording_fit
    try:
        for regime, steps, want in (("adacof", 3, [2 * FUSION_BATCH]),
                                    ("phase", 2, []),
                                    ("fusion", 2, [2 * FUSION_BATCH, 4 * FUSION_BATCH,
                                                   2 * FUSION_BATCH])):
            per_step.clear()
            data.paths.clear()
            out_dir = os.path.join(work, f"train_{regime}")
            r = run(f"train_{regime}", [
                "train", "--regime", regime, "--data_dir", vimeo, "--out_dir", out_dir,
                "--epochs", "1", "--steps_per_epoch", str(steps), "--batch_size",
                str(FUSION_BATCH), "--crop", str(CROP), "--phase_checkpoint", phase_pt],
                want * steps, want_k2=steps if regime == "adacof" else 0)
            r.update(steps=per_step[:], batches_by_path=dict(data.paths))
            launches = [s[:2] for s in per_step]
            if launches != [[len(want), int(regime == "adacof")]] * steps:
                raise AssertionError(f"cli train {regime}: K1/K2 launches per step {launches}")
            if not np.isfinite([s[2] for s in per_step]).all():
                raise AssertionError(f"cli train {regime}: losses {per_step}")
            if data.paths.get("native", 0) < steps or data.paths.get("numpy", 0):
                raise AssertionError(f"cli train {regime}: batches by path {dict(data.paths)}")
            if not (os.listdir(os.path.join(out_dir, "checkpoint"))
                    and os.path.exists(os.path.join(out_dir, "config.json"))):
                raise AssertionError(f"cli train {regime}: no checkpoint or config.json")
    finally:
        loop.fit = real_fit
    _line(phase="cli", seconds=time.perf_counter() - t0, size=list(clip.shape[1:3]), png_write_ms=float(np.median(write_ms[2:])),
          png_read_ms=float(np.median(read_ms[2:])), png_write_ms_all=write_ms,
          png_read_ms_all=read_ms, png_bytes=png_bytes, png_filter_types=filter_types.tolist(),
          unfilter_oracle_seconds=t_oracle, interpolate=interp, video_batch2_vs_per_pair_lsb=batch_lsb,
          commands=runs, k1_launches=k1 + interp_counts["k1"], k2_launches=k2)
    return k1 + interp_counts["k1"], k2


# run in a process of its own: load a `cuda` artifact onto the card, answer
# one pair (1 warm-up, then 3 timed requests), count K1 through the
# registered operator (images per launch recorded around its CUDA kernel)
_EXPORT_CHILD = """
import json, sys, time
import numpy as np
import torch
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
t0 = time.perf_counter()
from fmvfi_tpu_torch.ops import adacof_cuda
from fmvfi_tpu_torch.utils.export import load_exported
fn = load_exported(sys.argv[1], device="cuda")
torch.cuda.synchronize()
load_s = time.perf_counter() - t0
state = fn.program.state_dict
state_mb = sum(v.numel() * v.element_size() for v in state.values()) / 1e6
filter_mb = sum(v.numel() * v.element_size() for k, v in state.items()
                if k.startswith("filter_")) / 1e6
nodes = sum(len(m.graph.nodes) for m in fn.program.graph_module.modules()
            if isinstance(m, torch.fx.GraphModule))
d = np.load(sys.argv[2])
f1, f2 = torch.from_numpy(d["f1"]).cuda(), torch.from_numpy(d["f2"]).cuda()
real, images = adacof_cuda.warp_fwd_cuda, []
def recording(x, *args):
    images[-1].append(x.shape[0])
    return real(x, *args)
adacof_cuda.warp_fwd_cuda = recording  # the operator's CUDA kernel calls it
ms = []
adacof_cuda.launches = adacof_cuda.bwd_launches = 0
adacof_cuda.paths.clear()
for i in range(4):
    images.append([])
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn(f1, f2)
    torch.cuda.synchronize()
    ms.append(1e3 * (time.perf_counter() - t))
np.save(sys.argv[3], out.cpu().numpy())
print(json.dumps(dict(load_seconds=load_s, warmup_ms=ms[0], ms_requests=ms[1:],
                      ms_per_frame=float(np.median(ms[1:])), meta=fn.meta, state_mb=state_mb,
                      filter_mb=filter_mb, graph_nodes=nodes, k1=adacof_cuda.launches,
                      k2=adacof_cuda.bwd_launches, k1_paths=dict(adacof_cuda.paths),
                      k1_images=images)))
"""

# run in a process of its own, outside the repository with fmvfi_tpu_torch
# unimportable: a ("cpu",) artifact with torch.export.load alone
_BARE_CHILD = """
import json, sys
sys.modules["fmvfi_tpu_torch"] = None
import numpy as np
import torch
extra = {"meta.json": ""}
program = torch.export.load(sys.argv[1], extra_files=extra)
d = np.load(sys.argv[2])
with torch.no_grad():
    out = program.module()(torch.from_numpy(d["f1"]), torch.from_numpy(d["f2"]))
np.save(sys.argv[3], out.numpy())
print(json.dumps(dict(meta=json.loads(extra["meta.json"]), cuda_initialized=torch.cuda.is_initialized(),
                      package=[n for n in sys.modules if n.startswith("fmvfi")
                               and sys.modules[n] is not None])))
"""


def phase_export(dev, repo, ada_path, fusion_path, pair, serve_ms):
    """`cli export` of fusion at 1080p for cuda, that artifact answering the
    pair in a fresh process, a ("cpu",) artifact without the package, a
    port-trained AdaCoF written out as .msgpack and read back, and the
    profiling utilities on one request; returns the K1 and K2 launches of
    its runs."""
    with _work_dir(repo) as work_dir:
        return _export(dev, repo, ada_path, fusion_path, pair, serve_ms, work_dir)


def _cpu_artifact(work, ada_path):
    """A ("cpu",) adacof artifact at 64x64 (adacof: its export traces the
    plain warp's 25 taps once), run by torch alone in a process outside the
    repository where fmvfi_tpu_torch cannot be imported, against the live
    CPU pipeline."""
    from fmvfi_tpu_torch.models.adacof import AdaCoFNet
    from fmvfi_tpu_torch.pipeline.interpolate import FusionModels, adacof_interpolate
    from fmvfi_tpu_torch.utils.convert import load_adacof_weights
    from fmvfi_tpu_torch.utils.export import export_pipeline, save_exported

    ada_cpu = AdaCoFNet().eval()
    ada_cpu.load_state_dict(load_adacof_weights(ada_path))
    small = [np.random.default_rng(s).random((1, 64, 64, 3), dtype=np.float32) for s in (1, 2)]
    t = time.perf_counter()
    blob = export_pipeline(FusionModels(None, ada_cpu, None), 64, 64, "adacof",
                           platforms=("cpu",))
    export_s = time.perf_counter() - t
    path = os.path.join(work, "adacof_cpu.pt2")
    save_exported(path, blob)
    np.savez(os.path.join(work, "small.npz"), f1=small[0], f2=small[1])
    bare = os.path.join(work, "bare")
    os.makedirs(bare)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _BARE_CHILD, path,
                           os.path.join(work, "small.npz"), os.path.join(work, "small.npy")],
                          cwd=bare, env=env, capture_output=True, text=True, timeout=600)
    process_s = time.perf_counter() - t
    if proc.returncode != 0:
        raise AssertionError(f"the cpu artifact without the package: {proc.stderr[-3000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    got = np.load(os.path.join(work, "small.npy"))
    diff = float(np.abs(got - adacof_interpolate(ada_cpu, *small, device="cpu").numpy()).max())
    cpu = dict(export_seconds=export_s, process_seconds=process_s, mb=len(blob) / 1e6,
               max_abs_diff=diff, finite=bool(np.isfinite(got).all()), **res)
    if not (cpu["finite"] and diff <= EXPORT_CPU_TOL and not res["package"]):
        raise AssertionError(f"export: the cpu artifact without the package: {cpu}")
    return cpu


def _export(dev, repo, ada_path, fusion_path, pair, serve_ms, work):
    import torch
    from fmvfi_tpu_torch.eval.synth import translation_triplet
    from fmvfi_tpu_torch.models.adacof import AdaCoFNet
    from fmvfi_tpu_torch.models.fusion_net import FusionNet, infer_variant
    from fmvfi_tpu_torch.models.phase_net import PhaseNetCore
    from fmvfi_tpu_torch.ops import adacof_cuda
    from fmvfi_tpu_torch.pipeline.interpolate import (
        FusionModels,
        adacof_interpolate,
        fusion_interpolate,
    )
    from fmvfi_tpu_torch.train.data import SyntheticTriplets, batch_iterator
    from fmvfi_tpu_torch.train.trainer import make_adacof_trainer
    from fmvfi_tpu_torch.utils import profiling
    from fmvfi_tpu_torch.utils.checkpoint import save_msgpack
    from fmvfi_tpu_torch.utils.convert import (
        adacof_to_flax,
        load_adacof_weights,
        load_fusion_weights,
        phase_net_from_torch,
    )

    t0 = time.perf_counter()
    k1 = k2 = 0
    parts = {}  # seconds of each part of the phase
    phase_pt = _reference_phase_pt(os.path.join(work, "phase_net.pt"))
    artifact = os.path.join(work, "fusion_1080p.pt2")
    # cli export, a process of its own: the bundled AdaCoF, the demo
    # FusionNet and the seeded PhaseNet, as cli interpolate takes them.  It
    # traces on one host core while this process makes and runs the ("cpu",)
    # artifact on another
    t_export = time.perf_counter()
    exporter = subprocess.Popen(
        [sys.executable, "-m", "fmvfi_tpu_torch.cli", "export", "--method", "fusion", "--size",
         f"{H_FULL}x{W_FULL}", "--platforms", "cuda", "--out", artifact, "--phase_checkpoint",
         phase_pt], cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        cpu = _cpu_artifact(work, ada_path)
        parts["cpu_artifact"] = time.perf_counter() - t_export
        out, err = exporter.communicate(timeout=600)
    finally:
        if exporter.poll() is None:
            exporter.kill()
            exporter.wait()
    export_process_s = time.perf_counter() - t_export
    if exporter.returncode != 0:
        raise AssertionError(f"cli export exited {exporter.returncode}: {err[-3000:]}")
    export_said = out.strip().splitlines()[-1]
    artifact_bytes = os.path.getsize(artifact)

    # the live request in this process, on the same weights
    t = time.perf_counter()
    ada = AdaCoFNet().to(dev).eval()
    ada.load_state_dict(load_adacof_weights(ada_path))
    fusion_sd = load_fusion_weights(fusion_path)
    fusion = FusionNet(variant=infer_variant(fusion_sd)).to(dev).eval()
    fusion.load_state_dict(fusion_sd)
    phase = PhaseNetCore().to(dev).eval()
    phase.load_state_dict(phase_net_from_torch(phase_pt))
    models = FusionModels(phase, ada, fusion)
    f1, f2 = (torch.from_numpy(np.ascontiguousarray(f[None])).to(dev) for f in pair)
    live_ms = []
    _reset_counts()
    for _ in range(4):
        torch.cuda.synchronize()
        t = time.perf_counter()
        live = fusion_interpolate(models, f1, f2, device=dev)
        torch.cuda.synchronize()
        live_ms.append(1e3 * (time.perf_counter() - t))
    live_counts = _counts()
    k1 += live_counts["k1"]
    if live_counts["k1_paths"] != {RING_PATH: 12} or live_counts["k2"]:
        raise AssertionError(f"export: the live requests' launches {live_counts}")
    live = live[0].cpu().numpy()
    parts["live"] = time.perf_counter() - t

    # the artifact in a fresh process
    frames_npz = os.path.join(work, "pair.npz")
    np.savez(frames_npz, f1=pair[0][None].astype(np.float32), f2=pair[1][None].astype(np.float32))
    torch.cuda.empty_cache()
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _EXPORT_CHILD, artifact, frames_npz,
                           os.path.join(work, "out.npy")],
                          cwd=repo, capture_output=True, text=True, timeout=600)
    child_process_s = parts["child"] = time.perf_counter() - t
    if proc.returncode != 0:
        raise AssertionError(f"loading the artifact exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    got = np.load(os.path.join(work, "out.npy"))[0]
    k1 += child["k1"]  # the child's four requests, counted together
    artifact_db = _psnr(got, live)
    served = dict(
        artifact_ms_per_frame=child["ms_per_frame"], artifact_ms_requests=child["ms_requests"],
        artifact_warmup_ms=child["warmup_ms"], live_ms_per_frame=float(np.median(live_ms[1:])),
        live_ms_requests=live_ms[1:], live_warmup_ms=live_ms[0],
        artifact_vs_live_db=artifact_db, max_abs_diff=float(np.abs(got - live).max()),
        k1_images=child["k1_images"], k1_paths=child["k1_paths"], k2_launches=child["k2"],
        load_seconds=child["load_seconds"],
        child_process_seconds=child_process_s, meta=child["meta"])
    if not artifact_db >= PLAIN_AGREEMENT_DB or got.shape != (H_FULL, W_FULL, 3):
        raise AssertionError(f"export: the artifact against the live request: {served}")
    if (child["k1_images"], child["k1"], child["k1_paths"], child["k2"]) != (
            [[2, 4, 2]] * 4, 12, {RING_PATH: 12}, 0):
        raise AssertionError(f"export: the artifact's K1 launches {served}")

    # weights out: 2 AdaCoF training steps on the card, written as .msgpack,
    # read back, bit-equal on one pair
    t = time.perf_counter()
    state, step = make_adacof_trainer(device=dev, h=CROP, w=CROP)
    batches = batch_iterator(SyntheticTriplets(n=8, h=CROP + 16, w=CROP + 16), 2, crop=CROP)
    try:
        _reset_counts()
        for _ in range(2):
            state, metrics = step(state, next(batches))
        torch.cuda.synchronize()
        train_counts = _counts()
    finally:
        batches.close()
    k1, k2 = k1 + train_counts["k1"], k2 + train_counts["k2"]
    trained = state.model.eval()
    ckpt = os.path.join(work, "adacof_trained.msgpack")
    save_msgpack(ckpt, adacof_to_flax(trained.state_dict()))
    back = AdaCoFNet().to(dev).eval()
    back.load_state_dict(load_adacof_weights(ckpt))
    g1, _, g2 = translation_triplet(CROP, CROP, dx=3.0, dy=1.0, seed=5)
    _reset_counts()
    want = adacof_interpolate(trained, g1[None], g2[None], device=dev)
    got_w = adacof_interpolate(back, g1[None], g2[None], device=dev)
    k1 += _counts()["k1"]
    weights_out = dict(steps=2, k1=train_counts["k1"], k2=train_counts["k2"],
                       loss=float(metrics["loss"]), msgpack_mb=os.path.getsize(ckpt) / 1e6,
                       params_equal=all(torch.equal(a, b) for a, b in zip(
                           trained.state_dict().values(), back.state_dict().values())),
                       output_equal=bool(torch.equal(want, got_w)))
    del state, trained, back
    if not (weights_out["params_equal"] and weights_out["output_equal"]
            and train_counts["k1"] == 2 and train_counts["k2"] == 2):
        raise AssertionError(f"export: weights out {weights_out}")
    parts["weights_out"] = time.perf_counter() - t

    # what the registered operator adds per launch: K1 called directly,
    # through the operator, and through K3 (autograd.Function + operator),
    # back to back; at 8x8 the launch is all host work
    t = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(3)
    dispatch = {}
    for name, (b, h, w) in (("tiny_8x8", (1, 8, 8)), ("images_4_1080p", (4, 1088, 1920))):
        x, wgt, a, be = _k1_case(gen, b, 3, h, w, 5, 1, 3.0)
        inner = 100 if h == 8 else 10
        dispatch[name] = dict(
            direct_ms=_cuda_ms(lambda: adacof_cuda.warp_fwd_cuda(x, wgt, a, be, 1, 48), 5, inner),
            op_ms=_cuda_ms(lambda: adacof_cuda.warp_fwd_op(x, wgt, a, be, 1, 48), 5, inner),
            k3_ms=_cuda_ms(lambda: adacof_cuda.adacof_warp(x, wgt, a, be, 1, 48), 5, inner))
        del x, wgt, a, be
    torch.cuda.empty_cache()
    parts["op_dispatch"] = time.perf_counter() - t

    # profiling: timed over one request chained through its output, and
    # the trace of one request (its kernels' device ms beside its wall ms)
    t = time.perf_counter()
    _reset_counts()
    timed_ms = 1e3 * profiling.timed(lambda f: fusion_interpolate(models, f, f2, device=dev),
                                     f1, iters=3, warmup=1)
    parts["timed"] = time.perf_counter() - t
    t = time.perf_counter()
    with profiling.trace(os.path.join(work, "trace")):
        t_req = time.perf_counter()
        fusion_interpolate(models, f1, f2, device=dev)
        torch.cuda.synchronize()
        traced_ms = 1e3 * (time.perf_counter() - t_req)
    parts["trace"] = time.perf_counter() - t
    k1 += _counts()["k1"]
    trace_files = os.listdir(os.path.join(work, "trace"))
    if len(trace_files) != 1 or not timed_ms > 0:
        raise AssertionError(f"export: profiling wrote {trace_files}, timed {timed_ms} ms")
    # the traced request's device time, from the trace file (the
    # profiler's key_averages() takes tens of seconds on ~2e5 events)
    trace_path = os.path.join(work, "trace", trace_files[0])
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    prof_line = dict(timed_ms_per_request=timed_ms, serve_ms_per_frame=serve_ms,
                     trace_mb=os.path.getsize(trace_path) / 1e6, traced_request_ms=traced_ms,
                     traced_device_ms=sum(e.get("dur", 0) for e in events if e.get("cat") in
                                          ("kernel", "gpu_memcpy", "gpu_memset")) / 1e3,
                     traced_kernels=sum(e.get("cat") == "kernel" for e in events))
    del events

    _line(phase="export", seconds=time.perf_counter() - t0, size=[H_FULL, W_FULL],
          export_process_seconds=export_process_s, export_stdout=export_said,
          artifact_mb=artifact_bytes / 1e6, state_mb=child["state_mb"],
          filter_bank_mb=child["filter_mb"], graph_nodes=child["graph_nodes"], served=served,
          cpu_artifact=cpu, weights_out=weights_out, op_dispatch=dispatch, profiling=prof_line,
          part_seconds=parts)
    return k1, k2


def phase_serve_bf16(dev, models, requests, fp32_outs, fp32_ms, fp32_peak):
    """The serve phase's pairs and models with compute_dtype=torch.bfloat16
    (1 warm-up, 3 timed), the bf16 quality guard of tests/test_golden.py
    and one bf16 stream on 3 frames of 1080p; returns the path's K1
    launches."""
    import torch

    from fmvfi_tpu_torch.eval.synth import translation_triplet, translation_video
    from fmvfi_tpu_torch.ops import adacof_cuda
    from fmvfi_tpu_torch.pipeline.interpolate import (
        fusion_interpolate,
        fusion_stream_init,
        fusion_stream_scan,
    )

    bf16 = torch.bfloat16
    t0 = time.perf_counter()
    ada = models.adacof
    images, dtypes = [], set()

    def recording_warp(x, w, a, b, *args):
        images.append(x.shape[0])
        dtypes.update((x.dtype, w.dtype, a.dtype, b.dtype))
        return adacof_cuda.adacof_warp(x, w, a, b, *args)

    clip = translation_video(3, H_FULL, W_FULL, step=2.0, seed=0)
    f1, mid, f2 = translation_triplet(128, 128, dx=2.0, dy=1.0, seed=0)
    torch.cuda.synchronize()
    adacof_cuda.launches = adacof_cuda.bwd_launches = 0  # the bf16 serving path's run
    adacof_cuda.paths.clear()
    torch.cuda.reset_peak_memory_stats()
    ms, vs_fp32, per_request = [], [], []
    ada.warp = recording_warp
    try:
        for i, (r1, _, r2) in enumerate(requests):
            images.clear()
            torch.cuda.synchronize()
            t_req = time.perf_counter()
            out = fusion_interpolate(models, r1[None], r2[None], device=dev, compute_dtype=bf16)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t_req))
            per_request.append(list(images))
            if out.dtype != torch.float32:
                raise AssertionError(f"bf16 request {i}: output {out.dtype}, expected float32")
            o = out[0].cpu().numpy()
            if o.shape != (H_FULL, W_FULL, 3) or not np.isfinite(o).all() or o.min() < 0 or o.max() > 1:
                raise AssertionError(f"bf16 request {i}: output {o.shape} not finite/in [0, 1]")
            vs_fp32.append(_psnr(o, fp32_outs[i]))
        peak = torch.cuda.max_memory_allocated()
        guard = [fusion_interpolate(models, f1[None], f2[None], device=dev, compute_dtype=dt)[0]
                 .cpu().numpy() for dt in (None, bf16)]
        streams = []
        for dt in (None, bf16):
            carry = fusion_stream_init(clip[0][None], device=dev)
            _, fused = fusion_stream_scan(models, carry, np.stack([clip[1], clip[2], clip[2]])[:, None],
                                          device=dev, compute_dtype=dt)
            streams.append(fused[1:, 0].cpu().numpy())  # pairs (0, 1) and (1, 2)
        torch.cuda.synchronize()
    finally:
        ada.warp = adacof_cuda.adacof_warp
    launches, paths, k2 = adacof_cuda.launches, dict(adacof_cuda.paths), adacof_cuda.bwd_launches
    guard_db, guard_loss = _psnr(guard[1], guard[0]), _psnr(guard[0], mid) - _psnr(guard[1], mid)
    stream_db = [_psnr(a, b) for a, b in zip(streams[1], streams[0])]
    _line(phase="serve_bf16", seconds=time.perf_counter() - t0, size=[H_FULL, W_FULL], batch=1,
          warmup_ms=ms[0], ms_per_frame=float(np.mean(ms[1:])), ms_requests=ms[1:],
          fp32_ms_per_frame=float(np.mean(fp32_ms[1:])), peak_memory_bytes=peak,
          fp32_peak_memory_bytes=fp32_peak, psnr_vs_fp32_db=vs_fp32,
          k1_images_per_request=per_request, k1_launches=launches, k1_paths=paths,
          k2_launches=k2, warp_dtypes=sorted(str(d) for d in dtypes),
          guard_vs_fp32_db=guard_db, guard_loss_to_truth_db=guard_loss,
          guard_fp32_vs_truth_db=_psnr(guard[0], mid), stream_vs_fp32_db=stream_db)
    if any(r != [2, 4, 2] for r in per_request):
        raise AssertionError(f"bf16 serving: K1 images per request {per_request}, expected [2, 4, 2]")
    if dtypes != {torch.float32}:
        raise AssertionError(f"bf16 serving: the warp took {dtypes}, expected float32 only")
    if paths != {RING_PATH: launches} or k2 != 0 or launches == 0:
        raise AssertionError(f"bf16 serving: K1 {launches} by instantiation {paths}, K2 {k2}")
    if not min(vs_fp32) >= BF16_DB:
        raise AssertionError(f"bf16 requests against fp32: {vs_fp32} dB < {BF16_DB}")
    if not (guard_db >= BF16_DB and guard_loss < BF16_LOSS_DB):
        raise AssertionError(f"bf16 guard: {guard_db:.2f} dB against fp32, {guard_loss:.3f} dB "
                             f"lost to the truth (>= {BF16_DB}, < {BF16_LOSS_DB})")
    if not min(stream_db) >= BF16_DB:
        raise AssertionError(f"bf16 stream against fp32: {stream_db} dB < {BF16_DB}")
    return launches


def _dp_batches():
    """DP_STEPS seeded global batches of DP_BATCH triplets at CROP x CROP."""
    from fmvfi_tpu_torch.eval.synth import translation_triplet

    items = [translation_triplet(CROP, CROP, dx=2.0 + i % 4, dy=1.0 + i % 3, seed=i)
             for i in range(DP_BATCH * DP_STEPS)]
    return [tuple(np.stack([it[j] for it in items[s * DP_BATCH:(s + 1) * DP_BATCH]])
                  for j in range(3)) for s in range(DP_STEPS)]


def _dp_trainer(regime, dev):
    """(state, step) of a regime from fixed seeds with momentum SGD: its
    step is linear in the gradient, where Adam's first steps, lr * sign(g),
    turn float noise at a near-zero gradient entry (a conv bias before a
    train-mode BN has a zero one) into a 2 lr difference."""
    import torch

    from fmvfi_tpu_torch.train.trainer import make_adacof_trainer, make_phase_trainer

    if regime == "adacof":
        state, step = make_adacof_trainer(device=dev, seed=1)
    else:
        state, step, _, _ = make_phase_trainer(CROP, CROP, device=dev, seed=1)
    opt = torch.optim.SGD(state.model.parameters(), lr=DP_LR, momentum=0.9)
    opt.param_groups[0]["updates"] = 0  # the AdaCoF trainer's count of applied updates
    return state._replace(optimizer=opt), step


# one rank of phase dp (b): a gloo group of two processes on the one card,
# each stepping its half of the global batch through data_parallel
_DP_RANK_CHILD = """
import json, sys, time
import numpy as np
import torch
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
coord, rank, world, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
import chip_smoke as S
from fmvfi_tpu_torch.ops import adacof_cuda
from fmvfi_tpu_torch.parallel import distributed
from fmvfi_tpu_torch.parallel.dp import data_parallel
from fmvfi_tpu_torch.parallel.mesh import make_mesh, replicate
distributed.initialize(coord, num_processes=world, process_id=rank, backend="gloo")
mesh = make_mesh()
lo, hi = distributed.local_batch_slice(S.DP_BATCH)
dev = torch.device("cuda", torch.cuda.current_device())
res, arrays = {}, {}
for regime in ("adacof", "phase"):
    state, step = S._dp_trainer(regime, dev)
    state = replicate(mesh, state)
    pstep = data_parallel(step, mesh)
    rec = dict(loss=[], ms=[])
    adacof_cuda.launches = adacof_cuda.bwd_launches = 0  # this regime's data-parallel run
    for batch in S._dp_batches():
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = pstep(state, tuple(b[lo:hi] for b in batch))
        torch.cuda.synchronize()
        rec["ms"].append(1e3 * (time.perf_counter() - t))
        rec["loss"].append(float(m["loss"]))
    rec.update(k1=adacof_cuda.launches, k2=adacof_cuda.bwd_launches)
    res[regime] = rec
    arrays.update({regime + "/" + k: v.cpu().numpy() for k, v in state.model.state_dict().items()})
np.savez(out, **arrays)
print(json.dumps(dict(rank=rank, rows=[lo, hi], regimes=res)))
"""

# phase dp (a): the command line's train as a process of its own, counting
# K1 and K2 around it (deterministic cuDNN in both runs of the comparison)
_DP_CLI_CHILD = """
import json, sys
import torch
torch.backends.cudnn.deterministic = True
from fmvfi_tpu_torch import cli
from fmvfi_tpu_torch.ops import adacof_cuda
adacof_cuda.launches = adacof_cuda.bwd_launches = 0
adacof_cuda.paths.clear()
cli.main(sys.argv[1:])
print(json.dumps(dict(k1=adacof_cuda.launches, k2=adacof_cuda.bwd_launches,
                      k1_paths=dict(adacof_cuda.paths))))
"""


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_dp(dev, repo):
    """(a) `cli train --data_parallel` as a 1-process NCCL group against the
    same command without it; (b) two gloo ranks on the one card against
    the 1-process step on the global batch, adacof and phase.  Returns the
    data-parallel runs' K1 and K2 launches."""
    with _work_dir(repo) as work_dir:
        return _dp(dev, repo, work_dir)


def _dp(dev, repo, work):
    import torch

    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=repo)

    def spawn(code, *args):
        return subprocess.Popen([sys.executable, "-c", code, *args], cwd=repo, env=env,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def result(proc, what):
        out, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"dp {what}: exit {proc.returncode}\n{err[-3000:]}")
        return json.loads(out.strip().splitlines()[-1])

    # (a): the command with --data_parallel and twice without, three processes
    # at once (the second plain run reads the card's run-to-run spread)
    argv = ["train", "--regime", "adacof", "--steps_per_epoch", str(DP_CLI_STEPS),
            "--batch_size", str(DP_BATCH), "--crop", str(CROP)]
    outs = {k: os.path.join(work, k) for k in ("cli_dp", "cli_plain", "cli_plain_again")}
    cli_procs = {k: spawn(_DP_CLI_CHILD, *argv, "--out_dir", outs[k],
                          *(["--data_parallel"] if k == "cli_dp" else [])) for k in outs}
    cli = {k: result(p, k) for k, p in cli_procs.items()}
    cli_seconds = time.perf_counter() - t0
    # (b): the two ranks, alone on the card while their steps are timed
    t_ranks = time.perf_counter()
    coord = f"localhost:{_free_port()}"
    rank_procs = [spawn(_DP_RANK_CHILD, coord, str(r), "2", os.path.join(work, f"rank{r}.npz"))
                  for r in (0, 1)]
    ranks = [result(p, f"rank {r}") for r, p in enumerate(rank_procs)]
    ranks_seconds = time.perf_counter() - t_ranks

    # (b)'s reference: the 1-process steps on the global batch, here, and the
    # same steps with the batch's rows rolled by 1, 2 and 3 (the same math in
    # other orders: their largest gap is the float32 floor of the comparison)
    ref, ref_arrays, floor_arrays, floor_loss = {}, {}, {}, {}
    for regime in ("adacof", "phase"):
        for roll in range(DP_BATCH):
            state, step = _dp_trainer(regime, dev)
            rec = dict(loss=[], ms=[])
            _reset_counts()
            for batch in _dp_batches():
                batch = tuple(np.roll(b, roll, axis=0) for b in batch)
                torch.cuda.synchronize()
                t = time.perf_counter()
                state, m = step(state, batch)
                torch.cuda.synchronize()
                rec["ms"].append(1e3 * (time.perf_counter() - t))
                rec["loss"].append(float(m["loss"]))
            rec.update({k: v for k, v in _counts().items() if k in ("k1", "k2")})
            arrays = {k: v.cpu().numpy() for k, v in state.model.state_dict().items()}
            if roll:
                floor_arrays.setdefault(regime, []).append(arrays)
                floor_loss.setdefault(regime, []).append(rec["loss"])
            else:
                ref[regime], ref_arrays[regime] = rec, arrays
    rank_arrays = [dict(np.load(os.path.join(work, f"rank{r}.npz"))) for r in (0, 1)]
    ranks_equal = all(np.array_equal(rank_arrays[0][k], rank_arrays[1][k]) for k in rank_arrays[0])

    def max_abs(a, b):
        return max(float(np.abs(a[k].astype(np.float64) - b[k]).max()) for k in b)

    def max_rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    gaps = {}
    for regime in ref:
        ours = {k: rank_arrays[0][regime + "/" + k] for k in ref_arrays[regime]}
        gaps[regime] = dict(
            param_max_abs_diff=max_abs(ours, ref_arrays[regime]),
            param_floor=max(max_abs(a, ref_arrays[regime]) for a in floor_arrays[regime]),
            loss_max_rel_diff=max_rel(ranks[0]["regimes"][regime]["loss"], ref[regime]["loss"]),
            loss_floor=max(max_rel(f, ref[regime]["loss"]) for f in floor_loss[regime]))

    ckpt = {k: {n: v.numpy() for n, v in torch.load(
        os.path.join(d, "checkpoint", f"step_{DP_CLI_STEPS:08d}"), map_location="cpu",
        weights_only=True)["params"].items()} for k, d in outs.items()}
    cli_gap = max_abs(ckpt["cli_dp"], ckpt["cli_plain"])
    cli_floor = max_abs(ckpt["cli_plain_again"], ckpt["cli_plain"])
    written = sorted(os.listdir(outs["cli_dp"]))
    _line(phase="dp", seconds=time.perf_counter() - t0, cli_seconds=cli_seconds,
          ranks_seconds=ranks_seconds,
          cli=dict(steps=DP_CLI_STEPS, batch=DP_BATCH, crop=CROP, group="nccl, 1 process",
                   param_max_abs_diff=cli_gap, plain_against_itself=cli_floor,
                   written=written, dp=cli["cli_dp"], plain=cli["cli_plain"]),
          gloo_2_ranks=dict(steps=DP_STEPS, global_batch=DP_BATCH, crop=CROP,
                            rows=[r["rows"] for r in ranks], ranks_bit_equal=ranks_equal,
                            gaps=gaps,
                            ms_per_step={r["rank"]: {k: v["ms"] for k, v in r["regimes"].items()}
                                         for r in ranks},
                            one_process_ms_per_step={k: v["ms"] for k, v in ref.items()},
                            launches={r["rank"]: {k: [v["k1"], v["k2"]] for k, v in r["regimes"].items()}
                                      for r in ranks},
                            one_process_launches={k: [v["k1"], v["k2"]] for k, v in ref.items()}))
    if not cli_gap <= DP_PARAM_TOL:
        raise AssertionError(f"dp: cli train --data_parallel on one process {cli_gap:.3g} from the "
                             f"plain run (> {DP_PARAM_TOL}; the plain run against itself: "
                             f"{cli_floor:.3g})")
    if written != ["checkpoint", "config.json", "train_curve.png", "train_metrics.jsonl"]:
        raise AssertionError(f"dp: the data-parallel run wrote {written}")
    for k, c in cli.items():
        if (c["k1"], c["k2"]) != (DP_CLI_STEPS, DP_CLI_STEPS) or c["k1_paths"] != {RING_PATH: c["k1"]}:
            raise AssertionError(f"dp {k}: K1/K2 {c}, expected {DP_CLI_STEPS} each via {RING_PATH}")
    for regime, g in gaps.items():
        if not (ranks_equal and g["param_max_abs_diff"] <= max(DP_PARAM_TOL, FLOOR_SHARE * g["param_floor"])
                and g["loss_max_rel_diff"] <= max(DP_LOSS_TOL, FLOOR_SHARE * g["loss_floor"])):
            raise AssertionError(f"dp {regime}: 2 gloo ranks against 1 process: ranks equal "
                                 f"{ranks_equal}, {g} (params <= max({DP_PARAM_TOL}, "
                                 f"{FLOOR_SHARE} x floor), loss <= max({DP_LOSS_TOL}, ...))")
    for r in ranks:
        for regime, rec in r["regimes"].items():
            if (rec["k1"], rec["k2"]) != (ref[regime]["k1"], ref[regime]["k2"]):
                raise AssertionError(f"dp rank {r['rank']} {regime}: K1/K2 {rec['k1']}/{rec['k2']}, "
                                     f"one process {ref[regime]['k1']}/{ref[regime]['k2']}")
    if ref["adacof"]["k1"] != DP_STEPS or ref["adacof"]["k2"] != DP_STEPS:
        raise AssertionError(f"dp: the adacof reference launched K1/K2 {ref['adacof']}")
    k1 = cli["cli_dp"]["k1"] + sum(r["regimes"][g]["k1"] for r in ranks for g in r["regimes"])
    k2 = cli["cli_dp"]["k2"] + sum(r["regimes"][g]["k2"] for r in ranks for g in r["regimes"])
    return k1, k2


SPATIAL_R = 48  # the halo warp's clamp at the serve launch
SPATIAL_WARP_TOL = 1e-6  # the halo warp against K1 on the whole frame (JAX holds it bit-equal)
SPATIAL_REQUESTS = 2  # timed fusion_spatial_apply requests, after one warm-up


def _serve_models(dev, repo):
    """The serve phase's models: the bundled AdaCoF and FusionNet, a
    PhaseNet from seed 0."""
    import torch

    from fmvfi_tpu_torch.models.adacof import AdaCoFNet
    from fmvfi_tpu_torch.models.fusion_net import FusionNet, infer_variant
    from fmvfi_tpu_torch.models.phase_net import PhaseNetCore
    from fmvfi_tpu_torch.pipeline.interpolate import FusionModels
    from fmvfi_tpu_torch.utils.convert import load_adacof_weights, load_fusion_weights

    ckpt = os.path.join(repo, "checkpoints")
    ada = AdaCoFNet().to(dev).eval()
    ada.load_state_dict(load_adacof_weights(os.path.join(ckpt, "adacof_synth_demo.msgpack")))
    fusion_sd = load_fusion_weights(os.path.join(ckpt, "fusion_synth_demo.msgpack"))
    fusion = FusionNet(uncertainty_maps=3, variant=infer_variant(fusion_sd)).to(dev).eval()
    fusion.load_state_dict(fusion_sd)
    phase = PhaseNetCore().init_params(torch.Generator().manual_seed(0)).to(dev).eval()
    return FusionModels(phase_net=phase, adacof=ada, fusion_net=fusion)


def _spatial_requests():
    """The spatial phase's warm-up and timed pairs, 1080x1920."""
    from fmvfi_tpu_torch.eval.synth import translation_triplet

    return [translation_triplet(H_FULL, W_FULL, dx=4.0 + i, dy=2.0, seed=i)[::2]
            for i in range(1 + SPATIAL_REQUESTS)]


def _spatial_warp_case(dev):
    """The serve launch of K1 from one seeded generator on the card: the
    unpadded frames x (2, 3, 1080, 1920), softmax weights, offsets to +-60
    (beyond the clamp) and a cotangent."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(0)
    shape = (2, 25, H_FULL, W_FULL)
    x = torch.rand((2, 3, H_FULL, W_FULL), generator=gen, device=dev)
    wgt = torch.softmax(4.0 * torch.rand(shape, generator=gen, device=dev), dim=1)
    a, b = ((torch.rand(shape, generator=gen, device=dev) * 2 - 1) * 60 for _ in range(2))
    return x, wgt, a, b, torch.randn((2, 3, H_FULL, W_FULL), generator=gen, device=dev)


def _spatial_rank(mesh, dev, repo, out):
    """One rank of phase spatial on a (data 1 x spatial 2) mesh: (a) its band
    of the halo warp at the serve launch and the band's field gradients;
    (b) fusion_spatial_apply on the serve models, 1 warm-up and
    SPATIAL_REQUESTS requests.  Writes its warp blocks and the gathered
    fused frames to `out` (npz); returns its report."""
    import torch

    from fmvfi_tpu_torch.ops import adacof_cuda
    from fmvfi_tpu_torch.parallel import spatial

    # (a) the halo warp: 2 bands of 540 rows, K1 forward and K2 backward
    group = mesh.get_group("spatial")
    bands = spatial.Bands(group, mesh.get_local_rank("spatial"), (H_FULL // 2,) * 2)
    rows = slice(bands.lo, bands.hi)
    x, wgt, a, b, cot = _spatial_warp_case(dev)
    fields = [t[:, :, rows].contiguous().requires_grad_() for t in (wgt, a, b)]
    _reset_counts()
    with spatial.running(bands):
        warped = spatial.adacof_warp_tm_sharded(x[:, :, rows].contiguous(), *fields, 1,
                                                max_offset=SPATIAL_R)
    warped.backward(cot[:, :, rows])
    torch.cuda.synchronize()
    warp_counts = _counts()
    arrays = {"warp": warped.detach().cpu().numpy()}
    arrays.update({f"grad{i}": f.grad.cpu().numpy() for i, f in enumerate(fields)})
    del x, wgt, a, b, cot, fields, warped
    torch.cuda.empty_cache()

    # (b) the fused pipeline, the nets on this rank's band; the model's
    # warp recorded, which both routes call (the halo warp and the gathered
    # frame's)
    models = _serve_models(dev, repo)
    fn = spatial.fusion_spatial_apply(models, mesh, device=dev)
    images = []

    def recording(x, *args):
        images.append(list(x.shape))
        return adacof_cuda.adacof_warp(x, *args)

    models.adacof.warp = recording
    ms, per_request = [], []
    torch.cuda.reset_peak_memory_stats()
    for i, (f1, f2) in enumerate(_spatial_requests()):
        _reset_counts()
        images.clear()
        spatial.exchanged.clear()
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn(f1[None], f2[None])
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t))
        per_request.append(dict(**_counts(), k1_inputs=list(images),
                                halo_bytes=spatial.exchanged["halo"],
                                gather_bytes=spatial.exchanged["gather"],
                                rows=[res.rows.start, res.rows.stop]))
        arrays[f"fused{i}"] = res.gather()[0].cpu().numpy()
    np.savez(out, **arrays)
    return dict(rank=bands.index, rows=[bands.lo, bands.hi], warp=warp_counts, ms=ms,
                peak_memory_bytes=torch.cuda.max_memory_allocated(), requests=per_request)


# one rank of phase spatial: a gloo group of two processes on the one card
_SPATIAL_RANK_CHILD = """
import json, sys
import torch
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
coord, rank, repo, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
import chip_smoke as S
from fmvfi_tpu_torch.parallel import distributed
from fmvfi_tpu_torch.parallel.mesh import make_mesh
distributed.initialize(coord, num_processes=2, process_id=rank, backend="gloo")
mesh = make_mesh(2, ("data", "spatial"), (1, 2))
dev = torch.device("cuda", torch.cuda.current_device())
print(json.dumps(S._spatial_rank(mesh, dev, repo, out)))
"""


def phase_spatial(dev, repo):
    """(a) the halo warp and (b) fusion_spatial_apply on two gloo ranks
    sharing the card, against the plain warp and its field gradients (and
    K1/K2) on the whole frame here and fusion_interpolate with the plain
    warp; (c) fusion_spatial_apply on a 1-process NCCL group, (1, 1)
    mesh, bit-equal to fusion_interpolate.  Returns the ranks' K1 and K2
    launches."""
    with _work_dir(repo) as work_dir:
        return _spatial(dev, repo, work_dir)


def _spatial(dev, repo, work):
    import torch
    import torch.distributed as dist

    from fmvfi_tpu_torch.ops import adacof_cuda
    from fmvfi_tpu_torch.ops.adacof import adacof_warp as warp_plain
    from fmvfi_tpu_torch.ops.adacof import adacof_warp_field_grads, pad_replicate
    from fmvfi_tpu_torch.parallel import distributed, spatial
    from fmvfi_tpu_torch.parallel.mesh import make_mesh
    from fmvfi_tpu_torch.pipeline.interpolate import fusion_interpolate

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    env = dict(os.environ, PYTHONPATH=repo)
    coord = f"localhost:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, "-c", _SPATIAL_RANK_CHILD, coord, str(r), repo,
                               os.path.join(work, f"rank{r}.npz")], cwd=repo, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in (0, 1)]
    ranks = []
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=600)
            if p.returncode != 0:
                raise AssertionError(f"spatial rank {r}: exit {p.returncode}\n{err[-3000:]}")
            ranks.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            p.kill()
    ranks_seconds = time.perf_counter() - t0
    blocks = [dict(np.load(os.path.join(work, f"rank{r}.npz"))) for r in (0, 1)]

    # (a)'s references on the whole frame, here: the plain warp and its
    # field gradients, and K1 and K2 (the JAX package holds the halo warp
    # bit-equal to the single-device warp)
    x, wgt, a, b, cot = _spatial_warp_case(dev)
    xp = pad_replicate(x, 2)
    fields = [t.requires_grad_() for t in (wgt, a, b)]
    whole = adacof_cuda.adacof_warp(xp, *fields, 1, SPATIAL_R)
    whole.backward(cot)
    refs = {"k1": [whole.detach()] + [f.grad for f in fields]}
    del whole, fields
    with torch.no_grad():
        refs["plain"] = [warp_plain(xp, wgt, a, b, 1, SPATIAL_R)]
    refs["plain"] += adacof_warp_field_grads(xp, wgt.detach(), a.detach(), b.detach(), cot, 1,
                                             SPATIAL_R)
    warp_diff = {k: 0.0 for k in refs}
    grad_diff = {k: 0.0 for k in refs}
    for rec, blk in zip(ranks, blocks):
        rows = slice(*rec["rows"])
        got = [torch.from_numpy(blk[k]).to(dev) for k in ("warp", "grad0", "grad1", "grad2")]
        for k, ref in refs.items():
            warp_diff[k] = max(warp_diff[k], float((got[0] - ref[0][:, :, rows]).abs().max()))
            for g, want in zip(got[1:], ref[1:]):
                grad_diff[k] = max(grad_diff[k], float((g - want[:, :, rows]).abs().max()))
    del x, xp, wgt, a, b, cot, refs, got
    torch.cuda.empty_cache()

    # (c): fusion_spatial_apply on a 1-process NCCL group and
    # fusion_interpolate on the card; (b)'s reference: fusion_interpolate
    # with the plain warp
    models = _serve_models(dev, repo)
    requests = _spatial_requests()
    if dist.is_initialized():
        raise AssertionError("spatial: a process group already exists in the smoke's process")
    distributed.initialize(backend="nccl")
    try:
        mesh = make_mesh(1, ("data", "spatial"), (1, 1))
        one = spatial.fusion_spatial_apply(models, mesh, device=dev)(
            requests[0][0][None], requests[0][1][None]).gather()
    finally:
        dist.destroy_process_group()
    one_bit_equal = bool(torch.equal(one, fusion_interpolate(models, requests[0][0][None],
                                                             requests[0][1][None], device=dev)))
    models.adacof.warp = warp_plain
    single = [fusion_interpolate(models, f1[None], f2[None], device=dev)[0].cpu().numpy()
              for f1, f2 in requests]
    psnr = {rec["rank"]: [_psnr(blk[f"fused{i}"], single[i]) for i in range(len(requests))]
            for rec, blk in zip(ranks, blocks)}
    ranks_equal = all(np.array_equal(blocks[0][f"fused{i}"], blocks[1][f"fused{i}"])
                      for i in range(len(requests)))
    del models
    torch.cuda.empty_cache()

    _line(phase="spatial", seconds=time.perf_counter() - t0, ranks_seconds=ranks_seconds,
          note="2 gloo ranks share one card and reduce through host memory: the collectives' "
               "cost, not a speed-up",
          warp=dict(images=2, size=[H_FULL, W_FULL], bands=[r["rows"] for r in ranks],
                    max_offset=SPATIAL_R, max_abs_diff=warp_diff,
                    tol=dict(plain=K1_TOL, k1=SPATIAL_WARP_TOL),
                    grad_max_abs_diff=grad_diff, grad_tol=K2_TOL,
                    launches={r["rank"]: r["warp"] for r in ranks}),
          fusion=dict(size=[H_FULL, W_FULL], batch=1, mesh=[1, 2],
                      ms_per_request={r["rank"]: r["ms"][1:] for r in ranks},
                      warmup_ms={r["rank"]: r["ms"][0] for r in ranks},
                      peak_memory_bytes={r["rank"]: r["peak_memory_bytes"] for r in ranks},
                      per_request={r["rank"]: r["requests"][1:] for r in ranks},
                      psnr_vs_one_process_plain_db=psnr, ranks_equal=ranks_equal),
          one_process_nccl=dict(mesh=[1, 1], bit_equal=one_bit_equal))
    # the halo warp's block: a band of the 1088-row (/32) frame, 51 halo
    # rows (max_offset 48 + kp 2 + 1) above and below
    halo_rows = -(-H_FULL // 32) * 32 // 2 + 2 * (48 + 2 + 1)
    if not (warp_diff["plain"] <= K1_TOL and warp_diff["k1"] <= SPATIAL_WARP_TOL
            and max(grad_diff.values()) <= K2_TOL):
        raise AssertionError(f"spatial (a): the halo warp {warp_diff} from the plain warp and "
                             f"K1 on the whole frame (<= {K1_TOL}, {SPATIAL_WARP_TOL}), its "
                             f"field gradients {grad_diff} (<= {K2_TOL})")
    for r in ranks:
        w = r["warp"]
        if (w["k1"], w["k2"]) != (1, 1) or w["k1_paths"] != {RING_PATH: 1}:
            raise AssertionError(f"spatial (a) rank {r['rank']}: K1/K2 {w}")
        for q in r["requests"]:
            if (q["k1"], q["k2"]) != (3, 0) or q["k1_paths"] != {RING_PATH: 3}:
                raise AssertionError(f"spatial (b) rank {r['rank']}: K1/K2 {q}")
            if [x[0] for x in q["k1_inputs"]] != [2, 4, 2] or q["halo_bytes"] <= 0:
                raise AssertionError(f"spatial (b) rank {r['rank']}: K1 inputs "
                                     f"{q['k1_inputs']}, halo bytes {q['halo_bytes']}")
            if any(x[2] != halo_rows for x in q["k1_inputs"]):
                raise AssertionError(f"spatial (b) rank {r['rank']}: K1 inputs {q['k1_inputs']}"
                                     f", not the halo warp's blocks of {halo_rows} rows")
    if not (ranks_equal and min(min(v) for v in psnr.values()) >= PLAIN_AGREEMENT_DB):
        raise AssertionError(f"spatial (b): ranks equal {ranks_equal}, {psnr} dB against "
                             f"one process with the plain warp (>= {PLAIN_AGREEMENT_DB})")
    if not one_bit_equal:
        raise AssertionError("spatial (c): fusion_spatial_apply on a (1, 1) mesh is not "
                             "fusion_interpolate bit for bit")
    k1 = sum(r["warp"]["k1"] + sum(q["k1"] for q in r["requests"]) for r in ranks)
    k2 = sum(r["warp"]["k2"] + sum(q["k2"] for q in r["requests"]) for r in ranks)
    return k1, k2


SPATIAL_TRAIN_STEPS = 5  # timed steps of regimes (a) and (b), after one warm-up
SPATIAL_TRAIN_FULL_STEPS = 2  # timed 1080p fusion steps (c), after one warm-up
SPATIAL_TRAIN_GAN_STEPS = 2  # timed adversarial steps (d), after the compared first one
SPATIAL_LOSS_TOL = 1e-5  # relative: a first step's loss on 2 ranks against one process
SPATIAL_GRAD_TOL = 2e-4  # of each tensor's largest: the first step's gradient, the same
# FusionNet's gradient on the ranks' own inputs to it against one process's
# on the same inputs (6.8e-6 and 8.6e-6 measured on the card, 2.8e-6 on the
# CPU); end to end the fusion step is held at ROUTE_GRAD_TOL (ROADMAP Q3-3)
SPATIAL_SHARED_GRAD_TOL = 5e-5
# ... or twice the one process's own spread (the same first step run twice),
# where that is larger: F.interpolate's bilinear backward adds with atomics
FLOOR_FACTOR = 2.0
SPATIAL_TRAIN_REGIMES = ("adacof", "fusion", "fusion_1080p", "adacof_gan")


def _spatial_train_batches(regime):
    """The seeded global NHWC batches of a regime of phase spatial_train: 4
    translation triplets of 256x256 per step (1 + SPATIAL_TRAIN_STEPS), or
    1 of 1080x1920 (1 + SPATIAL_TRAIN_FULL_STEPS), the same in every
    process."""
    from fmvfi_tpu_torch.eval.synth import translation_triplet

    if regime == "fusion_1080p":
        h, w, b, n = H_FULL, W_FULL, 1, 1 + SPATIAL_TRAIN_FULL_STEPS
    else:
        h, w, b = CROP, CROP, FUSION_BATCH
        n = 1 + (SPATIAL_TRAIN_GAN_STEPS if regime == "adacof_gan" else SPATIAL_TRAIN_STEPS)
    items = [translation_triplet(h, w, dx=2.0 + i % 4, dy=1.0 - i % 3, seed=100 + i)
             for i in range(b * n)]
    return [tuple(np.stack([it[j] for it in items[s * b:(s + 1) * b]]) for j in range(3))
            for s in range(n)]


def _warp_launch_gaps(x, weight, offset_i, offset_j, dilation, max_offset):
    """K1 at a launch of the main path, and K2 on the same inputs with a
    seeded cotangent, against their plain versions; these launches leave
    the counts as they were.  Returns {the K1 input's shape, each max abs
    error}."""
    import torch

    from fmvfi_tpu_torch.ops import adacof_cuda
    from fmvfi_tpu_torch.ops.adacof import adacof_warp as warp_plain
    from fmvfi_tpu_torch.ops.adacof import adacof_warp_field_grads

    counts = (adacof_cuda.launches, adacof_cuda.bwd_launches, dict(adacof_cuda.paths),
              dict(adacof_cuda.bwd_paths))
    args = [t.detach() for t in (x, weight, offset_i, offset_j)]
    with torch.no_grad():
        out, x4 = adacof_cuda.warp_fwd_cuda(*args, dilation, max_offset)
        gen = torch.Generator(device=out.device).manual_seed(0)
        cot = torch.randn(out.shape, generator=gen, device=out.device)
        grads = adacof_cuda.warp_bwd_cuda(*args, cot, dilation, max_offset, x4)
        k1 = float((out - warp_plain(*args, dilation, max_offset)).abs().max())
        k2 = max(float((g - p).abs().max()) for g, p in zip(
            grads, adacof_warp_field_grads(*args, cot, dilation, max_offset)))
    adacof_cuda.launches, adacof_cuda.bwd_launches = counts[:2]
    for live, saved in zip((adacof_cuda.paths, adacof_cuda.bwd_paths), counts[2:]):
        live.clear()
        live.update(saved)
    return dict(shape=list(x.shape), k1_max_abs_err=k1, k2_max_abs_err=k2)


def _spatial_train_run(regime, dev, repo, mesh=None, vgg_path=None, steps=None):
    """One regime of phase spatial_train from the bundled weights (and the
    seeded PhaseNet): on the mesh's bands through the spatial trainers, or
    (mesh None) in this one process through the single-device ones.  On the
    mesh, every warp of the first step (the warm-up) also holds K1 and K2
    against their plain versions on its inputs (`_warp_launch_gaps`).
    Returns (report: per step the metrics, ms, K1/K2 counts, K1's input
    shapes and the exchanged bytes by kind; those gaps; the timed steps'
    peak memory; a
    digest of the parameters after the last step; the first step's clipped
    gradient (the optimizer's first moment / 0.1) by name, on the CPU; for
    fusion on the mesh, the first step's FusionNet inputs on this band,
    else None)."""
    import hashlib

    import torch

    from fmvfi_tpu_torch.ops import adacof_cuda
    from fmvfi_tpu_torch.parallel import spatial
    from fmvfi_tpu_torch.train.losses import parse_loss_spec
    from fmvfi_tpu_torch.train.trainer import DEFAULT_LOSS, make_adacof_trainer, make_fusion_trainer
    from fmvfi_tpu_torch.utils.convert import load_adacof_weights

    images, plain = [], []

    def recording(x, *args):
        images.append(list(x.shape))
        if mesh is not None and not rec["ms"]:
            plain.append(_warp_launch_gaps(x, *args))
        return adacof_cuda.adacof_warp(x, *args)

    torch.cuda.empty_cache()
    if regime.startswith("adacof"):
        kw = dict(device=dev)
        if regime == "adacof_gan":
            kw.update(loss_spec=parse_loss_spec(DEFAULT_LOSS + GAN_TERMS.format("T_WGAN_GP")),
                      vgg_checkpoint=vgg_path, h=CROP, w=CROP)
        state, step = (make_adacof_trainer(**kw) if mesh is None
                       else spatial.adacof_spatial_trainer(mesh, **kw))
        state.model.load_state_dict(load_adacof_weights(
            os.path.join(repo, "checkpoints", "adacof_synth_demo.msgpack")))
        warped = state.model
    else:
        models = _serve_models(dev, repo)
        args = (models.phase_net, models.adacof) + (() if mesh is None else (mesh,))
        factory = make_fusion_trainer if mesh is None else spatial.fusion_spatial_trainer
        state, step = factory(*args, variant=2, device=dev)
        state.model.load_state_dict(models.fusion_net.state_dict())
        warped = models.adacof
    warped.warp = recording
    rec = dict(loss=[], ms=[], counts=[], k1_inputs=[], exchanged=[], d_loss=[], metrics=[])
    grads = inputs = None
    for batch in _spatial_train_batches(regime)[:steps]:
        _reset_counts()
        images.clear()
        spatial.exchanged.clear()
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        rec["ms"].append(1e3 * (time.perf_counter() - t))
        rec["metrics"].append({k: float(v) for k, v in m.items()})
        rec["loss"].append(float(m["loss"]))
        rec["d_loss"].append(float(m["d_loss"]) if "d_loss" in m else None)
        rec["counts"].append(_counts())
        rec["k1_inputs"].append(list(images))
        rec["exchanged"].append(dict(spatial.exchanged))
        if grads is None:
            opt = state.optimizer
            grads = {k: (opt.state[p]["exp_avg"] / 0.1).cpu() for k, p in
                     state.model.named_parameters()}
            if regime == "fusion" and mesh is not None:
                # the step's sections, once more (deterministic): its
                # FusionNet inputs on this band
                from fmvfi_tpu_torch.pipeline.interpolate import FusionModels, _block_inputs

                warped.warp = adacof_cuda.adacof_warp
                with torch.no_grad():
                    block, _, bands, _ = _block_inputs(
                        FusionModels(models.phase_net, models.adacof, state.model),
                        batch[0], batch[2], dev, mesh)
                inputs = {k: v.cpu().numpy() for k, v in block._asdict().items()}
                inputs["lo"] = np.array(bands.lo)
                del block
                warped.warp = recording
        if len(rec["ms"]) == 1:  # the peak of the timed steps, without the warm-up's checks
            torch.cuda.reset_peak_memory_stats()
    rec["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    rec["plain"] = plain
    h = hashlib.sha256()
    for v in state.model.state_dict().values():
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    rec["digest"] = h.hexdigest()
    if state.extra is not None:
        h = hashlib.sha256()
        for v in state.extra.critic.state_dict().values():
            h.update(v.detach().cpu().contiguous().numpy().tobytes())
        rec["critic_digest"] = h.hexdigest()
    warped.warp = adacof_cuda.adacof_warp
    del state, step
    torch.cuda.empty_cache()
    return rec, grads, inputs


def _spatial_train_rank(mesh, dev, repo, out, vgg_path):
    """One rank of phase spatial_train: every regime on its band; writes the
    first steps' gradients (and the fusion step's inputs) to `out` (npz),
    returns the reports."""
    import torch

    reports, arrays = {}, {}
    for regime in SPATIAL_TRAIN_REGIMES:
        rec, grads, inputs = _spatial_train_run(regime, dev, repo, mesh, vgg_path)
        reports[regime] = rec
        arrays.update({f"{regime}/{k}": v.numpy() for k, v in grads.items()})
        arrays.update({f"inputs/{k}": v for k, v in (inputs or {}).items()})
    np.savez(out, **arrays)
    group = mesh.get_group("spatial")
    return dict(rank=torch.distributed.get_rank(group), regimes=reports)


def _fusion_grads_on(blocks, dev, repo):
    """The first fusion step's clipped FusionNet gradient in this one
    process on the ranks' FusionNet inputs (their bands put together), and
    how far those inputs are from this process's own: (gradient by name,
    {each input's max abs diff, the maps' pixels over 1e-3, the L1 loss's
    sign flips between the two inputs' predictions})."""
    import torch

    from fmvfi_tpu_torch.models.fusion_net import FusionNet
    from fmvfi_tpu_torch.pipeline.interpolate import FusionInputs, _nchw, fusion_inputs
    from fmvfi_tpu_torch.train.trainer import fusion_loss

    models = _serve_models(dev, repo)
    f1, target, f2 = _spatial_train_batches("fusion")[0]
    rows = [int(b["inputs/lo"]) for b in blocks]
    whole = FusionInputs(*(torch.from_numpy(np.concatenate(
        [b[f"inputs/{k}"] for _, b in sorted(zip(rows, blocks), key=lambda t: t[0])], 2)).to(dev)
        for k in FusionInputs._fields))
    with torch.no_grad():
        own, _ = fusion_inputs(models, f1, f2, dev)
    net = FusionNet(uncertainty_maps=3, variant=2).to(dev)
    net.load_state_dict(models.fusion_net.state_dict())
    target = _nchw(target, dev)
    pred = net(*whole)
    loss, _ = fusion_loss(pred, target)
    names, params = zip(*net.named_parameters())
    grads = torch.autograd.grad(loss, params)
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = 1.0 / torch.clamp(norm, min=1.0)
    with torch.no_grad():
        flips = int((torch.sign(pred - target) != torch.sign(net(*own) - target)).sum())
    diff = {k: float((a - b).abs().max()) for k, a, b in zip(own._fields, whole, own)}
    return ({k: (g * scale).cpu() for k, g in zip(names, grads)},
            dict(max_abs=diff, maps_px_over_1e3=int(((whole.maps - own.maps).abs() > 1e-3).sum()),
                 l1_sign_flips=flips))


# one rank of phase spatial_train: a gloo group of two processes on the one card
_SPATIAL_TRAIN_RANK_CHILD = """
import json, sys
import torch
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
coord, rank, repo, out, vgg = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
import chip_smoke as S
from fmvfi_tpu_torch.parallel import distributed
from fmvfi_tpu_torch.parallel.mesh import make_mesh
distributed.initialize(coord, num_processes=2, process_id=rank, backend="gloo")
mesh = make_mesh(2, ("data", "spatial"), (1, 2))
dev = torch.device("cuda", torch.cuda.current_device())
print(json.dumps(S._spatial_train_rank(mesh, dev, repo, out, vgg)))
"""


def phase_spatial_train(dev, repo):
    """The spatial trainers on two gloo ranks sharing the card, (data 1 x
    spatial 2): (a) AdaCoF, (b) FusionNet at 256x256, batch 4, (c)
    FusionNet at 1080x1920, batch 1, (d) AdaCoF with the VGG and T_WGAN_GP
    terms, each against the same steps in this one process.  Returns the
    ranks' K1 and K2 launches."""
    with _work_dir(repo) as work_dir:
        return _spatial_train(dev, repo, work_dir)


def _spatial_train(dev, repo, work):
    t0 = time.perf_counter()
    vgg_path = _seeded_vgg16(os.path.join(work, "vgg16.pth"))
    env = dict(os.environ, PYTHONPATH=repo)
    coord = f"localhost:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, "-c", _SPATIAL_TRAIN_RANK_CHILD, coord, str(r),
                               repo, os.path.join(work, f"rank{r}.npz"), vgg_path], cwd=repo,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in (0, 1)]
    ranks = []
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=900)
            if p.returncode != 0:
                raise AssertionError(f"spatial_train rank {r}: exit {p.returncode}\n{err[-3000:]}")
            ranks.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            p.kill()
    ranks_seconds = time.perf_counter() - t0
    blocks = [dict(np.load(os.path.join(work, f"rank{r}.npz"))) for r in (0, 1)]

    # the one-process references: each regime's steps here, and its first
    # step once more (the card's own run-to-run spread)
    one, again, one_grads, again_grads = {}, {}, {}, {}
    for regime in SPATIAL_TRAIN_REGIMES:
        one[regime], one_grads[regime], _ = _spatial_train_run(regime, dev, repo,
                                                               vgg_path=vgg_path)
        if regime != "fusion_1080p":
            again[regime], again_grads[regime], _ = _spatial_train_run(
                regime, dev, repo, vgg_path=vgg_path, steps=1)
    shared, input_gaps = _fusion_grads_on(blocks, dev, repo)

    def grad_gap(got, want):
        return max(float((got[k].double() - w.double()).abs().max())
                   / max(float(w.abs().max()), 1e-30) for k, w in want.items())

    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-30)

    import torch

    gaps = {}
    for regime in SPATIAL_TRAIN_REGIMES:
        ours = {k[len(regime) + 1:]: torch.from_numpy(v) for k, v in blocks[0].items()
                if k.startswith(regime + "/")}
        r0 = ranks[0]["regimes"][regime]
        g = dict(loss_rel=rel(r0["loss"][0], one[regime]["loss"][0]),
                 grad_rel=grad_gap(ours, one_grads[regime]))
        if regime in again:
            g.update(loss_floor=rel(again[regime]["loss"][0], one[regime]["loss"][0]),
                     grad_floor=grad_gap(again_grads[regime], one_grads[regime]))
        if r0["d_loss"][0] is not None:
            g.update(d_loss_rel=rel(r0["d_loss"][0], one[regime]["d_loss"][0]),
                     d_loss_floor=rel(again[regime]["d_loss"][0], one[regime]["d_loss"][0]))
        if regime == "fusion":
            # FusionNet's gradient on the ranks' own inputs to it (ROADMAP
            # Q3-3: end to end the artifact map's histogram median turns the
            # bands' float noise into ~1e-2 at a few pixels)
            g.update(grad_rel_shared_inputs=grad_gap(ours, shared), inputs=input_gaps)
        g["terms_rel"] = {k: rel(v, one[regime]["metrics"][0][k])
                          for k, v in r0["metrics"][0].items()}
        gaps[regime] = g

    def per_rank(key, regime, first=False):
        """Each rank's `key` of the timed steps (first: of the first step,
        the warm-up or, for adacof_gan, the compared one)."""
        return {r["rank"]: (r["regimes"][regime][key][0] if first
                            else r["regimes"][regime][key][1:]) for r in ranks}

    _line(phase="spatial_train", seconds=time.perf_counter() - t0, ranks_seconds=ranks_seconds,
          note="2 gloo ranks share one card and reduce through host memory: the collectives' "
               "cost, not a speed-up", mesh=[1, 2], gaps=gaps,
          tol=dict(loss_rel=SPATIAL_LOSS_TOL, grad_rel=SPATIAL_GRAD_TOL,
                   grad_rel_shared_inputs=SPATIAL_SHARED_GRAD_TOL, grad_rel_end_to_end=ROUTE_GRAD_TOL,
                   floor_factor=FLOOR_FACTOR, k1=K1_TOL, k2=K2_TOL),
          regimes={regime: dict(
              ms_per_step=per_rank("ms", regime), first_ms=per_rank("ms", regime, True),
              one_process_ms_per_step=one[regime]["ms"][1:],
              peak_memory_bytes={r["rank"]: r["regimes"][regime]["peak_memory_bytes"]
                                 for r in ranks},
              one_process_peak_memory_bytes=one[regime]["peak_memory_bytes"],
              loss={r["rank"]: r["regimes"][regime]["loss"] for r in ranks},
              one_process_loss=one[regime]["loss"],
              exchanged_per_step={r["rank"]: r["regimes"][regime]["exchanged"][-1] for r in ranks},
              k1_inputs_per_step={r["rank"]: r["regimes"][regime]["k1_inputs"][-1] for r in ranks},
              counts_per_step={r["rank"]: r["regimes"][regime]["counts"][-1] for r in ranks},
              plain_gaps={r["rank"]: r["regimes"][regime]["plain"] for r in ranks},
              ranks_equal=len({r["regimes"][regime]["digest"] for r in ranks}) == 1)
              for regime in SPATIAL_TRAIN_REGIMES})

    # gates: the first step against one process (or twice its own spread).
    # adacof_gan's loss and its adversarial term read the critic after its
    # Adam step, lr * sign(g) at first, which turns float noise at a
    # near-zero critic gradient into 2 lr: there the terms before the
    # critic's update, d_loss and the generator's gradient are held
    before_critic = ("loss", "T_WGAN_GP", "d_loss")
    for regime, g in gaps.items():
        loss_tol = max(SPATIAL_LOSS_TOL, FLOOR_FACTOR * g.get("loss_floor", 0.0))
        grad_tol = max(SPATIAL_GRAD_TOL, FLOOR_FACTOR * g.get("grad_floor", 0.0))
        if regime == "adacof_gan":
            loss_rel = max(v for k, v in g["terms_rel"].items() if k not in before_critic)
        else:
            loss_rel = g["loss_rel"]
        if not loss_rel <= loss_tol:
            raise AssertionError(f"spatial_train {regime}: the first step's loss {g} from one "
                                 f"process (> {loss_tol:.3g})")
        if regime in ("adacof", "adacof_gan") and not g["grad_rel"] <= grad_tol:
            raise AssertionError(f"spatial_train {regime}: the first step's gradient {g} from one "
                                 f"process (> {grad_tol:.3g} of a tensor's largest)")
        shared_tol = max(SPATIAL_SHARED_GRAD_TOL, FLOOR_FACTOR * g.get("grad_floor", 0.0))
        if regime == "fusion" and not (g["grad_rel_shared_inputs"] <= shared_tol
                                       and g["grad_rel"] <= ROUTE_GRAD_TOL):
            raise AssertionError(f"spatial_train {regime}: the first step's gradient {g} from one "
                                 f"process on the ranks' inputs (> {shared_tol:.3g} of a tensor's "
                                 f"largest) or end to end (> {ROUTE_GRAD_TOL})")
        if "d_loss_rel" in g and not g["d_loss_rel"] <= max(SPATIAL_LOSS_TOL,
                                                            FLOOR_FACTOR * g["d_loss_floor"]):
            raise AssertionError(f"spatial_train {regime}: d_loss {g} from one process")
    # K1 and K2 at every launch shape of the first step on the bands against
    # their plain versions
    for r in ranks:
        for regime, rec in r["regimes"].items():
            held = [c["shape"] for c in rec["plain"]]
            bad = [c for c in rec["plain"]
                   if not (c["k1_max_abs_err"] <= K1_TOL and c["k2_max_abs_err"] <= K2_TOL)]
            if held != rec["k1_inputs"][0] or bad:
                raise AssertionError(f"spatial_train {regime} rank {r['rank']}: K1/K2 against "
                                     f"their plain versions {rec['plain']} (<= {K1_TOL}, {K2_TOL}) "
                                     f"at the launches {rec['k1_inputs'][0]}")
    # the ranks hold one model (and one critic), and every step launched K1
    # (and K2) on the bands' halo blocks through the ring
    band = CROP // 2 + 2 * (48 + 2 + 1)  # 128-row bands + 51 halo rows above and below
    full = -(-H_FULL // 32) * 32 // 2 + 2 * (48 + 2 + 1)
    want = {"adacof": ([[8, 3, band, CROP + 4]], 1),
            "adacof_gan": ([[8, 3, band, CROP + 4]], 1),
            "fusion": ([[8, 3, band, CROP + 4], [16, 3, band, CROP + 4], [8, 3, band, CROP + 4]], 0),
            "fusion_1080p": ([[2, 3, full, W_FULL + 4], [4, 3, full, W_FULL + 4],
                              [2, 3, full, W_FULL + 4]], 0)}
    k1 = k2 = 0
    for regime, (inputs, n_k2) in want.items():
        recs = [r["regimes"][regime] for r in ranks]
        if len({rec["digest"] for rec in recs}) != 1 or len(
                {rec.get("critic_digest") for rec in recs}) != 1:
            raise AssertionError(f"spatial_train {regime}: the ranks' parameters differ")
        for rec in recs:
            for c, seen, ex in zip(rec["counts"], rec["k1_inputs"], rec["exchanged"]):
                paths = [{RING_PATH: n} if n else {} for n in (len(inputs), n_k2)]
                if (seen != inputs or [c["k1"], c["k2"]] != [len(inputs), n_k2]
                        or [c["k1_paths"], c["k2_paths"]] != paths):
                    raise AssertionError(f"spatial_train {regime}: K1 inputs {seen}, counts {c}; "
                                         f"expected {inputs} and {n_k2} K2 via {RING_PATH}")
                if not (ex.get("halo", 0) > 0 and ex.get("halo_bwd", 0) > 0):
                    raise AssertionError(f"spatial_train {regime}: exchanged {ex}")
                k1, k2 = k1 + c["k1"], k2 + c["k2"]
            if not np.isfinite(rec["loss"]).all():
                raise AssertionError(f"spatial_train {regime}: losses {rec['loss']}")
    return k1, k2


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
        from fmvfi_tpu_torch import native
        from fmvfi_tpu_torch.eval import visualize
        from fmvfi_tpu_torch.eval.evaluate import evaluate_suite, synthetic_sets
        from fmvfi_tpu_torch.utils import imageio
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
        # offsets far past the tile with more blocks than the card holds at
        # once, through the ring: consumers lag the producer (the ring's
        # proxy fence, csrc/adacof_ring.cuh)
        (2, 3, 256, 512, 5, 1, 60.0, 48),
        (1, 3, 512, 768, 11, 1, 60.0, 48),
        (2, 3, 256, 512, 7, 1, 60.0, None),
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
    bf16_k1 = phase_serve_bf16(dev, models, requests, outs, lat_ms, peak)

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

    # eval: evaluate_suite on the synthetic sets, four methods, with the
    # panels and the panel videos (visualize=True, the default)
    t0 = time.perf_counter()
    sets = synthetic_sets(dim=256, n_frames=4)
    t_setup = time.perf_counter() - t0
    os.makedirs(os.path.join(repo, "build"), exist_ok=True)
    eval_dir = tempfile.mkdtemp(prefix="chip_smoke_eval_", dir=os.path.join(repo, "build"))
    draw = {"prediction_panel": 0.0, "panels_to_video": 0.0}
    real_draw = {k: getattr(visualize, k) for k in draw}

    def timed_draw(name):
        def fn(*a, **k):
            t = time.perf_counter()
            try:
                return real_draw[name](*a, **k)
            finally:
                draw[name] += time.perf_counter() - t
        return fn

    t_build = time.perf_counter()
    native.library()  # the host library's g++ build, kept out of the drawing seconds
    native_build_seconds = time.perf_counter() - t_build
    try:
        for k in draw:  # evaluate_suite reads them from the module at each call
            setattr(visualize, k, timed_draw(k))
        adacof_cuda.launches = adacof_cuda.bwd_launches = 0  # the evaluation path's run
        adacof_cuda.paths.clear()
        t_run = time.perf_counter()
        summary = evaluate_suite(models, os.path.join(eval_dir, "k1"), sets=sets,
                                 methods=EVAL_METHODS, dim=256, device=dev)
        run_seconds = time.perf_counter() - t_run
        eval_k1, eval_k2 = adacof_cuda.launches, adacof_cuda.bwd_launches  # read just after
        eval_paths = dict(adacof_cuda.paths)
        draw_seconds = dict(draw)
        for k in draw:
            setattr(visualize, k, real_draw[k])
        has_summary = os.path.exists(os.path.join(eval_dir, "k1", "summary.json"))
        figures = _eval_figures(os.path.join(eval_dir, "k1"), sets)
        rerun = evaluate_suite(models, os.path.join(eval_dir, "k1"), sets=sets,
                               methods=EVAL_METHODS, dim=256, device=dev)
        rerun_k1 = adacof_cuda.launches - eval_k1
        ada.warp = warp_plain  # its own directory: the weights digest is the same
        try:
            plain = evaluate_suite(models, os.path.join(eval_dir, "plain"), sets=sets,
                                   methods=("fusion",), dim=256, visualize=False, device=dev)
        finally:
            ada.warp = adacof_cuda.adacof_warp
    finally:
        for k in draw:
            setattr(visualize, k, real_draw[k])
        shutil.rmtree(eval_dir, ignore_errors=True)
    plain_gap = {k: abs(summary[k]["fusion"]["psnr"] - plain[k]["fusion"]["psnr"]) for k in sets}
    draw_total = sum(draw_seconds.values())
    _line(phase="eval", seconds=time.perf_counter() - t0, setup_seconds=t_setup,
          native_build_seconds=native_build_seconds,
          run_seconds=run_seconds, score_seconds=run_seconds - draw_total,
          panel_seconds=draw_seconds["prediction_panel"],
          avi_seconds=draw_seconds["panels_to_video"],
          panel_seconds_per_set=draw_seconds["prediction_panel"] / len(sets),
          avi_seconds_per_set=draw_seconds["panels_to_video"] / len(sets),
          dim=256, n_frames=4, sets=len(sets), figures=figures,
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

    # lpips: the VGG LPIPS on the card, and evaluate_suite filling lpips_vgg
    lpips_k1 = phase_lpips(dev, repo, models, sets)

    # photo: JPEG frames, the natural-photo sources, the photo set's
    # evaluation and photo_frac training through K1/K2
    photo_k1, photo_k2 = phase_photo(dev, repo, models, ada_path)

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
        curve_path = os.path.join(out_dir, "train_curve.png")
        curve_shape = list(imageio.imread(curve_path).shape) if os.path.exists(curve_path) else None
        if curve_shape != [400, 800, 3]:
            raise AssertionError(f"training: train_curve.png {curve_shape}, expected 400x800 RGB")
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
          train_curve_png=curve_shape,
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
        _reset_counts()  # the phase-training path's run
        torch.cuda.reset_peak_memory_stats()
        state = fit(state, regime_step(step_fn, rec), batches, phase_out, epochs=1,
                    steps_per_epoch=REGIME_STEPS + 1, log_every=1, ckpt_every=REGIME_STEPS + 1)
        phase_counts = _counts()
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
            _reset_counts()  # this mode's run
            st, _ = regime_step(fn, mrec)(st, next(batches))
            c = _counts()
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
        _reset_counts()  # the fusion-training path's run
        torch.cuda.reset_peak_memory_stats()
        state = fit(state, regime_step(step_fn, rec), batches, fusion_out, epochs=1,
                    steps_per_epoch=REGIME_STEPS + 1, log_every=1, ckpt_every=REGIME_STEPS + 1)
        fusion_counts = _counts()
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
            _reset_counts()  # this mode's run
            st, _ = regime_step(fn, mrec)(st, next(batches))
            c = _counts()
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

    # cli: the command line on PNG files of the serve phase's first pair and
    # the video phase's clip, after the training phases (the commands' own
    # setup, not the first step of a shape in this process, is then timed)
    del state, models
    torch.cuda.empty_cache()
    cli_k1, cli_k2 = phase_cli(dev, repo, ada_path, fusion_path,
                               (requests[0][0], requests[0][2]), clip)
    del clip

    # export: the fused pipeline as a torch.export artifact for the card,
    # loaded in a fresh process; a port-trained AdaCoF written out; the
    # profiling utilities on one request
    torch.cuda.empty_cache()
    export_k1, export_k2 = phase_export(dev, repo, ada_path, fusion_path,
                                        (requests[0][0], requests[0][2]),
                                        float(np.mean(lat_ms[1:])))
    del requests

    # train_gan: AdaCoF training with the VGG and adversarial terms; each
    # adversarial step on the card against the CPU; the native loader
    gan_k1, gan_k2, gan_types_k1, gan_types_k2 = phase_train_gan(dev, repo, ada_path)
    phase_gan_vs_cpu(dev)
    phase_native()
    dp_k1, dp_k2 = phase_dp(dev, repo)
    spatial_k1, spatial_k2 = phase_spatial(dev, repo)
    spatial_train_k1, spatial_train_k2 = phase_spatial_train(dev, repo)
    regime_k1.update(lpips=lpips_k1, photo=photo_k1, cli=cli_k1, export=export_k1,
                     train_gan=gan_k1,
                     train_gan_types=gan_types_k1, serve_bf16=bf16_k1, dp=dp_k1,
                     spatial=spatial_k1, spatial_train=spatial_train_k1)

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
        replaces=adacof_cuda.REPLACES_BWD,
        launches=(train_k2 + photo_k2 + gan_k2 + gan_types_k2 + cli_k2 + export_k2 + dp_k2
                  + spatial_k2 + spatial_train_k2),
        max_abs_err=k2_max_err,
        ms=k2_train["ms"], plain_ms=k2_train["plain_ms"], bound_ms=k2_train["bound_ms"],
        bound_by=k2_train["bound_by"], library_ms=None, design=DESIGN,
        launch_1080p_ms=k2_timings[1]["ms"],
        launches_by_path=dict(serve=0, serve_bf16=0, video=0, eval=0, lpips=0, photo=photo_k2,
                              cli=cli_k2,
                              export=export_k2, train=train_k2, train_phase=0, train_fusion=0,
                              train_gan=gan_k2, train_gan_types=gan_types_k2, dp=dp_k2,
                              spatial=spatial_k2, spatial_train=spatial_train_k2),
    )])
    _line(ok=True, device=dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                               count=torch.cuda.device_count()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
