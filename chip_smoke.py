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
  inputs    - (after photo; lines inputs_pins, inputs_webp_gif,
              inputs_vp9_highbd_lossless, inputs_h263, inputs_video,
              inputs_mp4v, inputs_mkv, inputs_vp9, inputs_mpeg, inputs_frames)
              the inputs JAX reads through cv2, read here without it: the
              fixtures of tests/data/inputs/ (tools/make_input_fixtures.py:
              Adam7 PNGs, progressive JPEGs, one cut after its second scan
              so that block smoothing runs, cv2.VideoWriter's and
              MjpgWriter's Motion-JPEG AVIs at 4:2:0, 4:2:2 and 4:4:4,
              cv2.VideoWriter's mp4v .mp4, .mov and FMP4 .avi and two mp4v
              AVIs of the port's encoder, odd-sized and with 4MV, DQUANT,
              AC prediction and DC-as-TCOEF; Matroska and WebM files of
              VP8, MJPG, mp4v and XVID from cv2.VideoWriter, libvpx VP8
              clips at odd sides, 8 token partitions, alt-ref, segmentation
              and versions 1-3, and forged unknown-size, laced,
              audio-first and Colour / PixelCrop copies; VP9 from
              cv2.VideoWriter in .webm, .mkv, .mp4 and .avi, libvpx clips
              with superframes and hidden frames, tiles, lossless, AQ
              segmentation, error resilience, cpu-used 0 / 5 / 8, profile
              1 at 4:4:4, 4:2:2 and 4:4:0, BT.709 full range, BT.2020,
              SMPTE 240M, and forged sharpness, bilinear, show_existing,
              Colour and vpcC copies) each decoded by
              the port with the sha256 of its pixels equal to that of cv2's
              or PIL's (INPUT_PINS, held by the CPU tests), the WebP and
              GIF fixtures among them (lossy, with ALPH, EXIF-rotated and
              lossless WebPs of every VP8L transform, the colour cache,
              LZ77 and meta prefix codes, animated WebPs; GIF87a / 89a,
              local tables, interlacing, transparency, disposals 0-3, odd
              code widths, a full LZW table, clips and sequences); (line
              inputs_webp_gif) the committed 1080x1920 WebP (cv2's lossy,
              quality 90, of a smooth scene) decoded, the port's lossless
              file of those pixels written and read back equal, and the
              committed 1080p animated GIF's 3 frames, each timed (median
              of 5, on the calling thread) beside the card's name and
              power limit; (line inputs_vp9_highbd_lossless) the pins of
              VP9 profiles 2 and 3 (10 and 12 bits, every sampling and
              container), PNG and raw frames in AVI and MOV and the
              corrupted WebPs libwebp reads on past their chunk, all
              equal, and the committed 1080p 10-bit VP9 WebM's key and
              inter frames decoded (median of 5, on the calling thread);
              (line inputs_h263) the pins of the H.263 family (H.263 in
              AVI, 3GP and MOV with OBMC, 4MV, GOB headers, DQUANT, Annex D
              and PEI; Sorenson in FLV and AVI, formats 0 and 1, disposable
              pictures; MS-MPEG4 v2 and v3 with slices, flipflop rounding,
              DC escapes and x86's inexact unrounded averages; mp4v with
              short-header pictures), all equal, and the committed 1080p
              MS-MPEG4 v3 AVI's and Sorenson FLV's key and inter pictures and
              the 352x288 H.263 AVI's I and P pictures decoded (medians of
              5, on the calling thread) beside the card's name and power
              limit;
              the video phase's first 3 frames written as a 1080x1920 MJPG
              AVI with MjpgWriter and `cli video --input clip.avi --method
              fusion` on it: 5 PNGs, the originals those read_video_frames
              returns, K1 exactly [2, 4, 2] images a pair through F5C3 with
              the ring, no K2, each interpolated frame >= 60 dB against
              double_frame_rate per pair in this process on the frames
              read_video_frames returns; the decoded frames finite and >=
              17.5 dB against the pixels written (quality 95 on the clip's
              pixel-noise texture decodes at ~18.3 dB), and the ms to
              decode one 1080p frame beside the card's name and power
              limit; (line inputs_mp4v) the same 3 frames as PNGs through
              images_to_video into clip.mp4 (mp4v, quant 3), read back
              with read_video_frames (>= 18.0 dB against the pixels
              written: 18.58 dB measured on the CPU), the encoder's own
              reconstruction and packets equal to the port's decode of the
              file, ms to decode a 1080p I-VOP and a P-VOP and to encode a
              frame, the file's bytes, and `cli video --input clip.mp4
              --method fusion` checked as the AVI's (5 PNGs, originals
              exact, K1 [2, 4, 2] x 2 via F5C3 with the ring, no K2, >= 60
              dB against per pair); (line inputs_mkv) the committed
              1080x1920 WebM of the same 3 frames (cv2.VideoWriter's VP80,
              tests/data/inputs/vp8_cv2_1080x1920.webm) read with
              utils/mkv.py and native/vp8.cpp (>= 13.0 dB against the
              pixels written: 13.43-13.45 dB measured on the CPU), the
              Matroska parse ms and the ms to decode its VP8 key frame and
              inter frames (medians of 5, one host thread), and `cli video
              --input clip.webm --method fusion` checked as the AVI's; the
              3 PNGs through images_to_video into clip.mkv, its blocks the
              mp4v encoder's packets and its frames read back equal to the
              encoder's reconstruction, its bytes; (line inputs_vp9) each
              VP9 pin, the committed 1080x1920 WebM of the same 3 frames
              (cv2.VideoWriter's VP90, tests/data/inputs/
              vp9_cv2_1080x1920.webm, 4 tile columns) read with
              utils/mkv.py and native/vp9.cpp (>= 18.0 dB against the
              pixels written: 18.29 dB measured on the CPU), the Matroska
              parse ms and the ms to decode its VP9 key frame and inter
              frames (medians of 5, one host thread), and `cli video
              --input clip.webm --method fusion` checked as the AVI's;
              (line inputs_mpeg) each MPEG-1/2 pin (cv2's MPG2 and PIM1
              in .mpg, .vob, .ts, .m2ts, .m1v / .m2v, .avi, .mkv, .mp4 and
              .mov; libavcodec clips with MPEG-1 B pictures, alternate
              scan, table B.15, q_scale_type 1, intra DC of 9-11 bits,
              custom matrices and a quant matrix extension, field DCT and
              field motion, BT.709, quantiser changes, address escapes)
              and the pins of IVF (VP8, VP9), VP8 in AVI, Motion-JPEG in
              MOV and MP4 and mp4v in a transport stream; the committed
              1080x1920 MPEG-2 transport stream of the same 3 frames
              (cv2.VideoWriter's MPG2, tests/data/inputs/
              mpeg2_cv2_1080x1920.ts: an I, a P and a B picture) split
              into pictures with utils/mpegts.py and decoded with
              native/mpeg12.cpp (>= 16.5 dB against the pixels written:
              16.96-18.24 dB measured on the CPU), the demux ms and the ms
              to decode its I, P and B pictures and the flush (medians of
              5, one host thread), and `cli video --input clip.ts
              --method fusion` checked as the AVI's; the stills pins
              (BMP, PNM, TIFF with the committed 1080x1920 cv2 LZW TIFF,
              CMYK / RGB JPEGs, EXIF-oriented PNG and JPEG, lone images
              and numbered sequences read as video);
              double_frame_rate per pair on the Adam7 and the
              progressive-JPEG frame directories through K1;
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
              (line cli_interpolate_stills) the pair as a.tif and b.bmp
              (the port's imwrite; the 1080p BMP, PPM and TIFF write and
              read ms and bytes) fused by a second cold process into
              mid.tif, within 1 LSB of mid.png, K1 [2, 4, 2] counted on
              the same request in process; (line cli_interpolate_webp)
              the pair as a.webp and b.webp (the port's lossless imwrite,
              read back bit-equal; the 1080p WebP write and read ms and
              bytes beside the card's name and power limit) fused by a
              third cold process into mid.webp, within 1 LSB of mid.png,
              K1 [2, 4, 2] counted on the same request in process;
              then through cli.main: `video` per pair, on `clip/%03d.png`
              (line cli_video_sequence: every frame equal to the directory
              route's, K1 3 a pair), on the committed 1080x1920 animated
              GIF (line cli_video_gif: tests/data/inputs/
              gif_clip_1080x1920.gif, 3 images of a smooth moving scene,
              every image a frame as FFmpeg's gif demuxer reads it, the
              frames equal to their pin, the originals exact, K1 3 a pair,
              each interpolated frame >= 60 dB against double_frame_rate
              per pair in this process), on the committed 1080p 10-bit
              VP9 WebM with --method fusion (line cli_video_vp9_10bit:
              tests/data/inputs/vp9_hbd10_1080x1920.webm, the clip's 3
              frames at full precision in profile 2, the same checks, K1
              3 a pair), on the committed 1080p MS-MPEG4 v3 AVI with
              --method fusion (line cli_video_msmpeg4: tests/data/inputs/
              msmpeg4_cv2_mp43_1080x1920.avi, cv2's MP43 writer on the
              clip's 3 frames; the frames equal to their pin, the originals
              exact, the interpolated frames against double_frame_rate per
              pair in this process (identical, and >= 60 dB), ms a pair, K1
              6) and --batch 2 (9
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
CLI_ORACLE_FILES = 3  # the pair and the clip's first frame: the C++ unfilter against numpy
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
INPUTS_DIR = os.path.join("tests", "data", "inputs")  # tools/make_input_fixtures.py writes it
# what cv2 or PIL returns for each fixture, computed by tools/make_input_fixtures.py
# and held by the CPU tests: the contract ("imread": cv2.imread + BGR2RGB;
# "read_jpeg": PIL's Image.open; "video": cv2.VideoCapture's frames + BGR2RGB,
# stacked) and the sha256 of those RGB pixels
INPUT_PINS = {
    "adam7_frames/00000.png":
        ("imread", "fe9f607398a955b1eef6025a827a938ad5064c998dc7547b362e2b1aa808f8c7"),
    "adam7_frames/00001.png":
        ("imread", "c65b8b4676150823af415da33537be4e8201ba2d2abfaed385153bf93be10812"),
    "adam7_frames/00002.png":
        ("imread", "83a6a14f92f70bb286f014d5c59419b9b00745e61eb54c817cbf83bfcddb9d2e"),
    "adam7_grey16_5x7.png":
        ("imread", "d26528b30b977f6c8d2042f8a4bd7d1746a4f73995c40e0f05d33cfcaa6de15d"),
    "adam7_pal4_9x13.png":
        ("imread", "930f8a9729766be2bc91687d7a80f6440fef3d16331a3b18282d151ce7ad3932"),
    "adam7_rgb8_29x37.png":
        ("imread", "44ba622fc3f3cddba47bc234481aeb502d02797d50369838a423388bf99c820c"),
    "adam7_rgba16_3x2.png":
        ("imread", "4323f7c3fb98f03458668c5d9cd224d7883ede628553bf1b40a8c3e74f39096c"),
    "cv2_writer_48x64.avi":
        ("video", "3bae71454830e2814ae204db2229ba957b1eeb290d8db6f78cb4de007e43234a"),
    "mjpg_420_21x37.avi":
        ("video", "73ffdf421ed72013445327379082416e657edcc6e95a71428e8dfc0b83d68373"),
    "mjpg_422_45x62.avi":
        ("video", "b7d9910c4f8a01b2bf114aa90a6b896eb9c9b35a9f75e07e4558e408fe61c42f"),
    "mjpg_444_21x37.avi":
        ("video", "5d6ff6b9279f3d6e3beafcc1f5814c77091ebbf2c5ee9ba7babb99cef1ae1718"),
    "mjpg_cv2_64x48.mkv":
        ("video", "5253c9fe108a514773115f46be97431a0eb10d640ea202cb8c743dd49bb89f0f"),
    "mp4v_94x70.mov":
        ("video", "cbc173ff6f73ab4338dc849d127bbf1ed17083c28396d601a6768c77154fafec"),
    "mp4v_96x72.mp4":
        ("video", "9ee8076ec9d769027f921ceda40fe1fa1595d7f5901bae5720a40bf62b97e36b"),
    "mp4v_cv2_96x72.mkv":
        ("video", "776cab2da490e9273724349824999343d252058e8ffb164bcbbe3f46bf84482e"),
    "mp4v_fmp4_64x46.avi":
        ("video", "e53f003617163c686b9562590886b3dfae4eb2877bfeb28330d7764a9a9a8c99"),
    "mp4v_port_95x71.avi":
        ("video", "f383575216c51bd475c03849bfdfba1f0db59da5fe8587b36fd7db5f8dd40387"),
    "mp4v_port_paths_45x37.avi":
        ("video", "8efbc0710af0507fb2f4b1adb735f8402a629db89573bf8a2f7e9d6d046a5864"),
    "progressive_420_61x77.jpg":
        ("imread", "285d70bc5250bb7200de08c0b2dcd654476b010ba5bdb4a258c93c4e5476701f"),
    "progressive_420_61x77_cut2.jpg":
        ("imread", "8f37944d8833735ced289d8e275728702dad2f8a498cbd81a757c2b300a72437"),
    "progressive_444_33x40_rst2.jpg":
        ("imread", "526bd73ee57a14f666c6b711b803df46c0272491f18943ee95aa9fe8f3c9368d"),
    "progressive_frames/00000.jpg":
        ("imread", "8233a4cdc077b4b795297af2bef55e942c4738fdd7dcfc4238863a389f4e07d3"),
    "progressive_frames/00001.jpg":
        ("imread", "ad056f6c498aafc9f1298f0500bd7bb22437c215011ed57b0217252f7194e023"),
    "progressive_frames/00002.jpg":
        ("imread", "4d83a285f4e3c2c34939c17d5c0de73f88ef841da828b2eda8361288c488e049"),
    "progressive_grey_pil_45x50.jpg":
        ("read_jpeg", "8415dbcb09e0e3b474b0828189150afa9488c01eb5088537dc76a8aa1da9a3b9"),
    "vp8_altref_45x37.webm":
        ("video", "5cb2eb8918bb7206530162d1dfda3253063cd132bfdff754e0c32bc9f7d7bccc"),
    "vp8_audio_first_96x72.webm":
        ("video", "e89e5e6998a3a82030cd7818f8a071a5021159d05ceabe8b9e5a659ad9c49723"),
    "vp8_colour_crop_96x72.webm":
        ("video", "e89e5e6998a3a82030cd7818f8a071a5021159d05ceabe8b9e5a659ad9c49723"),
    "vp8_cv2_1080x1920.webm":
        ("video", "94cc636c609360696cccb433d76a562776bd0291190558469fe4231202561ffb"),
    "vp8_cv2_94x70.mkv":
        ("video", "a97302ec3a38ccf4d939fe28e3e9b9d28d60998b0b4c2c40e16f049f8b16d3e9"),
    "vp8_cv2_96x72.webm":
        ("video", "e89e5e6998a3a82030cd7818f8a071a5021159d05ceabe8b9e5a659ad9c49723"),
    "vp8_errres_seg_64x48.webm":
        ("video", "64e57e5317f64be866291ab56b8ed9dd5172c55b47746244bcb84860e5e063e9"),
    "vp8_laced_96x72.webm":
        ("video", "e89e5e6998a3a82030cd7818f8a071a5021159d05ceabe8b9e5a659ad9c49723"),
    "vp8_odd_p8_95x71.webm":
        ("video", "f28ea8f044973759793b390c8e8bd1f91e04a960b53a0909495d72feb26ef65d"),
    "vp8_unknown_size_96x72.webm":
        ("video", "e89e5e6998a3a82030cd7818f8a071a5021159d05ceabe8b9e5a659ad9c49723"),
    "vp8_v1_33x17.webm":
        ("video", "a52eb4f4a2ac084460a36955101262422bd59b5a40cd3e425b584c901acaec0e"),
    "vp8_v2_40x24.webm":
        ("video", "8a765590ad83d628389f143e8fc741986dd9303aabc0b19a82adab53db601446"),
    "vp8_v3_31x29.webm":
        ("video", "475e926eb3b8e038d42d82d89f0b4fa9c2ae4cbbefe8f62852925e1c5e740ae0"),
    "xvid_cv2_64x46.mkv":
        ("video", "a1d8371d92bcd8c134c58f6741415d5a4a671c2e8011d4bb2ffe3d1103fbe5e2"),
    "vp9_altref_45x37.webm":
        ("video", "ec17fc2b4206cdc2f308733b8fddfec36e2bb08ef80e9608911f5c2f4a495c4e"),
    "vp9_aq1_47x35.webm":
        ("video", "e9609812d90746f5675b95d15e82a4f473d5a0f63a98e96f153900a4f3d68d1c"),
    "vp9_aq2_56x40.webm":
        ("video", "642f0759573d385832e009a25659a66cd401a130fa84d9974e46693a5a6fb142"),
    "vp9_aq3_64x48.webm":
        ("video", "d026276f19576777b5931946ad31cf2f8ede0797e81683c03a5075c8777d4e3d"),
    "vp9_bilinear_44x36.webm":
        ("video", "f5a98f97e51675999e111cd3a37b4482482c9d471bf7f4339f8f09c0cf3b40b3"),
    "vp9_bt2020_40x30.webm":
        ("video", "5345756e823027994f07933fb4658b9881dba8109bf86af102fe98ca5372b9de"),
    "vp9_bt709_full_47x35.webm":
        ("video", "59f39c74b4e6eb71a6bef7acf0bb3d8c4e3abfddf295416bb2c0139779c123d5"),
    "vp9_colour_96x72.webm":
        ("video", "bad9fb5a999f126d0274b9023ed3b3a911bb34df3ea327301ea4c1aa20ea7739"),
    "vp9_cpu0_29x31.webm":
        ("video", "e385fb2eb05d57f92e56151a1eb39e7ac7fe67c69499b1b378253a5298c527c3"),
    "vp9_cpu5_50x26.webm":
        ("video", "062c9a59c79af74e25f69f9b4d684a590aa3806cc722e38fa77c9e5462d6f0d8"),
    "vp9_cpu8_41x33.webm":
        ("video", "fc77d88f1916d9dc9f664b6b1a1bd2fb70094b5fc56d76dc2d01d9c40a95d654"),
    "vp9_cv2_1080x1920.webm":
        ("video", "71da7a0b755496a9a844d4880f8cf2db825b9d1e31fad7e3b4ced5bab5081fb1"),
    "vp9_cv2_30x28.avi":
        ("video", "50daa30adff1e869dcc52597325045c52e5ac7ef9673c244a71446ce7f47b98a"),
    "vp9_cv2_44x36.mkv":
        ("video", "043f1cb7e43748fbde7e6dee76f038715b2f88298c4ea80dc2f1072b984e3c45"),
    "vp9_cv2_96x72.mp4":
        ("video", "8e9f5622467acc13f9626459b627229af9b1b9ca74d3794c391d245b9c5ade27"),
    "vp9_cv2_96x72.webm":
        ("video", "bad9fb5a999f126d0274b9023ed3b3a911bb34df3ea327301ea4c1aa20ea7739"),
    "vp9_errres_40x24.webm":
        ("video", "5cceab631723280bc8bc4b61cab3420d3aa7411b8336924e1a706a496dffd871"),
    "vp9_lossless_33x17.webm":
        ("video", "f3409dc68cc47f94d2f8ddd4596173f1dac59f979e3024e3af0dd0f5950ceeec"),
    "vp9_p1_422_46x31.webm":
        ("video", "b2527df6dadae4ff610dde79fec38544e9b7a8a22edbfad519e3db4b34e744d6"),
    "vp9_p1_440_29x38.webm":
        ("video", "72ec87c6e94299827dd7589ac30e83dbe0321b88027653f82c8b4ef76b30d5bf"),
    "vp9_p1_444_45x37.webm":
        ("video", "ff17fe2bfea12ec2a4209ed38eec2fc120d322efb721a36c6a0c1bd09d322588"),
    "vp9_sharpness5_48x40.webm":
        ("video", "d0f9ce9bb3a1798ffcaf5ffac12c6eabdea1e8211349eb5baefcd7d2711d7b17"),
    "vp9_show_existing_42x30.webm":
        ("video", "7b73f7f70d8bd850e947a9cff12e5984d57116c9d3fcd612e12c7f42e883dcd1"),
    "vp9_smpte240_444_23x19.webm":
        ("video", "5dcce2323274eb35304087a3a1e5c7014481e250f769113456edcc6ad57544a9"),
    "vp9_tilecols_520x40.webm":
        ("video", "402723d536c36bda4c9b376df022e20e8fefe236a1fb9501b3ce53448576b03c"),
    "vp9_tilerows_48x200.webm":
        ("video", "fd38271bc655a55a38cccf9b3b045b1edd5f101efb53b29d2ea5b4ea690b0d7c"),
    "vp9_vpcc_96x72.mp4":
        ("video", "8e9f5622467acc13f9626459b627229af9b1b9ca74d3794c391d245b9c5ade27"),
    "mjpg_cv2_64x48.mov":
        ("video", "32d03363a57454e70e55f01633492bd5a3f8781f44d0c45ae98de6e7cf68d2f8"),
    "mjpg_cv2_64x48.mp4":
        ("video", "5fb5fe0946db5acb6c9064b5a1e8d3be10a6213d3ec0caf735a67c21c4abe80a"),
    "mp4v_cv2_96x72.ts":
        ("video", "b48da281e2c610ab6ab960ff73cff0e3897978a1c5c128c91f2d971d6568db7b"),
    "mpeg1_bf_45x37.m1v":
        ("video", "641dbb7831ba1061c7ec181e3dab079a9fe4a6ea7dac8c2755f5c94c6b7764e7"),
    "mpeg1_cv2_44x36.m1v":
        ("video", "e6a1d7dc3f3e7e7375da76568665ab4b9a6f5bd692bb92627f937fe20bac4879"),
    "mpeg1_cv2_96x72.avi":
        ("video", "c0c218ddec090632b831decacca7990839c53c090909a7282fe307831232ecc3"),
    "mpeg1_cv2_96x72.mkv":
        ("video", "e72345660454d7307f958410311c1c6efff320de42c8b330e02ffc8fc631b66f"),
    "mpeg1_cv2_96x72.mov":
        ("video", "00cd4df97b06329677843b5b319a23789051d513251adb596fedec35a5c70bd5"),
    "mpeg1_cv2_96x72.mpg":
        ("video", "4b3ad9992e4ee9f13e8be4bb6372e288e64f9b91af94276ae8e44f35602674c4"),
    "mpeg1_cv2_96x72.ts":
        ("video", "535b948ae544e98eeca4dc0ff0d30696c2deed4159818000d58fc0ef8bfa25a3"),
    "mpeg2_aq_95x71.m2v":
        ("video", "e1f6c9159a76095ed9c2acecefd590e51334fad84c3169318aae799c345555e4"),
    "mpeg2_bt709_dc10_47x35.m2v":
        ("video", "7ccdada8c8ca9782bd20e3c0ed9c3ed07ed9257d98f886d008cde0a8f59fb25f"),
    "mpeg2_cv2_1080x1920.ts":
        ("video", "7de399df0d2e3c9e47e0daaa0b0795dd8e11aa3581acd4f9be8eb34d7cb0b75f"),
    "mpeg2_cv2_44x36.m2v":
        ("video", "c4b6de4e330ea27098c4414625342b9045d2f65eeeecbdf7ef3383317c6af93e"),
    "mpeg2_cv2_94x70.ts":
        ("video", "581ffa4d77415629e92461dcbec304df2d559b89a45c411242de429f0ca03edb"),
    "mpeg2_cv2_96x72.avi":
        ("video", "8da64007f30a8074a58c6257929abbf47f55a056aa360d77600f4fecb8341181"),
    "mpeg2_cv2_96x72.m2ts":
        ("video", "79e26038534c39bb0c3a8cce33c9310bd4ddbe10947c8b41b12a6c0a2b92f159"),
    "mpeg2_cv2_96x72.mkv":
        ("video", "dd670eda9ec25337f217681eb980e5adb84d18188a0b534a46d6000f1b5d67a1"),
    "mpeg2_cv2_96x72.mov":
        ("video", "9ba249149572c30497f74ddbb8c4a9c3ec8152e7cad803e0a5142442e0b35a07"),
    "mpeg2_cv2_96x72.mp4":
        ("video", "a96af61bed1f604b3862c7685b8973025d140e2255c0562753ca5dd2480c468e"),
    "mpeg2_cv2_96x72.mpg":
        ("video", "ec7406062f22add6a4377c68afcdcbcaa3171f5ad87cfb62a69160139b48c1d6"),
    "mpeg2_cv2_96x72.vob":
        ("video", "d9b9cd12a61cfded775bfc3cbf16cfde8aacf55a3ec201447d17236a7feb45b3"),
    "mpeg2_field_48x40.m2v":
        ("video", "4c257c677bcfece903bc04a2c0ce0d68dd78610c7fee54059d38672085524a65"),
    "mpeg2_matrices_dc11_64x48.m2v":
        ("video", "805fa3a8e80ddeae5ed93f9c18874431e5a2b0d0c67e7d9c6df212fa1d47d340"),
    "mpeg2_scan_vlc_q_96x72.m2v":
        ("video", "e66e25ce4f0c6c7ab41b67a185a4e569a13405756ac51abc791ef0be814259b5"),
    "mpeg2_wide_720x48.m2v":
        ("video", "47f883c5354b20d323fc30d287fc19d1512968734a355030badd338ac74e1957"),
    "vp8_cv2_64x48.avi":
        ("video", "819b67a58f7416e12397eb72512563a6686dd802639c2e71e352843319d44b3b"),
    "ivf_vp8_cv2_96x72.ivf":
        ("video", "b8a9212765fc8509e2b03889e29183e907eab0c4da747159e8e890e573a7ed2b"),
    "ivf_vp9_cv2_96x72.ivf":
        ("video", "9f3fa159c1528eff6216cb824208f8b2280a9ef220e5bb17c442b1d84da3af9b"),
    "bmp_1bit_37x53.bmp":
        ("imread", "9227f77e08a5964ea43c042a0c3c704e03bdd62f496049440c84287c1b4e9d29"),
    "bmp_32_29x31.bmp":
        ("imread", "52a4eb3ff40f8ef1adbb6d2dbbcab9b81d79e0d71574b17969af2a5a1a64cd30"),
    "bmp_4bit_29x31.bmp":
        ("imread", "49aa09f8662f762614d4e8e04038fc6a670ae7403361caaaf8bbe02d121f07a8"),
    "bmp_555_29x31.bmp":
        ("imread", "90e81a8d274fe497de32c369225b80bdf3bb9f3d03d7a5a1ece1859560414594"),
    "bmp_565_29x31.bmp":
        ("imread", "b02a12fe3ae290cb5a5a57e5f386e8254e3ad28d34c08f1e999c6d7048a7d554"),
    "bmp_8bit_29x31.bmp":
        ("imread", "bb451e18fa47e7c5ade7d8fb106fa8700a7a1407312815eeb4967d65101db105"),
    "bmp_cv2_24_37x53.bmp":
        ("imread", "aceedc0beb0db32ca6aad7bdf21bace33df1f78ee0260a2ddfa3d9bd1bae94b8"),
    "bmp_cv2_grey_37x53.bmp":
        ("imread", "f6062d819f5b336ea90bab308a343895b8e32a45acf32b7810b695ce2408ba61"),
    "bmp_os2_24_29x31.bmp":
        ("imread", "e16df3f099095d079d02732e9dfdd7fe4a5782eeb5277b20af1850e6995f9307"),
    "bmp_os2_8bit_29x31.bmp":
        ("imread", "0dfa5f25941cb959044a292e2e0d6794a19f1fe2013c7960ca9faa9ea4330453"),
    "bmp_rle4_40x30.bmp":
        ("imread", "32db6c6f4007e1153a81c9363369674472be7df9f19f1dda7e41a49b9698497d"),
    "bmp_rle8_40x30.bmp":
        ("imread", "3b7560f911f9198a77257533723408019477b3788642f843d845b3a0e9f543cc"),
    "bmp_topdown_29x31.bmp":
        ("imread", "e16df3f099095d079d02732e9dfdd7fe4a5782eeb5277b20af1850e6995f9307"),
    "bmp_v5_24_29x31.bmp":
        ("imread", "e16df3f099095d079d02732e9dfdd7fe4a5782eeb5277b20af1850e6995f9307"),
    "bmp_v5_bitfields_29x31.bmp":
        ("imread", "915650e121bbbdcc094d550338d64fbfa990fc299373326e776f77eb72b52349"),
    "jpeg_cmyk_29x31.jpg":
        ("imread", "3e2e50fdbde3d24edc55a212bfdb0d0fe8b23d980f31b4a3e06f3da6a7e20378"),
    "jpeg_cmyk_noadobe_29x31.jpg":
        ("imread", "3e2e50fdbde3d24edc55a212bfdb0d0fe8b23d980f31b4a3e06f3da6a7e20378"),
    "jpeg_exif6_37x53.jpg":
        ("imread", "ea7b8ffe12761bc1312e0167aea1509dd7ebcf5d42c4431010d862b9d2e7dee5"),
    "jpeg_rgb_29x31.jpg":
        ("imread", "f7dfe47aae1c29dc64734fcd4272c28bb20e744478d056c9ef2c30dce74d8d89"),
    "jpeg_rgb_progressive_29x31.jpg":
        ("imread", "6fa40875b30672c138f8db00b3b172634fb2f39a524832d2244a5f245551aa6c"),
    "png_exif6_37x53.png":
        ("imread", "9772891e078ccce8801bb8f882ed2a0cbbba059a98b264a37b85001cffeb42ee"),
    "pnm_cv2_p5_37x53.pgm":
        ("imread", "e99e7ed16655bca63578ce91c0321e4707eeaf78f0252c2803737c3c9fb653d3"),
    "pnm_cv2_p6_37x53.ppm":
        ("imread", "aceedc0beb0db32ca6aad7bdf21bace33df1f78ee0260a2ddfa3d9bd1bae94b8"),
    "pnm_p1_23x17.pbm":
        ("imread", "d27d8609aba9a4ecc7393e7a2c040deb7f74c23cf5c4b3e4e24eaa698d3d50be"),
    "pnm_p2_16bit_23x17.pgm":
        ("imread", "ec756987c88665fb99affaebef225c213c9203e08316a71316725307e1335eb2"),
    "pnm_p2_23x17.pgm":
        ("imread", "c9f31d7d7264cc309d9a1523907a6bb4ec5d12a12d54a1a53b804ef5ba8cf70c"),
    "pnm_p3_23x17.ppm":
        ("imread", "c38099dbe74c8c2beab7f5d9954d8ba3bb44eb93b573e8ebccb5d6bb91b85cb0"),
    "pnm_p4_23x17.pbm":
        ("imread", "92e2db36daf5f2417b3e07692b1b981994677e89ee9121b32f7f847abac847f8"),
    "pnm_p5_16bit_23x17.pgm":
        ("imread", "7d38304da8914fdb8826877f083a7cf5c807d442335bd4b7f419021f2844521e"),
    "pnm_p6_max100_23x17.ppm":
        ("imread", "fa096c9ff8c575f57a711d54830fd9f904bcad5fe0af78207f1ddafb8f925e39"),
    "tiff_1bit_29x31.tif":
        ("imread", "798d9c942ad4c409a4a68157834f02602c89a08124c0c97f81873606cfa2b24f"),
    "tiff_1bit_miniswhite_29x31.tif":
        ("imread", "c030f21f3386696901fc29891a2bbd60a5ab04eb3d384b0a1d46b9b5a86e5e04"),
    "tiff_cmyk_29x31.tif":
        ("imread", "1e10e9cb24d8c40dc05107f72aa81dd0e1eaf44f2c203c3d5b92bd64e47b5a74"),
    "tiff_cv2_1080x1920.tif":
        ("imread", "1f41793533290f7c00314f85fc145c69f7c73a55d6a85b6a6deac10283173345"),
    "tiff_cv2_grey_37x53.tif":
        ("imread", "da8c7de10b174efd939e2f7f510b49fc557970646a1f2e6fe82bde4361b361c0"),
    "tiff_cv2_lzw_37x53.tif":
        ("imread", "aceedc0beb0db32ca6aad7bdf21bace33df1f78ee0260a2ddfa3d9bd1bae94b8"),
    "tiff_deflate_29x31.tif":
        ("imread", "1e10e9cb24d8c40dc05107f72aa81dd0e1eaf44f2c203c3d5b92bd64e47b5a74"),
    "tiff_grey16_29x31.tif":
        ("imread", "67d7f23451c7e7e4c889748afe2e7450d3c50a3bd0830ba9fde4a88be2196e80"),
    "tiff_la_29x31.tif":
        ("imread", "5b9b706484b481db03194c0651cf032a2f17ad73463917beb537e6e64f988746"),
    "tiff_lzw_29x31.tif":
        ("imread", "1e10e9cb24d8c40dc05107f72aa81dd0e1eaf44f2c203c3d5b92bd64e47b5a74"),
    "tiff_miniswhite_29x31.tif":
        ("imread", "85b7c585daa100bbb8c578cf867a111247640139f00b03bb4e71cb3ed9b45959"),
    "tiff_orient3_29x31.tif":
        ("imread", "07fed191230a53b5d10c0f2888c7fe81308fef3ccedfa3b40a838b60acf20e42"),
    "tiff_packbits_29x31.tif":
        ("imread", "1e10e9cb24d8c40dc05107f72aa81dd0e1eaf44f2c203c3d5b92bd64e47b5a74"),
    "tiff_palette4_29x31.tif":
        ("imread", "f97601432e647432e1d6071fe140447a4e7b5500c991528d2ad39f490746f84e"),
    "tiff_palette_29x31.tif":
        ("imread", "595da5fd1503de86186219b0aa2edf0d11b94f4b748cb1839e46cfce2790e859"),
    "tiff_planar2_29x31.tif":
        ("imread", "dce24a37a55eb9471914043708b948e02cb0359b7b495d6d318f7dde1ca3daca"),
    "tiff_raw_29x31.tif":
        ("imread", "1e10e9cb24d8c40dc05107f72aa81dd0e1eaf44f2c203c3d5b92bd64e47b5a74"),
    "tiff_rgb16_mm_29x31.tif":
        ("imread", "4d4fca3ca11eb3bea328f2742e4f378872f242e0421889b259b150a3c89cdf7a"),
    "tiff_rgba_assoc_29x31.tif":
        ("imread", "db69ab455e1ce2a724adb301e5f07bce69fec1ae8deeb924d652d7960b707e52"),
    "tiff_rgba_unassoc_29x31.tif":
        ("imread", "ab03b5e61b3e2755feda537078e578d9602e130ffc17986780eefc3316fb3e82"),
    "tiff_tiled_50x40.tif":
        ("imread", "353510cd9cd6a6c94b64f2b310c7d2d27d6172fb0b164f8facdb51e06eb9dcf5"),
    "video_jpeg_exif6_37x53.jpg":
        ("video", "a465c64637f5c15ad2070cb2f91aa98eed5d189d21740221dd290fd4604cbd13"),
    "video_png_exif6_37x53.png":
        ("video", "d960604eb6c95797ccf7ffe45a30fc9912cb271e3147555deea4a3a15e414b1a"),
    "video_png_grey16_37x53.png":
        ("video", "53240e39d21880977158a6751af554f21fbe6b04ed762eb7e1772c12507948d0"),
    "video_png_l_37x53.png":
        ("video", "ccbd5e2db98e793714f9f7fbc283fe1ae2091d8b5125a936a24f7751ddcecbc2"),
    "video_png_p_37x53.png":
        ("video", "6c6250617052718f61406930312c3ed479b1ceedff8f730f889ffbd56cb31b2c"),
    "video_png_rgb16_37x53.png":
        ("video", "5fb2b93f1131fff7316499b70139ff92c1a9911e29a347574c45a7f680b76189"),
    "video_png_rgba16_37x53.png":
        ("video", "eeaefbbbf6c20ed3ef4ad85186cf589e69cf0f86f3926d7f1303cc91bb559fae"),
    "video_png_rgba_37x53.png":
        ("video", "d960604eb6c95797ccf7ffe45a30fc9912cb271e3147555deea4a3a15e414b1a"),
    "video_seq0/%05d.jpg":
        ("video", "082fb758427cb0b0f686fa065ca83e6e0d1bc1911c904c6cb01235955cebca90"),
    "video_seq2/%03d.png":
        ("video", "773f59064d8cbfb25f25a498064ad2bc4df8c4c56ff6105e363e1f406877f2e7"),
    "tiff_jpeg_cmyk_29x31.tif":
        ("imread", "6986c5f06127bdddd4f89a4c7f55466d3fde1e501ac182943c02790881bf3e24"),
    "tiff_jpeg_l_29x31.tif":
        ("imread", "b4fbe48c7703b4853199b1ad48417df0145b26d9ccabace5d5f0b649dc107b8e"),
    "tiff_jpeg_la_29x31.tif":
        ("imread", "b4fbe48c7703b4853199b1ad48417df0145b26d9ccabace5d5f0b649dc107b8e"),
    "tiff_jpeg_rgb_29x31.tif":
        ("imread", "f0f152eed362cf6a60b6e6c88caf115bce8a2d3110e056eb3e559f736d6d2230"),
    "tiff_jpeg_rgba_29x31.tif":
        ("imread", "577bfd137f4df5f419d7a65ea4bf1c8ed5afa9c3e386faae266918468668ece1"),
    "tiff_jpeg_ycbcr_29x31.tif":
        ("imread", "e6ce0e0a7460f629acb8cc4231da6550f5eef5d60a0cc393713dc2376a5e99d0"),
    "gif_87a_53x37.gif":
        ("imread", "bd126d55f953dbe73444f6299534a09c970c3e1583d65ebf320638fee2227d7b"),
    "gif_clip_1080x1920.gif":
        ("video", "c670413e47d05477a52108eaf979098e3b609f62bd415ca24a2edc4556f13453"),
    "gif_clip_87a_three_images_32x24.gif":
        ("video", "c4dc74ab03954a146f3f7df70799604efefe2f4ef186056a6308e9b781aba7c1"),
    "gif_clip_comment_third_32x24.gif":
        ("video", "0ed4ca432f8017f61a69ef11e7185e9f100091047d5e5e0e38076f933e408129"),
    "gif_clip_disposals_53x37.gif":
        ("video", "8c407389f03d990716e3a1638899eeee30b642a69976f7b6cf9ebe4ec86cb249"),
    "gif_clip_local_only_53x37.gif":
        ("video", "dae21210ebba72524f9041a7c6b383b8d02c127628dbe65356185bf846e96249"),
    "gif_clip_one_transparent_53x37.gif":
        ("video", "d3aeadec34e1b9a43881a977b90cc622db7f64cf4bc238d06c9c424c516c437f"),
    "gif_clip_pil_disposal0_53x37.gif":
        ("video", "25864241797a220e7c3b505679233dd05db9f9a2f6e1ebdfd215fc08a645b108"),
    "gif_clip_pil_disposal1_53x37.gif":
        ("video", "25864241797a220e7c3b505679233dd05db9f9a2f6e1ebdfd215fc08a645b108"),
    "gif_clip_pil_disposal2_53x37.gif":
        ("video", "25864241797a220e7c3b505679233dd05db9f9a2f6e1ebdfd215fc08a645b108"),
    "gif_clip_pil_disposal3_53x37.gif":
        ("video", "fcf5c19dc168021745267a515e88462302e6813f27c017a54592bc845d750b87"),
    "gif_clip_pil_transparent_53x37.gif":
        ("video", "2e77b9a9c322ed19cd922554c5f626cf036431a0dc7edb532a999bc0a073d841"),
    "gif_deferred_clear_64x64.gif":
        ("imread", "72123ed115e2c598f18f7b7ec2d2e3a98a40dbef657f04d767b1c5229d50a44f"),
    "gif_full_table_64x64.gif":
        ("imread", "72123ed115e2c598f18f7b7ec2d2e3a98a40dbef657f04d767b1c5229d50a44f"),
    "gif_interlaced_53x37.gif":
        ("imread", "bd126d55f953dbe73444f6299534a09c970c3e1583d65ebf320638fee2227d7b"),
    "gif_local_53x37.gif":
        ("imread", "a7cc0eaf39dce7c9d73eecdb48ec6c4343e0063a914b323cc22f3fb29749cc1d"),
    "gif_local_only_sub_53x37.gif":
        ("imread", "b7eb88218a939cacda02aa31ea1b852c9780b830e391aec277f164ef6c633236"),
    "gif_pal32_53x37.gif":
        ("imread", "0829af97bf9e9663937754db5538abcf57a0382677bae0fe65664f9244e61dd8"),
    "gif_pal3_2bit_53x37.gif":
        ("imread", "dec02ab27c288adf410aa1bae4243425a7db490ef3eae64e6c98bc63b3c533d5"),
    "gif_quantized_53x37.gif":
        ("imread", "e9c986d600484f5c3a2d76b3184ba959b00c7985ed70dfde0183bd20e9fde225"),
    "gif_seq/%03d.gif":
        ("video", "611c62aaf8cb88140350f0acb4b5ee3a49b0e6e9e004931966af8ec6443a3ed7"),
    "gif_sub_bg_53x37.gif":
        ("imread", "08afd2e171feee285bc6176094bc3cd2f3f8834b66e6cf867c76d10044a11b28"),
    "gif_transparent_53x37.gif":
        ("imread", "08403c5d434cc4f4e5a73c1067d80f4eb26a204629030aeaf116a7eb56fbaf5c"),
    "webp_anim_lossless_53x37.webp":
        ("imread", "979c4a44f3a87fad16e8f3dc987388d90a45e4160c3bbe04b1264b510a7d8bd0"),
    "webp_anim_lossy_53x37.webp":
        ("imread", "45356ecd05eb231ac381659a6d4bd2fc584106f885b67ba4a23c03082e4490cf"),
    "webp_cv2_lossless_53x37.webp":
        ("imread", "97855150b8a25ca5c399e604fb57415d5b1291511cbb1d68ad318d03cb7b2819"),
    "webp_cv2_q90_1080x1920.webp":
        ("imread", "9109bcbbbb0b01b38d236ed8252f3c0a9ee2a18421870168457afcd1e0c871e2"),
    "webp_lossless_alpha_53x37.webp":
        ("imread", "82d17cc091f2da59d4db84272959300e7e684fa48f058423eb6be1e91b2e60c0"),
    "webp_lossless_cache_128x96.webp":
        ("imread", "e9696827a32e299626c3518bcf99cadd6312f106418a039eb9db8d0472e524c7"),
    "webp_lossless_m0_64x48.webp":
        ("imread", "c4643fc7c130713e3c29ad1d726e2fdf83fc12a5c39b780b51c958f240c2c5c3"),
    "webp_lossless_meta_128x96.webp":
        ("imread", "4df9c2b72e02e6ff9bab12bdbb80a3027f5b076e71d9ade8f7db539302d15af6"),
    "webp_lossless_noise_29x31.webp":
        ("imread", "39820eaaadef2a083ad64d45a59d01bf68cc112f723419dbe2af5b83b8659577"),
    "webp_lossless_pal16_31x29.webp":
        ("imread", "021a8fa90a30225c34848528634f1e3c87031ea5415df5bb60039fe27dfe724b"),
    "webp_lossless_pal256_31x29.webp":
        ("imread", "92b139426cb60775d003e8161345b2f7cc6220b725ab71ea87cd78a285ba6bec"),
    "webp_lossless_pal2_31x29.webp":
        ("imread", "a0a38b33e65c377c7f020c40078805556123f2f8ef90cb933a64b14015037cf2"),
    "webp_lossless_pal4_31x29.webp":
        ("imread", "b8454a6eeeaa9e9fc472ca47fa474811c0e662539d0eada4c043ecbb6e3b40f7"),
    "webp_lossy_53x37.webp":
        ("imread", "a36ec55302ac6c47ef2eb6eead01e906a6ad227b157cf9d1edc8ecf8331657ca"),
    "webp_lossy_alpha_53x37.webp":
        ("imread", "a4c5d1c72d2e4e066d2b786c316090bd6e1094835993a4fd59840d9aa3a9c927"),
    "webp_lossy_exif6_53x37.webp":
        ("imread", "ef73561141c9473ba58207bb83353432ba06a104e77f65b3ed765ffd3900d964"),
    "webp_lossy_q50_33x17.webp":
        ("imread", "644ba7be12d35a598654c11c5c151d835e36e82fef30dd0e5219349c13e5182c"),
    "webp_video_cv2_lossless_53x37.webp":
        ("video", "97855150b8a25ca5c399e604fb57415d5b1291511cbb1d68ad318d03cb7b2819"),
    "webp_video_lossy_53x37.webp":
        ("video", "0b8e323c6efcadebb7211a2d36007f0d6c9b93e83110aa1bc2e8a07057c3f9c8"),
    "webp_video_lossy_alpha_53x37.webp":
        ("video", "88e2393f4d346a25f90cfa197f26882b5e9dbe43996ebc6d5c4fc660d011cfd8"),
    "webp_video_lossy_exif6_53x37.webp":
        ("video", "6c5869f4514332accfeacf23ca89cdcd6fbfe632196bfae8c030adcb3225b3cc"),
    "webp_video_seq/%03d.webp":
        ("video", "587dcd0d3866d3dbb3a9837392b709469fabd35fe696e4db2fa4d0e15b1b5ee2"),
    # VP9 profiles 2-3 (10 and 12 bits), PNG and raw frames in AVI and MOV, and
    # the corrupted lossy WebPs libwebp reads past their chunk
    "ivf_vp9_hbd12_440_36x44.ivf":
        ("video", "8c1516674dbe27574a638ee6b729c51a9d831ef933a3f8744d8020120dba3941"),
    "lossless_cv2_grey_46x36.avi":
        ("video", "39a874e95ca93962f22b9d996cb3153336b3764229182d0d7851f413a3cdfb28"),
    "lossless_cv2_i420_46x36.avi":
        ("video", "21bf453dd3347da33012ef8632d009284c72c5292b082820717826b21574ae2f"),
    "lossless_cv2_iyuv_64x48.avi":
        ("video", "80dcc352127ce2f504697ba27335c16f503a6e50a4119c4ae25c11f15ae5e06c"),
    "lossless_cv2_mpng_46x36.avi":
        ("video", "38588f87925681503d4061f0be85186d7111e00cc72a9754c73c1ede30fd958f"),
    "lossless_cv2_png_42x30.mov":
        ("video", "c55b658b9033ce5c76b1585b7206e85a291adf7ebd70e26e3966c74207d25d2e"),
    "lossless_cv2_png_64x48.avi":
        ("video", "5d6adb1e488cdede0ceef0dae2128b965f687b33bbdbb8d7d1da1d7e28620449"),
    "lossless_cv2_rgba_46x36.avi":
        ("video", "aae805455396ed016619bdff806ed875cdb398fbc799e676d8ed30e342cb4087"),
    "lossless_cv2_rgba_64x48.mov":
        ("video", "893928ba82e07ccccd5d9d261eff44ae482f68ff6f6c1905c5581e02ababa13f"),
    "lossless_cv2_y800_64x48.avi":
        ("video", "f900b92b5623ad59c76e5ad5a44cbcd3c6c337cee1255f089759e092f3183dc7"),
    "lossless_cv2_y8_42x30.avi":
        ("video", "60296cda2cbdafd38d6bf53ec41aa71d69f81de2f30c02ec34c8bb07fbb4812f"),
    "lossless_cv2_yv12_42x30.avi":
        ("video", "bf68f7e9a343605b1b9c9804950a0cd1665c0542ebdea51de321eb949f28f924"),
    "lossless_grey_45x37.avi":
        ("video", "97662766233a4c2f90cf65cef1d80c7f3469c6bcc2c0e35be73c5d849ef29ac2"),
    "lossless_i420_45x37.avi":
        ("video", "f0c50615135ec5b398241852a7339ecaf16e12d6273156c6b3fa0e660a126e05"),
    "lossless_png_kinds_31x17.avi":
        ("video", "4c7505e1c0797fd5134fb2c8ce5e6477dfd6a5112c01a66f4c13ed7e52097633"),
    "lossless_png_pal_45x37.mov":
        ("video", "30dd0f728ad2b07aebc39718630f70fcf7a0846d55cf5ce93149439a51f52bc8"),
    "lossless_png_rgb_45x37.avi":
        ("video", "704b44653b21b9ab80c42dbee5f8b37d513ad4960913b1cf8fc28a74c45b731e"),
    "lossless_rgba_45x37.mov":
        ("video", "704b44653b21b9ab80c42dbee5f8b37d513ad4960913b1cf8fc28a74c45b731e"),
    "lossless_rgba_topdown_45x37.avi":
        ("video", "704b44653b21b9ab80c42dbee5f8b37d513ad4960913b1cf8fc28a74c45b731e"),
    "vp9_hbd10_1080x1920.webm":
        ("video", "bbe0cdca97187af1b6bcf8f29fdea484a1d9aa15d7a1a055d46806fc90a90e1b"),
    "vp9_hbd10_30x28.avi":
        ("video", "68a35ea2b1524d05f2a0cf612f55199563063e5c700049674ab6d68e3c6f8bd3"),
    "vp9_hbd10_420_64x48.webm":
        ("video", "053ef0c052789a3cb1a8c11bc7acaf73c75367db5b380e877ec7139cdf20c4f7"),
    "vp9_hbd10_422_45x37.webm":
        ("video", "d2a4b131b2e323d54b678ea1d37495994f22316d68899a936076273293325b9e"),
    "vp9_hbd10_440_29x38.webm":
        ("video", "22837ddd75fef4d2b5b76b227c881877acfe1720733715216519f6b2fdcfda09"),
    "vp9_hbd10_444_40x31.webm":
        ("video", "e73232ac74537077b953b30497155fb6e294f39381cf07cb7f72512774b902b1"),
    "vp9_hbd10_44x36.mkv":
        ("video", "2666c1f5fa74e740eb8bffd2f4d058db18fd79a229b79dfb757fa15551e71bce"),
    "vp9_hbd10_altref_45x37.webm":
        ("video", "af104f3adb3299f27309c427662d3ed64dc1deb9a8792e4474c5f113ae24b909"),
    "vp9_hbd10_bt709_full_47x35.webm":
        ("video", "dc9b2161280fb074704165a638a5638af4533193721347318c5c92a64fd98111"),
    "vp9_hbd10_lossless_33x17.webm":
        ("video", "ecdbd58cf55694a24554d35d13c54d538bde30c310ede23c6a14e2b933b486ba"),
    "vp9_hbd10_tilecols_520x40.webm":
        ("video", "aaec0b1fcd72083efad15b45702c9be3ee892234143a8677a4f1e59de9d73ca7"),
    "vp9_hbd12_420_45x37.webm":
        ("video", "7c788fc5dd7a9786280c59cfd3a934f038673d08613f408c620d8a8c44417ad4"),
    "vp9_hbd12_422_46x31.webm":
        ("video", "f09d437ad4041ff38dd16912e5fe2c2e2fe0de1f7ac9b1d6a588a2978a446d5b"),
    "vp9_hbd12_440_48x40.webm":
        ("video", "02096b3b38eb21cef96eb272cc2344c12a99c0339cf98b877ca80f7989b11121"),
    "vp9_hbd12_444_33x18.webm":
        ("video", "57bb2aef7fc018e738ebe68eb77939632dbfae08bf6e5ce8fd3186447e14ef84"),
    "vp9_hbd12_444_64x48.mp4":
        ("video", "e91256960b52938c958e6ee8e9931241c26935a921fc2d931879c02a40105b19"),
    "vp9_hbd12_bt2020_422_30x26.webm":
        ("video", "3158dadc74b2ea8884b82c8ecf082206dd746a3068235926f2de72483b887841"),
    "vp9_hbd12_errres_40x24.webm":
        ("video", "af90405a79cb35418fbcc93ef84d5021d46147ef4adaf949908e36037f9f05e9"),
    "vp9_hbd12_lossless_444_23x19.webm":
        ("video", "a2cc2a238d059ec1d86942c73ed32d15d0609e34ca8c4f46e0208ddf3002bfde"),
    "corrupt_webp_dup140_53x37.webp":
        ("imread", "2b4624dac149cc3d694a4db99004137e287ff6c71021140708a3efdffdd1232f"),
    "corrupt_webp_dup244_53x37.webp":
        ("imread", "6108675918cce4c59c13e20ed85afddfaab4130b866439f1f3f08e40b520ba66"),
    "corrupt_webp_dup372_53x37.webp":
        ("imread", "ba9b3272cc679c95b1163a3a78aca351c8d1a60a62ff6eb76efeb144c8ce441e"),
    "corrupt_webp_dup407_53x37.webp":
        ("imread", "99e62e5791196f83c8313f14fedd5d2e67d2b9e8544f5688129392d265e50254"),
    "div3_cv2_80x64.avi":
        ("video", "cb298eb14f764915ad462ca37f9c25c920660111c8c6fe8febe518e4f7911f6f"),
    "flv1_45x37.flv": ("video", "2be4a86deb16bb9f2fb6f0ad09c37b0f663d56904ed00fe27842713fcee8f950"),
    "flv1_cv2_160x120.flv":
        ("video", "2f1ec22c2bf12e5efee4edae4b9050c600e8ee3619c5d805d55ccab29b967298"),
    "flv1_cv2_44x36.flv":
        ("video", "675e587f03cf4d5a5c048855e4455583c9c3fa6c620eb7b15b8b8f28cb1b8cf0"),
    "flv1_cv2_64x48.avi":
        ("video", "19f7b8ab6af6475c9c85650c8506771a485fb1759fdf17e017cbac62d3f21367"),
    "flv1_cv2_64x48.flv":
        ("video", "479099651f0eefb8112da738fab38f20be27df96a82197edc75c5d13e91f57cb"),
    "flv1_cv2_smooth_1080x1920.flv":
        ("video", "bd3b3d41adc210670bc5e24d1837c8c707363eab20ef8472b6a55c3249e4164a"),
    "flv1_cv2_still_64x48.flv":
        ("video", "6792f76ccdb8b6b427d25ddf2d13b4a6aa77598a05fd7da916b50e5cd4aa2ebf"),
    "flv1_disposable_64x48.flv":
        ("video", "50d97a9b4a248239edd8ccd7ea741a8317ebdd0792d1285a23cdcc83fdb4a8c8"),
    "flv1_format0_176x144.flv":
        ("video", "65f6b1a1741f7e83a723906c7eb144b266bc26063675763efd6e942322df1470"),
    "flv1_q1_64x48.flv":
        ("video", "22289958061d1462afb8d3775044190d958382a734173103c3f55a017121bc85"),
    "flv1_q31_64x48.flv":
        ("video", "a32c799513ec042e82e8dbf0f08b3f9150fed49bb8d5dca75dfd8baf6e602a4a"),
    "h263_annexd_176x144.avi":
        ("video", "e62a78f0078ef9e977f1bac71f0f0bf08318c624895dd73b03472ab44de53fc2"),
    "h263_cv2_128x96.3gp":
        ("video", "a8794691a1b3a791bfd77ed701122fd170d60336a7becf0d7f7755d52dac129d"),
    "h263_cv2_176x144.avi":
        ("video", "9ad3002e1aa18d2a8b1515d006ba187f76591d428423c02bf1c60033e9e4f6a2"),
    "h263_cv2_176x144.mov":
        ("video", "998a006c89e0630729ef0316fde219cf8855fd17dcabe3ad90dfae5f3dda8e50"),
    "h263_cv2_352x288.avi":
        ("video", "3b14ad2d3711e1b8209b77d090aebfa614212f35fb65b84fb4a63050ddfecce3"),
    "h263_cv2_still_176x144.avi":
        ("video", "6823f4a0839f0fe5ed292021a252c3f573d360d84d80831cdf8a387071a00236"),
    "h263_cv2_u263_128x96.avi":
        ("video", "4577d72e74b687f58ff05f4c4235288d9b963db6ab6b5e4a6c92ceff195f9ce6"),
    "h263_dquant_176x144.avi":
        ("video", "226673ce6d7d368ba6f13ad275c7e1de59028eb6c93edc7bb3624fc8f6f97c7d"),
    "h263_gob_q1_176x144.avi":
        ("video", "5990d160e29cdfe13ec8f687649ecf74dc803ac8409790c77f805679440e43ef"),
    "h263_mv4_176x144.avi":
        ("video", "450bd790126e286981b5f4e086569e7d8c946e61b14557d0e7bfb5caefa47efe"),
    "h263_noise_q1_176x144.avi":
        ("video", "b233fdd7ce9f8c63578a29c875a717f00d45197d54212f5bb9e3212113239238"),
    "h263_obmc_176x144.3gp":
        ("video", "8a69c99fa5cf58ff989b0f5de0276cefc22ed86aff885ccd9a795425541ae6d3"),
    "h263_obmc_176x144.avi":
        ("video", "47bbbb530c41f45df425befb33bfed85e9147936dfee40e3cef78c30636666f3"),
    "h263_obmc_gob_352x288.avi":
        ("video", "7708eadf806c025dbfeb56041f786e456c0a9bd28484e14b8ab3b81d44c78f8a"),
    "h263_obmc_mv4_q4_176x144.avi":
        ("video", "5b8f520590f19afed8c3aa8c022aa7319b7a03e512a7458c1a878466bd6b3c45"),
    "h263_pei_176x144.avi":
        ("video", "6abf85a1042837e1aa39ff07a3e8e77cdbe2e74a204ae346207042f5e29ab410"),
    "h263_q31_176x144.avi":
        ("video", "826adb2eeef61fb84b6e74e26cba9a085f00eb189cc70c00c0091cccd2a7ed51"),
    "mp42_cv2_44x36.avi":
        ("video", "4bd99823968d411d60862ad45fa01700a36c438e9cda505ad3e0ed88b8bbcf9d"),
    "mp42_cv2_64x48.avi":
        ("video", "4c0529aebfa58aacf4baccf0d6138cd6f7a4d4e3cfa32cac8a19b2bb4a40561d"),
    "mp42_cv2_still_64x48.avi":
        ("video", "15f4926070fbdb4f3b228283dfd6e9f581ee0535175ca625d28c2d4210f588cd"),
    "mp43_cv2_44x36.avi":
        ("video", "d4e5bf679c0fbbfe5a2784d9d8bc0a819c95de8eb1b1c5816ad47ecdb4fc67dd"),
    "mp43_cv2_64x48.avi":
        ("video", "54cf7547932c154c66a9831b08dc6711289a5e0afa09b7db24e6fe2c1cb1bed2"),
    "mp43_cv2_still_64x48.avi":
        ("video", "1f5a0c8811f46f17a53d522f184f0a1b2c190a9a3619b9bf59fec3ecfaef60d5"),
    "mp4v_shortheader_176x144.avi":
        ("video", "eb031b5e89013d696feb7f7d17aeda2fa659054becee07f4b25fcd68df821c82"),
    "msmpeg4_cv2_mp43_1080x1920.avi":
        ("video", "fc220081a5c45b969dd519411c1dbb91460c0193fc4a0b48aae08c406ba12836"),
    "msmpeg4v2_blocks_q2_64x48.avi":
        ("video", "39bc8bdfbdc5affcf92cd338d7f18e073665b00a2fadc5c6a1e990f16056a668"),
    "msmpeg4v2_q1_64x48.avi":
        ("video", "30af74790f5a378114cd11ab0069fcf1d685aadb158b68430c8831bba98f9c69"),
    "msmpeg4v2_q31_64x48.avi":
        ("video", "02535cfdeb9802d0de0fcdcc9223d32bf2bec83b56ff2baced86a7f53d6aa721"),
    "msmpeg4v2_q8_64x48.avi":
        ("video", "a3a78194f79039d64be5fbd833f5b9908262a3753944ea8a2d04cff3184b4933"),
    "msmpeg4v2_slices_64x48.avi":
        ("video", "e879a95803c1b6430d40dc8ea9562315b20339e95c38c114fad8c7f01273ca05"),
    "msmpeg4v3_45x37.avi":
        ("video", "6619782025648e4c33b5437d3dfef454f8ed305382f79dd464537f49d08ae10f"),
    "msmpeg4v3_blocks_q2_64x48.avi":
        ("video", "82160c152c10a7252d8d6bd559342c3e9e668c1f93a7b49a683a7198d42e5a47"),
    "msmpeg4v3_moving_blocks_64x48.avi":
        ("video", "c2d828f68982f2efc57e47cabf06e723e0d7890b9d063e566a15687365d65dbe"),
    "msmpeg4v3_noflipflop_64x48.avi":
        ("video", "e25ddbdb1109f7cd8c777ed2138de27de46a1bee9e3eb9ae2555894b1998e883"),
    "msmpeg4v3_q1_64x48.avi":
        ("video", "dfbb979ef6bcab17cb5e9331492d500fbe095a0887a583b18bf9f243ca2e11a0"),
    "msmpeg4v3_q31_64x48.avi":
        ("video", "b6c8bc0cc939b51ac991d8d53cb0b4ab83eac458ae06a6829503ad34f1bcf142"),
    "msmpeg4v3_q8_64x48.avi":
        ("video", "4c5e807f8052e1d1a4690ac469e5226e13fe2ae058bbbcf5f873185e8630e511"),
    "msmpeg4v3_slices_64x48.avi":
        ("video", "415b777d4c2db586db28fc7da07bc40b5ac25e294fe3803d02459acbee908b1f"),
    "corrupt_vp9_hbd12_lossless_444_23x19.webm":
        ("video", "419674a0a166b843ed4ab033224219ab8c835db2d4bc6d4d33b93fc9e4866def"),
    "flv1_45x37.flv":
        ("video", "2be4a86deb16bb9f2fb6f0ad09c37b0f663d56904ed00fe27842713fcee8f950"),
    "msmpeg4v3_tables0_acpred_64x48.avi":
        ("video", "4177927ecfc31f7e142289ebc390ad79b2dcaddab9d692bc7fb6466f8251cd85"),
}
INPUTS_FRAME_DIRS = ("adam7_frames", "progressive_frames")
INPUTS_CLIP_FRAMES = 3  # of the video phase's clip, written as a 1080p MJPG AVI
INPUTS_JPEG_DB = 17.5  # the clip's frames decoded against the pixels written
INPUTS_DECODE_REPS = 5  # timed decodes of one 1080p frame
INPUTS_MP4V_DB = 18.0  # the clip's frames through images_to_video (mp4v, quant 3) and back:
# 18.58 dB on the clip's pixel-noise texture (4:2:0 chroma), measured on the CPU
INPUTS_WEBM = "vp8_cv2_1080x1920.webm"  # the clip's 3 frames as cv2's VP80 writer codes them
INPUTS_VP8_DB = 13.0  # that file decoded against the pixels written: 13.43-13.45 dB measured
# on the CPU (cv2's default VP8 bitrate on the pixel-noise texture)
INPUTS_VP9_WEBM = "vp9_cv2_1080x1920.webm"  # the same 3 frames as cv2's VP90 writer codes them
INPUTS_VP9_DB = 18.0  # that file decoded against the pixels written: 18.29 dB measured on the
# CPU (cv2's default VP9 bitrate on the pixel-noise texture)
INPUTS_MPEG2_TS = "mpeg2_cv2_1080x1920.ts"  # the same 3 frames as cv2's MPG2 writer codes them
INPUTS_MPEG2_DB = 16.5  # that file decoded against the pixels written: 16.96 dB (the I
# picture), 18.24 and 18.23 dB measured on the CPU (cv2's MPG2 writer on the pixel-noise texture)
# the pins of the MPEG-1/2 fixtures and of the containers read since then (IVF, VP8 in AVI,
# Motion-JPEG in MOV / MP4, mp4v in a transport stream)
INPUTS_MPEG_PINS = tuple(n for n in INPUT_PINS if n.startswith(("mpeg1_", "mpeg2_", "ivf_")) or (
    n in ("vp8_cv2_64x48.avi", "mjpg_cv2_64x48.mov", "mjpg_cv2_64x48.mp4", "mp4v_cv2_96x72.ts")))
# the pins of the stills (BMP, PNM, TIFF, CMYK / RGB JPEGs, PNG orientation, WebP, GIF) and of
# the lone images, GIF clips and numbered sequences read as video (the names starting video_,
# webp_video_ and gif_clip_, and the sequences)
INPUTS_STILL_PINS = tuple(n for n in INPUT_PINS if n.startswith(("bmp_", "pnm_", "tiff_", "jpeg_",
                                                                  "png_", "video_", "webp_", "gif_")))
INPUTS_TIFF = "tiff_cv2_1080x1920.tif"  # cv2.imwrite's 1080p LZW TIFF: one row a strip
CLI_STILL_REPS = 3  # timed writes and reads of each 1080p BMP, PPM, TIFF and WebP
INPUTS_GIF = "gif_clip_1080x1920.gif"  # 3 images of a smooth moving scene, PIL's, 256 colours
INPUTS_WEBP = "webp_cv2_q90_1080x1920.webp"  # cv2's lossy WebP (quality 90) of its first frame
INPUTS_WEBP_REPS = 5  # timed decodes of the 1080p WebP and GIF, one host thread
# the clip's 3 frames at full precision as a 10-bit VP9 (profile 2) WebM, coded by libvpx
INPUTS_VP9_10BIT = "vp9_hbd10_1080x1920.webm"
# the pins of line inputs_vp9_highbd_lossless
INPUTS_HIGHBD_LOSSLESS = ("vp9_hbd", "ivf_vp9_hbd", "lossless_", "corrupt_webp_", "corrupt_vp9_")
# the H.263 family's timed files (line inputs_h263): the clip's 3 frames as cv2's MP43
# (MS-MPEG4 v3) AVI, 3 frames of the GIF's smooth scene as cv2's FLV1 (Sorenson) FLV, and a
# 352x288 H.263 AVI of cv2's H263 writer; and the family's pins
INPUTS_MSMPEG4 = "msmpeg4_cv2_mp43_1080x1920.avi"
INPUTS_FLV = "flv1_cv2_smooth_1080x1920.flv"
INPUTS_H263 = "h263_cv2_352x288.avi"
INPUTS_H263_PINS = ("h263_", "flv1_", "mp42_", "mp43_", "div3_", "msmpeg4", "mp4v_short")


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


def phase_inputs(dev, repo, models, ada_path, fusion_path, clip, smi):
    """The inputs JAX reads through cv2: the committed fixtures against
    cv2's and PIL's digests, a 1080p MJPG AVI, a 1080p mp4v .mp4 (from
    images_to_video) and the committed 1080p VP8 and VP9 WebMs and MPEG-2
    transport stream through `cli video --method fusion`, the frames
    through images_to_video into a .mkv, and the Adam7 and
    progressive-JPEG frame directories through double_frame_rate; returns
    the path's K1 launches."""
    with _work_dir(repo) as work:
        return _inputs(dev, repo, models, ada_path, fusion_path, clip, smi, work)


def _inputs(dev, repo, models, ada_path, fusion_path, clip, smi, work):
    import contextlib
    import hashlib
    import io

    import torch
    from fmvfi_tpu_torch import cli, native
    from fmvfi_tpu_torch.models.adacof import AdaCoFNet
    from fmvfi_tpu_torch.models.fusion_net import FusionNet, infer_variant
    from fmvfi_tpu_torch.models.phase_net import PhaseNetCore
    from fmvfi_tpu_torch.ops import adacof_cuda
    from fmvfi_tpu_torch.pipeline.interpolate import FusionModels
    from fmvfi_tpu_torch.pipeline.video import (double_frame_rate, iter_video_frames, quantize,
                                                read_frame_dir, read_video_frames)
    from fmvfi_tpu_torch.utils import avi, datasets, imageio, mkv, mp4, mpegts
    from fmvfi_tpu_torch.utils.convert import (load_adacof_weights, load_fusion_weights,
                                               phase_net_from_torch)

    # (a) the fixtures, each decoded as its contract says, against the pins
    t0 = time.perf_counter()
    readers = dict(imread=imageio.imread, read_jpeg=imageio.read_jpeg,
                   video=lambda path: np.stack(list(iter_video_frames(path))))
    pins = {}
    for name, (contract, digest) in INPUT_PINS.items():
        t = time.perf_counter()
        pixels = readers[contract](os.path.join(repo, INPUTS_DIR, name))
        pins[name] = dict(contract=contract, shape=list(pixels.shape),
                          ms=1e3 * (time.perf_counter() - t),
                          equal=hashlib.sha256(np.ascontiguousarray(pixels).tobytes()).hexdigest()
                          == digest)
    _line(phase="inputs_pins", seconds=time.perf_counter() - t0, fixtures=pins)
    if not all(p["equal"] for p in pins.values()):
        raise AssertionError(f"inputs: decodes unequal to cv2's or PIL's pixels: "
                             f"{[n for n, p in pins.items() if not p['equal']]}")

    # (a2) the 1080p WebP and GIF codecs on the card's host, each on the
    # calling thread: cv2's lossy WebP decoded as imread, the port's lossless
    # file of those pixels written and read back, the animated GIF's frames
    from fmvfi_tpu_torch.utils import gif, webp
    t0 = time.perf_counter()
    webp_path = os.path.join(repo, INPUTS_DIR, INPUTS_WEBP)
    gif_path = os.path.join(repo, INPUTS_DIR, INPUTS_GIF)
    with open(webp_path, "rb") as f:
        lossy = f.read()
    with open(gif_path, "rb") as f:
        gif_data = f.read()
    codec_ms = dict(lossy_decode=[], lossless_encode=[], lossless_decode=[], gif_frames=[])
    for _ in range(INPUTS_WEBP_REPS):
        t = time.perf_counter()
        still, _ = webp.decode(lossy)
        codec_ms["lossy_decode"].append(1e3 * (time.perf_counter() - t))
        t = time.perf_counter()
        lossless = webp.encode(still)
        codec_ms["lossless_encode"].append(1e3 * (time.perf_counter() - t))
        t = time.perf_counter()
        back, _ = webp.decode(lossless)
        codec_ms["lossless_decode"].append(1e3 * (time.perf_counter() - t))
        t = time.perf_counter()
        gif_frames = gif.frames(gif_data)
        codec_ms["gif_frames"].append(1e3 * (time.perf_counter() - t))
    webp_gif = dict(seconds=time.perf_counter() - t0, size=list(still.shape[:2]), card=smi,
                    webp_lossy_bytes=len(lossy), webp_lossless_bytes=len(lossless),
                    lossless_round_trip_equal=bool(np.array_equal(back, still)),
                    gif_bytes=len(gif_data), gif_frames=len(gif_frames),
                    **{f"{k}_1080p_ms": float(np.median(v)) for k, v in codec_ms.items()},
                    ms=codec_ms, pins={k: v["equal"] for k, v in pins.items()
                                       if k.startswith(("webp_", "gif_"))})
    _line(phase="inputs_webp_gif", **webp_gif)
    if not webp_gif["lossless_round_trip_equal"] or len(gif_frames) != 3 or not all(
            webp_gif["pins"].values()):
        raise AssertionError(f"inputs: the 1080p WebP and GIF: {webp_gif}")

    # (a3) VP9 profiles 2-3, PNG and raw frames in AVI / MOV, the corrupted
    # WebPs: their pins (read in (a)), and the committed 1080p 10-bit VP9
    # WebM's key and inter frames decoded on the card's host, each decode
    # with its swscale conversion, medians of INPUTS_DECODE_REPS
    t0 = time.perf_counter()
    hbd_path = os.path.join(repo, INPUTS_DIR, INPUTS_VP9_10BIT)
    hbd_packets = list(mkv.iter_samples(mkv.open_video(hbd_path)))
    hbd_ms = dict(key=[], inter=[])
    for _ in range(INPUTS_DECODE_REPS):
        decoder = native.Vp9Decoder()
        for sample in hbd_packets:
            t = time.perf_counter()
            shown = decoder.decode(sample)
            hbd_ms["key" if decoder.info["keyframe"] else "inter"].append(
                1e3 * (time.perf_counter() - t))
        hbd_info = dict(decoder.info)
        decoder.close()
    hbd = dict(seconds=time.perf_counter() - t0, webm=INPUTS_VP9_10BIT,
               webm_bytes=os.path.getsize(hbd_path), frame_bytes=[len(p) for p in hbd_packets],
               size=list(shown[0].shape[:2]), profile=hbd_info["profile"],
               bit_depth=hbd_info["bit_depth"],
               vp9_10bit_decode_1080p_key_ms=float(np.median(hbd_ms["key"])),
               vp9_10bit_decode_1080p_inter_ms=float(np.median(hbd_ms["inter"])),
               decode_ms=hbd_ms, card=smi,
               pins={k: v["equal"] for k, v in pins.items()
                     if k.startswith(INPUTS_HIGHBD_LOSSLESS)})
    _line(phase="inputs_vp9_highbd_lossless", **hbd)
    if hbd["bit_depth"] != 10 or hbd["size"] != [1080, 1920] or len(hbd["pins"]) != sum(
            n.startswith(INPUTS_HIGHBD_LOSSLESS) for n in INPUT_PINS) or not all(
                hbd["pins"].values()):
        raise AssertionError(f"inputs: VP9 profiles 2-3 and the lossless frames: {hbd}")

    # (a4) the H.263 family: its pins (read in (a)), and the committed 1080p
    # MS-MPEG4 v3 AVI's and Sorenson FLV's key and inter pictures and the
    # 352x288 H.263 AVI's I and P pictures decoded on the card's host, each
    # decode with its swscale conversion, medians of INPUTS_DECODE_REPS
    from fmvfi_tpu_torch.utils import flv
    t0 = time.perf_counter()

    def timed_pictures(make, data):
        ms = dict(I=[], P=[])
        for _ in range(INPUTS_DECODE_REPS):
            decoder = make()
            for sample in data:
                t = time.perf_counter()
                frame = decoder.decode(sample)
                ms[decoder.picture_type].append(1e3 * (time.perf_counter() - t))
            decoder.close()
        return frame, ms

    ms_stream = avi.open_video(os.path.join(repo, INPUTS_DIR, INPUTS_MSMPEG4))
    ms_size = (ms_stream.strf["width"], ms_stream.strf["height"])
    ms_packets = list(avi.iter_frames(ms_stream))
    ms_frame, ms_ms = timed_pictures(lambda: native.Msmpeg4Decoder(3, ms_size), ms_packets)
    flv_packets = list(flv.iter_frames(flv.open_video(os.path.join(repo, INPUTS_DIR, INPUTS_FLV))))
    flv_frame, flv_ms = timed_pictures(lambda: native.H263Decoder("flv1"), flv_packets)
    h263_packets = list(avi.iter_frames(avi.open_video(os.path.join(repo, INPUTS_DIR,
                                                                     INPUTS_H263))))
    h263_frame, h263_ms = timed_pictures(lambda: native.H263Decoder("h263"), h263_packets)
    family = dict(seconds=time.perf_counter() - t0, card=smi,
                  msmpeg4_avi=INPUTS_MSMPEG4, msmpeg4_bytes=[len(p) for p in ms_packets],
                  msmpeg4_size=list(ms_frame.shape[:2]),
                  msmpeg4_decode_1080p_key_ms=float(np.median(ms_ms["I"])),
                  msmpeg4_decode_1080p_inter_ms=float(np.median(ms_ms["P"])),
                  flv=INPUTS_FLV, flv_bytes=[len(p) for p in flv_packets],
                  flv_size=list(flv_frame.shape[:2]),
                  sorenson_decode_1080p_key_ms=float(np.median(flv_ms["I"])),
                  sorenson_decode_1080p_inter_ms=float(np.median(flv_ms["P"])),
                  h263_avi=INPUTS_H263, h263_size=list(h263_frame.shape[:2]),
                  h263_decode_352x288_i_ms=float(np.median(h263_ms["I"])),
                  h263_decode_352x288_p_ms=float(np.median(h263_ms["P"])),
                  decode_ms=dict(msmpeg4=ms_ms, sorenson=flv_ms, h263=h263_ms),
                  pins={k: v["equal"] for k, v in pins.items() if k.startswith(INPUTS_H263_PINS)})
    _line(phase="inputs_h263", **family)
    if (family["msmpeg4_size"] != [1080, 1920] or family["flv_size"] != [1080, 1920]
            or family["h263_size"] != [288, 352] or not all(
                len(v[k]) for v in (ms_ms, flv_ms, h263_ms) for k in "IP")
            or len(family["pins"]) != sum(n.startswith(INPUTS_H263_PINS) for n in INPUT_PINS)
            or not all(family["pins"].values())):
        raise AssertionError(f"inputs: the H.263 family: {family}")

    # (b) the full-width path: a 1080p MJPG AVI through `cli video`, K1
    # counted around the command (the models it builds take the recording warp)
    t0 = time.perf_counter()
    written = (np.asarray(clip[:INPUTS_CLIP_FRAMES]) * 255 + 0.5).astype(np.uint8)
    n, h, w = written.shape[:3]
    path = os.path.join(work, "clip.avi")
    t = time.perf_counter()
    with avi.MjpgWriter(path, w, h, fps=30) as writer:
        for frame in written:
            writer.write(frame)
    write_seconds = time.perf_counter() - t
    frame_bytes = avi.read(path).frames[0]
    decode_ms_mjpg = []
    for _ in range(INPUTS_DECODE_REPS):
        t = time.perf_counter()
        native.mjpeg_decode(frame_bytes)
        decode_ms_mjpg.append(1e3 * (time.perf_counter() - t))
    t = time.perf_counter()
    frames = read_video_frames(path)
    read_seconds = time.perf_counter() - t
    decoded_db = [_psnr(f, g.astype(np.float32) / 255) for f, g in zip(frames, written)]
    libjpeg_db = _psnr(native.mjpeg_decode(frame_bytes).astype(np.float64) / 255,
                       native.jpeg_decode(frame_bytes).astype(np.float64) / 255)
    phase_pt = _reference_phase_pt(os.path.join(work, "phase_net.pt"))
    images = []
    real_warp = adacof_cuda.adacof_warp

    def recording_warp(x, *args):
        images.append(x.shape[0])
        return real_warp(x, *args)

    def cli_video(src, out_dir):
        """`cli video --method fusion` on src: seconds, counts, K1 images, PNGs."""
        images.clear()
        adacof_cuda.adacof_warp = recording_warp
        try:
            _reset_counts()  # the command's run
            torch.cuda.synchronize()
            t = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                cli.main(["video", "--input", src, "--output_dir", out_dir, "--method",
                          "fusion", "--phase_checkpoint", phase_pt, "--device", dev.type])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t
            c = _counts()  # read just after
        finally:
            adacof_cuda.adacof_warp = real_warp
        names = sorted(os.listdir(out_dir))
        return seconds, c, list(images), names, [imageio.imread(os.path.join(out_dir, name))
                                                 for name in names]

    cli_seconds, cli_c, cli_images, names, outs = cli_video(path, os.path.join(work, "video"))

    # (c) the same pixels as PNGs through images_to_video into an mp4v .mp4
    # (utils/mp4.py, native/mpeg4_enc.cpp), read back (native/mpeg4.cpp) and
    # through `cli video`; the encoder and decoder timed on their own
    t0_mp4 = time.perf_counter()
    png_dir = os.path.join(work, "mp4v_frames")
    os.makedirs(png_dir)
    for i, frame in enumerate(written):
        imageio.imwrite(os.path.join(png_dir, f"{i:05d}.png"), frame)
    mp4_path = os.path.join(work, "clip.mp4")
    t = time.perf_counter()
    datasets.images_to_video(png_dir, mp4_path)
    stitch_seconds = time.perf_counter() - t
    track = mp4.open_video(mp4_path)
    samples = list(mp4.iter_samples(track))
    encoder = native.Mpeg4Encoder(w, h, 30, mp4.QUANT, mp4.GOP, in_band=False)
    encode_ms, packets, recon = [], [], []
    for frame in written:
        t = time.perf_counter()
        packets.append(encoder.encode(frame))
        encode_ms.append(1e3 * (time.perf_counter() - t))
        recon.append(encoder.reconstruction())
    encoder.close()
    decode_ms = dict(I=[], P=[])
    for _ in range(INPUTS_DECODE_REPS):
        decoder = native.Mpeg4Decoder(track.config)
        decoded = []
        for sample in samples:
            t = time.perf_counter()
            decoded.append(decoder.decode(sample))
            decode_ms[decoder.vop_type].append(1e3 * (time.perf_counter() - t))
        decoder.close()
    recon_equal = packets == samples and all(np.array_equal(a, b) for a, b in zip(recon, decoded))
    t = time.perf_counter()
    mp4_frames = read_video_frames(mp4_path)
    mp4_read_seconds = time.perf_counter() - t
    mp4_db = [_psnr(f, g.astype(np.float32) / 255) for f, g in zip(mp4_frames, written)]
    mp4_cli_seconds, mp4_c, mp4_images, mp4_names, mp4_outs = cli_video(
        mp4_path, os.path.join(work, "video_mp4"))

    # (e) the committed 1080p WebM (cv2's VP8 of the same 3 frames): the
    # Matroska parse (utils/mkv.py) and native/vp8.cpp timed on their own,
    # then `cli video`; the PNGs through images_to_video into a .mkv, read back
    t0_mkv = time.perf_counter()
    webm_path = os.path.join(repo, INPUTS_DIR, INPUTS_WEBM)
    parse_ms = []
    for _ in range(INPUTS_DECODE_REPS):
        t = time.perf_counter()
        webm_track = mkv.open_video(webm_path)
        parse_ms.append(1e3 * (time.perf_counter() - t))
    webm_samples = list(mkv.iter_samples(webm_track))
    vp8_ms = dict(key=[], inter=[])
    for _ in range(INPUTS_DECODE_REPS):
        decoder = native.Vp8Decoder()
        for sample in webm_samples:
            t = time.perf_counter()
            decoder.decode(sample)
            vp8_ms["key" if decoder.info["keyframe"] else "inter"].append(
                1e3 * (time.perf_counter() - t))
        decoder.close()
    t = time.perf_counter()
    webm_frames = read_video_frames(webm_path)
    webm_read_seconds = time.perf_counter() - t
    webm_db = [_psnr(f, g.astype(np.float32) / 255) for f, g in zip(webm_frames, written)]
    webm_cli_seconds, webm_c, webm_images, webm_names, webm_outs = cli_video(
        webm_path, os.path.join(work, "video_webm"))
    mkv_path = os.path.join(work, "clip.mkv")
    t = time.perf_counter()
    datasets.images_to_video(png_dir, mkv_path)
    mkv_seconds = time.perf_counter() - t
    mkv_decoded = list(iter_video_frames(mkv_path))
    mkv_equal = list(mkv.iter_samples(mkv.open_video(mkv_path))) == packets and len(
        mkv_decoded) == n and all(np.array_equal(a, b) for a, b in zip(recon, mkv_decoded))

    # (f) the committed 1080p VP9 WebM (cv2's VP90 of the same 3 frames): the
    # Matroska parse and native/vp9.cpp timed on their own, then `cli video`
    t0_vp9 = time.perf_counter()
    vp9_path = os.path.join(repo, INPUTS_DIR, INPUTS_VP9_WEBM)
    vp9_parse_ms = []
    for _ in range(INPUTS_DECODE_REPS):
        t = time.perf_counter()
        vp9_track = mkv.open_video(vp9_path)
        vp9_parse_ms.append(1e3 * (time.perf_counter() - t))
    vp9_samples = list(mkv.iter_samples(vp9_track))
    vp9_ms = dict(key=[], inter=[])
    vp9_info = []
    for _ in range(INPUTS_DECODE_REPS):
        decoder = native.Vp9Decoder()
        for sample in vp9_samples:
            t = time.perf_counter()
            decoder.decode(sample)
            vp9_ms["key" if decoder.info["keyframe"] else "inter"].append(
                1e3 * (time.perf_counter() - t))
            vp9_info.append(decoder.info)
        decoder.close()
    t = time.perf_counter()
    vp9_frames = read_video_frames(vp9_path)
    vp9_read_seconds = time.perf_counter() - t
    vp9_db = [_psnr(f, g.astype(np.float32) / 255) for f, g in zip(vp9_frames, written)]
    vp9_cli_seconds, vp9_c, vp9_images, vp9_names, vp9_outs = cli_video(
        vp9_path, os.path.join(work, "video_vp9"))

    # (g) the committed 1080p MPEG-2 transport stream (cv2's MPG2 of the same
    # 3 frames: an I, a P and a B picture): the demux and split into
    # pictures (utils/mpegts.py) and native/mpeg12.cpp timed on their own
    # (each decode call converts the frame it lets out), then `cli video`
    t0_mpeg = time.perf_counter()
    ts_path = os.path.join(repo, INPUTS_DIR, INPUTS_MPEG2_TS)
    demux_ms = []
    for _ in range(INPUTS_DECODE_REPS):
        t = time.perf_counter()
        ts_packets = list(mpegts.iter_packets(mpegts.open_stream(ts_path, "ts")))
        demux_ms.append(1e3 * (time.perf_counter() - t))
    mpeg_ms = dict(I=[], P=[], B=[], flush=[])
    for _ in range(INPUTS_DECODE_REPS):
        decoder = native.Mpeg12Decoder()
        for sample in ts_packets:
            t = time.perf_counter()
            decoder.decode(sample)
            mpeg_ms[decoder.info["picture"]].append(1e3 * (time.perf_counter() - t))
        t = time.perf_counter()
        decoder.flush()
        mpeg_ms["flush"].append(1e3 * (time.perf_counter() - t))
        decoder.close()
    t = time.perf_counter()
    mpeg_frames = read_video_frames(ts_path)
    mpeg_read_seconds = time.perf_counter() - t
    mpeg_db = [_psnr(f, g.astype(np.float32) / 255) for f, g in zip(mpeg_frames, written)]
    mpeg_cli_seconds, mpeg_c, mpeg_images, mpeg_names, mpeg_outs = cli_video(
        ts_path, os.path.join(work, "video_mpeg2"))

    # the same models in this process, per pair, on the frames read back
    ada = AdaCoFNet().to(dev).eval()
    ada.load_state_dict(load_adacof_weights(ada_path))
    fusion_sd = load_fusion_weights(fusion_path)
    fusion = FusionNet(variant=infer_variant(fusion_sd)).to(dev).eval()
    fusion.load_state_dict(fusion_sd)
    phase = PhaseNetCore().to(dev).eval()
    phase.load_state_dict(phase_net_from_torch(phase_pt))
    pipe = FusionModels(phase, ada, fusion)
    per_pair = [quantize(f) for f in double_frame_rate(frames, pipe, device=dev)]
    mp4_per_pair = [quantize(f) for f in double_frame_rate(mp4_frames, pipe, device=dev)]
    webm_per_pair = [quantize(f) for f in double_frame_rate(webm_frames, pipe, device=dev)]
    vp9_per_pair = [quantize(f) for f in double_frame_rate(vp9_frames, pipe, device=dev)]
    mpeg_per_pair = [quantize(f) for f in double_frame_rate(mpeg_frames, pipe, device=dev)]
    del ada, fusion, phase, pipe
    originals = len(outs) == 2 * n - 1 and all(
        np.array_equal(outs[2 * i], quantize(frames[i])) for i in range(n))
    mid_db = [_psnr(outs[2 * i + 1].astype(np.float64) / 255,
                    per_pair[2 * i + 1].astype(np.float64) / 255) for i in range(n - 1)]
    mp4_originals = len(mp4_outs) == 2 * n - 1 and all(
        np.array_equal(mp4_outs[2 * i], quantize(mp4_frames[i])) for i in range(n))
    mp4_mid_db = [_psnr(mp4_outs[2 * i + 1].astype(np.float64) / 255,
                        mp4_per_pair[2 * i + 1].astype(np.float64) / 255) for i in range(n - 1)]
    webm_originals = len(webm_outs) == 2 * n - 1 and all(
        np.array_equal(webm_outs[2 * i], quantize(webm_frames[i])) for i in range(n))
    webm_mid_db = [_psnr(webm_outs[2 * i + 1].astype(np.float64) / 255,
                         webm_per_pair[2 * i + 1].astype(np.float64) / 255) for i in range(n - 1)]
    vp9_originals = len(vp9_outs) == 2 * n - 1 and all(
        np.array_equal(vp9_outs[2 * i], quantize(vp9_frames[i])) for i in range(n))
    vp9_mid_db = [_psnr(vp9_outs[2 * i + 1].astype(np.float64) / 255,
                        vp9_per_pair[2 * i + 1].astype(np.float64) / 255) for i in range(n - 1)]
    mpeg_originals = len(mpeg_outs) == 2 * n - 1 and all(
        np.array_equal(mpeg_outs[2 * i], quantize(mpeg_frames[i])) for i in range(n))
    mpeg_mid_db = [_psnr(mpeg_outs[2 * i + 1].astype(np.float64) / 255,
                         mpeg_per_pair[2 * i + 1].astype(np.float64) / 255) for i in range(n - 1)]
    want_images = [2, 4, 2] * (n - 1)
    _line(phase="inputs_video", seconds=t0_mp4 - t0, size=[h, w], frames=n,
          write_seconds=write_seconds, read_seconds=read_seconds,
          frame_bytes=len(frame_bytes), decode_1080p_ms=float(np.median(decode_ms_mjpg)),
          decode_ms=decode_ms_mjpg, card=smi, decoded_vs_written_db=decoded_db,
          mjpeg_vs_libjpeg_decode_db=libjpeg_db, cli_seconds=cli_seconds,
          pngs_written=len(names), originals_exact=originals, k1_launches=cli_c["k1"],
          k1_images=cli_images, k1_paths=cli_c["k1_paths"], k2_launches=cli_c["k2"],
          interpolated_vs_per_pair_db=mid_db)
    _line(phase="inputs_mp4v", seconds=time.perf_counter() - t0_mp4, size=[h, w], frames=n,
          images_to_video_seconds=stitch_seconds, file_bytes=os.path.getsize(mp4_path),
          sample_bytes=track.sizes, quant=mp4.QUANT,
          encode_ms_per_frame=float(np.median(encode_ms)), encode_ms=encode_ms,
          decode_1080p_i_vop_ms=float(np.median(decode_ms["I"])),
          decode_1080p_p_vop_ms=float(np.median(decode_ms["P"])), decode_ms=decode_ms,
          card=smi, encoder_recon_equals_decode=recon_equal, read_seconds=mp4_read_seconds,
          decoded_vs_written_db=mp4_db, db_floor=INPUTS_MP4V_DB, cli_seconds=mp4_cli_seconds,
          pngs_written=len(mp4_names), originals_exact=mp4_originals,
          k1_launches=mp4_c["k1"], k1_images=mp4_images, k1_paths=mp4_c["k1_paths"],
          k2_launches=mp4_c["k2"], interpolated_vs_per_pair_db=mp4_mid_db)
    _line(phase="inputs_mkv", seconds=time.perf_counter() - t0_mkv, size=[h, w], frames=n,
          webm=INPUTS_WEBM, webm_bytes=os.path.getsize(webm_path), frame_bytes=webm_track.sizes,
          matroska_parse_ms=float(np.median(parse_ms)), parse_ms=parse_ms,
          vp8_decode_1080p_key_ms=float(np.median(vp8_ms["key"])),
          vp8_decode_1080p_inter_ms=float(np.median(vp8_ms["inter"])), vp8_decode_ms=vp8_ms,
          card=smi, read_seconds=webm_read_seconds, decoded_vs_written_db=webm_db,
          db_floor=INPUTS_VP8_DB, cli_seconds=webm_cli_seconds, pngs_written=len(webm_names),
          originals_exact=webm_originals, k1_launches=webm_c["k1"], k1_images=webm_images,
          k1_paths=webm_c["k1_paths"], k2_launches=webm_c["k2"],
          interpolated_vs_per_pair_db=webm_mid_db, images_to_video_mkv_seconds=mkv_seconds,
          mkv_bytes=os.path.getsize(mkv_path), mkv_recon_equal=mkv_equal)
    _line(phase="inputs_vp9", seconds=time.perf_counter() - t0_vp9, size=[h, w], frames=n,
          pins={k: v["equal"] for k, v in pins.items() if k.startswith("vp9_")},
          webm=INPUTS_VP9_WEBM, webm_bytes=os.path.getsize(vp9_path),
          frame_bytes=vp9_track.sizes, matroska_parse_ms=float(np.median(vp9_parse_ms)),
          parse_ms=vp9_parse_ms, vp9_decode_1080p_key_ms=float(np.median(vp9_ms["key"])),
          vp9_decode_1080p_inter_ms=float(np.median(vp9_ms["inter"])), vp9_decode_ms=vp9_ms,
          tile_cols_log2=vp9_info[0]["tile_cols_log2"], card=smi,
          read_seconds=vp9_read_seconds, decoded_vs_written_db=vp9_db, db_floor=INPUTS_VP9_DB,
          cli_seconds=vp9_cli_seconds, pngs_written=len(vp9_names),
          originals_exact=vp9_originals, k1_launches=vp9_c["k1"], k1_images=vp9_images,
          k1_paths=vp9_c["k1_paths"], k2_launches=vp9_c["k2"],
          interpolated_vs_per_pair_db=vp9_mid_db)
    if frames.shape != (n, h, w, 3) or not np.isfinite(frames).all() or not (
            min(decoded_db) >= INPUTS_JPEG_DB):
        raise AssertionError(f"inputs: the 1080p AVI decodes to {frames.shape}, "
                             f"{decoded_db} dB against the pixels written")
    mpeg_pins = {k: v["equal"] for k, v in pins.items() if k in INPUTS_MPEG_PINS}
    _line(phase="inputs_mpeg", seconds=time.perf_counter() - t0_mpeg, size=[h, w], frames=n,
          pins=mpeg_pins, ts=INPUTS_MPEG2_TS, ts_bytes=os.path.getsize(ts_path),
          packet_bytes=[len(p) for p in ts_packets], demux_ms=float(np.median(demux_ms)),
          demux_ms_each=demux_ms,
          mpeg2_decode_1080p_i_ms=float(np.median(mpeg_ms["I"])),
          mpeg2_decode_1080p_p_ms=float(np.median(mpeg_ms["P"])),
          mpeg2_decode_1080p_b_ms=float(np.median(mpeg_ms["B"])),
          mpeg2_flush_ms=float(np.median(mpeg_ms["flush"])), mpeg2_decode_ms=mpeg_ms, card=smi,
          read_seconds=mpeg_read_seconds, decoded_vs_written_db=mpeg_db,
          db_floor=INPUTS_MPEG2_DB, cli_seconds=mpeg_cli_seconds,
          pngs_written=len(mpeg_names), originals_exact=mpeg_originals,
          k1_launches=mpeg_c["k1"], k1_images=mpeg_images, k1_paths=mpeg_c["k1_paths"],
          k2_launches=mpeg_c["k2"], interpolated_vs_per_pair_db=mpeg_mid_db)
    if len(names) != 2 * n - 1 or not originals or not min(mid_db) >= PLAIN_AGREEMENT_DB:
        raise AssertionError(f"inputs: cli video wrote {names}, originals exact {originals}, "
                             f"interpolated frames against per pair {mid_db} dB")
    if cli_images != want_images or cli_c["k1_paths"] != {RING_PATH: len(want_images)} or (
            cli_c["k2"]):
        raise AssertionError(f"inputs: cli video K1 images {cli_images} "
                             f"({cli_c['k1_paths']}), K2 {cli_c['k2']}; expected {want_images}")
    if mp4_frames.shape != (n, h, w, 3) or not np.isfinite(mp4_frames).all() or not (
            min(mp4_db) >= INPUTS_MP4V_DB) or not recon_equal:
        raise AssertionError(f"inputs: the 1080p mp4 decodes to {mp4_frames.shape}, {mp4_db} dB "
                             f"against the pixels written; encoder reconstruction equal to "
                             f"the decode: {recon_equal}")
    if len(mp4_names) != 2 * n - 1 or not mp4_originals or not (
            min(mp4_mid_db) >= PLAIN_AGREEMENT_DB):
        raise AssertionError(f"inputs: cli video on the mp4 wrote {mp4_names}, originals exact "
                             f"{mp4_originals}, interpolated frames against per pair "
                             f"{mp4_mid_db} dB")
    if mp4_images != want_images or mp4_c["k1_paths"] != {RING_PATH: len(want_images)} or (
            mp4_c["k2"]):
        raise AssertionError(f"inputs: cli video on the mp4: K1 images {mp4_images} "
                             f"({mp4_c['k1_paths']}), K2 {mp4_c['k2']}; expected {want_images}")

    if webm_frames.shape != (n, h, w, 3) or not np.isfinite(webm_frames).all() or not (
            min(webm_db) >= INPUTS_VP8_DB) or not mkv_equal:
        raise AssertionError(f"inputs: the 1080p WebM decodes to {webm_frames.shape}, {webm_db} "
                             f"dB against the pixels written; the .mkv's samples and frames "
                             f"equal to the encoder's: {mkv_equal}")
    if len(webm_names) != 2 * n - 1 or not webm_originals or not (
            min(webm_mid_db) >= PLAIN_AGREEMENT_DB):
        raise AssertionError(f"inputs: cli video on the WebM wrote {webm_names}, originals "
                             f"exact {webm_originals}, interpolated frames against per pair "
                             f"{webm_mid_db} dB")
    if webm_images != want_images or webm_c["k1_paths"] != {RING_PATH: len(want_images)} or (
            webm_c["k2"]):
        raise AssertionError(f"inputs: cli video on the WebM: K1 images {webm_images} "
                             f"({webm_c['k1_paths']}), K2 {webm_c['k2']}; expected "
                             f"{want_images}")

    if vp9_frames.shape != (n, h, w, 3) or not np.isfinite(vp9_frames).all() or not (
            min(vp9_db) >= INPUTS_VP9_DB):
        raise AssertionError(f"inputs: the 1080p VP9 WebM decodes to {vp9_frames.shape}, "
                             f"{vp9_db} dB against the pixels written")
    if len(vp9_names) != 2 * n - 1 or not vp9_originals or not (
            min(vp9_mid_db) >= PLAIN_AGREEMENT_DB):
        raise AssertionError(f"inputs: cli video on the VP9 WebM wrote {vp9_names}, originals "
                             f"exact {vp9_originals}, interpolated frames against per pair "
                             f"{vp9_mid_db} dB")
    if vp9_images != want_images or vp9_c["k1_paths"] != {RING_PATH: len(want_images)} or (
            vp9_c["k2"]):
        raise AssertionError(f"inputs: cli video on the VP9 WebM: K1 images {vp9_images} "
                             f"({vp9_c['k1_paths']}), K2 {vp9_c['k2']}; expected "
                             f"{want_images}")

    if len(mpeg_pins) != len(INPUTS_MPEG_PINS) or not all(mpeg_pins.values()):
        raise AssertionError(f"inputs: MPEG and container pins {mpeg_pins}")
    if mpeg_frames.shape != (n, h, w, 3) or not np.isfinite(mpeg_frames).all() or not (
            min(mpeg_db) >= INPUTS_MPEG2_DB) or sorted(k for k, v in mpeg_ms.items() if v) != [
            "B", "I", "P", "flush"]:
        raise AssertionError(f"inputs: the 1080p MPEG-2 .ts decodes to {mpeg_frames.shape}, "
                             f"{mpeg_db} dB against the pixels written, pictures "
                             f"{ {k: len(v) for k, v in mpeg_ms.items()} }")
    if len(mpeg_names) != 2 * n - 1 or not mpeg_originals or not (
            min(mpeg_mid_db) >= PLAIN_AGREEMENT_DB):
        raise AssertionError(f"inputs: cli video on the .ts wrote {mpeg_names}, originals "
                             f"exact {mpeg_originals}, interpolated frames against per pair "
                             f"{mpeg_mid_db} dB")
    if mpeg_images != want_images or mpeg_c["k1_paths"] != {RING_PATH: len(want_images)} or (
            mpeg_c["k2"]):
        raise AssertionError(f"inputs: cli video on the .ts: K1 images {mpeg_images} "
                             f"({mpeg_c['k1_paths']}), K2 {mpeg_c['k2']}; expected "
                             f"{want_images}")

    # (d) the Adam7 and progressive-JPEG frame directories through K1
    t0 = time.perf_counter()
    dirs = {}
    models.adacof.warp = recording_warp
    try:
        for name in INPUTS_FRAME_DIRS:
            seq = read_frame_dir(os.path.join(repo, INPUTS_DIR, name))
            _reset_counts()  # this directory's run
            images.clear()
            out = list(double_frame_rate(seq, models, device=dev))
            c = _counts()  # read just after
            dirs[name] = dict(frames=len(seq), out=len(out), k1_images=list(images),
                              k1_paths=c["k1_paths"], k2_launches=c["k2"],
                              finite=bool(all(np.isfinite(f).all() for f in out)),
                              originals_exact=all(np.array_equal(out[2 * i], seq[i])
                                                  for i in range(len(seq))))
    finally:
        models.adacof.warp = real_warp
    _line(phase="inputs_frames", seconds=time.perf_counter() - t0, dirs=dirs)
    for name, d in dirs.items():
        want = [2, 4, 2] * (d["frames"] - 1)
        if (d["out"] != 2 * d["frames"] - 1 or not d["finite"] or not d["originals_exact"]
                or d["k1_images"] != want or d["k1_paths"] != {RING_PATH: len(want)}
                or d["k2_launches"]):
            raise AssertionError(f"inputs: {name} through double_frame_rate: {d}")
    return cli_c["k1"] + mp4_c["k1"] + webm_c["k1"] + vp9_c["k1"] + mpeg_c["k1"] + sum(
        len(d["k1_images"]) for d in dirs.values())


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


def phase_cli(dev, repo, ada_path, fusion_path, pair, clip, smi):
    """The command line on PNG files of a 1080p `pair` of frames and a
    1080p `clip`, float in [0, 1]; returns its K1 and K2 launches."""
    with _work_dir(repo) as work_dir:
        return _cli(dev, repo, ada_path, fusion_path, pair, clip, smi, work_dir)


def _cli(dev, repo, ada_path, fusion_path, pair, clip, smi, work):
    import hashlib

    import torch
    from fmvfi_tpu_torch import cli, native
    from fmvfi_tpu_torch.eval.synth import translation_triplet, translation_video
    from fmvfi_tpu_torch.models.adacof import AdaCoFNet
    from fmvfi_tpu_torch.models.fusion_net import FusionNet, infer_variant
    from fmvfi_tpu_torch.models.phase_net import PhaseNetCore
    from fmvfi_tpu_torch.ops import adacof_cuda
    from fmvfi_tpu_torch.pipeline.interpolate import FusionModels, fusion_interpolate
    from fmvfi_tpu_torch.pipeline.video import double_frame_rate, quantize, read_video_frames
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
    for i, (path, u8) in enumerate(frames.items()):
        t = time.perf_counter()
        back = imageio.imread(path)
        read_ms.append(1e3 * (time.perf_counter() - t))
        if not np.array_equal(back, u8):
            raise AssertionError(f"cli: {path} does not read back as written")
        if i >= CLI_ORACLE_FILES:
            continue
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

    # the same pair as a TIFF and a BMP (the port's imwrite), fused by a
    # second cold process into a .tif; the 1080p BMP, PPM and TIFF codecs
    # timed on the card's host
    still_ms, still_bytes = {}, {}
    for ext in ("bmp", "ppm", "tif"):
        path = os.path.join(work, f"a.{ext}")
        w_ms, r_ms = [], []
        for _ in range(CLI_STILL_REPS):
            t = time.perf_counter()
            imageio.imwrite(path, quantize(pair[0]))
            w_ms.append(1e3 * (time.perf_counter() - t))
            t = time.perf_counter()
            back = imageio.imread(path)
            r_ms.append(1e3 * (time.perf_counter() - t))
            if not np.array_equal(back, quantize(pair[0])):
                raise AssertionError(f"cli: {path} does not read back as written")
        still_ms[ext] = dict(write_ms=float(np.median(w_ms)), read_ms=float(np.median(r_ms)))
        still_bytes[ext] = os.path.getsize(path)
    imageio.imwrite(os.path.join(work, "b.bmp"), quantize(pair[1]))
    out_tif = os.path.join(work, "mid.tif")
    t_start, t = time.time(), time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "fmvfi_tpu_torch.cli", "interpolate", "--first_frame",
         os.path.join(work, "a.tif"), "--second_frame", os.path.join(work, "b.bmp"),
         "--output_frame", out_tif, "--method", "fusion", "--phase_checkpoint", phase_pt],
        cwd=repo, capture_output=True, text=True, timeout=600)
    stills_process_s = time.perf_counter() - t
    if proc.returncode != 0:
        raise AssertionError(f"cli interpolate (TIFF + BMP) exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    stills_cold_s = os.path.getmtime(out_tif) - t_start
    # K1 counted in process, on the frames the TIFF and the BMP decode to
    f1s, f2s = (imageio.imread(os.path.join(work, n)).astype(np.float32) / 255.0
                for n in ("a.tif", "b.bmp"))
    ada = AdaCoFNet().to(dev).eval()
    ada.load_state_dict(load_adacof_weights(ada_path))
    fusion = FusionNet(variant=infer_variant(fusion_sd)).to(dev).eval()
    fusion.load_state_dict(fusion_sd)
    phase = PhaseNetCore().to(dev).eval()
    phase.load_state_dict(phase_net_from_torch(phase_pt))
    ada.warp = recording_warp
    try:
        _reset_counts()
        images.clear()
        want_stills = quantize(fusion_interpolate(FusionModels(phase, ada, fusion), f1s[None],
                                                  f2s[None], device=dev)[0].cpu().numpy())
        stills_counts, stills_images = _counts(), list(images)
    finally:
        ada.warp = real_warp
    del ada, fusion, phase
    got_tif = imageio.imread(out_tif)
    diff = np.abs(got_tif.astype(np.int16) - imageio.imread(out_png).astype(np.int16))
    stills = dict(seconds=stills_cold_s, process_seconds=stills_process_s,
                  max_lsb_vs_png_run=int(diff.max()),
                  share_differing_vs_png_run=float((diff > 0).mean()),
                  in_process_lsb_vs_png_request=int(np.abs(want_stills.astype(np.int16)
                                                           - want.astype(np.int16)).max()),
                  k1_launches=stills_counts["k1"], k1_images=stills_images,
                  k1_paths=stills_counts["k1_paths"], k2_launches=stills_counts["k2"],
                  codec_1080p_ms=still_ms, codec_1080p_bytes=still_bytes,
                  size=list(pair[0].shape[:2]), stderr=proc.stderr.strip().splitlines())
    _line(phase="cli_interpolate_stills", **stills)
    if max(stills["max_lsb_vs_png_run"], stills["in_process_lsb_vs_png_request"]) > CLI_LSB:
        raise AssertionError(f"cli interpolate (TIFF + BMP) against the PNG run: {stills}")
    if stills_images != [2, 4, 2] or stills_counts["k1_paths"] != {RING_PATH: 3}:
        raise AssertionError(f"cli: the TIFF + BMP request's K1 launches {stills}")

    # the same pair as lossless WebPs (the port's imwrite: read back as
    # written), fused by a third cold process into mid.webp; the 1080p WebP
    # write and read timed on the card's host
    w_ms, r_ms = {"a": [], "b": []}, {"a": [], "b": []}
    for name, frame in (("a", pair[0]), ("b", pair[1])):
        path = os.path.join(work, f"{name}.webp")
        for _ in range(CLI_STILL_REPS):
            t = time.perf_counter()
            imageio.imwrite(path, quantize(frame))
            w_ms[name].append(1e3 * (time.perf_counter() - t))
            t = time.perf_counter()
            back = imageio.imread(path)
            r_ms[name].append(1e3 * (time.perf_counter() - t))
            if not np.array_equal(back, quantize(frame)):
                raise AssertionError(f"cli: {path} does not read back as written")
    out_webp = os.path.join(work, "mid.webp")
    t_start, t = time.time(), time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "fmvfi_tpu_torch.cli", "interpolate", "--first_frame",
         os.path.join(work, "a.webp"), "--second_frame", os.path.join(work, "b.webp"),
         "--output_frame", out_webp, "--method", "fusion", "--phase_checkpoint", phase_pt],
        cwd=repo, capture_output=True, text=True, timeout=600)
    webp_process_s = time.perf_counter() - t
    if proc.returncode != 0:
        raise AssertionError(f"cli interpolate (WebP) exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    webp_cold_s = os.path.getmtime(out_webp) - t_start
    f1w, f2w = (imageio.imread(os.path.join(work, n)).astype(np.float32) / 255.0
                for n in ("a.webp", "b.webp"))
    ada = AdaCoFNet().to(dev).eval()
    ada.load_state_dict(load_adacof_weights(ada_path))
    fusion = FusionNet(variant=infer_variant(fusion_sd)).to(dev).eval()
    fusion.load_state_dict(fusion_sd)
    phase = PhaseNetCore().to(dev).eval()
    phase.load_state_dict(phase_net_from_torch(phase_pt))
    ada.warp = recording_warp
    try:
        _reset_counts()
        images.clear()
        want_webp = quantize(fusion_interpolate(FusionModels(phase, ada, fusion), f1w[None],
                                                f2w[None], device=dev)[0].cpu().numpy())
        webp_counts, webp_images = _counts(), list(images)
    finally:
        ada.warp = real_warp
    del ada, fusion, phase
    diff = np.abs(imageio.imread(out_webp).astype(np.int16)
                  - imageio.imread(out_png).astype(np.int16))
    webp_line = dict(seconds=webp_cold_s, process_seconds=webp_process_s,
                     max_lsb_vs_png_run=int(diff.max()),
                     share_differing_vs_png_run=float((diff > 0).mean()),
                     in_process_lsb_vs_png_request=int(np.abs(want_webp.astype(np.int16)
                                                              - want.astype(np.int16)).max()),
                     k1_launches=webp_counts["k1"], k1_images=webp_images,
                     k1_paths=webp_counts["k1_paths"], k2_launches=webp_counts["k2"],
                     webp_1080p_write_ms=float(np.median(w_ms["a"] + w_ms["b"])),
                     webp_1080p_read_ms=float(np.median(r_ms["a"] + r_ms["b"])),
                     write_ms=w_ms, read_ms=r_ms,
                     webp_bytes={n: os.path.getsize(os.path.join(work, f"{n}.webp"))
                                 for n in ("a", "b", "mid")},
                     png_bytes=png_bytes, card=smi, size=list(pair[0].shape[:2]),
                     stderr=proc.stderr.strip().splitlines())
    _line(phase="cli_interpolate_webp", **webp_line)
    if max(webp_line["max_lsb_vs_png_run"], webp_line["in_process_lsb_vs_png_request"]) > CLI_LSB:
        raise AssertionError(f"cli interpolate (WebP) against the PNG run: {webp_line}")
    if webp_images != [2, 4, 2] or webp_counts["k1_paths"] != {RING_PATH: 3}:
        raise AssertionError(f"cli: the WebP request's K1 launches {webp_line}")

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
    # the clip as a numbered sequence (FFmpeg's image2, as cv2 reads it): the
    # directory route's frames, 3 K1 launches a pair
    r = run("video_sequence", ["video", "--input", os.path.join(clip_dir, "%03d.png"),
                               "--output_dir", os.path.join(work, "video_sequence"),
                               "--phase_checkpoint", phase_pt], [2, 4, 2] * n_pairs)
    seq_names = sorted(os.listdir(os.path.join(work, "video_sequence")))
    r["ms_per_interpolated_frame"] = r["ms"] / n_pairs
    r["equal_to_directory_route"] = seq_names == sorted(os.listdir(
        os.path.join(work, "video_per_pair"))) and all(np.array_equal(
            imageio.imread(os.path.join(work, "video_sequence", n)),
            imageio.imread(os.path.join(work, "video_per_pair", n))) for n in seq_names)
    _line(phase="cli_video_sequence", input="clip/%03d.png", frames=n_frames, **r)
    if not r["equal_to_directory_route"]:
        raise AssertionError(f"cli video on clip/%03d.png differs from the directory route: {r}")
    # the committed 1080p animated GIF (3 images of a smooth moving scene, 256
    # colours) as a clip: every image a frame, as FFmpeg's gif demuxer reads
    # it; per pair, K1 3 a pair, against double_frame_rate in this process
    gif_path = os.path.join(repo, INPUTS_DIR, INPUTS_GIF)
    t = time.perf_counter()
    gif_frames = read_video_frames(gif_path)
    gif_read_s = time.perf_counter() - t
    gif_digest = hashlib.sha256(np.ascontiguousarray(
        quantize(gif_frames)).tobytes()).hexdigest()
    r = run("video_gif", ["video", "--input", gif_path, "--output_dir",
                          os.path.join(work, "video_gif"), "--phase_checkpoint", phase_pt],
            [2, 4, 2] * (len(gif_frames) - 1))
    gif_names = sorted(os.listdir(os.path.join(work, "video_gif")))
    gif_outs = [imageio.imread(os.path.join(work, "video_gif", n)) for n in gif_names]
    ada = AdaCoFNet().to(dev).eval()
    ada.load_state_dict(load_adacof_weights(ada_path))
    fusion = FusionNet(variant=infer_variant(fusion_sd)).to(dev).eval()
    fusion.load_state_dict(fusion_sd)
    phase = PhaseNetCore().to(dev).eval()
    phase.load_state_dict(phase_net_from_torch(phase_pt))
    gif_per_pair = [quantize(f) for f in double_frame_rate(
        gif_frames, FusionModels(phase, ada, fusion), device=dev)]
    del ada, fusion, phase
    n_gif = len(gif_frames)
    r.update(frames=n_gif, size=list(gif_frames.shape[1:3]), read_seconds=gif_read_s,
             gif_bytes=os.path.getsize(gif_path), pngs_written=len(gif_names),
             decoded_equal_to_pin=gif_digest == INPUT_PINS[INPUTS_GIF][1],
             originals_exact=len(gif_outs) == 2 * n_gif - 1 and all(
                 np.array_equal(gif_outs[2 * i], quantize(gif_frames[i])) for i in range(n_gif)),
             interpolated_vs_per_pair_db=[
                 _psnr(gif_outs[2 * i + 1].astype(np.float64) / 255,
                       gif_per_pair[2 * i + 1].astype(np.float64) / 255)
                 for i in range(n_gif - 1)],
             ms_per_interpolated_frame=r["ms"] / max(n_gif - 1, 1))
    _line(phase="cli_video_gif", input=INPUTS_GIF, **r)
    if (n_gif != 3 or not r["decoded_equal_to_pin"] or not r["originals_exact"]
            or not min(r["interpolated_vs_per_pair_db"]) >= PLAIN_AGREEMENT_DB):
        raise AssertionError(f"cli video on the animated GIF: {r}")
    # the committed 1080p 10-bit VP9 WebM (profile 2, yuv420p10 through
    # swscale's 16-bit route) through `cli video --method fusion`: per pair,
    # K1 3 a pair, the originals exact, against double_frame_rate here
    hbd_path = os.path.join(repo, INPUTS_DIR, INPUTS_VP9_10BIT)
    t = time.perf_counter()
    hbd_frames = read_video_frames(hbd_path)
    hbd_read_s = time.perf_counter() - t
    hbd_digest = hashlib.sha256(np.ascontiguousarray(
        quantize(hbd_frames)).tobytes()).hexdigest()
    r = run("video_vp9_10bit", ["video", "--input", hbd_path, "--output_dir",
                                os.path.join(work, "video_vp9_10bit"), "--method", "fusion",
                                "--phase_checkpoint", phase_pt],
            [2, 4, 2] * (len(hbd_frames) - 1))
    hbd_names = sorted(os.listdir(os.path.join(work, "video_vp9_10bit")))
    hbd_outs = [imageio.imread(os.path.join(work, "video_vp9_10bit", n)) for n in hbd_names]
    ada = AdaCoFNet().to(dev).eval()
    ada.load_state_dict(load_adacof_weights(ada_path))
    fusion = FusionNet(variant=infer_variant(fusion_sd)).to(dev).eval()
    fusion.load_state_dict(fusion_sd)
    phase = PhaseNetCore().to(dev).eval()
    phase.load_state_dict(phase_net_from_torch(phase_pt))
    hbd_per_pair = [quantize(f) for f in double_frame_rate(
        hbd_frames, FusionModels(phase, ada, fusion), device=dev)]
    del ada, fusion, phase
    n_hbd = len(hbd_frames)
    r.update(frames=n_hbd, size=list(hbd_frames.shape[1:3]), read_seconds=hbd_read_s,
             webm_bytes=os.path.getsize(hbd_path), pngs_written=len(hbd_names),
             decoded_equal_to_pin=hbd_digest == INPUT_PINS[INPUTS_VP9_10BIT][1],
             originals_exact=len(hbd_outs) == 2 * n_hbd - 1 and all(
                 np.array_equal(hbd_outs[2 * i], quantize(hbd_frames[i])) for i in range(n_hbd)),
             interpolated_vs_per_pair_db=[
                 _psnr(hbd_outs[2 * i + 1].astype(np.float64) / 255,
                       hbd_per_pair[2 * i + 1].astype(np.float64) / 255)
                 for i in range(n_hbd - 1)],
             ms_per_interpolated_frame=r["ms"] / max(n_hbd - 1, 1))
    _line(phase="cli_video_vp9_10bit", input=INPUTS_VP9_10BIT, **r)
    if (n_hbd != 3 or not r["decoded_equal_to_pin"] or not r["originals_exact"]
            or not min(r["interpolated_vs_per_pair_db"]) >= PLAIN_AGREEMENT_DB):
        raise AssertionError(f"cli video on the 10-bit VP9 WebM: {r}")
    # the committed 1080p MS-MPEG4 v3 AVI (cv2's MP43 writer: the clip's 3
    # frames) through `cli video --method fusion`: per pair, K1 3 a pair, the
    # originals exact, the interpolated frames against double_frame_rate here
    ms_path = os.path.join(repo, INPUTS_DIR, INPUTS_MSMPEG4)
    t = time.perf_counter()
    ms_frames = read_video_frames(ms_path)
    ms_read_s = time.perf_counter() - t
    ms_digest = hashlib.sha256(np.ascontiguousarray(quantize(ms_frames)).tobytes()).hexdigest()
    r = run("video_msmpeg4", ["video", "--input", ms_path, "--output_dir",
                              os.path.join(work, "video_msmpeg4"), "--method", "fusion",
                              "--phase_checkpoint", phase_pt],
            [2, 4, 2] * (len(ms_frames) - 1))
    ms_names = sorted(os.listdir(os.path.join(work, "video_msmpeg4")))
    ms_outs = [imageio.imread(os.path.join(work, "video_msmpeg4", n)) for n in ms_names]
    ada = AdaCoFNet().to(dev).eval()
    ada.load_state_dict(load_adacof_weights(ada_path))
    fusion = FusionNet(variant=infer_variant(fusion_sd)).to(dev).eval()
    fusion.load_state_dict(fusion_sd)
    phase = PhaseNetCore().to(dev).eval()
    phase.load_state_dict(phase_net_from_torch(phase_pt))
    ms_per_pair = [quantize(f) for f in double_frame_rate(
        ms_frames, FusionModels(phase, ada, fusion), device=dev)]
    del ada, fusion, phase
    n_ms = len(ms_frames)
    r.update(frames=n_ms, size=list(ms_frames.shape[1:3]), read_seconds=ms_read_s,
             avi_bytes=os.path.getsize(ms_path), pngs_written=len(ms_names),
             decoded_equal_to_pin=ms_digest == INPUT_PINS[INPUTS_MSMPEG4][1],
             originals_exact=len(ms_outs) == 2 * n_ms - 1 and all(
                 np.array_equal(ms_outs[2 * i], quantize(ms_frames[i])) for i in range(n_ms)),
             interpolated_identical_to_per_pair=len(ms_outs) == 2 * n_ms - 1 and all(
                 np.array_equal(ms_outs[2 * i + 1], ms_per_pair[2 * i + 1])
                 for i in range(n_ms - 1)),
             interpolated_vs_per_pair_db=[
                 _psnr(ms_outs[2 * i + 1].astype(np.float64) / 255,
                       ms_per_pair[2 * i + 1].astype(np.float64) / 255)
                 for i in range(n_ms - 1)],
             ms_per_pair=r["ms"] / max(n_ms - 1, 1), card=smi)
    _line(phase="cli_video_msmpeg4", input=INPUTS_MSMPEG4, **r)
    if (n_ms != 3 or r["k1_launches"] != 6 or not r["decoded_equal_to_pin"]
            or not r["originals_exact"] or not r["interpolated_identical_to_per_pair"]
            or not min(r["interpolated_vs_per_pair_db"]) >= PLAIN_AGREEMENT_DB):
        raise AssertionError(f"cli video on the 1080p MS-MPEG4 v3 AVI: {r}")
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
          commands=runs, k1_launches=k1 + interp_counts["k1"] + stills_counts["k1"]
          + webp_counts["k1"], k2_launches=k2)
    return k1 + interp_counts["k1"] + stills_counts["k1"] + webp_counts["k1"], k2


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


def start_export(repo):
    """`cli export` of fusion at 1080p for cuda, a process of its own started
    ahead of phase export (it traces on one host core while train_gan and
    gan_vs_cpu run): the bundled AdaCoF, the demo FusionNet and the seeded
    PhaseNet, as cli interpolate takes them."""
    work = _work_dir(repo)
    phase_pt = _reference_phase_pt(os.path.join(work.name, "phase_net.pt"))
    artifact = os.path.join(work.name, "fusion_1080p.pt2")
    t_wall = time.time()
    proc = _spawn_children([[sys.executable, "-m", "fmvfi_tpu_torch.cli", "export", "--method",
                             "fusion", "--size", f"{H_FULL}x{W_FULL}", "--platforms", "cuda",
                             "--out", artifact, "--phase_checkpoint", phase_pt]],
                           repo, None, work.name, "export")
    return dict(work=work, proc=proc, t_wall=t_wall, artifact=artifact, phase_pt=phase_pt)


def phase_export(dev, repo, ada_path, fusion_path, pair, serve_ms, exporter):
    """The artifact of `cli export` (start_export) answering the pair in a
    fresh process, a ("cpu",) artifact without the package, a port-trained
    AdaCoF written out as .msgpack and read back, and the profiling
    utilities on one request; returns the K1 and K2 launches of its runs."""
    try:
        return _export(dev, repo, ada_path, fusion_path, pair, serve_ms, exporter)
    finally:
        _stop_children(exporter["proc"])
        exporter["work"].cleanup()


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


def _export(dev, repo, ada_path, fusion_path, pair, serve_ms, exporter):
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
    work, phase_pt, artifact = exporter["work"].name, exporter["phase_pt"], exporter["artifact"]
    (proc, out, err), = exporter["proc"]
    proc.wait(timeout=600)
    out.close()
    err.close()
    with open(err.name) as f:
        if proc.returncode != 0:
            raise AssertionError(f"cli export exited {proc.returncode}: {f.read()[-3000:]}")
    with open(out.name) as f:
        export_said = f.read().strip().splitlines()[-1]
    # from its start to the artifact written
    export_process_s = os.path.getmtime(artifact) - exporter["t_wall"]
    parts["export_wait"] = time.perf_counter() - t0
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

    # the artifact in a fresh process, while this process makes and runs the
    # ("cpu",) artifact
    frames_npz = os.path.join(work, "pair.npz")
    np.savez(frames_npz, f1=pair[0][None].astype(np.float32), f2=pair[1][None].astype(np.float32))
    torch.cuda.empty_cache()
    t = time.perf_counter()
    loader = _spawn_children([[sys.executable, "-c", _EXPORT_CHILD, artifact, frames_npz,
                               os.path.join(work, "out.npy")]], repo, None, work, "child")
    try:
        cpu = _cpu_artifact(work, ada_path)
        parts["cpu_artifact"] = time.perf_counter() - t
        child, = _child_results(loader, "loading the artifact", 600)
    finally:
        _stop_children(loader)
    child_process_s = parts["child"] = time.perf_counter() - t
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


def _spawn_children(argvs, cwd, env, work, name):
    """Child processes whose stdout and stderr go to files in `work`, so that
    this process works on while they run and no pipe fills."""
    procs = []
    for i, argv in enumerate(argvs):
        out = open(os.path.join(work, f"{name}{i}.out"), "w")
        err = open(os.path.join(work, f"{name}{i}.err"), "w")
        procs.append((subprocess.Popen(argv, cwd=cwd, env=env, stdout=out, stderr=err), out, err))
    return procs


def _child_results(procs, what, timeout):
    """Each child's last line of stdout as JSON, once all have exited;
    AssertionError, with the child's stderr, for one that failed."""
    deadline = time.monotonic() + timeout
    results = []
    for i, (p, out, err) in enumerate(procs):
        p.wait(timeout=max(deadline - time.monotonic(), 1.0))
        out.close()
        err.close()
        if p.returncode != 0:
            with open(err.name) as f:
                raise AssertionError(f"{what} {i}: exit {p.returncode}\n{f.read()[-3000:]}")
        with open(out.name) as f:
            results.append(json.loads(f.read().strip().splitlines()[-1]))
    return results


def _stop_children(procs):
    for p, out, err in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
        out.close()
        err.close()


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

    # (a): the command with --data_parallel and twice without (the second
    # plain run reads the card's run-to-run spread), and (b): the two ranks,
    # five processes at once
    argv = ["train", "--regime", "adacof", "--steps_per_epoch", str(DP_CLI_STEPS),
            "--batch_size", str(DP_BATCH), "--crop", str(CROP)]
    outs = {k: os.path.join(work, k) for k in ("cli_dp", "cli_plain", "cli_plain_again")}
    coord = f"localhost:{_free_port()}"
    children = [[sys.executable, "-c", _DP_CLI_CHILD, *argv, "--out_dir", outs[k],
                 *(["--data_parallel"] if k == "cli_dp" else [])] for k in outs]
    children += [[sys.executable, "-c", _DP_RANK_CHILD, coord, str(r), "2",
                  os.path.join(work, f"rank{r}.npz")] for r in (0, 1)]
    procs = _spawn_children(children, repo, env, work, "child")
    try:
        results = _child_results(procs[:3], "dp command", 600)
        cli_seconds = time.perf_counter() - t0
        ranks = _child_results(procs[3:], "dp rank", 600)
        ranks_seconds = time.perf_counter() - t0
    finally:
        _stop_children(procs)
    cli = dict(zip(outs, results))

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
SPATIAL_REQUESTS = 1  # timed fusion_spatial_apply requests, after one warm-up


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
    procs = _spawn_children([[sys.executable, "-c", _SPATIAL_RANK_CHILD, coord, str(r), repo,
                              os.path.join(work, f"rank{r}.npz")] for r in (0, 1)],
                            repo, env, work, "rank")
    try:
        # the ranks alone on the card (beside them, the references below
        # ran out of its memory)
        ranks = _child_results(procs, "spatial rank", 600)
    finally:
        _stop_children(procs)
    ranks_seconds = time.perf_counter() - t0
    # (a)'s references on the whole frame, here: the plain warp and its
    # field gradients, and K1 and K2 (the JAX package holds the halo
    # warp bit-equal to the single-device warp)
    x, wgt, a, b, cot = _spatial_warp_case(dev)
    xp = pad_replicate(x, 2)
    fields = [t.requires_grad_() for t in (wgt, a, b)]
    whole = adacof_cuda.adacof_warp(xp, *fields, 1, SPATIAL_R)
    whole.backward(cot)
    refs = {"k1": [whole.detach()] + [f.grad for f in fields]}
    del whole, fields
    with torch.no_grad():
        refs["plain"] = [warp_plain(xp, wgt, a, b, 1, SPATIAL_R)]
    refs["plain"] += adacof_warp_field_grads(xp, wgt.detach(), a.detach(), b.detach(), cot,
                                             1, SPATIAL_R)
    del x, xp, wgt, a, b, cot

    # (c): fusion_spatial_apply on a 1-process NCCL group and
    # fusion_interpolate on the card; (b)'s reference: fusion_interpolate
    # with the plain warp
    models = _serve_models(dev, repo)
    requests = _spatial_requests()
    if dist.is_initialized():
        raise AssertionError("spatial: a process group already exists in the smoke's "
                             "process")
    distributed.initialize(backend="nccl")
    try:
        mesh = make_mesh(1, ("data", "spatial"), (1, 1))
        one = spatial.fusion_spatial_apply(models, mesh, device=dev)(
            requests[0][0][None], requests[0][1][None]).gather()
    finally:
        dist.destroy_process_group()
    one_bit_equal = bool(torch.equal(one, fusion_interpolate(
        models, requests[0][0][None], requests[0][1][None], device=dev)))
    models.adacof.warp = warp_plain
    single = [fusion_interpolate(models, f1[None], f2[None], device=dev)[0].cpu().numpy()
              for f1, f2 in requests]
    del models, one
    blocks = [dict(np.load(os.path.join(work, f"rank{r}.npz"))) for r in (0, 1)]
    warp_diff = {k: 0.0 for k in refs}
    grad_diff = {k: 0.0 for k in refs}
    for rec, blk in zip(ranks, blocks):
        rows = slice(*rec["rows"])
        got = [torch.from_numpy(blk[k]).to(dev) for k in ("warp", "grad0", "grad1", "grad2")]
        for k, ref in refs.items():
            warp_diff[k] = max(warp_diff[k], float((got[0] - ref[0][:, :, rows]).abs().max()))
            for g, want in zip(got[1:], ref[1:]):
                grad_diff[k] = max(grad_diff[k], float((g - want[:, :, rows]).abs().max()))
    del refs, got
    psnr = {rec["rank"]: [_psnr(blk[f"fused{i}"], single[i]) for i in range(len(requests))]
            for rec, blk in zip(ranks, blocks)}
    ranks_equal = all(np.array_equal(blocks[0][f"fused{i}"], blocks[1][f"fused{i}"])
                      for i in range(len(requests)))
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


SPATIAL_TRAIN_STEPS = 2  # timed steps of regimes (a) and (b), after one warm-up
SPATIAL_TRAIN_FULL_STEPS = 1  # timed 1080p fusion steps (c), after one warm-up
SPATIAL_TRAIN_GAN_STEPS = 1  # timed adversarial steps (d), after the compared first one
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
    procs = _spawn_children([[sys.executable, "-c", _SPATIAL_TRAIN_RANK_CHILD, coord, str(r),
                              repo, os.path.join(work, f"rank{r}.npz"), vgg_path]
                             for r in (0, 1)], repo, env, work, "rank")
    try:
        # the one-process references, here while the ranks run: each
        # regime's steps, and its first step once more (the card's own
        # run-to-run spread)
        one, again, one_grads, again_grads = {}, {}, {}, {}
        for regime in SPATIAL_TRAIN_REGIMES:
            one[regime], one_grads[regime], _ = _spatial_train_run(regime, dev, repo,
                                                                   vgg_path=vgg_path)
            if regime != "fusion_1080p":
                again[regime], again_grads[regime], _ = _spatial_train_run(
                    regime, dev, repo, vgg_path=vgg_path, steps=1)
        ranks = _child_results(procs, "spatial_train rank", 900)
    finally:
        _stop_children(procs)
    ranks_seconds = time.perf_counter() - t0
    blocks = [dict(np.load(os.path.join(work, f"rank{r}.npz"))) for r in (0, 1)]
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

    # inputs: the fixtures JAX reads through cv2, a 1080p MJPG AVI and a 1080p
    # mp4v .mp4 through `cli video --method fusion`, and the Adam7 and
    # progressive-JPEG frame directories through K1
    inputs_k1 = phase_inputs(dev, repo, models, ada_path, fusion_path, clip, smi)

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
                               (requests[0][0], requests[0][2]), clip, smi)
    del clip

    # train_gan: AdaCoF training with the VGG and adversarial terms; each
    # adversarial step on the card against the CPU; the native loader; and
    # beside them `cli export`'s process.  Then export: its artifact loaded
    # in a fresh process; a port-trained AdaCoF written out; the profiling
    # utilities on one request
    torch.cuda.empty_cache()
    exporter = start_export(repo)
    try:
        gan_k1, gan_k2, gan_types_k1, gan_types_k2 = phase_train_gan(dev, repo, ada_path)
        phase_gan_vs_cpu(dev)
        phase_native()
        torch.cuda.empty_cache()
    except BaseException:
        _stop_children(exporter["proc"])
        exporter["work"].cleanup()
        raise
    export_k1, export_k2 = phase_export(dev, repo, ada_path, fusion_path,
                                        (requests[0][0], requests[0][2]),
                                        float(np.mean(lat_ms[1:])), exporter)
    del requests
    dp_k1, dp_k2 = phase_dp(dev, repo)
    spatial_k1, spatial_k2 = phase_spatial(dev, repo)
    spatial_train_k1, spatial_train_k2 = phase_spatial_train(dev, repo)
    regime_k1.update(lpips=lpips_k1, photo=photo_k1, inputs=inputs_k1, cli=cli_k1,
                     export=export_k1,
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
                              inputs=0,
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
