"""Command-line entry points of the port (port of fmvfi_tpu/cli.py):

    python -m fmvfi_tpu_torch.cli interpolate --first_frame a.png --second_frame b.png
    python -m fmvfi_tpu_torch.cli video       --input frames/ --output_dir out/
    python -m fmvfi_tpu_torch.cli evaluate    --out_dir results/
    python -m fmvfi_tpu_torch.cli train       --regime adacof --data_dir vimeo_triplet/
    python -m fmvfi_tpu_torch.cli export      --method fusion --size 1080x1920 --out f.pt2

Flags, defaults and messages are JAX's, plus `--device` (default cuda): a
command exits with an error when there is no CUDA card, unless it is given
`--device cpu`.  Convolutions run in float32 (TF32 off), as the reference
computes.  Images are PNG or baseline JPEG files (utils/imageio.py); output
frames are written in the format their extension names, as cv2.imwrite
writes them (.png, or .jpg/.jpeg/.jpe at quality 95).  The default PhaseNet
and FusionNet checkpoints are the reference's file names under the
repository's checkpoints/ directory.  As in JAX, without
--adacof_checkpoint the bundled demo AdaCoF is used, and with it the demo
FusionNet in place of a file named fusion_net.pt.

`evaluate` writes JAX's files: summary.json, each synthetic set's panels
and <set>.avi, and the results.png bar chart (eval/visualize.py).  Not
ported yet: video files as input raise NotImplementedError (ROADMAP Queue
1, item 18.4).  `train --data_parallel` runs one process per GPU
(torchrun), where JAX runs one process over a mesh of devices.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

CKPT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "checkpoints")


def _device_of(p: argparse.ArgumentParser, args) -> torch.device:
    """The parsed --device; exits through p.error when it is a CUDA device
    and there is no card.  On a card, TF32 is turned off."""
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            p.error("no CUDA card is available; pass --device cpu to run on the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev


def _load_weights(args):
    """The FusionModels a command needs, on args.device, in eval mode
    (fmvfi_tpu/cli.py:21-117).  A single method loads only its own networks
    (phase: PhaseNet; adacof: AdaCoF), the others None; `--methods` loads
    what any listed method needs.  Resolves args.fusion_maps and
    args.fusion_variant (>= 0) by JAX's rules: maps 0 when the FusionNet
    file's name holds "nouncertainty", else 3; variant 1 when a .pt file's
    name holds "phase", else 0; a .msgpack file's variant from its tree."""
    from .models.adacof import AdaCoFNet
    from .models.fusion_net import FusionNet, infer_variant
    from .models.phase_net import PhaseNetCore
    from .models.registry import get_model
    from .pipeline.interpolate import FusionModels
    from .utils.convert import load_adacof_weights, load_fusion_weights, phase_net_from_torch

    dev = torch.device(args.device)
    method = getattr(args, "method", "fusion")
    methods = set(getattr(args, "methods", method).split(","))
    need_ada = bool(methods - {"phase"})
    need_phase = bool(methods - {"adacof"})
    need_fusion = bool(methods & {"fusion"})

    using_demo_ada = False
    ada = None
    if need_ada:
        if args.adacof_checkpoint:
            ada = AdaCoFNet(kernel_size=args.kernel_size, dilation=args.dilation)
            ada.load_state_dict(load_adacof_weights(args.adacof_checkpoint))
        else:
            demo = os.path.join(CKPT_DIR, "adacof_synth_demo.msgpack")
            if os.path.exists(demo) and args.kernel_size == 5:
                ada = AdaCoFNet(kernel_size=5, dilation=args.dilation)
                ada.load_state_dict(load_adacof_weights(demo))
                using_demo_ada = True
                print(f"note: using bundled demo AdaCoF weights ({demo}); pass "
                      "--adacof_checkpoint for trained ones", file=sys.stderr)
            else:
                with torch.random.fork_rng(devices=[]):  # seed 0, as JAX's key 0
                    torch.manual_seed(0)
                    ada = get_model(getattr(args, "model", None) or "adacof",
                                    kernel_size=args.kernel_size, dilation=args.dilation)
                print("warning: no --adacof_checkpoint, using random AdaCoF weights",
                      file=sys.stderr)

    fusion_ckpt = args.fusion_checkpoint
    demo_fusion = os.path.join(CKPT_DIR, "fusion_synth_demo.msgpack")
    if (
        need_fusion
        and using_demo_ada
        and os.path.exists(demo_fusion)
        and fusion_ckpt.endswith("fusion_net.pt")
    ):
        # the published FusionNet was trained against the published AdaCoF;
        # with the demo AdaCoF, prefer the FusionNet finetuned alongside it
        fusion_ckpt = demo_fusion
        print(f"note: using bundled demo FusionNet ({demo_fusion}) matched to "
              "the demo AdaCoF", file=sys.stderr)

    name = os.path.basename(fusion_ckpt)
    if getattr(args, "fusion_maps", -1) < 0:
        args.fusion_maps = 0 if "nouncertainty" in name else 3
    explicit_variant = getattr(args, "fusion_variant", -1)
    if explicit_variant < 0 and not fusion_ckpt.endswith(".msgpack"):
        explicit_variant = 1 if "phase" in name else 0
    fusion_sd = load_fusion_weights(fusion_ckpt) if need_fusion else None
    if getattr(args, "fusion_variant", -1) < 0:
        if explicit_variant >= 0 or fusion_sd is None:
            args.fusion_variant = max(explicit_variant, 0)
        else:
            args.fusion_variant = infer_variant(fusion_sd)
    fusion = None
    if fusion_sd is not None:
        fusion = FusionNet(uncertainty_maps=args.fusion_maps, variant=args.fusion_variant)
        fusion.load_state_dict(fusion_sd)
    phase = None
    if need_phase:
        phase = PhaseNetCore()
        phase.load_state_dict(phase_net_from_torch(args.phase_checkpoint))
    return FusionModels(*(m if m is None else m.to(dev).eval() for m in (phase, ada, fusion)))


def _common(p):
    p.add_argument("--method", default="fusion", choices=["fusion", "phase", "adacof"])
    p.add_argument("--phase_checkpoint", default=os.path.join(CKPT_DIR, "phase_net.pt"))
    p.add_argument("--fusion_checkpoint", default=os.path.join(CKPT_DIR, "fusion_net.pt"))
    p.add_argument("--adacof_checkpoint", default="")
    p.add_argument("--fusion_variant", type=int, default=-1,
                   choices=[-1, 0, 1, 2],
                   help="FusionNet head: 0 = residual over the baseline "
                        "composite, 1 = residual over the phase prediction "
                        "(fusion_net_phase.pt), 2 = gated-blend head "
                        "(beyond-reference; *blend*.msgpack); -1 = auto "
                        "from checkpoint name")
    p.add_argument("--fusion_maps", type=int, default=-1, choices=[-1, 0, 3],
                   help="uncertainty-map channels: 3 = full, 0 = no-maps "
                        "ablation (fusion_net_nouncertainty.pt); -1 = auto "
                        "from checkpoint name")
    p.add_argument("--kernel_size", type=int, default=5)
    p.add_argument("--dilation", type=int, default=1)
    p.add_argument("--model", default="",
                   help="registry name or dotted path exposing make_model() "
                        "(the reference's dynamic loader, models/__init__.py)")
    p.add_argument("--device", default="cuda",
                   help="torch device; without a CUDA card the command exits "
                        "unless this is 'cpu'")


def _write(path: str, img) -> None:
    """A [0, 1] (H, W, 3) frame (tensor or array) quantized as JAX writes it,
    in the format the extension names (cv2.imwrite's choice)."""
    from .pipeline.video import quantize
    from .utils import imageio

    imageio.imwrite(path, quantize(img.cpu().numpy() if torch.is_tensor(img) else img))
    print(f"wrote {path}")


def cmd_interpolate(argv):
    p = argparse.ArgumentParser(prog="interpolate")
    p.add_argument("--first_frame", required=True)
    p.add_argument("--second_frame", required=True)
    p.add_argument("--output_frame", default="./output.png")
    p.add_argument("--dim", type=int, default=0, help="center-crop size (0 = full)")
    p.add_argument("--output_phase", default="", help="also write the PhaseNet prediction here")
    p.add_argument("--output_adacof", default="", help="also write the AdaCoF prediction here")
    p.add_argument("--output_baseline", default="", help="also write the 3-pass baseline composite here")
    _common(p)
    args = p.parse_args(argv)
    dev = _device_of(p, args)

    from .eval.evaluate import crop_center
    from .pipeline.interpolate import fusion_interpolate
    from .pipeline.video import _interp_fn
    from .utils import imageio

    def read(path):
        try:
            img = imageio.imread(path)
        except (OSError, ValueError, NotImplementedError) as e:
            p.error(f"cannot read image: {path} ({e})")
        return img.astype(np.float32) / 255.0

    f1, f2 = read(args.first_frame), read(args.second_frame)
    if args.dim:
        f1 = crop_center(f1, args.dim)
        f2 = crop_center(f2, args.dim)
    models = _load_weights(args)

    side = args.output_phase or args.output_adacof or args.output_baseline
    if side and args.method == "fusion":
        out, parts = fusion_interpolate(models, f1[None], f2[None], return_parts=True, device=dev)
        if args.output_phase:
            _write(args.output_phase, parts["phase"][0])
        if args.output_adacof:
            _write(args.output_adacof, parts["adacof"][0])
        if args.output_baseline:
            _write(args.output_baseline, parts["baseline"][0])
        out = out[0]
    else:
        out = _interp_fn(models, args.method, device=dev)(f1[None], f2[None])[0]
    _write(args.output_frame, out)


def cmd_video(argv):
    p = argparse.ArgumentParser(prog="video")
    p.add_argument("--input", required=True, help="video file or frame directory")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--batch", type=int, default=1,
                   help="pairs per device dispatch (>1 = offline-throughput "
                        "mode; 1 = per-pair latency mode)")
    p.add_argument("--factor", type=int, default=2,
                   help="rate multiplier (power of two; >2 = recursive "
                        "midpoint doubling)")
    p.add_argument("--stream", action="store_true",
                   help="fusion: streaming serving loop (the shared frame's "
                        "pyramid decomposition is reused across consecutive "
                        "pairs) instead of per-pair")
    p.add_argument("--stream_window", type=int, default=8,
                   help="stream steps per fetch of their outputs")
    p.add_argument("--seq_chunk", type=int, default=0,
                   help="fusion + --batch>1: run the bandwidth-bound middle "
                        "sections over batch chunks of this size (bounds "
                        "peak device memory)")
    _common(p)
    args = p.parse_args(argv)
    dev = _device_of(p, args)

    from .eval.evaluate import load_set
    from .pipeline.video import multiply_frame_rate, write_frame_dir

    frames = load_set(args.input)
    models = _load_weights(args)
    out = list(multiply_frame_rate(frames, models, args.method, factor=args.factor,
                                   stream=args.stream, batch=args.batch,
                                   stream_window=args.stream_window, seq_chunk=args.seq_chunk,
                                   device=dev))
    write_frame_dir(args.output_dir, out)
    print(f"wrote {len(out)} frames to {args.output_dir}")


def cmd_evaluate(argv):
    p = argparse.ArgumentParser(prog="evaluate")
    p.add_argument("--out_dir", default="./results")
    p.add_argument("--test_sets", default="synthetic",
                   help="'synthetic', 'synthetic+photo' (adds a real-"
                        "photograph motion set with exact GT), "
                        "comma-separated video/frame-dir paths, "
                        "or adapter specs like middlebury:<in>:<gt>, "
                        "davis:<in>:<gt>, ucf101:<dir>, vimeo:<root>, "
                        "middlebury_eval:<dir> (scored per scene like "
                        "TestModule.py)")
    p.add_argument("--methods", default="fusion")
    p.add_argument("--dim", type=int, default=512)
    p.add_argument("--max_num", type=int, default=10)
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--vgg_checkpoint", default="",
                   help="torchvision vgg16 state dict: adds the real "
                        "VGG-feature LPIPS column (evaluate_image.py:21-28); "
                        "without it the documented lpips_sub substitute is "
                        "reported")
    _common(p)
    args = p.parse_args(argv)
    dev = _device_of(p, args)

    from .eval.datasets import load_test_set
    from .eval.evaluate import evaluate_suite, evaluate_triplets, load_set, synthetic_sets
    from .eval.visualize import metric_bars

    lpips_fn = None
    if args.vgg_checkpoint:
        from .eval.metrics import make_vgg_lpips

        lpips_fn = make_vgg_lpips(args.vgg_checkpoint, device=dev)

    adapters = {a + ":" for a in
                ("middlebury", "middlebury_eval", "davis", "ucf101", "vimeo")}
    synth_mode = args.test_sets in ("synthetic", "synthetic+photo")
    specs = [] if synth_mode else args.test_sets.split(",")
    paired = [s for s in specs if any(s.startswith(a) for a in adapters)]
    plain = [s for s in specs if s not in paired]

    models = _load_weights(args)
    summary = {}
    if synth_mode or plain:
        if synth_mode:
            sets = synthetic_sets(
                args.dim, include_photo=args.test_sets.endswith("+photo")
            )
        else:
            # streamed: frames decode as they score (u8 until device
            # upload), so a multi-clip 1080p sweep fits host RAM
            sets = {s.split("/")[-1]: load_set(s, stream=True) for s in plain}
        summary = evaluate_suite(
            models,
            args.out_dir,
            sets=sets,
            methods=args.methods.split(","),
            dim=args.dim,
            max_num=args.max_num,
            overwrite=args.overwrite,
            lpips_fn=lpips_fn,
            device=dev,
        )
        metric_bars(summary, out_path=f"{args.out_dir}/results.png")

    for spec in paired:
        name = spec.split(":")[0]
        triplets = load_test_set(spec, max_num=args.max_num)
        for method in args.methods.split(","):
            res = evaluate_triplets(
                triplets, models, method,
                output_dir=f"{args.out_dir}/{name}_{method}",
                lpips_fn=lpips_fn,
                device=dev,
            )
            os.makedirs(args.out_dir, exist_ok=True)
            with open(f"{args.out_dir}/result_{name}_{method}.json", "w") as f:
                json.dump(res, f, indent=2)
            summary[f"{name}/{method}"] = res.get("average", {})
    print(json.dumps(summary, indent=2))


def cmd_train(argv):
    p = argparse.ArgumentParser(prog="train")
    p.add_argument("--regime", default="adacof", choices=["adacof", "phase", "fusion"])
    p.add_argument("--data_dir", default="", help="Vimeo90k root (empty = synthetic)")
    p.add_argument("--out_dir", default="./output")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--steps_per_epoch", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--crop", type=int, default=128)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--lr_decay_epochs", type=int, default=0,
                   help="halve the LR every N epochs (reference AdaCoF: 20)")
    p.add_argument("--loss", default="1*Charb+0.01*g_Spatial+0.005*g_Occlusion")
    p.add_argument("--vgg_checkpoint", default="",
                   help="torchvision vgg16 state dict (required for *VGG loss)")
    p.add_argument("--optimizer", default="adamax")
    p.add_argument("--mode", default="phase", choices=["phase", "fusion"],
                   help="phase regime: plain or fusion-input variant "
                        "(train/train.py --mode)")
    p.add_argument("--model_variant", type=int, default=0, choices=[0, 1],
                   help="fusion-mode phase training: 0=warped pair inputs "
                        "(num_img=4), 1=blended input (num_img=3)")
    p.add_argument("--high_level", action="store_true",
                   help="carry AdaCoF's highpass band (architecture.py:64-66)")
    p.add_argument("--m", type=int, default=0,
                   help="hierarchical training: start predicting only the m "
                        "coarsest levels (0 = all levels, no schedule)")
    p.add_argument("--m_update", type=int, default=500,
                   help="increment m every N batches (train/trainer.py:162)")
    p.add_argument("--data_parallel", action="store_true",
                   help="one step on the global batch over a process group, one process per "
                        "GPU (run under `torchrun --nproc_per_node=N python -m "
                        "fmvfi_tpu_torch.cli train ...`; without torchrun a group of this one "
                        "process): --batch_size is the global batch, each process loads its "
                        "share, gradients and batch statistics are reduced over the group "
                        "(NCCL on CUDA, gloo on the CPU) and only rank 0 writes.  JAX's "
                        "--data_parallel is one process over a mesh of devices")
    _common(p)
    args = p.parse_args(argv)
    dev = _device_of(p, args)
    if args.data_parallel:
        from .parallel import distributed

        # before the trainer's tensors: under torchrun this takes the card of
        # LOCAL_RANK, so that "cuda" is this process's own
        distributed.initialize(backend="nccl" if dev.type == "cuda" else "gloo")

    from .train import trainer as T
    from .train.data import SyntheticTriplets, Vimeo90kTriplets, batch_iterator
    from .train.loop import fit
    from .train.losses import parse_loss_spec
    from .utils import config as C

    hw = args.crop
    decay_steps = args.lr_decay_epochs * args.steps_per_epoch or None
    make_step = None
    if args.regime == "adacof":
        state, step = T.make_adacof_trainer(
            kernel_size=args.kernel_size, dilation=args.dilation,
            lr=args.lr or 1e-3, loss_spec=parse_loss_spec(args.loss),
            optimizer=args.optimizer, lr_decay_steps=decay_steps,
            vgg_checkpoint=args.vgg_checkpoint or None, h=hw, w=hw, device=dev,
        )
    elif args.regime == "phase":
        adacof = None
        if args.mode == "fusion" or args.high_level:
            adacof = _load_weights(args).adacof
        state, step, _, make_step = T.make_phase_trainer(
            hw, hw, lr=args.lr or 1e-3, mode=args.mode,
            model_variant=args.model_variant, adacof=adacof,
            high_level=args.high_level, device=dev,
        )
    else:
        w = _load_weights(args)
        state, step = T.make_fusion_trainer(
            w.phase_net, w.adacof, lr=args.lr or 1e-4,
            variant=args.fusion_variant, uncertainty_maps=args.fusion_maps, device=dev,
        )

    # persist the full config next to the checkpoints (train/train.py:107-111)
    cfg = C.Config()
    cfg.adacof.kernel_size = args.kernel_size
    cfg.adacof.dilation = args.dilation
    cfg.adacof.checkpoint = args.adacof_checkpoint
    cfg.phase_net.checkpoint = args.phase_checkpoint
    cfg.fusion_net.checkpoint = args.fusion_checkpoint
    cfg.train.epochs = args.epochs
    cfg.train.batch_size = args.batch_size
    cfg.train.lr = args.lr or {"adacof": 1e-3, "phase": 1e-3, "fusion": 1e-4}[args.regime]
    cfg.train.optimizer = args.optimizer
    cfg.train.loss = args.loss
    cfg.train.crop = args.crop
    cfg.train.out_dir = args.out_dir
    cfg.train.data_dir = args.data_dir
    rank0 = True
    wrap, shard = None, None
    if args.data_parallel:
        from .parallel.dp import data_parallel
        from .parallel.mesh import make_mesh, replicate

        mesh = make_mesh()
        state = replicate(mesh, state)
        shard = distributed.local_batch_slice(args.batch_size)
        rank0 = distributed.process_index() == 0

        def wrap(raw):  # fit applies it to the first step and every m rebuild
            return data_parallel(raw, mesh)

    if rank0:
        C.save(cfg, f"{args.out_dir}/config.json")

    if args.data_dir:
        ds = Vimeo90kTriplets(args.data_dir)
    else:
        ds = SyntheticTriplets(n=32, h=args.crop + 16, w=args.crop + 16)
        if rank0:
            print("note: no --data_dir, training on synthetic motion", file=sys.stderr)
    batches = batch_iterator(ds, args.batch_size, crop=args.crop, shard=shard)
    try:
        state = fit(
            state, step, batches, args.out_dir,
            epochs=args.epochs, steps_per_epoch=args.steps_per_epoch,
            make_step=make_step if args.m else None,
            m_init=args.m or None, m_update=args.m_update,
            wrap_step=wrap,
        )
    finally:
        batches.close()
    if rank0:
        print(f"trained {int(state.step)} steps; checkpoints in {args.out_dir}/checkpoint")


def cmd_export(argv):
    """AOT-export a pipeline as a serving artifact in one file (a
    torch.export program with its weights and filter bank, utils/export.py):
    with --platforms cpu it loads with torch alone, without this package;
    an artifact for cuda calls K1 through its registered operator."""
    p = argparse.ArgumentParser(prog="export", description=cmd_export.__doc__)
    p.add_argument("--size", default="512x512", help="HxW the artifact serves")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--out", default="pipeline.fmx.pt2")
    p.add_argument("--platforms", default="",
                   help="comma list of cpu and cuda (e.g. cpu,cuda) for a multi-platform "
                        "artifact; empty = the --device's")
    _common(p)
    args = p.parse_args(argv)
    _device_of(p, args)
    h, w = (int(x) for x in args.size.split("x"))

    from .utils.export import export_pipeline, save_exported

    weights = _load_weights(args)  # resolves fusion_variant/maps >= 0
    blob = export_pipeline(
        weights, h, w, args.method, batch=args.batch,
        kernel_size=args.kernel_size, dilation=args.dilation,
        variant=args.fusion_variant, uncertainty_maps=args.fusion_maps,
        platforms=[s for s in args.platforms.split(",") if s] or None,
    )
    save_exported(args.out, blob)
    print(f"exported {args.method} {args.batch}x{h}x{w} -> {args.out} "
          f"({len(blob)/1e6:.1f} MB)")


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    cmds = {
        "interpolate": cmd_interpolate,
        "video": cmd_video,
        "evaluate": cmd_evaluate,
        "train": cmd_train,
        "export": cmd_export,
    }
    if not argv or argv[0] not in cmds:
        print(f"usage: python -m fmvfi_tpu_torch.cli {{{'|'.join(cmds)}}} ...")
        return 1
    return cmds[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main() or 0)
