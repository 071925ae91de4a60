#!/usr/bin/env python3
"""Where the AdaCoF warp kernels' time goes, on one CUDA card.

    python3 scripts/adacof_kernel_diagnostics.py [--parent DIR]

Times this checkout's K1 (csrc/adacof_warp.cu) and K2 (adacof_warp_bwd.cu)
at the main paths' launches, 4 and 2 images of 1088x1920 (serving) and 8 of
256x256 (training), F 5, d 1, max_offset 48, uniform +-3 px offsets and
softmax weights, in four forms:

  as_is         the kernels as the package builds them;
  no_ring       the same fields one float off a 16-byte boundary, which the
                kernels take without the asynchronous-copy ring;
  fields_only   built with -DADACOF_DIAG_FORM=1 (csrc/adacof_ring.cuh): every
                gather gives 1, so a kernel only streams its fields and
                writes its outputs;
  gathers_only  built with -DADACOF_DIAG_FORM=2: every tile reads the fields
                of its image's first tile, which stay in L2, so a kernel
                only gathers.

Each form's result is held against what it computes (the plain versions
for as_is, no_ring and gathers_only, on the fields it read; sum_t W for K1's
fields_only, and dW = sum_c g, dalpha = dbeta = 0 for K2's), so that a form
which skipped work fails instead of reading fast.  K2 takes the RGBX copy
of x that K1 wrote, as on the training path.

--parent DIR also times DIR's kernels as they are, through DIR's own
wrapper (DIR: another checkout, e.g. `git archive <commit> | tar -x -C
DIR`), in a process of its own before and after this checkout's: the order
is parent, this, this, parent.

Each time is the median over 10 repetitions of the mean of 10 back-to-back
launches (CUDA events).  Prints one JSON line per launch shape, per tree,
and the card's nvidia-smi line.

Each tree's kernels are also held against the plain versions where the
ring's consumers lag its producer (FAR: offsets to +-60 px, more blocks
than the card holds at once; the race of ROADMAP Q3-4), three launches of
K1 and of K2 each; the line reports every launch's max abs error.
"""

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

LAUNCHES = ((4, 1088, 1920), (2, 1088, 1920), (8, 256, 256))
FORMS = {"fields_only": 1, "gathers_only": 2}  # form -> ADACOF_DIAG_FORM
K1_TOL, K2_TOL = 1e-5, 1e-4
TILE = (8, 64)  # csrc/adacof_ring.cuh kTileH, kTileW


def cuda_ms(fn, reps=10, inner=10):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(inner):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / inner)
    return float(np.median(times))


def inputs(b, h, w):
    """x, W, alpha, beta and a cotangent, the same in every process."""
    gen = torch.Generator(device="cuda").manual_seed(b * 10007 + h)
    x = torch.rand((b, 3, h + 4, w + 4), generator=gen, device="cuda")
    wgt = torch.softmax(2.0 * torch.randn((b, 25, h, w), generator=gen, device="cuda"), 1)
    a, be = ((torch.rand((b, 25, h, w), generator=gen, device="cuda") * 2 - 1) * 3.0
             for _ in range(2))
    g = torch.randn((b, 3, h, w), generator=gen, device="cuda")
    return x, wgt, a, be, g


FAR = ((2, 1080, 1920), (8, 256, 256))  # images, rows, columns; F 5, offsets to +-60


def far_errors(cuda, plain, tree):
    """Each of three K1 and K2 launches' max abs error against the plain
    versions at the FAR launches (one JSON line each); returns the largest
    of K1's and of K2's."""
    worst = [0.0, 0.0]
    for b, h, w in FAR:
        gen = torch.Generator(device="cuda").manual_seed(b * 7 + h)
        x = torch.rand((b, 3, h + 4, w + 4), generator=gen, device="cuda")
        wgt = torch.softmax(4.0 * torch.rand((b, 25, h, w), generator=gen, device="cuda"), 1)
        a, be = ((torch.rand((b, 25, h, w), generator=gen, device="cuda") * 2 - 1) * 60.0
                 for _ in range(2))
        g = torch.randn((b, 3, h, w), generator=gen, device="cuda")
        want1 = plain.adacof_warp(x, wgt, a, be, 1, 48)
        want2 = plain.adacof_warp_field_grads(x, wgt, a, be, g, 1, 48)
        k1, k2 = [], []
        for _ in range(3):
            out, x4 = cuda.warp_fwd_cuda(x, wgt, a, be, 1, 48)
            k1.append(max_err([out], [want1]))
            k2.append(max_err(cuda.warp_bwd_cuda(x, wgt, a, be, g, 1, 48, x4), want2))
        print(json.dumps(dict(tree=tree, far=[b, h, w], offsets=60.0, k1_max_abs_err=k1,
                              k2_max_abs_err=k2)), flush=True)
        worst = [max(worst[0], *k1), max(worst[1], *k2)]
        del x, wgt, a, be, g, want1, want2
        torch.cuda.empty_cache()
    return worst


def unaligned(t):
    """t's values in a tensor whose data starts one float off 16 bytes."""
    out = torch.empty(t.numel() + 1, device=t.device)[1:].view(t.shape)
    out.copy_(t)
    return out


def first_tile(t):
    """The fields every tile reads in the gathers_only form: each tile's
    values replaced by those of its image's first tile."""
    h, w = t.shape[2:]
    th, tw = TILE
    return t[:, :, :th, :tw].repeat(1, 1, h // th, w // tw)


def max_err(got, want):
    return max(float((k - p).abs().max()) for k, p in zip(got, want))


def time_parent(cuda):
    """The parent tree's kernels as they are (run with DIR first on sys.path)."""
    for b, h, w in LAUNCHES:
        x, wgt, a, be, g = inputs(b, h, w)
        ms = {"k1": cuda_ms(lambda: cuda.adacof_warp(x, wgt, a, be, 1, 48))}
        if hasattr(cuda, "warp_bwd_cuda"):  # on the RGBX copy K1 wrote, as time_this
            x4 = cuda.warp_fwd_cuda(x, wgt, a, be, 1, 48)[1]
            ms["k2"] = cuda_ms(lambda: cuda.warp_bwd_cuda(x, wgt, a, be, g, 1, 48, x4))
        print(json.dumps(dict(tree="parent", images=b, h=h, w=w, ms=ms)), flush=True)
        del x, wgt, a, be, g
        torch.cuda.empty_cache()
    from fmvfi_tpu_torch.ops import adacof as plain

    far_errors(cuda, plain, "parent")


def time_this():
    from fmvfi_tpu_torch import _build
    from fmvfi_tpu_torch.ops import adacof as plain
    from fmvfi_tpu_torch.ops import adacof_cuda as cuda

    flags = {form: (f"-DADACOF_DIAG_FORM={n}",) for form, n in FORMS.items()}
    with ThreadPoolExecutor(len(flags) + 1) as ex:  # every build at once
        paths = dict(zip(["as_is", *flags], ex.map(_build.build, [(), *flags.values()])))
    libs = {form: _build.load(p) for form, p in paths.items()}
    libs["no_ring"] = libs["as_is"]

    def use(form):
        _build._lib = libs[form]  # the wrapper's library

    for b, h, w in LAUNCHES:
        x, wgt, a, be, g = inputs(b, h, w)
        fields = {"as_is": (wgt, a, be), "no_ring": tuple(unaligned(t) for t in (wgt, a, be))}
        fields["fields_only"] = fields["gathers_only"] = fields["as_is"]
        x4 = {}
        for form in fields:
            use(form)
            x4[form] = cuda.warp_fwd_cuda(x, *fields[form], 1, 48)[1]

        def k1(form):  # through K3, as the parent's is timed
            use(form)
            return cuda.adacof_warp(x, *fields[form], 1, 48)

        def k2(form):
            use(form)
            return cuda.warp_bwd_cuda(x, *fields[form], g, 1, 48, x4=x4[form])

        ms = {}
        order = [(k, f) for f in fields for k in ("k1", "k2")]
        for kernel, form in order + order[::-1]:
            fn = k1 if kernel == "k1" else k2
            ms.setdefault(f"{kernel}_{form}", []).append(cuda_ms(lambda: fn(form)))

        # what each form computed, after the timed launches
        cuda.paths.clear()
        cuda.bwd_paths.clear()
        tiled = tuple(first_tile(t) for t in (wgt, a, be))
        want1 = plain.adacof_warp(x, wgt, a, be, 1, 48)
        want2 = plain.adacof_warp_field_grads(x, wgt, a, be, g, 1, 48)
        zero = torch.zeros_like(wgt)
        err = {
            "k1_as_is": max_err([k1("as_is")], [want1]),
            "k1_no_ring": max_err([k1("no_ring")], [want1]),
            "k1_fields_only": max_err([k1("fields_only")], [wgt.sum(1, keepdim=True).expand(
                -1, 3, -1, -1)]),
            "k1_gathers_only": max_err([k1("gathers_only")],
                                       [plain.adacof_warp(x, *tiled, 1, 48)]),
            "k2_as_is": max_err(k2("as_is"), want2),
            "k2_no_ring": max_err(k2("no_ring"), want2),
            "k2_fields_only": max_err(k2("fields_only"), [
                g.sum(1, keepdim=True).expand_as(wgt), zero, zero]),
            "k2_gathers_only": max_err(k2("gathers_only"),
                                       plain.adacof_warp_field_grads(x, *tiled, g, 1, 48)),
        }
        use("as_is")
        print(json.dumps(dict(tree="this", images=b, h=h, w=w, ms=ms, max_abs_err=err,
                              k1_paths=dict(cuda.paths), k2_paths=dict(cuda.bwd_paths))),
              flush=True)
        bad = {k: v for k, v in err.items() if not v <= (K1_TOL if k[:2] == "k1" else K2_TOL)}
        if bad:
            raise SystemExit(f"forms disagree with what they compute: {bad}")
        del x, wgt, a, be, g, fields, x4, tiled, want1, want2, zero
        torch.cuda.empty_cache()
    k1_err, k2_err = far_errors(cuda, plain, "this")
    if not (k1_err <= K1_TOL and k2_err <= K2_TOL):
        raise SystemExit(f"far offsets: K1 {k1_err}, K2 {k2_err} from the plain versions")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another checkout whose kernels to time as they are")
    ap.add_argument("--tree", help=argparse.SUPPRESS)  # the parent's own process
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("adacof_kernel_diagnostics: no CUDA card", file=sys.stderr)
        return 2
    if args.tree:
        sys.path.insert(0, os.path.abspath(args.tree))
        from fmvfi_tpu_torch.ops import adacof_cuda

        time_parent(adacof_cuda)
        return 0
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    parent = [sys.executable, os.path.abspath(__file__), "--tree", args.parent or ""]
    if args.parent:
        subprocess.run(parent, check=True)
    time_this()
    if args.parent:
        subprocess.run(parent, check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
