"""Evaluation harness (port of the array side of fmvfi_tpu/eval/evaluate.py):
every consecutive triplet (i, i+1, i+2) of a set is interpolated from frames
i and i+2 and scored against frame i+1, center-cropped to `dim`.  Results
are cached per (set, method, weights) in `result_*.npz` files beside a
`summary.json`.

Sets are (N, H, W, 3) arrays (float in [0, 1] or uint8), frame iterators,
or zero-argument callables returning a fresh iterator; `load_set` reads
them from directories of PNG or JPEG frames.  With visualize=True (the
default, as in JAX) `evaluate_suite` also draws each set's target /
prediction / |diff| panels and stitches them into an MJPG AVI
(eval/visualize.py).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..pipeline.interpolate import FusionModels, _device
from ..pipeline.video import (
    _interp_fn,
    iter_frame_dir,
    iter_video_frames,
    quantize,
    read_frame_dir,
    read_video_frames,
    to_device,
)
from ..utils import imageio
from .metrics import all_metrics
from .synth import benchmark_sets, photo_video, translation_video

METRIC_NAMES = ("ssim", "lpips_sub", "psnr", "ssd", "l1", "mean_diff", "var_diff")

# part of every cache key: bump it when code changes what a cached number means
_EVAL_PROTOCOL = "torch.1"


def crop_center(img: np.ndarray, dim: int) -> np.ndarray:
    h, w = img.shape[-3:-1]
    if dim >= min(h, w):
        return img
    y0 = h // 2 - dim // 2
    x0 = w // 2 - dim // 2
    return img[..., y0 : y0 + dim, x0 : x0 + dim, :]


def _upload(batch: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Host frames to the device: uint8 frames go up as uint8 (a quarter of
    the bytes) and are normalized there; float frames go up as they are."""
    t = to_device(batch, dev)
    return t.float() / 255.0 if t.dtype == torch.uint8 else t


def evaluate_frames(
    frames,
    models: FusionModels,
    method: str = "fusion",
    dim: int = 512,
    max_num: Optional[int] = None,
    return_preds: bool = False,
    batch_size: int = 4,
    lpips_fn=None,
    *,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """Score every (i, i+1, i+2) triplet; returns {metric: (n_triplets,)}
    (fmvfi_tpu/eval/evaluate.py:57-153).

    `frames` is an (N, H, W, 3) array or an iterator of (H, W, 3) frames,
    read through a 3-frame rolling window, so at most `batch_size` triplets
    are held on the host; `max_num` stops the reading after that many
    triplets.  Triplets go through the method `batch_size` at a time.
    `lpips_fn` (one (H, W, 3) pair -> a scalar) adds `lpips_vgg`.  With
    return_preds=True the dict also holds "preds", (n, H, W, 3) uint8."""
    dev = _device(device)
    out: Dict[str, List[np.ndarray]] = {k: [] for k in METRIC_NAMES}
    if lpips_fn is not None:
        out["lpips_vgg"] = []
    preds_all: List[np.ndarray] = []
    fn = None
    shape = (0, 0)

    def flush(tri):
        nonlocal fn, shape
        f1, tgt, f2 = (np.stack([t[j] for t in tri]) for j in range(3))
        if fn is None:
            shape = f1.shape[1:3]
            fn = _interp_fn(models, method, device=dev)
        preds = fn(_upload(f1, dev), _upload(f2, dev))
        with torch.no_grad():
            m = all_metrics(preds, _upload(tgt, dev), lpips_fn)
        for k, v in m.items():
            out[k].append(v.cpu().numpy())
        if return_preds:
            preds_all.append((preds.cpu().numpy() * 255.0).clip(0, 255).astype(np.uint8))

    window: List[np.ndarray] = []
    pending = []
    n_done = 0
    for frame in frames:  # a 4-D array iterates as (H, W, 3) frames
        window.append(crop_center(np.asarray(frame), dim))
        if len(window) > 3:
            window.pop(0)
        if len(window) == 3:
            pending.append(tuple(window))
            n_done += 1
            if len(pending) == batch_size:
                flush(pending)
                pending = []
            if max_num is not None and n_done >= max_num:
                break
    if pending:
        flush(pending)

    result = {k: np.concatenate(v) if v else np.zeros(0, np.float32) for k, v in out.items()}
    if return_preds:
        result["preds"] = (
            np.concatenate(preds_all) if preds_all else np.zeros((0, *shape, 3), np.uint8)
        )
    return result


def synthetic_sets(
    dim: int = 512, n_frames: int = 6, include_photo: bool = False, seeds: Sequence[int] = (0,)
) -> Dict[str, np.ndarray]:
    """One set per motion regime of `benchmark_sets` plus the two step-
    translation sets (fmvfi_tpu/eval/evaluate.py:156-194), and with
    include_photo the real-photograph set `photo` (photo_video, natural
    image statistics).  With several `seeds` each set is drawn once per seed
    under `<name>@s<k>`."""
    multi = len(seeds) > 1
    sets: Dict[str, np.ndarray] = {}
    for k in seeds:
        off = 100 * int(k)
        sfx = f"@s{k}" if multi else ""
        for name, frames in benchmark_sets(dim, n_frames, seed_offset=off).items():
            sets[name + sfx] = frames
        for s in (1, 10):
            sets[f"synth_step{s}{sfx}"] = translation_video(
                n_frames, dim, dim, step=float(s), seed=s + off
            )
        if include_photo:
            sets[f"photo{sfx}"] = photo_video(n_frames, dim, dim, seed=11 + off)
    return sets


def _weights_digest(modules: Sequence[torch.nn.Module], *config) -> str:
    """Content key of the result cache: the protocol, the config and every
    byte of the modules' state dicts (names, shapes, dtypes, values)."""
    hsh = hashlib.sha1()
    hsh.update(_EVAL_PROTOCOL.encode())
    hsh.update("|".join(map(str, config)).encode())
    for m in modules:
        for name, v in m.state_dict().items():
            a = v.detach().cpu().numpy()
            hsh.update(f"{name}{a.shape}{a.dtype}".encode())
            hsh.update(np.ascontiguousarray(a).tobytes())
    return hsh.hexdigest()[:10]


def _method_cache_key(models: FusionModels, method: str, dim: int, max_num,
                      cache_token: str = "") -> str:
    """A digest over only the networks the method runs (adacof and phase
    results survive a new FusionNet), its config, and `cache_token`, which
    must name every set-making parameter the set names do not show."""
    nets = {
        "adacof": (models.adacof,),
        "phase": (models.phase_net,),
        "baseline": (models.phase_net, models.adacof),
    }
    if method in nets:
        return _weights_digest(nets[method], method, dim, max_num, cache_token)
    fnet = models.fusion_net
    return _weights_digest(models, method, fnet.variant, fnet.uncertainty_maps, dim, max_num,
                           cache_token)


def evaluate_suite(
    models: FusionModels,
    out_dir: str,
    sets: Optional[Dict[str, np.ndarray]] = None,
    methods: Sequence[str] = ("fusion",),
    dim: int = 512,
    max_num: Optional[int] = 10,
    overwrite: bool = False,
    visualize: bool = True,
    lpips_fn=None,
    cache_token: str = "",
    *,
    device="cuda",
) -> Dict[str, Dict[str, Dict[str, float]]]:
    """Score every set with every method, caching each (set, method) in
    `<out_dir>/result_<set>_<method>_<digest>.npz`; returns {set: {method:
    {metric: mean}}} and writes it to `summary.json`
    (fmvfi_tpu/eval/evaluate.py:247-345).  A set given as a callable is
    called once per method for a fresh iterator.

    With visualize=True each set that is held whole (an array; a callable or
    an iterator streams its frames, and is skipped) gets one panel per triplet,
    <out_dir>/panels_<set>/panel_<i>.png (its target, each method's
    prediction and |diff| map), and <out_dir>/<set>.avi of the panels at 2
    fps; the predictions are cached in the npz, and a cached npz without
    them is scored again."""
    from .visualize import panels_to_video, prediction_panel

    os.makedirs(out_dir, exist_ok=True)
    if sets is None:
        sets = synthetic_sets(dim)
    digests = {m: _method_cache_key(models, m, dim, max_num, cache_token) for m in methods}
    summary: Dict[str, Dict[str, Dict[str, float]]] = {}
    for name, frames_src in sets.items():
        streamed = callable(frames_src) or not hasattr(frames_src, "__len__")
        want_preds = visualize and not streamed
        summary[name] = {}
        preds_by_method: Dict[str, np.ndarray] = {}
        for method in methods:
            cache = os.path.join(out_dir, f"result_{name}_{method}_{digests[method]}.npz")
            data = None
            if os.path.exists(cache) and not overwrite:
                with np.load(cache) as f:
                    data = dict(f)
                if (want_preds and "preds" not in data) or (
                        lpips_fn is not None and "lpips_vgg" not in data):
                    data = None
            if data is None:
                data = evaluate_frames(
                    frames_src() if callable(frames_src) else frames_src,
                    models, method, dim, max_num, return_preds=want_preds,
                    lpips_fn=lpips_fn, device=device,
                )
                np.savez(cache, **data)
            if "preds" in data:
                preds_by_method[method] = data.pop("preds")
            summary[name][method] = {k: float(v.mean()) for k, v in data.items()}
        if want_preds and preds_by_method:
            cropped = crop_center(np.asarray(frames_src), dim)
            if cropped.dtype == np.uint8:
                cropped = cropped.astype(np.float32) / 255.0
            n_panels = min(p.shape[0] for p in preds_by_method.values())
            panel_paths = []
            for i in range(n_panels):
                path = os.path.join(out_dir, f"panels_{name}", f"panel_{i:03d}.png")
                prediction_panel(cropped[i + 1],
                                 {m: p[i] / 255.0 for m, p in preds_by_method.items()},
                                 out_path=path)
                panel_paths.append(path)
            if panel_paths:
                panels_to_video(panel_paths, os.path.join(out_dir, f"{name}.avi"))
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary


def load_set(path: str, resize=None, stream: bool = False):
    """A test set from a directory of frames or a video file (what
    utils/formats.py's table lists; pipeline/video.py) (fmvfi_tpu/eval/evaluate.py:332-347): (N, H, W, 3)
    float32 in [0, 1], or with stream=True a zero-argument callable
    returning a fresh uint8 frame iterator (for evaluate_suite, which calls
    it once per method).  `resize` = (h, w) applies to a video's frames, as
    in JAX.  A video the port cannot decode as cv2 does raises
    NotImplementedError (item 18.4)."""
    if stream:
        if os.path.isdir(path):
            return lambda: iter_frame_dir(path)
        return lambda: iter_video_frames(path, resize=resize)
    if os.path.isdir(path):
        return read_frame_dir(path)
    return read_video_frames(path, resize=resize)


def evaluate_triplets(
    triplets: Dict[str, tuple],
    models: FusionModels,
    method: str = "fusion",
    output_dir: Optional[str] = None,
    lpips_fn=None,
    *,
    device="cuda",
) -> Dict[str, Dict[str, float]]:
    """Score {scene: (f1, gt, f2)} triplets of (H, W, 3) frames at their own
    resolution: per-scene metrics and an "average" row; gt=None scenes are
    interpolated but not scored (fmvfi_tpu/eval/evaluate.py:368-424).
    With `output_dir`, each prediction is written as
    <output_dir>/<scene>/output.png, quantized as JAX writes it."""
    dev = _device(device)
    results: Dict[str, Dict[str, float]] = {}
    for name, (f1, gt, f2) in triplets.items():
        fn = _interp_fn(models, method, device=dev)
        pred = fn(_upload(f1[None], dev), _upload(f2[None], dev))
        if output_dir is not None:
            os.makedirs(os.path.join(output_dir, name), exist_ok=True)
            imageio.imwrite(os.path.join(output_dir, name, "output.png"),
                            quantize(pred[0].cpu().numpy()))
        if gt is not None:
            with torch.no_grad():
                m = all_metrics(pred, _upload(gt[None], dev), lpips_fn)
            results[name] = {k: float(v[0]) for k, v in m.items()}
    if results:
        results["average"] = {
            k: float(np.mean([r[k] for r in results.values()])) for k in next(iter(results.values()))
        }
    return results
