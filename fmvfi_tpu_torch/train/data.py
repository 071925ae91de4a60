"""Host-side input pipeline (port of fmvfi_tpu/train/data.py, its Python
path and its native one): the Vimeo90k triplet reader, the synthetic
triplet sets (one regime, or the six mixed), the continuously jittered
mixed-regime pool (with its natural-photo share), the reference's
augmentations (shared random crop, h/v flips, time reversal) and a
thread-prefetched batch iterator, which augments in numpy or, for a
dataset of uint8 frames, in the C++ library of fmvfi_tpu_torch.native.

Batches are NHWC numpy arrays, as the JAX package yields them, and a seed
draws the same random numbers in the same order, so it gives the same
batches.
"""

from __future__ import annotations

import os
import queue
import threading
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from .. import native
from ..eval import synth
from ..utils import imageio

# batches that batch_iterator assembled, by path ("native" or "numpy"),
# since the last reset (clear() to reset); producer threads count under the lock
paths = Counter()
_paths_lock = threading.Lock()


def _count(path: str) -> None:
    with _paths_lock:
        paths[path] += 1


def _mixed_item(i: int, h: int, w: int):
    """Item i of the mixed diet: regime i % 6 (translation, large motion,
    rotation, zoom, occlusion, brightness) with its parameters stepped by i."""
    k = i % 6
    if k == 0:
        v = synth.translation_video(3, h, w, step=1.0 + (i % 8), seed=i)
    elif k == 1:
        v = synth.large_motion_video(3, h, w, step=8.0 + 3 * (i % 5), seed=i)
    elif k == 2:
        v = synth.rotation_video(3, h, w, deg_per_frame=0.5 + 0.5 * (i % 4), seed=i)
    elif k == 3:
        v = synth.zoom_video(3, h, w, scale_per_frame=1.005 + 0.005 * (i % 4), seed=i)
    elif k == 4:
        v = synth.occlusion_video(3, h, w, fg_step=2.0 + 2 * (i % 3), bg_step=-1.0 - (i % 2),
                                  seed=i)
    else:
        v = synth.brightness_video(3, h, w, step=1.0 + (i % 4), seed=i)
    return v[0], v[1], v[2]


class Vimeo90kTriplets:
    """vimeo_triplet/sequences/<seq>/<clip>/im{1,2,3}.png, clips in sorted
    order (fmvfi_tpu/train/data.py:20-52)."""

    def __init__(self, db_dir: str):
        seq_dir = os.path.join(db_dir, "sequences")
        self.triplets = []
        for seq in sorted(os.listdir(seq_dir)):
            sp = os.path.join(seq_dir, seq)
            if not os.path.isdir(sp):
                continue
            for clip in sorted(os.listdir(sp)):
                cp = os.path.join(sp, clip)
                if os.path.isdir(cp):
                    self.triplets.append(cp)
        if not self.triplets:
            raise ValueError(f"no triplets under {seq_dir}")

    def __len__(self):
        return len(self.triplets)

    def load_u8(self, index: int) -> np.ndarray:
        """(3, H, W, 3) uint8 RGB triplet (the native loader's input)."""
        path = self.triplets[index]
        return np.stack([imageio.imread(os.path.join(path, f"im{i}.png")) for i in (1, 2, 3)])

    def load(self, index: int):
        return tuple(f.astype(np.float32) / 255.0 for f in self.load_u8(index))


class SyntheticTriplets:
    """In-memory stand-in dataset (tests and demos without Vimeo90k): n
    triplets of h x w.  Item i moves by (2 + i % 6, i % 3) px; with
    mixed=True it cycles through the six motion regimes of eval.synth with
    parameters stepped by i (the diet of the bundled demo weights).  The
    items are drawn on a thread pool (numpy releases the interpreter lock in
    its array loops); each depends on its index alone."""

    def __init__(self, n: int = 64, h: int = 256, w: int = 448, mixed: bool = False):
        def item(i):
            if mixed:
                return _mixed_item(i, h, w)
            return synth.translation_triplet(h, w, dx=float(2 + i % 6), dy=float(i % 3), seed=i)

        with ThreadPoolExecutor(max_workers=max(1, min(8, n))) as ex:
            self._items = list(ex.map(item, range(n)))

    def __len__(self):
        return len(self._items)

    def load(self, index: int):
        return self._items[index]


def _photo_item(k: int, h: int, w: int, seed: int, rng: np.random.Generator) -> np.ndarray:
    """A photo scene of regime k: the regime's parameters drawn from `rng`
    as fmvfi_tpu/train/data.py:129-167 draws them, over synth.natural_video,
    as (3, h, w, 3) float32."""
    angle = rng.uniform(0, 2 * np.pi)
    if k == 0:
        step = rng.uniform(0.25, 8.0)
        kw = dict(dx=step * np.cos(angle), dy=step * np.sin(angle))
    elif k == 1:
        step = rng.uniform(8.0, 28.0)
        kw = dict(dx=step * (1.0 if rng.random() < 0.5 else -1.0), dy=rng.uniform(-4, 4))
    elif k == 2:
        kw = dict(deg_per_frame=rng.uniform(0.25, 2.5))
    elif k == 3:
        kw = dict(scale_per_frame=rng.uniform(1.003, 1.028))
    elif k == 4:
        kw = dict(fg_step=rng.uniform(1.0, 8.0) * (1 if rng.random() < 0.5 else -1),
                  dx=rng.uniform(-4.0, 4.0))
    else:
        step = rng.uniform(0.5, 4.0)
        kw = dict(dx=step * np.cos(angle), dy=step * np.sin(angle),
                  gain_per_frame=rng.uniform(0.88, 0.97))
    return synth.natural_video(3, h, w, seed=seed, **kw)


def _stream_item(i: int, h: int, w: int, seed0: int, photo_frac: float) -> np.ndarray:
    """Scene i of MixedSynthStream: regime i % 6 with parameters drawn from
    continuous ranges by default_rng(seed0 + i), over the natural photos
    when the first draw is below `photo_frac`, as (3, h, w, 3) uint8."""
    seed, k = seed0 + i, i % 6
    rng = np.random.default_rng(seed)
    if rng.random() < photo_frac:
        v = _photo_item(k, h, w, seed, rng)
        if k == 5:  # the synthetic brightness branch's absolute gain
            v = v * rng.uniform(0.55, 1.0)
        return np.clip(v * 255.0 + 0.5, 0, 255).astype(np.uint8)
    angle = rng.uniform(0, 2 * np.pi)
    if k == 0:  # translation, [0.25, 8] px/frame in any direction
        step = rng.uniform(0.25, 8.0)
        v = np.stack(synth.translation_triplet(
            h, w, dx=2 * step * np.cos(angle), dy=2 * step * np.sin(angle), seed=seed))
    elif k == 1:  # large motion, |dx| in [8, 28] px/frame with a random sign
        step = rng.uniform(8.0, 28.0)
        dx = 2 * step * (1.0 if rng.random() < 0.5 else -1.0)
        v = np.stack(synth.translation_triplet(h, w, dx=dx, dy=2 * rng.uniform(-4, 4),
                                               seed=seed))
    elif k == 2:
        v = synth.rotation_video(3, h, w, deg_per_frame=rng.uniform(0.25, 2.5), seed=seed)
    elif k == 3:
        v = synth.zoom_video(3, h, w, scale_per_frame=rng.uniform(1.003, 1.028), seed=seed)
    elif k == 4:
        fg_step = rng.uniform(1.0, 8.0) * (1 if rng.random() < 0.5 else -1)
        v = synth.occlusion_video(3, h, w, fg_step=fg_step, bg_step=rng.uniform(-4.0, 4.0),
                                  seed=seed)
    else:  # brightness ramp from a random absolute gain
        v = synth.brightness_video(3, h, w, step=rng.uniform(0.5, 4.0),
                                   gain_per_frame=rng.uniform(0.88, 0.97), seed=seed)
        v = v * rng.uniform(0.55, 1.0)
    return np.clip(v * 255.0 + 0.5, 0, 255).astype(np.uint8)


class MixedSynthStream:
    """A large pool of mixed-regime synthetic scenes whose parameters are
    drawn from continuous ranges covering the evaluation suite: translation
    0.25-8 px/frame in any direction, large motion 8-28 px/frame, rotation
    0.25-2.5 deg/frame, zoom 1.003-1.028/frame, occlusion, and brightness
    ramps from a random starting gain.  Scene i depends on seed0 + i alone;
    the scenes are stored as uint8 and drawn on `workers` threads.  About
    `photo_frac` of the scenes move the natural photos of synth.photo_sources
    in place of the textures (synth.natural_video, the same regimes)."""

    def __init__(self, n: int = 768, h: int = 288, w: int = 448, seed0: int = 1000,
                 workers: int = 8, photo_frac: float = 0.0):
        if photo_frac > 0.0:
            synth.photo_sources()  # warm the cache before the threads fan out
        with ThreadPoolExecutor(max_workers=max(1, workers)) as ex:
            self._items = list(ex.map(lambda i: _stream_item(i, h, w, seed0, photo_frac),
                                      range(n)))

    def __len__(self):
        return len(self._items)

    def load_u8(self, index: int) -> np.ndarray:
        return self._items[index]

    def load(self, index: int):
        return tuple(f.astype(np.float32) / 255.0 for f in self._items[index])


def augment_triplet(frames: Sequence[np.ndarray], rng: np.random.Generator, crop: int = 256):
    """Shared random crop + flips + time reversal (datareader.py:45-69)."""
    h, w = frames[0].shape[:2]
    return _augment_with(frames, _native_params(rng, 1, h, w, crop)[0], crop)


def _augment_with(frames: Sequence[np.ndarray], p: np.ndarray, crop: int):
    """augment_triplet with its draws given: p = (y0, x0, hflip, vflip,
    tswap), a row of _native_params."""
    y, x, hflip, vflip, tswap = (int(v) for v in p)
    f0, f1, f2 = (f[y : y + crop, x : x + crop] for f in frames)
    if hflip:
        f0, f1, f2 = (f[:, ::-1] for f in (f0, f1, f2))
    if vflip:
        f0, f1, f2 = (f[::-1] for f in (f0, f1, f2))
    if tswap:
        f0, f2 = f2, f0
    return np.ascontiguousarray(f0), np.ascontiguousarray(f1), np.ascontiguousarray(f2)


def _native_params(rng: np.random.Generator, n: int, h: int, w: int, crop: int) -> np.ndarray:
    """(n, 5) int32 (y0, x0, hflip, vflip, tswap), the draws of n items in
    the reference's order, for both augmentation paths."""
    if h < crop or w < crop:
        raise ValueError(f"frame {h}x{w} smaller than crop {crop}")
    return np.array([[rng.integers(0, h - crop + 1), rng.integers(0, w - crop + 1),
                      rng.random() < 0.5, rng.random() < 0.5, rng.random() < 0.5]
                     for _ in range(n)], np.int32)


def batch_iterator(
    dataset,
    batch_size: int,
    seed: int = 0,
    crop: int = 256,
    shuffle: bool = True,
    prefetch: int = 2,
    epochs: Optional[int] = None,
    use_native: Optional[bool] = None,
    shard: Optional[Tuple[int, int]] = None,
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Yield (frame1, target, frame2) batches, each (B, crop, crop, 3), in a
    fresh random order each epoch (`shuffle`; else in index order),
    augmented on a background thread up to `prefetch` batches ahead; a
    ragged last batch of an epoch is dropped.  A dataset with `load_u8`
    ((3, H, W, 3) uint8 triplets) is augmented by the native C++ library
    when it builds (use_native None) or always (True: raises RuntimeError
    when it does not build); False, or a dataset without `load_u8`, takes
    the numpy path.  Each batch counts in `paths`.  An error in the thread
    is raised here; closing the generator stops the thread.

    `shard=(start, stop)` (parallel.distributed.local_batch_slice): yield
    rows start:stop of each global batch of `batch_size`, loading only
    their triplets; the order and the augmentation draws are the global
    batch's (drawn for every row, all triplets being of one size, as
    Vimeo90k's and the synthetic sets' are), so the processes' shards make
    up the batches one process would yield."""
    lo, hi = shard or (0, batch_size)
    if not 0 <= lo < hi <= batch_size:
        raise ValueError(f"shard {shard} outside a batch of {batch_size}")
    rng = np.random.default_rng(seed)
    on_native = False
    if use_native is not False and hasattr(dataset, "load_u8"):
        if use_native:
            native.library()  # raises RuntimeError, with the reason, if it does not build
        on_native = native.available()
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()
    errors: list = []

    def make_batch(idx):
        if on_native:
            raw = np.stack([dataset.load_u8(int(i)) for i in idx[lo:hi]])
            params = _native_params(rng, len(idx), raw.shape[2], raw.shape[3], crop)[lo:hi]
            _count("native")
            return native.augment_batch(raw, crop, params)
        if shard is None:
            items = [augment_triplet(dataset.load(int(i)), rng, crop=crop) for i in idx]
        else:
            frames = [dataset.load(int(i)) for i in idx[lo:hi]]
            h, w = frames[0][0].shape[:2]
            params = _native_params(rng, len(idx), h, w, crop)[lo:hi]
            items = [_augment_with(f, p, crop) for f, p in zip(frames, params)]
        _count("numpy")
        return tuple(np.stack([it[j] for it in items]) for j in range(3))

    def producer():
        epoch = 0
        try:
            while not stop.is_set() and (epochs is None or epoch < epochs):
                order = rng.permutation(len(dataset)) if shuffle else np.arange(len(dataset))
                for s in range(0, len(order) - batch_size + 1, batch_size):
                    if stop.is_set():
                        return
                    batch = make_batch(order[s : s + batch_size])
                    # a bounded put that keeps observing `stop`: a plain put
                    # blocks forever once the consumer has left a full queue
                    while not stop.is_set():
                        try:
                            q.put(batch, timeout=0.2)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
                epoch += 1
        except Exception as e:  # handed to the consumer, which raises it
            errors.append(e)
        finally:
            while True:
                try:
                    q.put(None, timeout=0.2)
                    break
                except queue.Full:
                    # evict only once the consumer is gone (stop set); a slow
                    # consumer must still see every real batch
                    if stop.is_set():
                        try:
                            q.get_nowait()
                        except queue.Empty:
                            pass

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                if errors:
                    raise errors[0]
                return
            yield item
    finally:
        stop.set()
