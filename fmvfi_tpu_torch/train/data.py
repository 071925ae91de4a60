"""Host-side input pipeline (port of fmvfi_tpu/train/data.py, its Python
path): the synthetic triplet sets (one regime, or the six mixed), the
continuously jittered mixed-regime pool, the reference's augmentations
(shared random crop, h/v flips, time reversal) and a thread-prefetched batch
iterator.

Batches are NHWC numpy arrays, as the JAX package yields them, and a seed
draws the same random numbers in the same order, so it gives the same
batches.  Still to be ported (ROADMAP Queue 1, items 17-18): the Vimeo90k
reader, the native C++ augmentation and the photo sources of
MixedSynthStream.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from ..eval import synth


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


def _stream_item(i: int, h: int, w: int, seed0: int) -> np.ndarray:
    """Scene i of MixedSynthStream: regime i % 6 with parameters drawn from
    continuous ranges by default_rng(seed0 + i), as (3, h, w, 3) uint8."""
    seed, k = seed0 + i, i % 6
    rng = np.random.default_rng(seed)
    rng.random()  # the photo-source draw: spent at photo_frac 0 too, so scene i stays put
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
    the scenes are stored as uint8 and drawn on `workers` threads.
    `photo_frac` > 0 (natural-photo sources) is not ported yet."""

    def __init__(self, n: int = 768, h: int = 288, w: int = 448, seed0: int = 1000,
                 workers: int = 8, photo_frac: float = 0.0):
        if photo_frac > 0.0:
            raise NotImplementedError(
                "MixedSynthStream(photo_frac > 0) needs the photo sources of "
                "eval.synth, not ported yet (ROADMAP Queue 1, item 18)"
            )
        with ThreadPoolExecutor(max_workers=max(1, workers)) as ex:
            self._items = list(ex.map(lambda i: _stream_item(i, h, w, seed0), range(n)))

    def __len__(self):
        return len(self._items)

    def load_u8(self, index: int) -> np.ndarray:
        return self._items[index]

    def load(self, index: int):
        return tuple(f.astype(np.float32) / 255.0 for f in self._items[index])


def augment_triplet(frames: Sequence[np.ndarray], rng: np.random.Generator, crop: int = 256):
    """Shared random crop + flips + time reversal (datareader.py:45-69)."""
    f0, f1, f2 = frames
    h, w = f0.shape[:2]
    if h < crop or w < crop:
        raise ValueError(f"frame {h}x{w} smaller than crop {crop}")
    y = int(rng.integers(0, h - crop + 1))
    x = int(rng.integers(0, w - crop + 1))
    f0, f1, f2 = (f[y : y + crop, x : x + crop] for f in (f0, f1, f2))
    if rng.random() < 0.5:
        f0, f1, f2 = (f[:, ::-1] for f in (f0, f1, f2))
    if rng.random() < 0.5:
        f0, f1, f2 = (f[::-1] for f in (f0, f1, f2))
    if rng.random() < 0.5:
        f0, f2 = f2, f0
    return np.ascontiguousarray(f0), np.ascontiguousarray(f1), np.ascontiguousarray(f2)


def batch_iterator(
    dataset,
    batch_size: int,
    seed: int = 0,
    crop: int = 256,
    epochs: Optional[int] = None,
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Yield (frame1, target, frame2) batches, each (B, crop, crop, 3), in a
    fresh random order each epoch, augmented on a background thread two
    batches ahead; a ragged last batch of an epoch is dropped.  An error in the thread is raised here; closing the generator
    stops the thread."""
    rng = np.random.default_rng(seed)
    q: "queue.Queue" = queue.Queue(maxsize=2)
    stop = threading.Event()
    errors: list = []

    def producer():
        epoch = 0
        try:
            while not stop.is_set() and (epochs is None or epoch < epochs):
                order = rng.permutation(len(dataset))
                for s in range(0, len(order) - batch_size + 1, batch_size):
                    if stop.is_set():
                        return
                    items = [
                        augment_triplet(dataset.load(int(i)), rng, crop=crop)
                        for i in order[s : s + batch_size]
                    ]
                    batch = tuple(np.stack([it[j] for it in items]) for j in range(3))
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
