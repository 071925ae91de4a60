"""Host-side input pipeline (port of fmvfi_tpu/train/data.py, its Python
path): a synthetic triplet set, the reference's augmentations (shared random
crop, h/v flips, time reversal) and a thread-prefetched batch iterator.

Batches are NHWC numpy arrays, as the JAX package yields them, and a seed
draws the same random numbers in the same order, so it gives the same
batches.  Still to be ported (ROADMAP Queue 1, item 17): the Vimeo90k
reader, the mixed-regime synthetic sets and the native C++ augmentation.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from ..eval.synth import translation_triplet


class SyntheticTriplets:
    """In-memory stand-in dataset (tests and demos without Vimeo90k): n
    translation triplets of h x w, item i moving by (2 + i % 6, i % 3) px.
    The items are drawn on a thread pool (numpy releases the interpreter
    lock in its array loops); each depends on its index alone."""

    def __init__(self, n: int = 64, h: int = 256, w: int = 448):
        def item(i):
            return translation_triplet(h, w, dx=float(2 + i % 6), dy=float(i % 3), seed=i)

        with ThreadPoolExecutor(max_workers=max(1, min(8, n))) as ex:
            self._items = list(ex.map(item, range(n)))

    def __len__(self):
        return len(self._items)

    def load(self, index: int):
        return self._items[index]


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
