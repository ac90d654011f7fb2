"""Host-side epoch loader: a shuffled order, fixed-shape batches, and one
prefetch thread that reads and collates the next batches while the device
runs the current step. The port's own copy of `scenerf_tpu/data/loader.py`.

Several ranks (`process_index` / `process_count`, as the JAX loader): every
rank draws the same shuffled order from the shared seed, and yields only its
contiguous batch_size / process_count items of each global batch
(`batch_size` is the global batch); a trailing partial batch is dropped. The
ray modes of multi-GPU training read the unsliced batches on every rank
(process_count 1).
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np


class DataLoader:
    def __init__(self, dataset, collate_fn: Callable[[List[Dict]], Dict[str, np.ndarray]],
                 batch_size: int = 1, shuffle: bool = False, drop_last: bool = True,
                 limit_fraction: float = 1.0, prefetch: int = 2, seed: int = 42,
                 max_batches: Optional[int] = None, process_index: int = 0,
                 process_count: int = 1):
        """Each epoch shuffles the whole dataset with `seed`'s generator (one
        shuffle per epoch, as the JAX loader draws them), keeps its first
        `limit_fraction`, and, with `max_batches`, reads no more than that
        many batches of it: the thread then reads no item beyond the last
        batch, so the dataset's own draws do not depend on how far the thread
        ran ahead.

        `timings` records, per batch of the last epoch, the host seconds the
        thread spent reading its items (`read_s`) and collating them
        (`collate_s`), and the seconds the consumer waited on the queue
        (`wait_s`)."""
        if batch_size % process_count:
            raise ValueError(f"global batch {batch_size} not divisible by process_count "
                             f"{process_count}")
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} of {process_count}")
        self.process_index = process_index
        self.process_count = process_count
        self.local_batch_size = batch_size // process_count
        self.dataset = dataset
        self.collate_fn = collate_fn
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.limit_fraction = limit_fraction
        self.prefetch = prefetch
        self.max_batches = max_batches
        self.rng = np.random.default_rng(seed)
        self.timings: Dict[str, List[float]] = {"read_s": [], "collate_s": [], "wait_s": []}

    def __len__(self):
        n = int(len(self.dataset) * self.limit_fraction)
        if self.drop_last or self.process_count > 1:
            n = n // self.batch_size
        else:
            n = -(-n // self.batch_size)
        return n if self.max_batches is None else min(n, self.max_batches)

    def epoch_order(self) -> np.ndarray:
        """The next epoch's item order (draws its shuffle): this rank's items
        of it."""
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        # the half-train-set epoch (limit_fraction 0.5) of the reference
        idx = idx[:int(len(idx) * self.limit_fraction)]
        if self.max_batches is not None:
            idx = idx[:self.max_batches * self.batch_size]
        if self.process_count > 1:
            n_full = len(idx) // self.batch_size
            idx = idx[:n_full * self.batch_size].reshape(
                n_full, self.process_count, self.local_batch_size)[:, self.process_index]
            idx = idx.reshape(-1)
        return idx

    def _produce(self, order: Sequence[int], out_q: queue.Queue, stop: threading.Event):
        def put(x) -> bool:
            while not stop.is_set():
                try:
                    out_q.put(x, timeout=0.05)
                    return True
                except queue.Full:
                    pass
            return False

        try:
            bs = self.local_batch_size
            batches = [order[i:i + bs] for i in range(0, len(order), bs)]
            if self.drop_last and batches and len(batches[-1]) < bs:
                batches.pop()
            for b in batches:
                t0 = time.perf_counter()
                items = [self.dataset[int(i)] for i in b]
                t1 = time.perf_counter()
                batch = self.collate_fn(items)
                self.timings["read_s"].append(t1 - t0)
                self.timings["collate_s"].append(time.perf_counter() - t1)
                if not put(batch):  # the consumer stopped
                    return
        except Exception as e:  # raised in the consumer
            put(e)
        finally:
            put(None)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        """The epoch's batches. A worker's exception is raised here. Leaving
        the loop early stops the thread and waits for it."""
        self.timings = {"read_s": [], "collate_s": [], "wait_s": []}
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        t = threading.Thread(target=self._produce, args=(self.epoch_order(), q, stop),
                             daemon=True)
        t.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                self.timings["wait_s"].append(time.perf_counter() - t0)
                if item is None:
                    self.timings["wait_s"].pop()
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()
