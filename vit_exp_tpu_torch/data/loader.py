"""Threaded prefetching batch loader (counterpart of
vit_exp_tpu/data/loader.py, one process): a thread pool loads and collates
numpy batches ahead of consumption, with at most ``num_workers + prefetch``
batches submitted and not yet consumed.  For a seed the shuffle order is
the JAX package's: ``default_rng((seed, epoch))`` permutes the indices.
String fields are collated to lists; per-class prompt tensors that repeat
across samples are collapsed to one copy.  A dataset with a
``collate_batch(indices)`` method builds its own batches (the same dict,
made without the per-item copies)."""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List

import numpy as np

_SHARED_KEYS = {"prompt_ids", "prompt_mask"}
_META_KEYS = {"data_type"}


def collate(items: List[Dict]) -> Dict:
    out: Dict = {}
    for key in items[0]:
        vals = [item[key] for item in items]
        if key in _META_KEYS:
            out[key] = vals[0]
        elif key in _SHARED_KEYS:
            out[key] = np.asarray(vals[0])
        elif isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        elif isinstance(vals[0], (int, float, np.floating, np.integer)):
            out[key] = np.asarray(vals)
        else:
            out[key] = vals
    return out


class Loader:
    """One pass over the dataset in batches."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False, num_workers: int = 4,
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _batch_indices(self) -> List[List[int]]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            rng.shuffle(idx)
        batches = [idx[i:i + self.batch_size].tolist()
                   for i in range(0, len(idx), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def load_batch(self, indices) -> Dict:
        """The batch of the given dataset indices (what one worker does)."""
        fill = getattr(self.dataset, "collate_batch", None)
        if fill is not None:
            return fill(indices)
        return collate([self.dataset[i] for i in indices])

    def __iter__(self) -> Iterator[Dict]:
        batches = self._batch_indices()
        self.epoch += 1
        if not batches:
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            """Bounded put that gives up once the consumer has gone, so an
            abandoned iterator never leaves this thread blocked."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            pool = ThreadPoolExecutor(self.num_workers)
            try:
                it = iter(batches)
                pending: List = []
                for b in it:
                    pending.append(pool.submit(self.load_batch, b))
                    if len(pending) >= self.num_workers + self.prefetch:
                        break
                while pending:
                    fut = pending.pop(0)
                    try:
                        result = fut.result()
                    except Exception as e:  # surface loader errors downstream
                        put_or_stop(("err", e))
                        return
                    if not put_or_stop(("ok", result)):
                        return
                    nxt = next(it, None)
                    if nxt is not None:
                        pending.append(pool.submit(self.load_batch, nxt))
                put_or_stop(("done", None))
            finally:
                pool.shutdown(wait=False, cancel_futures=True)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                kind, payload = q.get()
                if kind == "done":
                    return
                if kind == "err":
                    raise payload
                yield payload
        finally:
            stop.set()


class InfiniteLoader:
    """Endless cycling iterator over a Loader's epochs."""

    def __init__(self, loader: Loader):
        self.loader = loader
        self._it = iter(loader)

    def __next__(self) -> Dict:
        for _ in range(2):
            try:
                return next(self._it)
            except StopIteration:
                self._it = iter(self.loader)
        raise RuntimeError(
            "loader yields no batches — dataset smaller than batch_size with "
            f"drop_last (len(dataset)={len(self.loader.dataset)}, "
            f"batch_size={self.loader.batch_size})")

    def __iter__(self):
        return self
