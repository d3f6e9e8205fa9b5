"""Threaded prefetching batch loader (counterpart of
vit_exp_tpu/data/loader.py, one process): a thread pool loads and collates
numpy batches ahead of consumption, with at most ``num_workers + prefetch``
batches submitted and not yet consumed.  For a seed the shuffle order is
the JAX package's: ``default_rng((seed, epoch))`` permutes the indices.
String fields are collated to lists; per-class prompt tensors that repeat
across samples are collapsed to one copy.  A dataset with a
``collate_batch(indices, alloc=None)`` method builds its own batches (the
same dict, made without the per-item copies; ``alloc(key, shape, dtype)``,
when given, is where each array field goes).

With a ``pool`` (``data/pinned.py::PinnedPool``) the workers collate the
pool's keys straight into its page-locked buffers: an item-wise worker
loads its items first and then takes its batch's slot, so only the
collation waits on the pool.  Each batch is then a ``HostBatch`` whose
``release(event)`` (called by ``BatchCopier.start``) gives the slot back;
a batch not released by the time the consumer asks for the next one is
released then, so its buffers are valid until that moment.  The pool
leaves which indices a batch holds, and its bytes, as they are.

``shard_id``/``num_shards`` (the JAX loader's process sharding): every
process permutes the whole index with the same (seed, epoch) and takes
the stride ``idx[shard_id::num_shards]``, so the strides are disjoint and
together cover the data set; a stride shorter than ceil(len /
num_shards) is padded by repeating its own first indices, so every
process yields the same number of batches."""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

from vit_exp_tpu_torch.data.pinned import HostBatch, PinnedPool, Stopped

_SHARED_KEYS = {"prompt_ids", "prompt_mask"}
_META_KEYS = {"data_type"}


def collate(items: List[Dict], alloc: Optional[Callable] = None) -> Dict:
    """One batch dict of ``items``; ``alloc(key, shape, dtype)`` gives the
    array each stacked or shared field is written into (fresh memory
    without it)."""
    out: Dict = {}
    for key in items[0]:
        vals = [item[key] for item in items]
        if key in _META_KEYS:
            out[key] = vals[0]
        elif key in _SHARED_KEYS:
            v = np.asarray(vals[0])
            if alloc is None:
                out[key] = v
            else:
                out[key] = alloc(key, v.shape, v.dtype)
                out[key][...] = v
        elif isinstance(vals[0], np.ndarray):
            if alloc is None:
                out[key] = np.stack(vals)
            else:
                dtype = np.result_type(*vals)
                out[key] = np.stack(vals, out=alloc(
                    key, (len(vals),) + vals[0].shape, dtype))
        elif isinstance(vals[0], (int, float, np.floating, np.integer)):
            out[key] = np.asarray(vals)
        else:
            out[key] = vals
    return out


class Loader:
    """One pass over the dataset in batches."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False, num_workers: int = 4,
                 prefetch: int = 2, pool: Optional[PinnedPool] = None,
                 shard_id: int = 0, num_shards: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.pool = pool
        self.shard_id = shard_id
        self.num_shards = max(1, num_shards)
        self.epoch = 0
        self._seq = 0   # pooled batches are numbered across iterations
        self._producer: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def __len__(self):
        n = -(-len(self.dataset) // self.num_shards)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _batch_indices(self) -> List[List[int]]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            rng.shuffle(idx)
        if self.num_shards > 1:
            full, target = idx, -(-len(idx) // self.num_shards)
            idx = idx[self.shard_id::self.num_shards]
            if len(idx) == 0:   # more shards than samples
                idx = full[np.arange(target) % len(full)]
            elif len(idx) < target:
                idx = np.concatenate([idx, idx[:target - len(idx)]])
        batches = [idx[i:i + self.batch_size].tolist()
                   for i in range(0, len(idx), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def load_batch(self, indices) -> Dict:
        """The batch of the given dataset indices in fresh memory."""
        fill = getattr(self.dataset, "collate_batch", None)
        if fill is not None:
            return fill(indices)
        return collate([self.dataset[i] for i in indices])

    def _load_pinned(self, indices, seq: int,
                     stop: threading.Event) -> HostBatch:
        """Batch ``seq`` of this iteration (what one worker does), its
        pool keys collated into the pool's slot for it."""
        fill = getattr(self.dataset, "collate_batch", None)
        items = None if fill is not None else [self.dataset[i]
                                               for i in indices]
        slot = self.pool.acquire(seq, stop)
        try:
            batch = HostBatch(fill(indices, alloc=slot.array) if items is None
                              else collate(items, alloc=slot.array))
        except BaseException:
            self.pool.release(seq)
            raise
        batch.release = lambda event=None: self.pool.release(seq, event)
        return batch

    def stop(self) -> None:
        """Stop the last iteration (its iterator yields nothing more) and
        wait until its producer and workers are done."""
        self._stop.set()
        if self._producer is not None:
            self._producer.join()
            self._producer = None

    def close(self) -> None:
        """``stop()``, then free the pool's buffers."""
        self.stop()
        if self.pool is not None:
            self.pool.close()

    def __iter__(self) -> Iterator[Dict]:
        batches = self._batch_indices()
        self.epoch += 1
        if not batches:
            return
        base = self._seq
        self._seq += len(batches)
        if self.pool is not None:
            self.stop()   # no worker may still write to a slot
            self.pool.reset(base)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = self._stop = threading.Event()

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

        def submit(workers, i):
            if self.pool is None:
                return workers.submit(self.load_batch, batches[i])
            return workers.submit(self._load_pinned, batches[i], base + i,
                                  stop)

        def producer():
            workers = ThreadPoolExecutor(self.num_workers)
            try:
                ahead = min(len(batches), self.num_workers + self.prefetch)
                pending: List = [submit(workers, i) for i in range(ahead)]
                for i in range(len(batches)):
                    try:
                        result = pending.pop(0).result()
                    except Stopped:
                        return
                    except Exception as e:  # surface loader errors downstream
                        put_or_stop(("err", e))
                        return
                    if not put_or_stop(("ok", result)):
                        return
                    if i + ahead < len(batches):
                        pending.append(submit(workers, i + ahead))
                put_or_stop(("done", None))
            finally:
                stop.set()   # wakes workers waiting for a pool slot
                # a pooled loader's next iteration reuses the slots: let
                # every worker finish writing first
                workers.shutdown(wait=self.pool is not None,
                                 cancel_futures=True)

        thread = threading.Thread(target=producer, daemon=True)
        self._producer = thread
        thread.start()
        last = None
        try:
            while True:
                if last is not None and last.release is not None:
                    last.release()   # the consumer has moved on
                try:
                    kind, payload = q.get(timeout=0.1)
                except queue.Empty:
                    if stop.is_set() and not thread.is_alive():
                        return   # closed: nothing more will come
                    continue
                if kind == "done":
                    return
                if kind == "err":
                    raise payload
                last = payload if isinstance(payload, HostBatch) else None
                yield payload
        finally:
            stop.set()


class InfiniteLoader:
    """Endless cycling iterator over a Loader's epochs."""

    def __init__(self, loader: Loader):
        self.loader = loader
        self._it = iter(loader)

    def close(self) -> None:
        """End the current epoch's iterator and close the loader."""
        self._it.close()
        self.loader.close()

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
