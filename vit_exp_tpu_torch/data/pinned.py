"""Page-locked batch buffers and the side-stream batch copy (the port's
counterpart of the JAX package's asynchronous ``device_put`` of a batch,
vit_exp_tpu/train/trainer.py ``_device_batch``).

- ``PinnedPool``: a bounded set of ``slots`` host buffer sets, allocated
  once and reused.  Batch ``seq`` of a loader iteration is collated into
  slot ``seq % slots``, and only once batch ``seq − slots`` has given the
  slot back, so a worker never waits on a later batch than its own: the
  loader's in-order consumer cannot deadlock on the pool.  On a CUDA host
  each buffer is anonymous page-aligned memory registered with
  ``cudaHostRegister`` (page-locked at its exact size; torch's pinned
  allocator rounds every block up to a power of two, 8 GB for a 4.9 GB
  mask); elsewhere it is plain memory.
- ``BatchCopier``: copies a batch's arrays to one device.  On a CUDA device
  the copies run on a side stream of their own, an event marks their end,
  the batch's pool slot is handed back with that event (the slot's next
  user waits on it before writing), and ``DeviceBatch.get`` makes the
  current stream wait on the event and records each tensor on that
  stream.  On the CPU the arrays become tensors that share their memory:
  there is no copy.
"""

from __future__ import annotations

import mmap
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, List, Mapping, Optional

import numpy as np
import torch


class Stopped(Exception):
    """Raised in a worker waiting for a pool slot when its loader stops."""


# page-locking faults every page in first, ≈ 0.4 GB/s on one thread (885
# MB in 2.3 s on the card's host): the pages are touched on several
# threads first, then the buffer is registered whole (a copy may not span
# two registrations)
_CHUNK_BYTES = 256 << 20
_TOUCH_THREADS = 8


def _register(array: np.ndarray) -> None:
    """Page-lock ``array`` (page-aligned), its pages faulted in first in
    parallel."""
    chunks = [array[o:o + _CHUNK_BYTES]
              for o in range(0, array.nbytes, _CHUNK_BYTES)]
    with ThreadPoolExecutor(min(_TOUCH_THREADS, len(chunks))) as pool:
        list(pool.map(lambda c: c.fill(0), chunks))
    torch.cuda.check_error(torch.cuda.cudart().cudaHostRegister(
        array.ctypes.data, array.nbytes, 0))


def _unregister(array: np.ndarray) -> None:
    torch.cuda.check_error(torch.cuda.cudart().cudaHostUnregister(
        array.ctypes.data))


class _Buffer:
    """One page-aligned host buffer of ``nbytes`` (huge pages where the
    kernel gives them), page-locked for CUDA when ``register``;
    ``view(shape, dtype)`` is its first bytes as an array."""

    def __init__(self, nbytes: int, register: bool):
        self._map = mmap.mmap(-1, max(nbytes, 1),
                              flags=mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS)
        if hasattr(mmap, "MADV_HUGEPAGE"):
            self._map.madvise(mmap.MADV_HUGEPAGE)
        self.raw = np.frombuffer(self._map, np.uint8)
        self.registered = False
        if register:
            _register(self.raw)
            self.registered = True

    def view(self, shape, dtype) -> np.ndarray:
        n = int(np.prod(shape)) * np.dtype(dtype).itemsize
        return self.raw[:n].view(dtype).reshape(shape)

    def release(self) -> None:
        if self.registered:
            self.registered = False
            _unregister(self.raw)

    def __del__(self):
        try:
            self.release()
        except Exception:  # noqa: BLE001 -- CUDA may be gone at exit
            pass


class Slot:
    """The buffers of one pool slot, by batch key.  ``array(key, shape,
    dtype)`` gives the slot's buffer for ``key`` as an array of that shape
    (grown once when a batch needs more bytes) for the keys the pool pins,
    and fresh plain memory for any other key."""

    def __init__(self, pool: "PinnedPool"):
        self._pool = pool
        self._buffers: Dict[str, _Buffer] = {}

    def array(self, key: str, shape, dtype) -> np.ndarray:
        if key not in self._pool.keys:
            return np.empty(shape, dtype)
        need = int(np.prod(shape)) * np.dtype(dtype).itemsize
        buf = self._buffers.get(key)
        if buf is None or buf.raw.nbytes < need:
            if buf is not None:
                buf.release()
            buf = self._buffers[key] = _Buffer(need, self._pool.register)
        return buf.view(shape, dtype)

    def release(self) -> None:
        for buf in self._buffers.values():
            buf.release()
        self._buffers.clear()


class PinnedPool:
    """``slots`` reusable buffer sets for the batch keys ``keys``, handed
    out in batch order (see the module docstring).  ``register`` (default:
    whether CUDA is available) page-locks the buffers."""

    def __init__(self, slots: int, keys: Iterable[str],
                 register: Optional[bool] = None):
        self.keys = frozenset(keys)
        self.register = (torch.cuda.is_available() if register is None
                         else register)
        self._slots = [Slot(self) for _ in range(max(1, int(slots)))]
        n = len(self._slots)
        self._held: List[Optional[int]] = [None] * n
        self._next = list(range(n))      # the next seq each slot admits
        self._events: List[Optional[torch.cuda.Event]] = [None] * n
        self._cond = threading.Condition()

    def __len__(self):
        return len(self._slots)

    def reset(self, base: int = 0) -> None:
        """A new loader iteration whose first batch is seq ``base``: no
        slot is held (a slot's pending copy is still waited for).  Only
        call it once no worker of the previous iteration is running."""
        with self._cond:
            n = len(self._slots)
            self._held = [None] * n
            self._next = [base + (i - base) % n for i in range(n)]
            self._cond.notify_all()

    def acquire(self, seq: int, stop: Optional[threading.Event] = None
                ) -> Slot:
        """Slot ``seq % slots`` once batch ``seq − slots`` has released it
        and its copy has ended; raises ``Stopped`` when ``stop`` is set
        first."""
        i = seq % len(self._slots)
        with self._cond:
            while self._held[i] is not None or self._next[i] != seq:
                if stop is not None and stop.is_set():
                    raise Stopped()
                self._cond.wait(timeout=0.1)
            self._held[i] = seq
            event, self._events[i] = self._events[i], None
        if event is not None:
            event.synchronize()
        return self._slots[i]

    def release(self, seq: int, event: Optional[torch.cuda.Event] = None
                ) -> None:
        """Batch ``seq`` gives its slot back; ``event`` marks the end of the
        copy still reading it.  A second release of the same seq is a
        no-op."""
        i = seq % len(self._slots)
        with self._cond:
            if self._held[i] != seq:
                return
            self._held[i] = None
            self._events[i] = event
            self._next[i] = seq + len(self._slots)
            self._cond.notify_all()

    def close(self) -> None:
        """Wait for the pending copies and free every buffer (unregistered
        first).  Arrays a caller still holds stay valid as plain memory."""
        with self._cond:
            events, self._events = self._events, [None] * len(self._slots)
        for event in events:
            if event is not None:
                event.synchronize()
        for slot in self._slots:
            slot.release()


class HostBatch(dict):
    """A collated batch whose arrays may live in a pool slot: ``release``
    (set by the loader) gives the slot back, with the event that marks the
    end of the copy reading it."""

    release: Optional[Callable[[Optional[torch.cuda.Event]], None]] = None


class DeviceBatch:
    """A batch's device tensors, usable once ``get()`` has returned."""

    def __init__(self, tensors: Dict[str, torch.Tensor],
                 event: Optional[torch.cuda.Event] = None, device=None):
        self._tensors = tensors
        self._event = event
        self._device = device

    def get(self) -> Dict[str, torch.Tensor]:
        """The tensors, with the current stream made to wait for their
        copy and each tensor recorded on it (so its memory is not reused
        before the current stream's work on it has run)."""
        if self._event is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(self._event)
            for t in self._tensors.values():
                t.record_stream(stream)
            self._event = None
        return self._tensors


class BatchCopier:
    """Copies batches to ``device``: on a CUDA device on a side stream (see
    the module docstring), elsewhere by sharing the host memory."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)

    def start(self, batch: Mapping, keys: Iterable[str]) -> DeviceBatch:
        """Start copying ``batch[k]`` for each of ``keys`` the batch holds
        and release the batch's pool slot with the copies' end event."""
        arrays = {k: batch[k] for k in keys if k in batch}
        release = getattr(batch, "release", None)
        if self.stream is None:
            tensors = {k: _as_tensor(v).to(self.device)
                       for k, v in arrays.items()}
            if release is not None:
                release(None)
            return DeviceBatch(tensors)
        with torch.cuda.stream(self.stream):
            tensors = {k: _as_tensor(v).to(self.device, non_blocking=True)
                       for k, v in arrays.items()}
            event = torch.cuda.Event()
            event.record(self.stream)
        if release is not None:
            release(event)
        return DeviceBatch(tensors, event, self.device)

    def to_device(self, batch: Mapping, keys: Iterable[str]
                  ) -> Dict[str, torch.Tensor]:
        """``start(batch, keys).get()``."""
        return self.start(batch, keys).get()


def _as_tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v
    return torch.from_numpy(np.ascontiguousarray(v))
