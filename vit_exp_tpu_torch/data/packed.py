"""Packed binary shards (counterpart of vit_exp_tpu/data/packed.py): the
volume store that reads at ingest speed.

An npz tree costs one file open and one inflate per volume.  A packed store
holds the preprocessed volumes as raw arrays concatenated into shards of
about 1 GB with a JSON index: a read is one memmap slice (no copy until the
pages are touched, no decompression) or one positional read through the
native reader, and a shard lays its records out in write order.

The format is the JAX package's, byte for byte, so a store written by
either package loads in the other:

    index.json           {"version": 1, "records": [{"key", "shard",
                          "offset", "shape", "dtype", "meta"}, ...]}
    shard_00000.bin ...  raw little-endian array bytes, records 64-byte
                         aligned

``PackedShardWriter`` writes, ``PackedVolumeStore`` reads;
``CTReportPackedDataset`` and ``CTReportPackedInferenceDataset`` are the
data sets of datasets.py over a store.  The port's packer is
cli/pack_dataset.py.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from vit_exp_tpu_torch import native

ALIGN = 64


class PackedShardWriter:
    """Appends arrays; starts a new shard past ``shard_bytes``."""

    def __init__(self, out_dir: str, shard_bytes: int = 1 << 30):
        self.out_dir = out_dir
        self.shard_bytes = shard_bytes
        os.makedirs(out_dir, exist_ok=True)
        self.records: List[Dict] = []
        self._shard_idx = -1
        self._fh = None
        self._offset = 0

    def _roll(self):
        if self._fh is not None:
            self._fh.close()
        self._shard_idx += 1
        path = os.path.join(self.out_dir, f"shard_{self._shard_idx:05d}.bin")
        self._fh = open(path, "wb")
        self._offset = 0

    def append(self, key: str, array: np.ndarray, meta: Optional[Dict] = None):
        array = np.ascontiguousarray(array)
        if self._fh is None or (
                self._offset > 0
                and self._offset + array.nbytes > self.shard_bytes):
            self._roll()
        pad = (-self._offset) % ALIGN
        if pad:
            self._fh.write(b"\0" * pad)
            self._offset += pad
        self.records.append({
            "key": key,
            "shard": self._shard_idx,
            "offset": self._offset,
            "shape": list(array.shape),
            "dtype": array.dtype.name,
            "meta": meta or {},
        })
        self._fh.write(array.tobytes())
        self._offset += array.nbytes

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        with open(os.path.join(self.out_dir, "index.json"), "w") as f:
            json.dump({"version": 1, "records": self.records}, f)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class PackedVolumeStore:
    """Random access over packed shards, by two paths:

    - ``get``: one memmap slice (a view, no copy);
    - ``get_f32`` and ``get_batch``: the native reader (``native``),
      positional reads with the conversion to fp32 fused, on a thread pool
      with the GIL released; numpy when the library did not build.
    """

    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, "index.json")) as f:
            index = json.load(f)
        if index.get("version") != 1:
            raise ValueError(f"{root}: unknown packed-shard version "
                             f"{index.get('version')!r}")
        self.records = index["records"]
        self.by_key = {r["key"]: r for r in self.records}
        self._maps: Dict[int, np.memmap] = {}
        self._fds: Dict[int, int] = {}
        self._fd_lock = threading.Lock()

    def keys(self) -> List[str]:
        return [r["key"] for r in self.records]

    def _shard_path(self, shard: int) -> str:
        return os.path.join(self.root, f"shard_{shard:05d}.bin")

    def _mmap(self, shard: int) -> np.memmap:
        m = self._maps.get(shard)
        if m is None:
            m = np.memmap(self._shard_path(shard), dtype=np.uint8, mode="r")
            self._maps[shard] = m
        return m

    def _fd(self, shard: int) -> int:
        # loader threads call this concurrently: without the lock two of
        # them could both open the shard and one descriptor would leak
        with self._fd_lock:
            fd = self._fds.get(shard)
            if fd is None:
                fd = os.open(self._shard_path(shard), os.O_RDONLY)
                self._fds[shard] = fd
            return fd

    def close(self):
        with self._fd_lock:
            for fd in self._fds.values():
                os.close(fd)
            self._fds.clear()
        self._maps.clear()

    def meta(self, key: str) -> Dict:
        return self.by_key[key]["meta"]

    def get(self, key: str) -> np.ndarray:
        r = self.by_key[key]
        dtype = np.dtype(r["dtype"])
        nbytes = int(np.prod(r["shape"])) * dtype.itemsize
        raw = self._mmap(r["shard"])[r["offset"]: r["offset"] + nbytes]
        return raw.view(dtype).reshape(r["shape"])

    __getitem__ = get

    def get_f32(self, key: str, *, scale: float = 1.0, shift: float = 0.0,
                threads: Optional[int] = None) -> np.ndarray:
        """One record as a fresh float32 array, through the native reader."""
        return self.get_batch([key], scale=scale, shift=shift,
                              threads=threads)[0]

    def get_batch(self, keys: List[str], *, scale: float = 1.0,
                  shift: float = 0.0, threads: Optional[int] = None,
                  out: Optional[np.ndarray] = None) -> np.ndarray:
        """Records of one shape and dtype → one C-contiguous (B, *shape)
        float32 array (``out`` when given), filled by parallel reads with
        the conversion fused."""
        recs = [self.by_key[k] for k in keys]
        shape = tuple(recs[0]["shape"])
        dtype = np.dtype(recs[0]["dtype"])
        for r in recs:
            if tuple(r["shape"]) != shape or np.dtype(r["dtype"]) != dtype:
                raise ValueError("get_batch requires uniform records")
        n_elem = int(np.prod(shape))
        want = (len(recs),) + shape
        if out is None:
            out = np.empty(want, dtype=np.float32)
        elif (tuple(out.shape) != want or out.dtype != np.float32
              or not out.flags["C_CONTIGUOUS"]):
            # the native reader writes through a raw pointer at computed
            # element offsets: a wrong buffer would corrupt the heap
            raise ValueError(f"out must be C-contiguous float32 {want}; got "
                             f"{out.dtype} {tuple(out.shape)}")
        native.read_convert_f32(
            [self._fd(r["shard"]) for r in recs],
            [r["offset"] for r in recs],
            [n_elem * dtype.itemsize] * len(recs),
            dtype,
            [i * n_elem for i in range(len(recs))],
            out, scale=scale, shift=shift, threads=threads,
        )
        return out

    def __len__(self):
        return len(self.records)


class CTReportPackedDataset:
    """``CTReportDataset`` over a store: the same items, with each volume
    read from its shard instead of an npz.  The report comes from the
    record's meta (written by the packer) or a reports CSV."""

    def __init__(self, root: str, csv_file: Optional[str] = None, *,
                 tokenizer=None, keep_percent: int = 100,
                 max_text_len: int = 512):
        from vit_exp_tpu_torch.data.datasets import _STRIP_CHARS, load_reports

        self.store = PackedVolumeStore(root)
        self.tokenizer = tokenizer
        self.max_text_len = max_text_len
        self._strip = _STRIP_CHARS
        acc_to_text = load_reports(csv_file) if csv_file else {}
        self.samples: List[Tuple[str, str]] = []
        for r in self.store.records:
            text = r["meta"].get("text")
            if text is None:
                text = acc_to_text.get(r["key"])
            if text is not None:
                self.samples.append((r["key"], text))
        self.samples = self.samples[: len(self.samples) * keep_percent // 100]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, index: int) -> Dict:
        key, text = self.samples[index]
        volume = self.store.get_f32(key)
        return self._item(volume[None] if volume.ndim == 3 else volume, text)

    def _item(self, volume: Optional[np.ndarray], text: str) -> Dict:
        text = text.translate(self._strip)
        item = {"image": volume, "text": text, "data_type": "imagereport"}
        if self.tokenizer is not None:
            toks = self.tokenizer([text], max_length=self.max_text_len)
            item["input_ids"] = toks["input_ids"][0]
            item["attention_mask"] = toks["attention_mask"][0]
        return item

    def collate_batch(self, indices, alloc=None) -> Dict:
        """``collate([self[i] for i in indices])`` with the volumes read by
        one native ``get_batch`` straight into the batch array
        (``alloc(key, shape, dtype)``'s when given, the loader's
        page-locked buffers)."""
        from vit_exp_tpu_torch.data.loader import collate

        keys = [self.samples[i][0] for i in indices]
        recs = [self.store.by_key[k] for k in keys]
        shape = tuple(recs[0]["shape"])
        if any(tuple(r["shape"]) != shape or r["dtype"] != recs[0]["dtype"]
               for r in recs):   # records of several shapes: item by item
            return collate([self[i] for i in indices], alloc)
        full = (len(keys),) + ((1,) + shape if len(shape) == 3 else shape)
        images = (alloc("image", full, np.float32) if alloc
                  else np.empty(full, np.float32))
        self.store.get_batch(keys, out=images.reshape((len(keys),) + shape))
        batch = collate([{k: v for k, v in self._item(None,
                                                      self.samples[i][1])
                          .items() if k != "image"} for i in indices], alloc)
        batch["image"] = images
        return batch


class CTReportPackedInferenceDataset:
    """``CTReportInferenceDataset`` over a store: items (image, text, onehot,
    accession) for the zero-shot engines, each volume read through the
    native reader.  The packer keys records by their ``.nii.gz`` accession,
    the labels CSV's VolumeName."""

    def __init__(self, root: str, labels_file: str,
                 csv_file: Optional[str] = None, *,
                 limit: Optional[int] = None):
        from vit_exp_tpu_torch.data.datasets import load_labels, load_reports

        self.store = PackedVolumeStore(root)
        self.label_columns, acc_to_onehot = load_labels(labels_file)
        acc_to_text = load_reports(csv_file) if csv_file else {}
        self.samples: List[Tuple[str, str, np.ndarray]] = []
        for r in self.store.records:
            key = r["key"]
            onehot = acc_to_onehot.get(key)
            if onehot is None:
                continue
            text = r["meta"].get("text")
            if text is None:
                text = acc_to_text.get(key, "")
            self.samples.append((key, text, onehot))
        if limit:
            self.samples = self.samples[:limit]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, index: int) -> Dict:
        key, text, onehot = self.samples[index]
        volume = self.store.get_f32(key)
        if volume.ndim == 3:
            volume = volume[None]
        return {"image": volume, "text": text, "onehot": onehot,
                "accession": key}
