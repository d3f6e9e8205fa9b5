"""Synthetic data (counterpart of vit_exp_tpu/data/synthetic.py:
``SyntheticCTDataset`` of data type "imagereport", "imageseg" or
"imageopenseg", and ``SyntheticInferenceDataset``, the zero-shot eval set):
random volumes at the exact production shapes and the batch dict layout,
made in memory so end-to-end runs need no CT-RATE data.  Item ``index``
draws from ``numpy.random.default_rng((seed, index))`` (the eval set's from
``default_rng((seed, index, 7))``) exactly as the JAX package does, so both
packages see the same bytes: the volume, then for the segmentation types a
float32 0/1 mask of ``n_classes`` channels (uniform > 0.8); the
open-vocabulary items also carry the class prompts "This is region of
organ {i}." through the tokenizer.  The draws go in cache-sized chunks
straight into float32, and ``collate_batch`` draws a batch's volumes and
masks into batch arrays: at full width a volume is 55 M values (a
22-class mask 1.2 G), and the float64 temporary and the stacking copy
were half of the loader's host time."""

from __future__ import annotations

from typing import Dict

import numpy as np

from vit_exp_tpu_torch.core.config import ArchConfig
from vit_exp_tpu_torch.data.loader import collate

_CHUNK = 1 << 18   # float64 values per draw: 2 MB, stays in cache

_SYNTH_SENTENCES = [
    "no acute cardiopulmonary abnormality",
    "mild cardiomegaly with pericardial effusion",
    "bilateral pleural effusion and atelectasis",
    "emphysema with scattered lung nodules",
    "consolidation in the right lower lobe",
    "interlobular septal thickening noted",
]


def _draw_uniform(rng: np.random.Generator, image: np.ndarray,
                  above: float | None = None) -> None:
    """Fill ``image`` (float32) with the values of rng.uniform(0, 1,
    image.shape).astype(float32) or, with ``above``, of (rng.uniform(0, 1,
    image.shape) > above).astype(float32), drawn in chunks (uniform(0, 1) is
    random(): 0 + 1·x, value for value), leaving rng where that call
    would."""
    flat = image.reshape(-1)
    buf = np.empty(min(_CHUNK, flat.size))
    for i in range(0, flat.size, buf.size):
        chunk = buf[:min(buf.size, flat.size - i)]
        rng.random(out=chunk)
        flat[i:i + chunk.size] = chunk if above is None else chunk > above


class SyntheticCTDataset:
    def __init__(self, data_type: str = "imagereport", *, n: int = 30,
                 arch: ArchConfig | None = None, tokenizer=None,
                 n_classes: int = 4, max_text_len: int = 128, seed: int = 0):
        if data_type not in ("imagereport", "imageseg", "imageopenseg"):
            raise ValueError(f"unknown synthetic data type {data_type!r}")
        self.data_type = data_type
        self.n = n
        self.arch = arch or ArchConfig()
        self.tokenizer = tokenizer
        self.n_classes = n_classes
        self.max_text_len = max_text_len
        self.seed = seed
        if data_type == "imageopenseg":
            if tokenizer is None:
                raise ValueError(
                    "imageopenseg synthetic data needs a tokenizer for the "
                    "class prompts")
            toks = tokenizer([f"This is region of organ {i}."
                              for i in range(n_classes)],
                             max_length=max_text_len)
            self.prompt_ids = toks["input_ids"]
            self.prompt_mask = toks["attention_mask"]

    def __len__(self):
        return self.n

    def _image_shape(self):
        a = self.arch
        return (a.channels, a.temporal_size, a.image_size, a.image_size)

    def _mask_shape(self):
        a = self.arch
        return (self.n_classes, a.temporal_size, a.image_size, a.image_size)

    @property
    def _seg(self) -> bool:
        return self.data_type != "imagereport"

    def __getitem__(self, index: int) -> Dict:
        mask = np.empty(self._mask_shape(), np.float32) if self._seg else None
        return self._item(index, np.empty(self._image_shape(), np.float32),
                          mask)

    def collate_batch(self, indices, alloc=None) -> Dict:
        """``collate([self[i] for i in indices])``, the images (and masks)
        drawn in place into the batch arrays (``alloc(key, shape, dtype)``'s
        when given, the loader's page-locked buffers)."""
        alloc = alloc or (lambda key, shape, dtype: np.empty(shape, dtype))
        n = len(indices)
        images = alloc("image", (n, *self._image_shape()), np.float32)
        masks = (alloc("seg_mask", (n, *self._mask_shape()), np.float32)
                 if self._seg else [None] * n)
        items = [self._item(i, images[j], masks[j])
                 for j, i in enumerate(indices)]
        batch = collate([{k: v for k, v in item.items()
                          if k not in ("image", "seg_mask")}
                         for item in items], alloc)
        batch["image"] = images
        if self._seg:
            batch["seg_mask"] = masks
        return batch

    def _item(self, index: int, image: np.ndarray,
              mask: np.ndarray | None) -> Dict:
        """Item ``index`` with its volume drawn into ``image`` (and, for the
        segmentation types, its mask into ``mask``)."""
        rng = np.random.default_rng((self.seed, index))
        _draw_uniform(rng, image)
        item: Dict = {"image": image, "data_type": self.data_type}
        if self.data_type == "imagereport":
            text = _SYNTH_SENTENCES[index % len(_SYNTH_SENTENCES)]
            item["text"] = text
            if self.tokenizer is not None:
                toks = self.tokenizer([text], max_length=self.max_text_len)
                item["input_ids"] = toks["input_ids"][0]
                item["attention_mask"] = toks["attention_mask"][0]
            return item
        _draw_uniform(rng, mask, above=0.8)
        item["seg_mask"] = mask
        if self.data_type == "imageopenseg":
            item["prompt_ids"] = self.prompt_ids
            item["prompt_mask"] = self.prompt_mask
        return item


class SyntheticInferenceDataset:
    """Synthetic zero-shot eval set: random volumes and random one-hot
    labels."""

    def __init__(self, n: int = 10, arch: ArchConfig | None = None,
                 n_labels: int = 18, seed: int = 0):
        self.n = n
        self.arch = arch or ArchConfig()
        self.n_labels = n_labels
        self.seed = seed

    def __len__(self):
        return self.n

    def __getitem__(self, index: int) -> Dict:
        rng = np.random.default_rng((self.seed, index, 7))
        a = self.arch
        image = np.empty((a.channels, a.temporal_size, a.image_size,
                          a.image_size), np.float32)
        _draw_uniform(rng, image)
        return {
            "image": image,
            "text": "synthetic report",
            "onehot": (rng.uniform(0, 1, self.n_labels) > 0.5).astype(
                np.float32),
            "accession": f"synthetic_{index}.nii.gz",
        }
