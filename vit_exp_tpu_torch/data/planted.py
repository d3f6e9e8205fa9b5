"""Planted-signal synthetic CT task, the image-report half (counterpart of
vit_exp_tpu/data/planted.py; the port's own copy, so the port imports
nothing of the JAX package).

A LEARNABLE image-text correspondence, where the plain synthetic sets carry
none: four attributes, each a smooth blob with an attribute-specific
octant and appearance (polarity × size, energies equalised), paired with a
report built from exactly the zero-shot prompt sentences ("{attr} is
present." / "{attr} is not present."), so after contrastive training the
zero-shot engine scores the attributes directly, and a held-out mean AUROC
well above 0.5 can only come from learning the correspondence.

The segmentation half plants lesion blobs of two classes ("bright
lesion", "dark lesion": the class is read from the appearance, the
position is uniform) with their 1.5σ ellipsoids as uint8 voxel masks: the
closed-set sets (``PlantedSegDataset``, ``PlantedSegInferenceDataset``) and
the open-vocabulary ones, whose train items also carry the tokenized class
prompts (``PlantedOpenSegDataset``, ``PlantedOpenSegInferenceDataset``).

Every index gives the JAX package's bytes: the fp16 volume, the uint8
mask, the report text and, through the same tokenizer, the token ids (the
same seeded ``numpy.random.default_rng`` streams, drawn in the same
order).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from vit_exp_tpu_torch.core.config import ArchConfig

# the class-prompt templates of the segmentation data sets (the JAX
# package's data/datasets.py::PROMPT_TEMPLATES)
PROMPT_TEMPLATES = {
    "this_region": "This is region of {name}.",
    "this_is": "This is {name}.",
}

PLANTED_ATTRS: Tuple[str, ...] = (
    "left effusion",
    "cardiomegaly",
    "lung nodule",
    "consolidation",
)

# blob centers in fractional (z, y, x): distinct octants, so attributes
# never overlap even with the per-sample jitter
_CENTERS = (
    (0.30, 0.30, 0.30),
    (0.30, 0.70, 0.70),
    (0.70, 0.30, 0.70),
    (0.70, 0.70, 0.30),
)

# per-attribute (gain, sigma_frac): distinct in polarity and size, near
# equal in integrated energy |gain|·σ³ ≈ 0.0014 (the JAX package's run 7:
# identical blobs let the contrastive objective suppress redundant
# features, and unequal energies let it learn only the most salient ones)
_APPEARANCE = (
    (0.50, 0.140),
    (-0.40, 0.152),
    (0.30, 0.167),
    (-0.26, 0.175),
)


def planted_report(labels: Sequence[int],
                   attrs: Sequence[str] = PLANTED_ATTRS,
                   rng: np.random.Generator | None = None,
                   drop_neg_p: float = 0.0,
                   drop_any_p: float = 0.0) -> str:
    """Report text: the zero-shot prompt sentences of the labels, joined.

    With ``rng`` the sentence order is shuffled per sample (so the text
    tower encodes what a sentence says, not where it sits).  ``drop_neg_p``
    drops each negative sentence with that probability, ``drop_any_p`` each
    sentence alike (the variant that keeps "not" load-bearing); both need
    ``rng``, and at least one sentence is always kept."""
    sentences = [
        f"{a} is present." if y else f"{a} is not present."
        for a, y in zip(attrs, labels)
    ]
    if (drop_neg_p > 0 or drop_any_p > 0) and rng is None:
        raise ValueError("sentence dropping (drop_neg_p/drop_any_p > 0) "
                         "requires rng (must be seeded per sample)")
    if rng is not None and drop_neg_p > 0:
        kept = [s for s, y in zip(sentences, labels)
                if y or rng.uniform() >= drop_neg_p]
        if not kept:
            kept = [sentences[int(rng.integers(len(sentences)))]]
        sentences = kept
    if rng is not None and drop_any_p > 0:
        kept = [s for s in sentences if rng.uniform() >= drop_any_p]
        if not kept:
            kept = [sentences[int(rng.integers(len(sentences)))]]
        sentences = kept
    if rng is not None:
        sentences = [sentences[i] for i in rng.permutation(len(sentences))]
    return " ".join(sentences)


def _separable_blob(shape, center, sigma_frac, rng):
    """Axis-separable Gaussian bump with per-sample center jitter: the outer
    product of three 1-D Gaussians."""
    axes = []
    for size, c in zip(shape, center):
        cj = c + rng.uniform(-0.04, 0.04)
        x = (np.arange(size, dtype=np.float32) / size - cj) / sigma_frac
        axes.append(np.exp(-0.5 * x * x))
    return (axes[0][:, None, None] * axes[1][None, :, None]
            * axes[2][None, None, :])


def planted_volume(rng: np.random.Generator, labels: Sequence[int],
                   shape: Tuple[int, int, int]) -> np.ndarray:
    """(1, D, H, W) float16 volume in [0, 1]: a low-frequency background, one
    blob per present attribute, voxel noise.  fp16 halves the host-to-device
    bytes; the tower casts to its compute dtype on entry."""
    d, h, w = shape
    coarse = rng.standard_normal((3, 4, 4)).astype(np.float32)
    base = (coarse.repeat(-(-d // 3), 0)[:d]
                  .repeat(-(-h // 4), 1)[:, :h]
                  .repeat(-(-w // 4), 2)[:, :, :w])
    vol = 0.45 + 0.10 * base
    for k, y in enumerate(labels):
        if y:
            gain, sigma = _APPEARANCE[k]
            vol = vol + gain * _separable_blob(shape, _CENTERS[k], sigma, rng)
    vol = vol + 0.05 * rng.standard_normal(shape).astype(np.float32)
    return np.clip(vol, 0.0, 1.0)[None].astype(np.float16)


def _labels_for(rng: np.random.Generator, k: int) -> np.ndarray:
    return (rng.uniform(0, 1, k) < 0.5).astype(np.float32)


class PlantedCTDataset:
    """imagereport train set with a planted image-text correspondence."""

    def __init__(self, n: int = 64, *, arch: ArchConfig | None = None,
                 tokenizer=None, max_text_len: int = 64, seed: int = 0,
                 attrs: Sequence[str] = PLANTED_ATTRS,
                 drop_neg_p: float = 0.0, drop_any_p: float = 0.0):
        self.n = n
        self.arch = arch or ArchConfig()
        self.tokenizer = tokenizer
        self.max_text_len = max_text_len
        self.seed = seed
        self.attrs = list(attrs)
        self.drop_neg_p = drop_neg_p
        self.drop_any_p = drop_any_p

    def __len__(self):
        return self.n

    def __getitem__(self, index: int) -> Dict:
        rng = np.random.default_rng((self.seed, index))
        a = self.arch
        labels = _labels_for(rng, len(self.attrs))
        text = planted_report(labels, self.attrs, rng=rng,
                              drop_neg_p=self.drop_neg_p,
                              drop_any_p=self.drop_any_p)
        item: Dict = {
            "image": planted_volume(
                rng, labels, (a.temporal_size, a.image_size, a.image_size)),
            "text": text,
            "data_type": "imagereport",
        }
        if self.tokenizer is not None:
            toks = self.tokenizer([text], max_length=self.max_text_len)
            item["input_ids"] = toks["input_ids"][0]
            item["attention_mask"] = toks["attention_mask"][0]
        return item


class PlantedInferenceDataset:
    """Held-out zero-shot eval set over the same planted distribution,
    disjoint from any train index by a distinct seed stream."""

    def __init__(self, n: int = 32, *, arch: ArchConfig | None = None,
                 seed: int = 1, attrs: Sequence[str] = PLANTED_ATTRS):
        self.n = n
        self.arch = arch or ArchConfig()
        self.seed = seed
        self.attrs = list(attrs)

    def __len__(self):
        return self.n

    def __getitem__(self, index: int) -> Dict:
        rng = np.random.default_rng((self.seed, index, 11))
        a = self.arch
        labels = _labels_for(rng, len(self.attrs))
        return {
            "image": planted_volume(
                rng, labels, (a.temporal_size, a.image_size, a.image_size)),
            "text": planted_report(labels, self.attrs, rng=rng),
            "onehot": labels,
            "accession": f"planted_{index}.nii.gz",
        }


# --- the planted segmentation task ---------------------------------------------

# lexically distinct whole words: with "hyperdense"/"hypodense" a
# random-init BERT's CLS states barely differed and the two prompt
# embeddings collapsed (the JAX package's first open-seg run on its chip)
PLANTED_STRUCTS: Tuple[str, ...] = ("bright lesion", "dark lesion")

# class k adds _SEG_GAIN[k]·blob: the class is read from the appearance
_SEG_GAIN = (0.45, -0.40)
# σ 0.14 puts ~3.9% of the voxels in a mask (at 0.08, 0.7%, plain BCE found
# the all-background optimum)
_SEG_SIGMA = 0.14
# mask = blob ≥ this ⇔ the voxel lies within 1.5σ of the jittered center
_SEG_MASK_LEVEL = float(np.exp(-0.5 * 1.5 * 1.5))


def planted_seg_sample(rng: np.random.Generator, present: Sequence[int],
                       shape: Tuple[int, int, int]):
    """((1, D, H, W) float16 volume, (C, D, H, W) uint8 mask): each present
    class plants one blob at a uniform random center in [0.2, 0.8]³, and
    its mask is the blob's 1.5σ ellipsoid."""
    d, h, w = shape
    coarse = rng.standard_normal((3, 4, 4)).astype(np.float32)
    base = (coarse.repeat(-(-d // 3), 0)[:d]
                  .repeat(-(-h // 4), 1)[:, :h]
                  .repeat(-(-w // 4), 2)[:, :, :w])
    vol = 0.45 + 0.08 * base
    masks = np.zeros((len(present),) + shape, np.uint8)
    for k, y in enumerate(present):
        if y:
            center = tuple(rng.uniform(0.2, 0.8, 3))
            blob = _separable_blob(shape, center, _SEG_SIGMA, rng)
            vol = vol + _SEG_GAIN[k] * blob
            masks[k] = blob >= _SEG_MASK_LEVEL
    vol = vol + 0.04 * rng.standard_normal(shape).astype(np.float32)
    return np.clip(vol, 0.0, 1.0)[None].astype(np.float16), masks


class _PlantedSeg:
    """Item ``index`` of a planted segmentation set: its stream is
    default_rng((seed, index, ``_STREAM``)); each class is present with
    probability 0.7."""

    _STREAM = 0

    def __init__(self, n: int, *, arch: ArchConfig | None = None,
                 seed: int = 0, structs: Sequence[str] = PLANTED_STRUCTS):
        self.n = n
        self.arch = arch or ArchConfig()
        self.seed = seed
        self.structs = list(structs)

    def __len__(self):
        return self.n

    def _sample(self, index: int):
        rng = np.random.default_rng((self.seed, index, self._STREAM))
        a = self.arch
        present = (rng.uniform(0, 1, len(self.structs)) < 0.7).astype(int)
        return planted_seg_sample(
            rng, present, (a.temporal_size, a.image_size, a.image_size))


class PlantedSegDataset(_PlantedSeg):
    """imageseg train set: items with "image" and the voxel "seg_mask"."""

    _STREAM = 7

    def __init__(self, n: int = 64, **kwargs):
        super().__init__(n, **kwargs)

    def __getitem__(self, index: int) -> Dict:
        vol, masks = self._sample(index)
        return {"image": vol, "seg_mask": masks, "data_type": "imageseg"}


class PlantedOpenSegDataset(_PlantedSeg):
    """imageopenseg train set: the same planted lesions, supervised through
    the open-vocabulary path; items also carry the class prompts
    ("This is region of {name}."), tokenized once."""

    _STREAM = 17

    def __init__(self, n: int = 64, *, arch: ArchConfig | None = None,
                 tokenizer=None, max_text_len: int = 64, seed: int = 0,
                 structs: Sequence[str] = PLANTED_STRUCTS,
                 prompt_type: str = "this_region"):
        if tokenizer is None:
            raise ValueError("PlantedOpenSegDataset needs a tokenizer for "
                             "the class prompts")
        super().__init__(n, arch=arch, seed=seed, structs=structs)
        template = PROMPT_TEMPLATES[prompt_type]
        toks = tokenizer([template.format(name=s) for s in self.structs],
                         max_length=max_text_len)
        self.prompt_ids = toks["input_ids"]          # (C, L)
        self.prompt_mask = toks["attention_mask"]    # (C, L)

    def __getitem__(self, index: int) -> Dict:
        vol, masks = self._sample(index)
        return {"image": vol, "seg_mask": masks,
                "prompt_ids": self.prompt_ids,
                "prompt_mask": self.prompt_mask,
                "data_type": "imageopenseg"}


class PlantedSegInferenceDataset(_PlantedSeg):
    """Held-out dice set of the closed-set task (``ZeroShotSegmenter``)."""

    _STREAM = 13

    def __init__(self, n: int = 16, *, seed: int = 1, **kwargs):
        super().__init__(n, seed=seed, **kwargs)

    def __getitem__(self, index: int) -> Dict:
        vol, masks = self._sample(index)
        return {"image": vol, "seg_mask": masks,
                "accession": f"planted_seg_{index}.nii.gz"}


class PlantedOpenSegInferenceDataset(_PlantedSeg):
    """Held-out set of the open-vocabulary task, scored by the dice of its
    prediction surface thresholded at 0.5."""

    _STREAM = 19

    def __init__(self, n: int = 16, *, seed: int = 1, **kwargs):
        super().__init__(n, seed=seed, **kwargs)

    def __getitem__(self, index: int) -> Dict:
        vol, masks = self._sample(index)
        return {"image": vol, "seg_mask": masks,
                "accession": f"planted_openseg_{index}.nii.gz"}
