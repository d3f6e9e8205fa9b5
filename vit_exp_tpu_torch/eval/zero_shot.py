"""Zero-shot classification and segmentation engines (counterpart of
vit_exp_tpu/eval/zero_shot.py::ZeroShotClassifier and ZeroShotSegmenter).

18 CT-RATE pathologies, two prompts each ("{p} is present." / "{p} is not
present."); the 36 prompt latents are embedded once; each volume is encoded
once and scored as softmax([present, absent]) over cosine × exp(temperature).
The tokenizer is any callable ``(prompts, max_length=...) -> {"input_ids",
"attention_mask"}``.

``infer`` scores an inference data set (items with "image", "onehot" and
"accession") in batches of ``batch_size``: the port's threaded ``Loader``
makes batch i + 1 while batch i computes, and batch i's probabilities are
read one batch late (``_one_deep_map``).  On a CUDA device each engine's
loaders collate the volumes (and masks) into the engine's own pool of
ENGINE_PIN_SLOTS page-locked buffer sets, allocated once for all its
calls, and every batch, served ones included, goes to the card through
its ``BatchCopier`` (``data/pinned.py``): a side-stream copy that batch
i + 1 starts while batch i computes.  The JAX engine pads its tail batch
for XLA's static shapes; the port runs the short batch as it is (each
volume's probabilities depend on that volume alone, bit for bit on the
card: the tower's kernels take each volume alike at any batch, and the
latent and the scores are taken one volume at a time; on the int8 path
up to the batch's one k scale).  It returns
``evaluate_internal``'s per-label AUROCs and ``volumes_per_sec``.  The model
is scored in eval mode under ``torch.inference_mode`` and left in the mode
it was in; scoring draws from no random stream.

``ZeroShotSegmenter`` scores a segmentation set (items with "image" and
"seg_mask") by the per-sample, per-class dice of ``seg_forward``'s logits,
one batch at a time on the device (the tail batch padded by repeating its
last item, whose rows are dropped), read one batch late.  It returns the
per-class dice averaged over the samples with nanmean, ``dice_class_{i}``,
and their nanmean, ``mean_dice``.

With a process ``group`` (several cards; the JAX engines' mesh) an
engine's batch is ``batch_size`` volumes a rank, ``batch_size × ranks``
in all: each rank loads and encodes its own rows of each global batch
(the last one padded by repeating the last item), and a gather (not
differentiable) returns the whole batch's results to every rank in the
single-process order, cut to the items that exist.  Every rank thus
computes the same metrics; only global rank 0 writes files.  On a grid
the group is the batch group (core/mesh.py): every rank holds the whole
model, as JAX's engines do, and the ranks of a model group repeat their
position's rows.

The int8 path quantizes each block's k at one scale, the amax of the whole
batch (ops/flash_attention.py::quantize_qk).  Under a mesh JAX takes it
over the global batch, so with a group each block's amax is reduced (MAX)
over the ranks (``shared_k_scale``): the ranks' int8 results are those of
one process scoring the global batch.  The padded tail repeats its last
item, which leaves the amax as it is.

``SplitClassifier`` is one process driving several devices (``serve
--mesh``): a copy of the model on each, every batch split into contiguous
parts run at once, one thread per device, whose blocks exchange their k
amaxes at a barrier, so its answers are the one-device engine's on the
whole batch.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from vit_exp_tpu_torch.data.loader import Loader
from vit_exp_tpu_torch.data.pinned import BatchCopier, PinnedPool
from vit_exp_tpu_torch.eval.metrics import (evaluate_internal,
                                            save_inference_artifacts)
from vit_exp_tpu_torch.models.ctclip import CTCLIP
from vit_exp_tpu_torch.models.losses import dice_scores_per_sample
from vit_exp_tpu_torch.core import multihost
from vit_exp_tpu_torch.parallel.collectives import (all_reduce_max,
                                                    gather_objects,
                                                    gather_rows, rank,
                                                    world)

PATHOLOGIES: List[str] = [
    "Medical material", "Arterial wall calcification", "Cardiomegaly",
    "Pericardial effusion", "Coronary artery wall calcification",
    "Hiatal hernia", "Lymphadenopathy", "Emphysema", "Atelectasis",
    "Lung nodule", "Lung opacity", "Pulmonary fibrotic sequela",
    "Pleural effusion", "Mosaic attenuation pattern",
    "Peribronchial thickening", "Consolidation", "Bronchiectasis",
    "Interlobular septal thickening",
]


def build_pathology_prompts(
        pathologies: Sequence[str] = PATHOLOGIES) -> List[str]:
    """[p0 present, p0 absent, p1 present, ...] — 2 per pathology."""
    prompts = []
    for p in pathologies:
        prompts.append(f"{p} is present.")
        prompts.append(f"{p} is not present.")
    return prompts


class _Subset:
    """First-n view of a data set."""

    def __init__(self, dataset, n: int):
        self._dataset = dataset
        self._n = n

    def __len__(self):
        return self._n

    def __getitem__(self, i):
        return self._dataset[i]


class _RankRows:
    """Rank r's rows of each global batch of the first n items (R ranks,
    b rows each: items i·R·b + r·b … of global batch i), the last global
    batch padded with item n − 1, so every rank holds the same number of
    batches."""

    def __init__(self, dataset, n: int, batch_size: int, group):
        self._dataset, self._n, self._b = dataset, n, batch_size
        self._first = rank(group) * batch_size
        self.global_batch = batch_size * world(group)
        self.batches = -(-n // self.global_batch)

    def __len__(self):
        return self.batches * self._b

    def __getitem__(self, j):
        i, row = divmod(j, self._b)
        return self._dataset[min(i * self.global_batch + self._first + row,
                                 self._n - 1)]

    def valid(self, i: int) -> int:
        """The items global batch i holds."""
        return min(self.global_batch, self._n - i * self.global_batch)


def gather_batch(payload, group, k: int):
    """A rank's payload of device tensors and host lists (a tuple) as the
    global batch's: the tensors gathered along dim 0, the lists joined, in
    rank order, each cut to its first k rows."""
    host = [i for i, x in enumerate(payload) if not isinstance(x, torch.Tensor)]
    lists = gather_objects([list(payload[i]) for i in host], group)
    out = list(payload)
    for j, i in enumerate(host):
        out[i] = [row for parts in lists for row in parts[j]][:k]
    for i, x in enumerate(payload):
        if isinstance(x, torch.Tensor):
            out[i] = gather_rows(x, group)[:k]
    return tuple(out)


def amax_over(group):
    """The k-amax reducer of an engine with ``group``: the MAX over its
    ranks (None without a group)."""
    if group is None:
        return None
    return lambda amax: all_reduce_max(amax.reshape(1), group)[0]


@contextlib.contextmanager
def shared_k_scale(model: CTCLIP, reduce):
    """``model``'s image tower takes its int8 k amaxes through ``reduce``
    for the length of the context."""
    tower = model.visual_transformer
    prev, tower.k_amax_reduce = tower.k_amax_reduce, reduce
    try:
        yield
    finally:
        tower.k_amax_reduce = prev


# page-locked buffer sets of an engine: the batch being copied and the next
ENGINE_PIN_SLOTS = 2


class _Feed:
    """An engine's way to the device: its copier and, on a CUDA device, its
    pool of page-locked buffers for ``keys``."""

    def __init__(self, device, keys):
        self.device = torch.device(device)
        self.keys = tuple(keys)
        self.copier = BatchCopier(self.device)
        self.pool = (PinnedPool(ENGINE_PIN_SLOTS, self.keys, register=True)
                     if self.device.type == "cuda" else None)

    def to_device(self, batch) -> Dict[str, torch.Tensor]:
        return self.copier.to_device(batch, self.keys)

    def tensor(self, x, key: str) -> torch.Tensor:
        """An array (or tensor) of batch key ``key`` on the device."""
        if isinstance(x, torch.Tensor) and x.device == self.device:
            return x
        return self.copier.to_device({key: x}, (key,))[key]


def _one_deep_map(dataset, n: int, batch_size: int,
                  dispatch: Callable[[Dict], object], *,
                  num_workers: int = 4,
                  pool: Optional[PinnedPool] = None, group=None) -> Iterator:
    """dispatch(batch) over the first n items in batches (the tail batch may
    be short), loaded on background threads (into ``pool``'s buffers when
    given); each payload is yielded one batch late, after the next batch's
    dispatch, so the consumer's host reads overlap the device's work; the
    last is flushed at the end.  With a ``group`` the batches are this
    rank's rows (``_RankRows``) and each payload (a tuple of device tensors
    and host lists) comes back as the global batch's (``gather_batch``)."""
    view = (_Subset(dataset, n) if group is None
            else _RankRows(dataset, n, batch_size, group))
    loader = Loader(view, batch_size, shuffle=False,
                    num_workers=num_workers, prefetch=2, pool=pool)

    def payloads():
        pending = None
        try:
            for batch in loader:
                payload = dispatch(batch)
                if pending is not None:
                    yield pending
                pending = payload
        finally:
            loader.stop()   # the pool outlives this loader
        if pending is not None:
            yield pending

    for i, payload in enumerate(payloads()):
        yield (payload if group is None
               else gather_batch(payload, group, view.valid(i)))


class ZeroShotClassifier:
    """Batched zero-shot engine over one CTCLIP on one device."""

    def __init__(self, model: CTCLIP, tokenizer, *,
                 pathologies: Sequence[str] = PATHOLOGIES,
                 max_text_len: int = 512, batch_size: int = 4, group=None):
        self.model = model
        self.group = group
        self.tokenizer = tokenizer
        self.pathologies = list(pathologies)
        self.max_text_len = max_text_len
        self.batch_size = batch_size
        self.device = next(model.parameters()).device
        self.feed = _Feed(self.device, ("image",))
        self._cached_text = None
        self.k_amax_reduce = amax_over(group)

    def set_params(self, model: Optional[CTCLIP] = None) -> None:
        """Score ``model`` from now on (or, given nothing, the model the
        engine holds, whose weights have changed in place, as a trainer's
        do) and drop the prompt cache, which the old text tower made."""
        if model is not None:
            self.model = model
            if next(model.parameters()).device != self.device:
                self.device = next(model.parameters()).device
                self.feed = _Feed(self.device, self.feed.keys)
        self._cached_text = None

    @torch.inference_mode()
    def prepare(self) -> torch.Tensor:
        """Embed the 2·len(pathologies) prompts once."""
        toks = self.tokenizer(build_pathology_prompts(self.pathologies),
                              max_length=self.max_text_len)
        ids = torch.as_tensor(np.asarray(toks["input_ids"]), device=self.device)
        mask = torch.as_tensor(np.asarray(toks["attention_mask"]),
                               device=self.device)
        hidden = self.model.encode_text_hidden(ids, mask)
        self._cached_text = self.model.text_latents_from_hidden(hidden)
        return self._cached_text

    @torch.inference_mode()
    def probs(self, volumes) -> torch.Tensor:
        """(B, 1, D, H, W) → (B, n_pathologies) P(present), on the device;
        host volumes go through the engine's copier."""
        if self._cached_text is None:
            self.prepare()
        video = self.feed.tensor(volumes, "image")
        with shared_k_scale(self.model, self.k_amax_reduce):
            tokens = self.model.encode_image_tokens(video)
        # one volume's latent and scores at a time: a reduction's or a
        # product's algorithm follows its shape, so a batched one's last
        # bit would depend on the batch a volume rides in
        img = torch.cat([self.model.image_latents_from_tokens(t)
                         for t in tokens.split(1)])
        scores = torch.cat([row @ self._cached_text.T
                            for row in img.split(1)])
        scores = scores * self.model.logit_scale()
        pairs = scores.reshape(img.shape[0], len(self.pathologies), 2)
        return torch.softmax(pairs, dim=-1)[..., 0]

    def predict_batch(self, volumes) -> np.ndarray:
        """(B, 1, D, H, W) → (B, n_pathologies) P(present) as numpy."""
        return self.probs(volumes).cpu().numpy()

    def infer(self, dataset, *, results_folder: Optional[str] = None,
              limit: Optional[int] = None,
              num_workers: int = 4) -> Dict[str, float]:
        """Score the first ``limit`` items of ``dataset`` (all without it):
        per-label AUROC, 'mean_auc' and 'volumes_per_sec' (timed before the
        AUROC pass); with ``results_folder`` also the inference artifacts."""
        n = min(len(dataset), limit) if limit else len(dataset)
        was_training = self.model.training
        self.model.eval()
        preds, labels, accessions = [], [], []
        try:
            t0 = time.perf_counter()
            for dev, onehots, accs in _one_deep_map(
                    dataset, n, self.batch_size,
                    lambda b: (self.probs(self.feed.to_device(b)["image"]),
                               b["onehot"], b["accession"]),
                    num_workers=num_workers, pool=self.feed.pool,
                    group=self.group):
                preds.extend(dev.cpu().numpy())
                labels.extend(onehots)
                accessions.extend(accs)
            elapsed = time.perf_counter() - t0
        finally:
            self.model.train(was_training)
        y_pred, y_true = np.asarray(preds), np.asarray(labels)
        res = evaluate_internal(y_pred, y_true, self.pathologies)
        res["volumes_per_sec"] = n / elapsed
        if results_folder and multihost.is_main_process():
            save_inference_artifacts(results_folder, y_pred, y_true,
                                     accessions, res)
        return res


class ZeroShotSegmenter:
    """Closed-set dice engine over one CTCLIP with a seg head on one
    device."""

    def __init__(self, model: CTCLIP, *, batch_size: int = 1, group=None):
        self.model = model
        self.group = group
        self.batch_size = batch_size
        self.device = next(model.parameters()).device
        self.feed = _Feed(self.device, ("image", "seg_mask"))
        self.k_amax_reduce = amax_over(group)

    def set_params(self, model: Optional[CTCLIP] = None) -> None:
        """Score ``model`` from now on (given nothing, the engine's own
        model, whose weights have changed in place)."""
        if model is not None:
            self.model = model
            if next(model.parameters()).device != self.device:
                self.device = next(model.parameters()).device
                self.feed = _Feed(self.device, self.feed.keys)

    @torch.inference_mode()
    def dice(self, volumes, masks) -> torch.Tensor:
        """(B, 1, D, H, W), (B, C, D, H, W) → (B, C) per-sample dice, on the
        device; host arrays go through the engine's copier."""
        video = self.feed.tensor(volumes, "image")
        mask = self.feed.tensor(masks, "seg_mask")
        with shared_k_scale(self.model, self.k_amax_reduce):
            logits = self.model.seg_forward(video)
        return dice_scores_per_sample(logits, mask)

    def dice_batch(self, volumes, masks) -> np.ndarray:
        return self.dice(volumes, masks).cpu().numpy()

    def _dispatch(self, batch: Dict):
        dev = self.feed.to_device(batch)
        volumes, masks = dev["image"], dev["seg_mask"]
        k = volumes.shape[0]
        if k < self.batch_size:   # pad the tail: repeat the last item
            idx = torch.arange(self.batch_size,
                               device=volumes.device).clamp_max(k - 1)
            volumes, masks = volumes[idx], masks[idx]
        return (self.dice(volumes, masks)[:k],)

    def infer(self, dataset, *, results_folder: Optional[str] = None,
              limit: Optional[int] = None,
              num_workers: int = 4) -> Dict[str, float]:
        """Dice over the first ``limit`` items of ``dataset`` (all without
        it): ``dice_class_{i}`` and ``mean_dice``; with ``results_folder``
        also dice_scores.npy (samples × classes) and dice_scores.txt."""
        n = min(len(dataset), limit) if limit else len(dataset)
        was_training = self.model.training
        self.model.eval()
        all_dice: List[np.ndarray] = []
        try:
            for (dev,) in _one_deep_map(dataset, n, self.batch_size,
                                        self._dispatch,
                                        num_workers=num_workers,
                                        pool=self.feed.pool,
                                        group=self.group):
                all_dice.extend(dev.cpu().numpy())
        finally:
            self.model.train(was_training)
        dice = np.nanmean(np.stack(all_dice), axis=0)
        res = {f"dice_class_{i}": float(v) for i, v in enumerate(dice)}
        res["mean_dice"] = float(np.nanmean(dice))
        if results_folder and multihost.is_main_process():
            os.makedirs(results_folder, exist_ok=True)
            np.save(os.path.join(results_folder, "dice_scores.npy"),
                    np.stack(all_dice))
            with open(os.path.join(results_folder, "dice_scores.txt"),
                      "w") as f:
                for key, v in res.items():
                    f.write(f"{key}: {v}\n")
        return res


class _AmaxExchange:
    """The k amaxes of the parts of one batch, one thread per device: each
    block's reducer waits for every part's amax and returns their max on
    its own device.  A part that fails breaks the barrier, so the others
    raise rather than wait."""

    def __init__(self, n: int):
        self.barrier = threading.Barrier(n)
        self.slots: List[Optional[torch.Tensor]] = [None] * n

    def reducer(self, i: int):
        def reduce(amax: torch.Tensor) -> torch.Tensor:
            self.slots[i] = amax
            self.barrier.wait()
            out = torch.stack([a.to(amax.device) for a in self.slots]).amax()
            self.barrier.wait()   # every part has read the slots
            return out

        return reduce


class SplitClassifier:
    """One model on several devices (``serve --mesh``): ``engines`` are
    ``ZeroShotClassifier``s over copies of the same weights, one per
    device, each with its own copier and pool.  ``predict_batch`` splits
    the batch into contiguous parts, as even as they go (a part per device
    while there are volumes for it), runs them at once, one thread per
    device, with one int8 k scale over the whole batch (``_AmaxExchange``),
    and joins the answers in order: those of one engine on the whole
    batch.  The prompt latents are made once, on the first device."""

    def __init__(self, engines: Sequence[ZeroShotClassifier]):
        self.engines = list(engines)
        first = self.engines[0]
        self.model, self.device = first.model, first.device
        self.pathologies = first.pathologies

    def prepare(self) -> torch.Tensor:
        text = self.engines[0].prepare()
        for e in self.engines[1:]:
            e._cached_text = text.to(e.device)
        return text

    def predict_batch(self, volumes) -> np.ndarray:
        parts = [p for p in np.array_split(np.arange(len(volumes)),
                                           len(self.engines)) if len(p)]
        if len(parts) == 1:
            return self.engines[0].predict_batch(volumes)
        exchange = _AmaxExchange(len(parts))
        outs: List[Optional[np.ndarray]] = [None] * len(parts)
        errors: List[BaseException] = []

        def run(i: int, engine: ZeroShotClassifier, rows) -> None:
            try:
                with contextlib.ExitStack() as stack:
                    if engine.device.type == "cuda":
                        stack.enter_context(torch.cuda.device(engine.device))
                    engine.k_amax_reduce = exchange.reducer(i)
                    try:
                        outs[i] = engine.predict_batch(
                            volumes[rows[0]:rows[-1] + 1])
                    finally:
                        engine.k_amax_reduce = None
            except BaseException as e:  # noqa: BLE001 -- re-raised below
                errors.append(e)
                exchange.barrier.abort()

        threads = [threading.Thread(target=run, args=(i, e, p))
                   for i, (e, p) in enumerate(zip(self.engines, parts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return np.concatenate(outs)
