"""Latent dumps and cross-modal retrieval (counterpart of
vit_exp_tpu/eval/latents.py):

- ``dump_latents``: every sample encoded once, its image and report
  latents saved as latents.npz with accessions.txt;
- ``dump_encodings``: the image tower's tokens of every sample, one npz
  per accession;
- ``volume_to_volume``: the top-k volumes of each volume by image-latent
  cosine (itself left out), with a label-overlap score when labels are
  given; ``report_to_volume`` and ``volume_to_report``: cross-modal top-k
  by text-image cosine, with recall@k;
- ``tsne_plot``: a 2-D t-SNE scatter of latents (sklearn and matplotlib
  are imported when it is called; the card's host has neither).

The encoders run on a ``ZeroShotClassifier``'s model in eval mode under
``torch.inference_mode``, in batches of its ``batch_size``: the engine's
loader and side-stream copy bring batch i + 1 while batch i computes, and
batch i is read one batch late.  The tail batch runs as it is (the JAX
package pads it by repeating its last item; with int8 a volume's latents
depend on its batch companions, so the port's tail latents are those of
the short batch).  An engine with a process group encodes each rank's
rows of the global batch and gathers them (eval/zero_shot.py); every
rank gets every latent, and rank 0 alone writes.  The int8 k scale is the
whole global batch's, as in the engines (eval/zero_shot.py).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from vit_exp_tpu_torch.core import multihost
from vit_exp_tpu_torch.eval.zero_shot import _one_deep_map, shared_k_scale
from vit_exp_tpu_torch.parallel.collectives import rank, world


def _encode_batches(engine, dataset, limit, num_workers, encode):
    """``encode(batch, first)`` on the engine's model, in eval mode under
    inference mode, over the first ``limit`` items in batches; yields each
    payload (device tensors, then the accessions) one batch late, the
    global batch's under the engine's group.  ``first`` is the index of the
    batch's first item."""
    n = min(len(dataset), limit) if limit else len(dataset)
    model = engine.model
    group = getattr(engine, "group", None)
    was_training = model.training
    model.eval()
    step = engine.batch_size * world(group)
    seen = [rank(group) * engine.batch_size]

    @torch.inference_mode()
    def dispatch(batch):
        first, seen[0] = seen[0], seen[0] + step
        with shared_k_scale(model, getattr(engine, "k_amax_reduce", None)):
            return encode(batch, first)

    try:
        yield from _one_deep_map(dataset, n, engine.batch_size, dispatch,
                                 num_workers=num_workers,
                                 pool=engine.feed.pool, group=group)
    finally:
        model.train(was_training)


def _accessions(batch, first: int, k: int) -> List[str]:
    return list(batch.get("accession",
                          [f"sample_{first + j}" for j in range(k)]))


def dump_latents(engine, dataset, out_folder: str, *,
                 limit: Optional[int] = None,
                 num_workers: int = 4) -> Dict[str, np.ndarray]:
    """Encode every sample's volume and report once; save latents.npz
    (image_latents, text_latents) and accessions.txt into ``out_folder``.
    ``engine``: a ``ZeroShotClassifier`` (its model, tokenizer,
    max_text_len, batch size and copier).  Returns the latents and
    "accessions"."""
    main = multihost.is_main_process()
    if main:
        os.makedirs(out_folder, exist_ok=True)
    model, device = engine.model, engine.device

    def encode(batch, first):
        k = len(batch["image"])
        video = engine.feed.to_device(batch)["image"]
        img = model.image_latents_from_tokens(
            model.encode_image_tokens(video))
        toks = engine.tokenizer(list(batch["text"]),
                                max_length=engine.max_text_len)
        ids = torch.as_tensor(np.asarray(toks["input_ids"]), device=device)
        mask = torch.as_tensor(np.asarray(toks["attention_mask"]),
                               device=device)
        txt = model.text_latents_from_hidden(
            model.encode_text_hidden(ids, mask))
        return img, txt, _accessions(batch, first, k)

    image_latents, text_latents, accessions = [], [], []
    for img, txt, accs in _encode_batches(engine, dataset, limit,
                                          num_workers, encode):
        image_latents.extend(img.float().cpu().numpy())
        text_latents.extend(txt.float().cpu().numpy())
        accessions.extend(accs)
    out = {"image_latents": np.stack(image_latents),
           "text_latents": np.stack(text_latents)}
    if main:
        np.savez(os.path.join(out_folder, "latents.npz"), **out)
        with open(os.path.join(out_folder, "accessions.txt"), "w") as f:
            f.writelines(a + "\n" for a in accessions)
    out["accessions"] = accessions
    return out


def dump_encodings(engine, dataset, out_folder: str, *, limit=None,
                   num_workers: int = 4) -> List[str]:
    """The image tower's output tokens of every sample as float32, one
    ``{accession}.encodings.npz`` each ('/' in an accession becomes '_');
    returns the paths in sample order."""
    main = multihost.is_main_process()
    if main:
        os.makedirs(out_folder, exist_ok=True)
    model = engine.model

    def encode(batch, first):
        video = engine.feed.to_device(batch)["image"]
        return (model.encode_image_tokens(video),
                _accessions(batch, first, len(batch["image"])))

    paths = []
    for tokens, accs in _encode_batches(engine, dataset, limit, num_workers,
                                        encode):
        for row, acc in zip(tokens.float().cpu().numpy(), accs):
            path = os.path.join(out_folder,
                                f"{acc.replace('/', '_')}.encodings.npz")
            if main:
                np.savez(path, row)
            paths.append(path)
    return paths


def _topk_cosine(queries: np.ndarray, keys: np.ndarray, k: int):
    qn = queries / np.linalg.norm(queries, axis=-1, keepdims=True)
    kn = keys / np.linalg.norm(keys, axis=-1, keepdims=True)
    sim = qn @ kn.T
    return (np.argsort(-sim, axis=-1)[:, :k],
            np.sort(sim, axis=-1)[:, ::-1][:, :k])


def volume_to_volume(image_latents: np.ndarray, k: int = 5,
                     labels: Optional[np.ndarray] = None
                     ) -> Dict[str, np.ndarray]:
    """The top-k nearest volumes of each volume, itself left out (the
    first match); with ``labels``, the label overlap (intersection over
    union) of each retrieved volume with its query."""
    idx, sim = _topk_cosine(image_latents, image_latents, k + 1)
    idx, sim = idx[:, 1:], sim[:, 1:]
    out = {"indices": idx, "similarities": sim}
    if labels is not None:
        inter = (labels[:, None, :] * labels[idx]).sum(-1)
        union = np.maximum(
            np.maximum(labels[:, None, :], labels[idx]).sum(-1), 1e-9)
        out["label_overlap"] = inter / union
    return out


def report_to_volume(text_latents: np.ndarray, image_latents: np.ndarray,
                     k: int = 5) -> Dict[str, np.ndarray]:
    """The top-k volumes of each report, and recall@k: the share of
    reports whose own volume is among them."""
    idx, sim = _topk_cosine(text_latents, image_latents, k)
    recall_at_k = float(np.mean([i in idx[i]
                                 for i in range(len(text_latents))]))
    return {"indices": idx, "similarities": sim, "recall_at_k": recall_at_k}


def volume_to_report(image_latents: np.ndarray, text_latents: np.ndarray,
                     k: int = 5) -> Dict[str, np.ndarray]:
    return report_to_volume(image_latents, text_latents, k)


def tsne_plot(latents: np.ndarray, out_path: str, labels=None,
              perplexity: float = 5.0):
    """A 2-D t-SNE scatter of ``latents`` saved to ``out_path`` (coloured
    by ``labels``, or their argmax when one-hot); returns the embedding.
    Needs sklearn and matplotlib."""
    from sklearn.manifold import TSNE

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    emb = TSNE(n_components=2,
               perplexity=min(perplexity, max(len(latents) - 2, 1)),
               init="pca", random_state=0).fit_transform(
                   np.asarray(latents, np.float64))
    fig, ax = plt.subplots(figsize=(6, 6))
    color = None
    if labels is not None:
        labels = np.asarray(labels)
        color = labels if labels.ndim == 1 else labels.argmax(-1)
    sc = ax.scatter(emb[:, 0], emb[:, 1], c=color, s=14, cmap="tab10")
    if color is not None:
        fig.colorbar(sc, ax=ax)
    ax.set_title("latent t-SNE")
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return emb
