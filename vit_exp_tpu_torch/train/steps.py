"""Train steps per data type (counterpart of vit_exp_tpu/train/steps.py).

The image-report step: the contrastive forward (``CTCLIP.forward``), the
InfoNCE loss over the batch, times the data set's loss weight, backward
through the kernels' autograd Functions, then one micro-step of the
optimizer (clip + Adam, on every k-th micro-step under gradient
accumulation, as optax.MultiSteps does in the JAX package).  The MLM and
visual-SSL terms of that step, and the segmentation and open-vocabulary
steps, wait for a later slice.

``config`` is duck-typed: anything with a ``ct_clip_arch`` holding
``decoupled_contrastive_learning``, ``use_mlm`` and ``use_visual_ssl`` (the
JAX package's ``ExperimentConfig``); missing fields take the JAX defaults.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from vit_exp_tpu_torch.models.losses import infonce_loss


def make_train_steps(model, optimizer, config) -> Dict[str, Callable]:
    """Returns {data_type: step}.  step(batch, loss_weight) takes a dict
    with "image" (B, 1, T, H, W), "input_ids" (B, L) and optionally
    "attention_mask", updates the model's parameters in place and returns
    the metrics {"cl_loss", "loss"} as 0-dim tensors (no host read)."""
    ca = getattr(config, "ct_clip_arch", None)
    decoupled = bool(getattr(ca, "decoupled_contrastive_learning", False))
    if getattr(ca, "use_mlm", False) or getattr(ca, "use_visual_ssl", False):
        raise NotImplementedError(
            "the MLM and visual-SSL terms of the image-report step are not "
            "ported yet")

    def imagereport(batch, loss_weight: float = 1.0):
        out = model(batch["image"], batch["input_ids"],
                    batch.get("attention_mask"))
        b = out["text_latents"].shape[0]
        cl_loss = infonce_loss(out["text_latents"], out["image_latents"],
                               out["temperature"], local_batch_size=b,
                               decoupled=decoupled)
        loss = cl_loss * loss_weight
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        return {"cl_loss": cl_loss.detach(), "loss": loss.detach()}

    def not_ported(batch, loss_weight: float = 1.0):
        raise NotImplementedError(
            "the segmentation and open-vocabulary steps are not ported yet")

    return {"imagereport": imagereport, "imageseg": not_ported,
            "imageopenseg": not_ported}
