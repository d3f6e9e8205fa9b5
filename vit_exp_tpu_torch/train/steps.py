"""Train steps per data type (counterpart of vit_exp_tpu/train/steps.py).

Each step runs its forward, its loss times the data set's loss weight,
the backward through the kernels' autograd Functions, then one micro-step
of the optimizer (clip + Adam, on every k-th micro-step under gradient
accumulation, as optax.MultiSteps does in the JAX package):

- imagereport: the contrastive forward (``CTCLIP.forward``) and the InfoNCE
  loss over the batch;
- imageseg: ``seg_forward``'s voxel logits against "seg_mask" (B, C, D, W,
  H), ``seg_bce_loss``;
- imageopenseg: ``open_seg_forward`` on "image", "prompt_ids" and
  "prompt_mask"; the mask downsampled by ``open_seg_loss_down_factor``
  and flattened to (B, L, C); ``open_seg_loss`` of the config's type, the
  fusion head applied where the config has one.

The MLM and visual-SSL terms of the image-report step wait for a later
slice.  ``config`` is duck-typed: anything with a ``ct_clip_arch`` holding
the fields these read (the JAX package's ``ExperimentConfig``); missing
fields take the JAX defaults.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from vit_exp_tpu_torch.models.ctclip import downsample_stride
from vit_exp_tpu_torch.models.losses import (infonce_loss, open_seg_loss,
                                             seg_bce_loss)


def make_train_steps(model, optimizer, config) -> Dict[str, Callable]:
    """Returns {data_type: step}.  step(batch, loss_weight) takes a dict of
    device tensors ("image" (B, 1, T, H, W) and, by type, "input_ids" (B, L)
    and "attention_mask", or "seg_mask", or "seg_mask", "prompt_ids" (C, L)
    and "prompt_mask"), updates the model's parameters in place and returns
    its metrics ({"cl_loss"}, {"seg_loss"} or {"open_seg_loss"}, and
    "loss", the weighted one) as 0-dim tensors (no host read)."""
    ca = getattr(config, "ct_clip_arch", None)
    decoupled = bool(getattr(ca, "decoupled_contrastive_learning", False))
    if getattr(ca, "use_mlm", False) or getattr(ca, "use_visual_ssl", False):
        raise NotImplementedError(
            "the MLM and visual-SSL terms of the image-report step are not "
            "ported yet")

    def update(name, value, loss_weight):
        loss = value * loss_weight
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        return {name: value.detach(), "loss": loss.detach()}

    def imagereport(batch, loss_weight: float = 1.0):
        out = model(batch["image"], batch["input_ids"],
                    batch.get("attention_mask"))
        b = out["text_latents"].shape[0]
        cl_loss = infonce_loss(out["text_latents"], out["image_latents"],
                               out["temperature"], local_batch_size=b,
                               decoupled=decoupled)
        return update("cl_loss", cl_loss, loss_weight)

    def imageseg(batch, loss_weight: float = 1.0):
        logits = model.seg_forward(batch["image"])
        return update("seg_loss", seg_bce_loss(logits, batch["seg_mask"]),
                      loss_weight)

    def imageopenseg(batch, loss_weight: float = 1.0):
        out = model.open_seg_forward(batch["image"], batch["prompt_ids"],
                                     batch.get("prompt_mask"))
        mask = downsample_stride(batch["seg_mask"],
                                 ca.open_seg_loss_down_factor)
        b, c = mask.shape[:2]
        loss = open_seg_loss(
            out["seg_preds"], mask.permute(0, 2, 3, 4, 1).reshape(b, -1, c),
            out["prompt_logits"], loss_type=ca.open_seg_loss_type,
            hyper=ca.open_seg_loss_hyper_config,
            fusion_head_apply=(model.apply_fusion_head
                               if ca.fusion_head is not None else None))
        return update("open_seg_loss", loss, loss_weight)

    return {"imagereport": imagereport, "imageseg": imageseg,
            "imageopenseg": imageopenseg}
