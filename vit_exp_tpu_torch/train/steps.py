"""Train steps per data type (counterpart of vit_exp_tpu/train/steps.py).

Each step runs its forward, its loss times the data set's loss weight,
the backward through the kernels' autograd Functions, then one micro-step
of the optimizer (clip + Adam, on every k-th micro-step under gradient
accumulation, as optax.MultiSteps does in the JAX package):

- imagereport: the contrastive forward (``CTCLIP.forward``) and the InfoNCE
  loss over the batch; with ``use_mlm`` and/or ``use_visual_ssl`` the
  self-supervision terms join it as ``cl_w · cl + text_w · mlm + image_w ·
  ssl``, cl_w = 1 − (text_w + image_w) (the reference's combine):
  the MLM term is the cross-entropy of ``mlm_logits`` on the corrupted ids
  at the selected positions (models/mlm.py); the visual term runs two
  augmented views of the volumes (models/visual_ssl.py), each through the
  whole image tower (the kernels, forward and backward) and the
  projector, into SimSiam's or SimCLR's loss as ``visual_ssl_type`` says
  (ValueError on another type, when the steps are made);
- imageseg: ``seg_forward``'s voxel logits against "seg_mask" (B, C, D, W,
  H), ``seg_bce_loss``;
- imageopenseg: ``open_seg_forward`` on "image", "prompt_ids" and
  "prompt_mask"; the mask downsampled by ``open_seg_loss_down_factor``
  and flattened to (B, L, C); ``open_seg_loss`` of the config's type, the
  fusion head applied where the config has one.

The self-supervision draws of a micro-step are a function of the config's
``random_seed`` and the micro-step's index alone (``step_draws``, from a
host generator seeded with both), as JAX folds the step into its key: the
index is the optimizer's ``count`` (its micro-steps so far, saved with it),
so a resumed run draws the masks and views an unbroken one does.  A caller
may pass the draws themselves (``draws=``: the CPU tests hand in JAX's,
chip_smoke.py fixes step 0's for the kernel and plain paths).  ``config``
is duck-typed: anything with a ``ct_clip_arch`` holding the fields these
read (the JAX package's ``ExperimentConfig``); missing fields take the JAX
defaults.

``group`` (data parallelism, the JAX ``n_data_shards``): each rank steps
on its own rows of the global batch and every term is taken over the
global batch as JAX takes it, by the gradient rule of
parallel/collectives.py.  InfoNCE runs over the text and image latents
gathered from every rank, divided by the local batch (JAX's "local batch
size"); SimCLR's NT-Xent over the gathered z1 and z2; the MLM mean and
the Tversky arm over sums taken over the group; the per-sample means (the
BCE, SimSiam, the other open-seg arms) locally.  The draws are those of
the global batch (the global shape, from (seed, step)), of which each rank
takes its rows, so the ranks of a step draw what one process draws at the
global batch; ``draws=`` are likewise the global batch's.  The optimizer
averages the gradients over the group, and the metrics come back
averaged over it, the global values that every rank then holds.

``sharding`` (a parallel/sharding.py ``Sharded``, on a grid with fsdp or
model > 1): ``group`` is then the grid's batch group, and each step runs
inside ``sharding.gathered()``, which gathers the parameters outside the
sharded units for its length; the model's tensor-parallel modules and
units do the rest themselves.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from vit_exp_tpu_torch.models.ctclip import downsample_stride
from vit_exp_tpu_torch.models.losses import (infonce_loss, open_seg_loss,
                                             seg_bce_loss)
from vit_exp_tpu_torch.models.mlm import draw_mlm, mlm_corrupt, mlm_loss
from vit_exp_tpu_torch.models.visual_ssl import (draw_augment, nt_xent_loss,
                                                 random_augment_3d,
                                                 simsiam_loss)
from vit_exp_tpu_torch.parallel.collectives import (all_gather,
                                                    mean_over_ranks, rank,
                                                    world)

SSL_TYPES = ("simsiam", "simclr")


def step_generator(seed: int, step: int) -> torch.Generator:
    """A host generator seeded with (seed, step) alone."""
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(2)
    return torch.Generator().manual_seed(int(state[0]) << 32 | int(state[1]))


def step_draws(seed: int, step: int, ids_shape, vocab_size: int, *,
               mlm: bool, ssl: bool) -> Dict:
    """The micro-step's draws: "mlm" (MLMDraws for ids of ids_shape),
    "views" (two AugmentDraws of ids_shape[0] volumes), as enabled."""
    g = step_generator(seed, step)
    out = {}
    if mlm:
        out["mlm"] = draw_mlm(tuple(ids_shape), vocab_size, g)
    if ssl:
        out["views"] = tuple(draw_augment(ids_shape[0], g) for _ in range(2))
    return out


def local_rows(draws: Dict, rows: slice) -> Dict:
    """The draws of a batch's ``rows`` (a slice of the global batch)."""
    out = dict(draws)
    if "mlm" in out:
        out["mlm"] = type(out["mlm"])(*(t[rows] for t in out["mlm"]))
    if "views" in out:
        out["views"] = tuple(type(v)(*(t[rows] for t in v))
                             for v in out["views"])
    return out


def make_train_steps(model, optimizer, config, group=None,
                     sharding=None) -> Dict[str, Callable]:
    """Returns {data_type: step}.  step(batch, loss_weight, *, draws=None)
    takes a dict of device tensors ("image" (B, 1, T, H, W)
    and, by type, "input_ids" (B, L) and "attention_mask", or "seg_mask",
    or "seg_mask", "prompt_ids" (C, L) and "prompt_mask"), updates the
    model's parameters in place and returns its metrics ({"cl_loss"} and,
    where on, "text_ssl_loss" and "image_ssl_loss"; {"seg_loss"} or
    {"open_seg_loss"}; and "loss", the weighted total) as 0-dim tensors
    (no host read).  ``group``: the data-parallel group (the module
    docstring); the optimizer must average over the same one."""
    ca = getattr(config, "ct_clip_arch", None)
    decoupled = bool(getattr(ca, "decoupled_contrastive_learning", False))
    use_mlm = bool(getattr(ca, "use_mlm", False))
    use_ssl = bool(getattr(ca, "use_visual_ssl", False))
    ssl_type = getattr(ca, "visual_ssl_type", "simsiam")
    if use_ssl and ssl_type not in SSL_TYPES:
        raise ValueError(f"unknown visual_ssl_type {ssl_type!r}")
    text_w = (float(getattr(ca, "text_ssl_loss_weight", 0.05))
              if use_mlm else 0.0)
    image_w = (float(getattr(ca, "image_ssl_loss_weight", 0.05))
               if use_ssl else 0.0)
    cl_w = 1.0 - (text_w + image_w)
    seed = int(getattr(config, "random_seed", 0))

    def update(metrics, total, loss_weight):
        loss = total * loss_weight
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        out = {k: v.detach() for k, v in metrics.items()}
        out["loss"] = loss.detach()
        return mean_over_ranks(out, group)

    def ssl_terms(batch, draws):
        """{name: (weight, loss)} of the enabled self-supervision terms."""
        ids = batch["input_ids"]
        b = ids.shape[0]
        if draws is None:
            draws = step_draws(seed, getattr(optimizer, "count", 0),
                               (b * world(group), *ids.shape[1:]),
                               model.text_transformer.config.vocab_size,
                               mlm=use_mlm, ssl=use_ssl)
        if group is not None:
            draws = local_rows(draws, slice(rank(group) * b,
                                            (rank(group) + 1) * b))
        terms = {}
        if use_mlm:
            d = draws["mlm"]
            d = type(d)(*(t.to(ids.device) for t in d))
            corrupted, loss_mask = mlm_corrupt(
                ids, d, mask_token_id=int(getattr(ca, "mlm_mask_token_id",
                                                  103)),
                mask_prob=float(getattr(ca, "mlm_mask_prob", 0.15)))
            logits = model.mlm_logits(corrupted, batch.get("attention_mask"))
            terms["text_ssl_loss"] = (text_w, mlm_loss(logits, ids,
                                                       loss_mask, group))
        if use_ssl:
            z1, z2 = (model.ssl_project(random_augment_3d(batch["image"], d))
                      for d in draws["views"])
            if ssl_type == "simsiam":
                loss = simsiam_loss(model.ssl_predict(z1), z1,
                                    model.ssl_predict(z2), z2)
            else:
                loss = nt_xent_loss(all_gather(z1, group),
                                    all_gather(z2, group))
            terms["image_ssl_loss"] = (image_w, loss)
        return terms

    def imagereport(batch, loss_weight: float = 1.0, *,
                    draws: Optional[Dict] = None):
        out = model(batch["image"], batch["input_ids"],
                    batch.get("attention_mask"))
        b = out["text_latents"].shape[0]
        cl_loss = infonce_loss(all_gather(out["text_latents"], group),
                               all_gather(out["image_latents"], group),
                               out["temperature"], local_batch_size=b,
                               decoupled=decoupled)
        metrics = {"cl_loss": cl_loss}
        if text_w == 0.0 and image_w == 0.0:
            return update(metrics, cl_loss, loss_weight)
        total = cl_w * cl_loss
        for name, (w, loss) in ssl_terms(batch, draws).items():
            metrics[name] = loss
            total = total + w * loss
        return update(metrics, total, loss_weight)

    def imageseg(batch, loss_weight: float = 1.0):
        logits = model.seg_forward(batch["image"])
        loss = seg_bce_loss(logits, batch["seg_mask"])
        return update({"seg_loss": loss}, loss, loss_weight)

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
                               if ca.fusion_head is not None else None),
            group=group)
        return update({"open_seg_loss": loss}, loss, loss_weight)

    steps = {"imagereport": imagereport, "imageseg": imageseg,
             "imageopenseg": imageopenseg}
    if sharding is None:
        return steps

    def gathered(step):
        def run(*args, **kwargs):
            with sharding.gathered():
                return step(*args, **kwargs)
        return run

    return {k: gathered(v) for k, v in steps.items()}
