"""Loss functions of the CT-CLIP stack (counterpart of
vit_exp_tpu/models/losses.py), all in fp32 as the JAX package casts.

- ``infonce_loss``: the symmetric InfoNCE of the reference's image-report
  step, in log-sum-exp form, including its scale quirk: the mean over the
  batch is divided again by the local (per-device) batch size.
- ``seg_bce_loss`` and ``dice_scores``: the closed-set segmentation path
  (voxel logits (B, C, D, W, H) against a 0/1 mask).
- ``open_seg_loss``: the open-vocabulary family of seven loss types
  (cos_sim_l2, clip_loss, clip_bce_loss, weighted_bce_loss,
  clip_focal_loss, tversky_loss, fusion_focal_loss) over per-voxel
  embeddings (B, L, h) and per-class prompt embeddings (B, C, h).

torch semantics as the reference has them: cosine similarity clamps each
norm at 1e-8, BCE on probabilities clamps its log terms at -100.

``group`` (a data-parallel process group, parallel/collectives.py): the
terms that sum over the batch before they divide take their sums over the
global batch (Tversky's tp, fp and fn, differentiably; the weighted BCE's
class counts, which carry no gradient); the means over samples stay
local, and the gradient average over the group makes them global.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from vit_exp_tpu_torch.parallel.collectives import all_reduce_sum


def infonce_loss(text_latents: torch.Tensor, image_latents: torch.Tensor,
                 temperature: torch.Tensor, *,
                 local_batch_size: Optional[int] = None,
                 decoupled: bool = False) -> torch.Tensor:
    """Symmetric InfoNCE over the whole batch's latents.

    text_latents, image_latents: (B, d), l2-normalised.  temperature: a
    scalar used as exp(temperature).  local_batch_size: the divisor of the
    reference's quirk, B by default.  decoupled: the positive pair is masked
    out of each denominator."""
    b = text_latents.shape[0]
    local_batch_size = local_batch_size or b
    t2i = (text_latents.float() @ image_latents.float().t()
           * temperature.float().exp())
    eye = torch.eye(b, dtype=torch.bool, device=t2i.device)

    def one_side(logits):
        masked = logits.masked_fill(eye, float("-inf")) if decoupled else logits
        return (torch.logsumexp(masked, dim=-1) - logits.diagonal()).mean()

    return (one_side(t2i) + one_side(t2i.t())) / 2.0 / local_batch_size


# --- elementwise pieces --------------------------------------------------------

_BCE_LOG_CLAMP = -100.0


def bce_probs(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Elementwise BCE on probabilities, each log clamped at -100."""
    logp = torch.log(p).clamp_min(_BCE_LOG_CLAMP)
    log1mp = torch.log1p(-p).clamp_min(_BCE_LOG_CLAMP)
    return -(t * logp + (1.0 - t) * log1mp)


def cosine_similarity(a: torch.Tensor, b: torch.Tensor,
                      eps: float = 1e-8) -> torch.Tensor:
    """torch's cosine_similarity over the last axis, broadcasting, each
    operand's norm clamped at eps; fp32."""
    a32, b32 = a.float(), b.float()
    na = torch.linalg.vector_norm(a32, dim=-1).clamp_min(eps)
    nb = torch.linalg.vector_norm(b32, dim=-1).clamp_min(eps)
    return (a32 * b32).sum(dim=-1) / (na * nb)


# --- closed-set segmentation -----------------------------------------------------


def seg_bce_loss(seg_logits: torch.Tensor,
                 seg_mask: torch.Tensor) -> torch.Tensor:
    """Mean BCE-with-logits over (B, C, D, W, H) voxel logits, in fp32.
    torch's fused op keeps only its input and target for the backward (at
    full width with 22 classes each is 4.9 GB in fp32)."""
    x = seg_logits.float()
    return F.binary_cross_entropy_with_logits(x, seg_mask.to(x.dtype))


def dice_scores_per_sample(seg_logits: torch.Tensor,
                           seg_mask: torch.Tensor) -> torch.Tensor:
    """(B, C) dice at the sigmoid threshold 0.5 against a 0/1 mask:
    2·|P∩G| / (|P| + |G|), NaN where a class is absent from both.  One class
    at a time (the temporaries are a class's size, as booleans); the voxel
    counts are integers, so they stay exact past fp32's 2^24, and the ratio
    is taken in fp32."""
    dims = tuple(range(1, seg_logits.dim() - 1))
    out = []
    for c in range(seg_logits.shape[1]):
        pred = torch.sigmoid(seg_logits[:, c].float()) > 0.5
        gt = seg_mask[:, c] != 0
        inter = (pred & gt).sum(dim=dims)
        union = pred.sum(dim=dims) + gt.sum(dim=dims)
        out.append(2.0 * inter.float() / union.float())
    return torch.stack(out, dim=1)


def dice_scores(seg_logits: torch.Tensor,
                seg_mask: torch.Tensor) -> torch.Tensor:
    """Per-class dice, nanmean over the batch: (C,).  A class absent from
    both prediction and mask in one sample must not poison the average."""
    return torch.nanmean(dice_scores_per_sample(seg_logits, seg_mask), dim=0)


# --- open-vocabulary segmentation --------------------------------------------------


def _sim01(seg_preds: torch.Tensor, prompt_logits: torch.Tensor):
    """(cos(voxel embedding, class prompt) + 1) / 2 → (B, L, C), the cosine
    taken as one product over h (no (B, L, C, h) temporary)."""
    a, b = seg_preds.float(), prompt_logits.float()
    dot = torch.einsum("blh,bch->blc", a, b)
    na = torch.linalg.vector_norm(a, dim=-1).clamp_min(1e-8)
    nb = torch.linalg.vector_norm(b, dim=-1).clamp_min(1e-8)
    return (dot / (na[:, :, None] * nb[:, None, :]) + 1.0) / 2.0


def _focal(p, t, gamma, alpha):
    loss = bce_probs(p, t) * (1.0 - (p * t + (1 - p) * (1 - t))) ** gamma
    if alpha >= 0:
        loss = (alpha * t + (1 - alpha) * (1 - t)) * loss
    return loss


def tversky_loss(p: torch.Tensor, t: torch.Tensor, alpha: float, beta: float,
                 smooth: float, gamma: float, group=None) -> torch.Tensor:
    """Binary Tversky over all elements (SMP's TverskyLoss on
    probabilities), focal form (1 − TI)^gamma; tp, fp and fn summed over
    the group's global batch."""
    p32, t32 = p.float(), t.float()
    tp, fp, fn = all_reduce_sum(torch.stack([
        (p32 * t32).sum(), (p32 * (1.0 - t32)).sum(),
        ((1.0 - p32) * t32).sum()]), group)
    ti = (tp + smooth) / (tp + alpha * fp + beta * fn + smooth)
    return (1.0 - ti) ** gamma


def choose_cls(seg_mask_flatten: torch.Tensor, prompt_logits: torch.Tensor,
               classes: Sequence[int]):
    """The classes a loss is restricted to (the ``choose_cls`` hyper
    option): mask (B, L, C) and prompts (B, C, h) → (B, L, K), (B, K, h).
    An index past C raises (JAX's gather would clamp it to the last
    class)."""
    n = seg_mask_flatten.shape[-1]
    idx = [int(c) for c in classes]
    if any(not 0 <= c < n for c in idx):
        raise ValueError(f"choose_cls {idx} indexes past the {n} classes")
    idx = torch.tensor(idx, device=seg_mask_flatten.device)
    return seg_mask_flatten[:, :, idx], prompt_logits[:, idx, :]


def open_seg_loss(seg_preds: torch.Tensor, seg_mask_flatten: torch.Tensor,
                  prompt_logits: torch.Tensor, *, loss_type: str,
                  hyper: Optional[Dict[str, Any]] = None,
                  fusion_head_apply: Optional[
                      Callable[[torch.Tensor], torch.Tensor]] = None,
                  return_class_loss: bool = False, group=None):
    """seg_preds (B, L, h), seg_mask_flatten (B, L, C), prompt_logits
    (B, C, h) → the scalar loss, or (loss, per-class loss or None) with
    ``return_class_loss``.  ``group``: the global-batch sums of the
    weighted BCE and Tversky arms (the module docstring)."""
    hyper = hyper or {}
    if hyper.get("choose_cls") is not None:
        seg_mask_flatten, prompt_logits = choose_cls(
            seg_mask_flatten, prompt_logits, hyper["choose_cls"])
    t = seg_mask_flatten.float()
    B, L, C = t.shape
    class_loss = None

    if loss_type == "cos_sim_l2":
        per_class = ((_sim01(seg_preds, prompt_logits) - t) ** 2).mean(
            dim=(0, 1))
        loss = per_class.sum()   # the reference sums the per-class MSEs
        class_loss = per_class if return_class_loss else None
    elif loss_type == "clip_loss":
        logits = torch.einsum("bld,bcd->blc", seg_preds.float(),
                              prompt_logits.float()) / hyper.get("temp", 0.1)
        logp = torch.log_softmax(logits.reshape(-1, C), dim=-1)
        loss = (-t.reshape(-1, C) * logp).sum(dim=-1).mean()
    elif loss_type == "clip_bce_loss":
        sim = _sim01(seg_preds, prompt_logits)
        loss = bce_probs(sim.reshape(-1, C), t.reshape(-1, C)).mean()
    elif loss_type == "weighted_bce_loss":
        sim = _sim01(seg_preds, prompt_logits).reshape(-1, C)
        tf = t.reshape(-1, C)
        pos, neg = (tf == 1).float(), (tf == 0).float()
        counts = all_reduce_sum(torch.stack([pos.sum(dim=0),
                                             neg.sum(dim=0)]), group)
        n_pos, n_neg = counts[0] + 1e-6, counts[1] + 1e-6
        n_total = n_pos + n_neg
        weights = (n_total / (2 * n_pos)) * pos + (n_total / (2 * n_neg)) * neg
        per_elem = bce_probs(sim, tf) * weights
        loss = per_elem.mean()
        class_loss = per_elem.mean(dim=0) if return_class_loss else None
    elif loss_type == "clip_focal_loss":
        sim = _sim01(seg_preds, prompt_logits).reshape(-1, C)
        per_elem = _focal(sim, t.reshape(-1, C), hyper.get("gamma", 2),
                          hyper.get("alpha", 0.25))
        loss = per_elem.mean()
        class_loss = per_elem.mean(dim=0) if return_class_loss else None
    elif loss_type == "tversky_loss":
        alpha, beta = hyper.get("alpha", 0.3), hyper.get("beta", 0.7)
        gamma = hyper.get("gamma", 1.0)
        smooth = float(hyper.get("smooth", 1e-6))
        p = _sim01(seg_preds, prompt_logits).transpose(1, 2)   # (B, C, L)
        tt = t.transpose(1, 2)
        if return_class_loss:
            class_loss = torch.stack([
                tversky_loss(p[:, c], tt[:, c], alpha, beta, smooth, gamma,
                             group) for c in range(C)])
            loss = class_loss.sum() / C
        else:
            loss = tversky_loss(p, tt, alpha, beta, smooth, gamma, group)
    elif loss_type == "fusion_focal_loss":
        if fusion_head_apply is None:
            raise ValueError("fusion_focal_loss needs the fusion head")
        h_pred, h_prompt = seg_preds.shape[-1], prompt_logits.shape[-1]
        dtype = torch.promote_types(seg_preds.dtype, prompt_logits.dtype)
        concat = torch.cat([
            seg_preds.to(dtype)[:, :, None, :].expand(B, L, C, h_pred),
            prompt_logits.to(dtype)[:, None, :, :].expand(B, L, C, h_prompt),
        ], dim=-1).reshape(-1, h_pred + h_prompt)
        p = torch.sigmoid(fusion_head_apply(concat).float()).reshape(-1, C)
        per_elem = _focal(p, t.reshape(-1, C), hyper.get("gamma", 2),
                          hyper.get("alpha", 0.25))
        loss = per_elem.mean()
        class_loss = per_elem.mean(dim=0) if return_class_loss else None
    else:
        raise ValueError(f"unsupported open seg loss type: {loss_type}")

    if return_class_loss:
        return loss, class_loss
    return loss
