"""Masked-language-model term of the image-report step (counterpart of
vit_exp_tpu/models/mlm.py).

Each random function is split in two: a draw from an explicit
``torch.Generator`` (``draw_mlm``) and a pure function of the draws
(``mask_subset_with_prob``, ``mlm_corrupt``), so a caller may hand in the
draws of another source (the CPU tests feed the uniforms and ids JAX draws
from the same key).

- Selection: each row masks ceil(prob · n_valid) of its valid positions
  (neither pad nor a special id), those of lowest score, ties broken by
  position (two stable argsorts, as the JAX package ranks them).
- Corruption, BERT's 80/10/10: a selected position with u < 0.8 becomes the
  mask id, with 0.8 ≤ u < 0.9 a random id, otherwise stays.
- Loss: mean cross-entropy over the selected positions, the count clamped
  at 1.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from vit_exp_tpu_torch.parallel.collectives import all_reduce_sum


class MLMDraws(NamedTuple):
    scores: torch.Tensor       # (b, n) U[0, 1): selection order
    u: torch.Tensor            # (b, n) U[0, 1): the 80/10/10 split
    random_ids: torch.Tensor   # (b, n) ids in [0, vocab_size)


def draw_mlm(shape, vocab_size: int,
             generator: torch.Generator) -> MLMDraws:
    """The draws of one corruption, on the generator's device."""
    dev = generator.device
    scores = torch.rand(shape, generator=generator, device=dev)
    u = torch.rand(shape, generator=generator, device=dev)
    ids = torch.randint(0, vocab_size, shape, generator=generator, device=dev)
    return MLMDraws(scores, u, ids)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A Python float as an fp32 scalar, as JAX reads a weak-typed float."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def mask_subset_with_prob(scores: torch.Tensor, valid: torch.Tensor,
                          prob: float) -> torch.Tensor:
    """(b, n) bool: ceil(prob · n_valid) valid positions per row, those of
    lowest score."""
    scores = torch.where(valid, scores.float(),
                         torch.full_like(scores, float("inf")))
    # fp32 product, then ceil: at 0.15 · 20 the product rounds to exactly 3
    num = torch.ceil(valid.sum(-1).float() * _f32(prob, scores))
    order = torch.argsort(scores, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    return (ranks < num[:, None]) & valid


def mlm_corrupt(input_ids: torch.Tensor, draws: MLMDraws, *,
                mask_token_id: int, pad_id: int = 0,
                special_ids: Tuple[int, ...] = (), mask_prob: float = 0.15,
                replace_prob: float = 0.8,
                random_token_prob: float = 0.1
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(corrupted ids, loss mask) for the draws (on input_ids' device)."""
    valid = input_ids != pad_id
    for sid in special_ids:
        valid &= input_ids != sid
    loss_mask = mask_subset_with_prob(draws.scores, valid, mask_prob)
    u = draws.u.float()
    do_mask = loss_mask & (u < _f32(replace_prob, u))
    do_random = (loss_mask & (u >= _f32(replace_prob, u))
                 & (u < _f32(replace_prob + random_token_prob, u)))
    out = torch.where(do_mask, torch.full_like(input_ids, mask_token_id),
                      input_ids)
    out = torch.where(do_random, draws.random_ids.to(input_ids.dtype), out)
    return out, loss_mask


def mlm_loss(logits: torch.Tensor, targets: torch.Tensor,
             loss_mask: torch.Tensor, group=None) -> torch.Tensor:
    """Mean cross-entropy over the masked positions (fp32); under a
    data-parallel ``group`` over the global batch's masked positions (both
    sums taken over the group, parallel/collectives.py)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets[..., None].long())[..., 0]
    m = loss_mask.float()
    num, den = all_reduce_sum(torch.stack([(nll * m).sum(), m.sum()]), group)
    return num / den.clamp_min(1.0)
