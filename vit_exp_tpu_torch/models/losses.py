"""Loss functions of the CT-CLIP stack (counterpart of
vit_exp_tpu/models/losses.py; the segmentation and open-vocabulary losses
wait for a later slice).

- ``infonce_loss``: the symmetric InfoNCE of the reference's image-report
  step, in log-sum-exp form, including its scale quirk: the mean over the
  batch is divided again by the local (per-device) batch size.
"""

from __future__ import annotations

from typing import Optional

import torch


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
