"""CTCLIP dual encoder, contrastive/zero-shot surface (counterpart of
vit_exp_tpu/models/ctclip.py; the segmentation and SSL heads wait for a
later slice).  ``forward`` is the contrastive path the train step
differentiates.

Bias-free latent projections; the image latent is the token mean, then the
projection, then l2norm (the projection is linear, so this equals the
reference's per-token projection followed by the mean); the logit scale is
exp(temperature).  ``forward_infer`` scores paired latents.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from vit_exp_tpu_torch.core.config import CTClipArchConfig
from vit_exp_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from vit_exp_tpu_torch.models.bert import BertConfig, BertModel
from vit_exp_tpu_torch.models.ctvit3d import CTViT3D
from vit_exp_tpu_torch.models.layers import Linear
from vit_exp_tpu_torch.ops.attention import l2norm


class CTCLIP(nn.Module):
    def __init__(self, visual: CTViT3D, bert_config: BertConfig, *,
                 dim_latent: int = 768,
                 clip_arch: Optional[CTClipArchConfig] = None,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        kw = dict(policy=policy, device=device)
        self.clip_arch = clip_arch or CTClipArchConfig()
        self.visual_transformer = visual
        self.text_transformer = BertModel(bert_config, **kw)
        self.to_text_latent = Linear(bert_config.hidden_size, dim_latent,
                                     bias=False, **kw)
        self.to_visual_latent = Linear(visual.dim, dim_latent, bias=False, **kw)
        self.temperature = nn.Parameter(
            torch.empty((), device=device, dtype=torch.float32))

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.temperature)

    def encode_image_tokens(self, video: torch.Tensor) -> torch.Tensor:
        """(b, c, T, H, W) → encoded tokens (b, t, h, w, dim_image)."""
        return self.visual_transformer(video)

    def encode_text_hidden(self, input_ids: torch.Tensor,
                           attention_mask: Optional[torch.Tensor] = None):
        """BERT's hidden states; under ``fix_text_encoder`` detached (JAX's
        stop_gradient), so BERT's parameters get no ``.grad`` and the
        optimizer steps them on a zero gradient, as optax does."""
        hidden = self.text_transformer(input_ids, attention_mask)
        if self.clip_arch.fix_text_encoder:
            hidden = hidden.detach()
        return hidden

    def image_latents_from_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """Token mean (fp32) → projection → l2norm."""
        flat = tokens.reshape(tokens.shape[0], -1, tokens.shape[-1])
        pooled = flat.float().mean(dim=1).to(flat.dtype)
        return l2norm(self.to_visual_latent(pooled).float())

    def text_latents_from_hidden(self, hidden: torch.Tensor) -> torch.Tensor:
        """CLS state → projection → l2norm."""
        return l2norm(self.to_text_latent(hidden[:, 0, :]).float())

    def logit_scale(self) -> torch.Tensor:
        return self.temperature.exp()

    def forward_infer(self, text_latents: torch.Tensor,
                      image_latents: torch.Tensor) -> torch.Tensor:
        """Paired cosine score × exp(temperature), one per pair."""
        sim = (text_latents * image_latents).sum(dim=-1)
        return sim * self.logit_scale()

    def forward(self, video: torch.Tensor, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None):
        """Contrastive path: l2-normalised latents and the temperature."""
        hidden = self.encode_text_hidden(input_ids, attention_mask)
        tokens = self.encode_image_tokens(video)
        return {"text_latents": self.text_latents_from_hidden(hidden),
                "image_latents": self.image_latents_from_tokens(tokens),
                "temperature": self.temperature}
