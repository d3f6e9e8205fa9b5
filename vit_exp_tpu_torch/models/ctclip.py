"""CTCLIP dual encoder with the segmentation and self-supervision heads
(counterpart of vit_exp_tpu/models/ctclip.py).  ``forward`` is the
contrastive path the train step differentiates.

Bias-free latent projections; the image latent is the token mean, then the
projection, then l2norm (the projection is linear, so this equals the
reference's per-token projection followed by the mean); the logit scale is
exp(temperature).  ``forward_infer`` scores paired latents.

Segmentation (``clip_arch.use_seg``): ``seg_head``, an MLP per token of
out_dim × patch_voxel_nums features, unpatchified to (B, C, D, W, H) voxel
logits (``seg_forward``).  Open vocabulary (``use_open_seg``):
``open_seg_head`` per token to h-dim voxel embeddings, ``open_text_head``
on each class prompt's CLS state, and optionally ``fusion_head``, an MLP
over [voxel embedding, prompt embedding] (``open_seg_forward``,
``apply_fusion_head``).  The losses run in the train step.  The heads
are plain products in the compute dtype on every path (int8 serving
included), as the JAX package computes them outside any kernel.

Self-supervision (off in every reference config): ``use_mlm`` adds
``mlm_head``, a Linear from BERT's width to the vocabulary with bias, run
on the text tower's states of corrupted ids (``mlm_logits``; the text
tower is not detached there, even under ``fix_text_encoder``, as in JAX);
``use_visual_ssl`` adds ``ssl_projector`` on the token mean (taken in
fp32, rounded to the compute dtype, then cast to fp32, as JAX's bf16 mean
is) of an augmented view (``ssl_project``), and for "simsiam"
``ssl_predictor`` (``ssl_predict``).  The terms themselves run in the
train step (train/steps.py, models/mlm.py, models/visual_ssl.py).

Reference quirk kept: the open-vocabulary downsample draws a random start
but slices ``[::factor]`` regardless, so it is a deterministic stride
(``downsample_stride``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from vit_exp_tpu_torch.core.config import CTClipArchConfig
from vit_exp_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from vit_exp_tpu_torch.models.bert import BertConfig, BertModel
from vit_exp_tpu_torch.models.ctvit3d import CTViT3D
from vit_exp_tpu_torch.models.layers import Linear, MLPHead
from vit_exp_tpu_torch.models.visual_ssl import PredictionMLP, ProjectionMLP
from vit_exp_tpu_torch.ops.attention import l2norm
from vit_exp_tpu_torch.ops.patches import unpatchify_heads


def downsample_stride(x: torch.Tensor, factor: int) -> torch.Tensor:
    """(B, C, D, W, H) strided spatial downsample, ``[::factor]`` on each
    spatial axis."""
    if factor == 1:
        return x
    return x[:, :, ::factor, ::factor, ::factor]


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
        ca = self.clip_arch
        pv = (visual.patch_size * visual.patch_size
              * visual.temporal_patch_size)   # voxels a token covers
        if ca.use_seg:
            hc = ca.seg_head
            self.seg_head = MLPHead(visual.dim, hc.n_layers, hc.mid_dim,
                                    hc.out_dim * pv, **kw)
        if ca.use_open_seg:
            hc, tc = ca.open_seg_head, ca.open_text_head
            self.open_seg_head = MLPHead(visual.dim, hc.n_layers, hc.mid_dim,
                                         hc.out_dim * pv, **kw)
            self.open_seg_hidden = hc.out_dim
            self.open_text_head = MLPHead(bert_config.hidden_size,
                                          tc.n_layers, tc.mid_dim,
                                          tc.out_dim, **kw)
            self.fusion_head = None
            if ca.fusion_head is not None:
                fc = ca.fusion_head
                self.fusion_head = MLPHead(hc.out_dim + tc.out_dim,
                                           fc.n_layers, fc.mid_dim,
                                           fc.out_dim, **kw)
        if getattr(ca, "use_mlm", False):
            self.mlm_head = Linear(bert_config.hidden_size,
                                   bert_config.vocab_size, **kw)
        if getattr(ca, "use_visual_ssl", False):
            self.ssl_projector = ProjectionMLP(visual.dim, device=device)
            if ca.visual_ssl_type == "simsiam":
                self.ssl_predictor = PredictionMLP(device=device)

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

    def head_voxels(self, head: nn.Module,
                    tokens: torch.Tensor) -> torch.Tensor:
        """A per-token head's output unpatchified to (B, C, D, W, H)."""
        vt = self.visual_transformer
        return unpatchify_heads(head(tokens), vt.temporal_patch_size,
                                vt.patch_size, vt.patch_size)

    def seg_forward(self, video: torch.Tensor) -> torch.Tensor:
        """Closed-set path: (b, c, T, H, W) → (b, C, T, H, W) voxel logits
        in the compute dtype."""
        tokens = self.encode_image_tokens(video)
        return self.head_voxels(self.seg_head, tokens)

    def open_seg_forward(self, video: torch.Tensor, prompt_ids: torch.Tensor,
                         prompt_mask: Optional[torch.Tensor] = None,
                         down_factor: Optional[int] = None):
        """Open-vocabulary path.  prompt_ids: (C, L_text), one tokenized
        prompt per class.  Returns the voxel embeddings after the strided
        downsample, "seg_preds" (B, L, h), and the class prompts'
        embeddings, "prompt_logits" (B, C, h)."""
        factor = down_factor or self.clip_arch.open_seg_loss_down_factor
        b = video.shape[0]
        hidden = self.encode_text_hidden(prompt_ids, prompt_mask)
        prompt_logits = self.open_text_head(hidden[:, 0, :])   # (C, h)
        prompt_logits = prompt_logits[None].expand(b, *prompt_logits.shape)
        tokens = self.encode_image_tokens(video)
        voxel = downsample_stride(
            self.head_voxels(self.open_seg_head, tokens), factor)
        seg_preds = voxel.permute(0, 2, 3, 4, 1).reshape(
            b, -1, self.open_seg_hidden)
        return {"seg_preds": seg_preds, "prompt_logits": prompt_logits}

    def apply_fusion_head(self, x: torch.Tensor) -> torch.Tensor:
        return self.fusion_head(x)

    def mlm_logits(self, input_ids: torch.Tensor,
                   attention_mask: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
        """Corrupted ids → per-position vocabulary logits (compute dtype)."""
        return self.mlm_head(self.text_transformer(input_ids, attention_mask))

    def ssl_project(self, video: torch.Tensor) -> torch.Tensor:
        """An augmented view → the projector's embedding z (fp32)."""
        tokens = self.encode_image_tokens(video)
        flat = tokens.reshape(tokens.shape[0], -1, tokens.shape[-1])
        pooled = flat.float().mean(dim=1).to(flat.dtype)
        return self.ssl_projector(pooled.float())

    def ssl_predict(self, z: torch.Tensor) -> torch.Tensor:
        return self.ssl_predictor(z)
