"""MaskGITTransformer: text → CT video over a CTViT and a MaskGit
(counterpart of vit_exp_tpu/models/maskgit_pipeline.py).

- ``loss``: the video's VQ indices (frozen CTViT), cosine-schedule masking,
  the CE over the masked positions;
- ``sample``: the token grid by iterative demasking, conditioned on the
  text states, then CTViT's decode of the indices;
- ``make_video``: one clip per prompt, each primed with the VQ tokens of
  the previous clip's trailing frames, the clips concatenated along time.

``text_encode(ids, mask)`` is any (b, n) → (b, n, ctx_dim) encoder: the
port's BERT, or ``t5_text_encode`` over models/t5_adapter.py.  The CTViT
and the text encoder run without gradient.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from vit_exp_tpu_torch.models.ctvit import CTViT
from vit_exp_tpu_torch.models.maskgit import (MaskGit, maskgit_loss,
                                              maskgit_sample,
                                              maskgit_train_masking)


def t5_text_encode(t5_encoder) -> Callable:
    """models/t5_adapter.T5TextEncoder in the text_encode slot (its d_model
    must equal MaskGit's dim_context)."""

    def encode(ids, mask):
        states, _ = t5_encoder(ids, mask)
        return states

    return encode


class MaskGITTransformer:
    def __init__(self, ctvit: CTViT, maskgit: MaskGit,
                 text_encode: Callable[[torch.Tensor, Optional[torch.Tensor]],
                                       torch.Tensor]):
        self.ctvit, self.maskgit, self.text_encode = ctvit, maskgit, text_encode

    @property
    def device(self) -> torch.device:
        return self.maskgit.token_emb.device

    @torch.no_grad()
    def _encode_indices(self, video) -> torch.Tensor:
        """video → flat VQ token ids (b, t·h·w)."""
        video = torch.as_tensor(video).to(self.device)
        _, indices, _ = self.ctvit.quantize(self.ctvit(video))
        return indices.reshape(indices.shape[0], -1)

    @torch.no_grad()
    def _context(self, text_ids, text_mask):
        return self.text_encode(torch.as_tensor(text_ids).to(self.device),
                                torch.as_tensor(text_mask).to(self.device))

    def loss(self, video, text_ids, text_mask, *, draws=None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Masked-token CE; ``draws``: models/maskgit.py::MaskingDraws."""
        flat = self._encode_indices(video)
        masked, mask = maskgit_train_masking(
            flat, self.maskgit.mask_id, draws=draws, generator=generator)
        mask_t = torch.as_tensor(text_mask).to(self.device)
        logits = self.maskgit(masked, context=self._context(text_ids,
                                                            text_mask),
                              context_mask=mask_t)
        return maskgit_loss(logits, flat, mask)

    @torch.no_grad()
    def sample(self, text_ids, text_mask, *,
               token_grid: Tuple[int, int, int], steps: int = 18,
               cond_scale: float = 3.0, prime_frames=None,
               draws: Optional[Sequence] = None,
               generator: Optional[torch.Generator] = None,
               **sample_kwargs) -> torch.Tensor:
        """The decoded video (b, c, T, H, W).  ``prime_frames`` (b, c, T_p,
        H, W), T_p ≡ 1 (mod temporal_patch_size): a clip whose VQ tokens
        condition every round.  ``draws``: one
        models/maskgit.py::SampleDraws per step."""
        t, h, w = token_grid
        mask_t = torch.as_tensor(text_mask).to(self.device)
        prime_ids = (None if prime_frames is None
                     else self._encode_indices(prime_frames))
        ids = maskgit_sample(
            self.maskgit, batch=mask_t.shape[0], seq_len=t * h * w,
            context=self._context(text_ids, text_mask), context_mask=mask_t,
            steps=steps, cond_scale=cond_scale, prime_ids=prime_ids,
            draws=draws, generator=generator, **sample_kwargs)
        return self.ctvit.decode_from_indices(ids.reshape(-1, t, h, w))

    @torch.no_grad()
    def make_video(self, prompts: List[Tuple[torch.Tensor, torch.Tensor]], *,
                   token_grid: Tuple[int, int, int], prime_length: int = 1,
                   draws: Optional[Sequence[Sequence]] = None,
                   **sample_kwargs) -> torch.Tensor:
        """Scene chaining: a clip per (ids, mask) prompt, each primed with
        the previous clip's last ``prime_length`` frames; ``draws[i]`` are
        clip i's."""
        clips, prime = [], None
        for i, (ids, mask) in enumerate(prompts):
            clip = self.sample(ids, mask, token_grid=token_grid,
                               prime_frames=prime,
                               draws=None if draws is None else draws[i],
                               **sample_kwargs)
            clips.append(clip)
            if prime_length:
                prime = clip[:, :, -prime_length:]
        return torch.cat(clips, dim=2)
