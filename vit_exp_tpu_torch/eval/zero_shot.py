"""Zero-shot classification engine (counterpart of
vit_exp_tpu/eval/zero_shot.py::ZeroShotClassifier).

18 CT-RATE pathologies, two prompts each ("{p} is present." / "{p} is not
present."); the 36 prompt latents are embedded once; each volume is encoded
once and scored as softmax([present, absent]) over cosine × exp(temperature).
The tokenizer is any callable ``(prompts, max_length=...) -> {"input_ids",
"attention_mask"}``.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from vit_exp_tpu_torch.models.ctclip import CTCLIP

PATHOLOGIES: List[str] = [
    "Medical material", "Arterial wall calcification", "Cardiomegaly",
    "Pericardial effusion", "Coronary artery wall calcification",
    "Hiatal hernia", "Lymphadenopathy", "Emphysema", "Atelectasis",
    "Lung nodule", "Lung opacity", "Pulmonary fibrotic sequela",
    "Pleural effusion", "Mosaic attenuation pattern",
    "Peribronchial thickening", "Consolidation", "Bronchiectasis",
    "Interlobular septal thickening",
]


def build_pathology_prompts(
        pathologies: Sequence[str] = PATHOLOGIES) -> List[str]:
    """[p0 present, p0 absent, p1 present, ...] — 2 per pathology."""
    prompts = []
    for p in pathologies:
        prompts.append(f"{p} is present.")
        prompts.append(f"{p} is not present.")
    return prompts


class ZeroShotClassifier:
    """Batched zero-shot engine over one CTCLIP on one device."""

    def __init__(self, model: CTCLIP, tokenizer, *,
                 pathologies: Sequence[str] = PATHOLOGIES,
                 max_text_len: int = 512):
        self.model = model
        self.tokenizer = tokenizer
        self.pathologies = list(pathologies)
        self.max_text_len = max_text_len
        self.device = next(model.parameters()).device
        self._cached_text = None

    @torch.inference_mode()
    def prepare(self) -> torch.Tensor:
        """Embed the 2·len(pathologies) prompts once."""
        toks = self.tokenizer(build_pathology_prompts(self.pathologies),
                              max_length=self.max_text_len)
        ids = torch.as_tensor(np.asarray(toks["input_ids"]), device=self.device)
        mask = torch.as_tensor(np.asarray(toks["attention_mask"]),
                               device=self.device)
        hidden = self.model.encode_text_hidden(ids, mask)
        self._cached_text = self.model.text_latents_from_hidden(hidden)
        return self._cached_text

    @torch.inference_mode()
    def probs(self, volumes) -> torch.Tensor:
        """(B, 1, D, H, W) → (B, n_pathologies) P(present), on the device."""
        if self._cached_text is None:
            self.prepare()
        video = torch.as_tensor(volumes, device=self.device)
        tokens = self.model.encode_image_tokens(video)
        img = self.model.image_latents_from_tokens(tokens)
        scores = (img @ self._cached_text.T) * self.model.logit_scale()
        pairs = scores.reshape(img.shape[0], len(self.pathologies), 2)
        return torch.softmax(pairs, dim=-1)[..., 0]

    def predict_batch(self, volumes) -> np.ndarray:
        """(B, 1, D, H, W) → (B, n_pathologies) P(present) as numpy."""
        return self.probs(volumes).cpu().numpy()
