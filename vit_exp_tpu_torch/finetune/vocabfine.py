"""CT-VocabFine, end-to-end prompt-pair fine-tuning of CTCLIP (counterpart
of vit_exp_tpu/finetune/vocabfine.py).

One step per volume (batch 1): for each of the C pathologies the
(correct, incorrect) prompt pair is chosen by its label ("{p} is present. "
and "{p} is not present. ", swapped where the label is 0); the volume and
all 2C prompts are encoded in one forward (BERT at ``max_text_len``
tokens, the image tower through its kernels), each pair's two scores
(cosine × exp(temperature)) go through a softmax, and the loss is the MSE
against [1, 0].  The whole model trains; under ``fix_text_encoder`` BERT's
states are detached, so its parameters move by the weight decay alone, as
optax decays them.  Optimizer: ``AdamWOptax`` on ``finetune_schedule``
(train/optimizer.py: b2 0.999, decay on every parameter, no clip, lr 0 on
the first warmup update).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from vit_exp_tpu_torch.eval.zero_shot import PATHOLOGIES
from vit_exp_tpu_torch.train.optimizer import AdamWOptax, finetune_schedule


class VocabFineTrainer:
    def __init__(self, model, tokenizer, *,
                 pathologies: Optional[List[str]] = None, lr: float = 5e-6,
                 wd: float = 0.01, warmup_steps: int = 100,
                 total_steps: int = 10_000, max_text_len: int = 512):
        self.model = model.train()
        self.device = next(model.parameters()).device
        self.pathologies = list(pathologies or PATHOLOGIES)
        toks = [tokenizer([f"{p} is {w}present. " for p in self.pathologies],
                          max_length=max_text_len)
                for w in ("", "not ")]
        # (2, C, L): [present, absent]
        self.ids_pair = torch.as_tensor(np.stack(
            [np.asarray(t["input_ids"]) for t in toks])).long().to(self.device)
        self.mask_pair = torch.as_tensor(np.stack(
            [np.asarray(t["attention_mask"]) for t in toks])).to(self.device)
        self.opt = AdamWOptax(model.parameters(),
                              finetune_schedule(lr, warmup_steps, total_steps),
                              wd)
        self.step = 0

    def loss(self, video: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """The prompt-pair MSE of one volume (1, 1, D, H, W) with labels
        (C,)."""
        m, c = self.model, len(self.pathologies)
        lab = labels.bool()[:, None]
        ids_p, ids_a = self.ids_pair
        mask_p, mask_a = self.mask_pair
        ids = torch.cat([torch.where(lab, ids_p, ids_a),
                         torch.where(lab, ids_a, ids_p)])       # (2C, L)
        mask = torch.cat([torch.where(lab, mask_p, mask_a),
                          torch.where(lab, mask_a, mask_p)])
        txt = m.text_latents_from_hidden(m.encode_text_hidden(ids, mask))
        img = m.image_latents_from_tokens(m.encode_image_tokens(video))
        scores = (txt @ img[0]) * m.logit_scale()               # (2C,)
        probs = torch.softmax(scores.reshape(2, c).T, dim=-1)   # (C, 2)
        target = torch.tensor([1.0, 0.0], device=probs.device)
        return ((probs - target) ** 2).mean()

    def fit_batch(self, video, labels) -> float:
        """video: (1, 1, D, H, W); labels: (C,) one-hot pathology labels."""
        loss = self.loss(torch.as_tensor(video).to(self.device),
                         torch.as_tensor(labels).to(self.device))
        self.opt.zero_grad()
        loss.backward()
        self.opt.step()
        self.step += 1
        return float(loss.detach())
