"""CT-LiPro, a linear probe on the frozen CTCLIP image latents (counterpart
of vit_exp_tpu/finetune/lipro.py).

- Head: ReLU → Dropout(0.3) → Linear(dim_latent → 18), on the
  l2-normalised image latents (the token mean, then ``to_visual_latent``,
  then l2norm: the reference probe's return_latents output), the tower
  under ``torch.no_grad`` (no autograd graph, the attention forward
  without lse).
- Loss: ``weighted_bce_with_logits``, torch's BCEWithLogitsLoss with the
  18 hand-tuned positive-class weights (``LIPRO_POS_WEIGHTS``).
- Optimizer: ``AdamWOptax`` (train/optimizer.py), optax.adamw as the JAX
  package builds it (b2 0.999, decay on every head parameter, no clip), on
  ``finetune_schedule``: warmup min(warmup, max(total//10, 1)) then a
  cosine to 0 at max(total, warmup + 1), read at the count of updates
  taken, so the first update uses lr 0.
- The dropout keep mask is a draw: from the trainer's host generator
  (seeded with ``seed``), or handed to ``fit_batch`` (the CPU tests hand in
  the mask flax's Dropout draws).
- The head saves as a torch file (``save``/``load``); the JAX package's
  msgpack heads are not read (no flax on the card's host).
- ``infer`` scores an inference data set through the zero-shot engine's
  loop (eval/zero_shot.py ``_one_deep_map``, the engine's copier and pool)
  and writes its artifacts (``evaluate_internal``,
  ``save_inference_artifacts``).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from vit_exp_tpu_torch.core.precision import FP32_POLICY
from vit_exp_tpu_torch.models.layers import Linear
from vit_exp_tpu_torch.train.optimizer import AdamWOptax, finetune_schedule

LIPRO_POS_WEIGHTS = np.asarray([
    9.211362733, 2.384068466, 8.295479204, 32.8629776, 2.992233613,
    6.064870808, 3.176470588, 4.187083754, 3.022222222, 1.216071737,
    1.677849552, 3.152851834, 7.123261694, 18.16629381, 13.8480647,
    6.335045662, 10.81701149, 13.40695067,
], dtype=np.float32)


class LiProHead(nn.Module):
    def __init__(self, dim_latent: int, num_classes: int = 18,
                 dropout_prob: float = 0.3, *, device=None):
        super().__init__()
        self.num_classes = num_classes
        self.keep = 1.0 - dropout_prob
        self.classifier = Linear(dim_latent, num_classes, policy=FP32_POLICY,
                                 device=device)

    def forward(self, latents: torch.Tensor,
                keep_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits; with ``keep_mask`` (bool, latents' shape) the training
        dropout, kept entries scaled by 1/keep as flax's Dropout does."""
        x = F.relu(latents.float())
        if keep_mask is not None:
            x = torch.where(keep_mask, x / self.keep, torch.zeros_like(x))
        return self.classifier(x)


def weighted_bce_with_logits(logits: torch.Tensor, labels: torch.Tensor,
                             pos_weight: torch.Tensor) -> torch.Tensor:
    """torch BCEWithLogitsLoss(pos_weight=...) as the JAX package writes it:
    −(w·y·log σ(x) + (1 − y)·log σ(−x)), averaged."""
    per = -(pos_weight * labels * F.logsigmoid(logits)
            + (1.0 - labels) * F.logsigmoid(-logits))
    return per.mean()


class LiProTrainer:
    def __init__(self, clip_model, *, num_classes: int = 18,
                 lr: float = 1e-3, wd: float = 0.1, warmup_steps: int = 500,
                 total_steps: int = 10_000,
                 pos_weights: Optional[np.ndarray] = None, seed: int = 0):
        self.clip_model = clip_model
        self.device = next(clip_model.parameters()).device
        dim_latent = clip_model.to_visual_latent.weight.shape[0]
        self.head = LiProHead(dim_latent, num_classes, device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        with torch.no_grad():
            self.head.classifier.reset_parameters(gen)
        self.pos_weight = torch.as_tensor(
            pos_weights if pos_weights is not None
            else LIPRO_POS_WEIGHTS[:num_classes], dtype=torch.float32,
            device=self.device)
        self.opt = AdamWOptax(self.head.parameters(),
                              finetune_schedule(lr, warmup_steps, total_steps),
                              wd)
        self.generator = torch.Generator().manual_seed(seed)   # dropout
        self.step = 0

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype).to(self.device)

    @torch.no_grad()
    def image_latents(self, video) -> torch.Tensor:
        """(B, 1, D, H, W) → the frozen tower's l2-normalised latents."""
        m = self.clip_model
        return m.image_latents_from_tokens(
            m.encode_image_tokens(self._tensor(video)))

    def fit_batch(self, video, labels, keep_mask=None) -> float:
        """One update on a batch; ``keep_mask`` (B, dim_latent) bool, else
        drawn."""
        latents = self.image_latents(video)
        if keep_mask is None:
            keep_mask = torch.rand(latents.shape, generator=self.generator
                                   ) < self.head.keep
        logits = self.head(latents, self._tensor(keep_mask, torch.bool))
        loss = weighted_bce_with_logits(
            logits, self._tensor(labels, torch.float32), self.pos_weight)
        self.opt.zero_grad()
        loss.backward()
        self.opt.step()
        self.step += 1
        return float(loss.detach())

    @torch.no_grad()
    def probs(self, video) -> torch.Tensor:
        return torch.sigmoid(self.head(self.image_latents(video)))

    def predict(self, video) -> np.ndarray:
        return self.probs(video).cpu().numpy()

    def save(self, path: str) -> None:
        """The probe head's state dict (a torch file); the frozen backbone
        is whatever checkpoint was loaded."""
        torch.save({k: v.cpu() for k, v in self.head.state_dict().items()},
                   path)

    def load(self, path: str) -> None:
        self.head.load_state_dict(torch.load(path, map_location=self.device,
                                             weights_only=True))

    def infer(self, dataset, *, results_folder: Optional[str] = None,
              limit: Optional[int] = None, batch_size: int = 4,
              num_workers: int = 4) -> dict:
        """The probe's sigmoid probabilities over an inference data set,
        per-label AUROC, 'mean_auc' and 'volumes_per_sec'; with
        ``results_folder`` the reference artifact set."""
        from vit_exp_tpu_torch.eval.metrics import (evaluate_internal,
                                                    save_inference_artifacts)
        from vit_exp_tpu_torch.eval.zero_shot import (PATHOLOGIES, _Feed,
                                                      _one_deep_map)

        c = self.head.num_classes
        n = min(len(dataset), limit) if limit else len(dataset)
        feed = _Feed(self.device, ("image",))
        preds, labels, accessions = [], [], []
        t0 = time.perf_counter()
        for dev, onehots, accs in _one_deep_map(
                dataset, n, batch_size,
                lambda b: (self.probs(feed.to_device(b)["image"]),
                           b["onehot"], b["accession"]),
                num_workers=num_workers, pool=feed.pool):
            preds.extend(dev.cpu().numpy())
            labels.extend(np.asarray(onehots)[:, :c])
            accessions.extend(accs)
        elapsed = time.perf_counter() - t0
        y_pred, y_true = np.asarray(preds), np.asarray(labels)
        res = evaluate_internal(y_pred, y_true, list(PATHOLOGIES[:c]))
        res["volumes_per_sec"] = n / elapsed
        if results_folder:
            save_inference_artifacts(results_folder, y_pred, y_true,
                                     accessions, res)
        return res
