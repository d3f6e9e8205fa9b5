"""Multi-label report-classifier trainer (counterpart of
vit_exp_tpu/text_classifier/trainer.py): the BCE-with-logits loop, the
best-validation-loss snapshot with early stop, the choice between cosine
annealing with warm restarts and reduce-on-plateau, and the per-label
precision/recall/F1 report.

- ``cosine_annealing_warm_restarts`` is the JAX package's formula, not
  torch's scheduler, in fp32 with the constants associated as XLA
  compiles them (a division by a constant is a product by its reciprocal;
  π and the reciprocal of the cosine's span fold into one factor): bit for
  bit in the warmup, and within a couple of fp32 ulps in the cosine,
  where XLA evaluates its own fp32 cosine polynomial and this the
  correctly rounded cosine.
- ``ReduceLROnPlateau`` multiplies the learning rate by ``factor`` after
  ``patience`` epochs without improvement, floored at ``min_lr`` as an
  absolute learning rate.
- The optimizer is optax.adamw as the JAX package builds it here
  (``AdamWOptax``: b2 0.999, decay on every parameter, no clip) with its
  default weight decay 1e-4, on the CAWR schedule or, for "rlop", at the
  base rate times the plateau's scale.
- Checkpoints are torch files of the model's state dict (``best_model.pt``);
  the JAX package's msgpack files are not read.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional

import numpy as np
import torch

from vit_exp_tpu_torch.train.optimizer import AdamWOptax

_F = np.float32
WEIGHT_DECAY = 1e-4   # optax.adamw's default, which the JAX trainer keeps


def cosine_annealing_warm_restarts(base_lr: float, first_cycle: int,
                                   mult: int = 1, warmup: int = 0,
                                   min_lr: float = 0.0, gamma: float = 1.0):
    """step → learning rate: cycles of first_cycle · mult^k steps, each a
    linear warmup from min_lr to base_lr · gamma^k over ``warmup`` steps,
    then a half cosine down to min_lr."""
    one = _F(1)

    def schedule(step: int) -> float:
        s = _F(step)
        if mult == 1:
            cycle = np.floor(s * (one / _F(first_cycle)))
            s_in = s - cycle * _F(first_cycle)
            length = _F(first_cycle)
        else:
            cycle = np.floor(_F(math.log1p((mult - 1) * float(s) / first_cycle)
                                / math.log(mult)))
            start = _F(first_cycle * (mult ** float(cycle) - 1) / (mult - 1))
            length = _F(first_cycle * mult ** float(cycle))
            s_in = s - start
        peak = _F(base_lr) * _F(gamma ** float(cycle))
        lo = _F(min_lr)
        if s_in < warmup:
            return float(lo + (peak - lo) * s_in * (one / _F(max(warmup, 1))))
        span = np.maximum(length - _F(warmup), one)
        arg = (s_in - _F(warmup)) * (_F(math.pi) * (one / span))
        cos = _F(math.cos(float(arg)))
        return float(lo + (_F(0.5) * (peak - lo)) * (one + cos))

    return schedule


class ReduceLROnPlateau:
    """Host-side plateau multiplier; ``min_lr`` is an absolute floor on the
    effective learning rate, so the scale floors at min_lr / base_lr."""

    def __init__(self, factor: float = 0.5, patience: int = 5,
                 min_lr: float = 1e-8, base_lr: float = 1.0):
        self.factor = factor
        self.patience = patience
        self.min_scale = min_lr / max(base_lr, 1e-30)
        self.best = float("inf")
        self.bad_epochs = 0
        self.scale = 1.0

    def step(self, metric: float) -> float:
        if metric < self.best - 1e-12:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.scale = max(self.scale * self.factor, self.min_scale)
                self.bad_epochs = 0
        return self.scale


def bce_with_logits(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Elementwise BCE with logits, written as the JAX package writes it."""
    return x.clamp_min(0) - x * t + torch.log1p(torch.exp(-x.abs()))


class TextClassifierTrainer:
    def __init__(self, model, *, lr: float = 2e-5, scheduler: str = "cawr",
                 first_cycle: int = 1000,
                 results_folder: str = "./results_text_classifier",
                 early_stop: int = 100):
        self.model = model
        self.device = next(model.parameters()).device
        self.results_folder = results_folder
        os.makedirs(results_folder, exist_ok=True)
        self.scheduler_kind = scheduler
        self.rlop = ReduceLROnPlateau(base_lr=lr)
        self._lr_scale = 1.0
        schedule = (cosine_annealing_warm_restarts(lr, first_cycle, warmup=50)
                    if scheduler == "cawr"
                    else (lambda count: lr * self._lr_scale))
        self.opt = AdamWOptax(model.parameters(), schedule, WEIGHT_DECAY)
        self.best_loss = float("inf")
        self.best_state: Optional[Dict[str, torch.Tensor]] = None
        self.epochs_no_improve = 0
        self.early_stop = early_stop
        self.step = 0

    def _inputs(self, ids, mask, labels):
        return (torch.as_tensor(np.asarray(ids)).long().to(self.device),
                torch.as_tensor(np.asarray(mask)).to(self.device),
                torch.as_tensor(np.asarray(labels),
                                dtype=torch.float32).to(self.device))

    def fit_batch(self, ids, mask, labels) -> float:
        ids, mask, labels = self._inputs(ids, mask, labels)
        self.model.train()
        loss = bce_with_logits(self.model(ids, mask), labels).mean()
        self.opt.zero_grad()
        loss.backward()
        self.opt.step()
        self.step += 1
        return float(loss.detach())

    @torch.no_grad()
    def evaluate(self, batches) -> Dict[str, float]:
        """Validation loss and macro metrics over (ids, mask, labels)
        batches; under "rlop" the plateau's scale follows the loss."""
        losses, probs, labels = [], [], []
        self.model.eval()
        for ids, mask, y in batches:
            ids_t, mask_t, y_t = self._inputs(ids, mask, y)
            logits = self.model(ids_t, mask_t)
            losses.append(float(bce_with_logits(logits, y_t).mean()))
            probs.append(torch.sigmoid(logits).cpu().numpy())
            labels.append(np.asarray(y))
        probs = np.concatenate(probs)
        labels = np.concatenate(labels)
        preds = (probs > 0.5).astype(np.float32)
        eps = 1e-9
        tp = (preds * labels).sum(0)
        fp = (preds * (1 - labels)).sum(0)
        fn = ((1 - preds) * labels).sum(0)
        precision = tp / (tp + fp + eps)
        recall = tp / (tp + fn + eps)
        f1 = 2 * precision * recall / (precision + recall + eps)
        val_loss = float(np.mean(losses))
        if self.scheduler_kind == "rlop":
            self._lr_scale = self.rlop.step(val_loss)
        return {"val_loss": val_loss,
                "accuracy": float((preds == labels).mean()),
                "macro_f1": float(f1.mean()),
                "macro_precision": float(precision.mean()),
                "macro_recall": float(recall.mean())}

    def end_epoch(self, val_loss: float, *, autosave: bool = True) -> bool:
        """Track the best loss; on improvement snapshot the current weights
        as the best (and write them when ``autosave``).  Returns True when
        early stop triggers."""
        if val_loss < self.best_loss:
            self.best_loss = val_loss
            self.best_state = {k: v.detach().clone()
                               for k, v in self.model.state_dict().items()}
            self.epochs_no_improve = 0
            if autosave:
                self.save()
            return False
        self.epochs_no_improve += 1
        return self.epochs_no_improve >= self.early_stop

    def save(self, path: Optional[str] = None) -> str:
        """Write the best (or the current) weights, atomically."""
        path = path or os.path.join(self.results_folder, "best_model.pt")
        state = (self.best_state if self.best_state is not None
                 else self.model.state_dict())
        torch.save({k: v.cpu() for k, v in state.items()}, path + ".tmp")
        os.replace(path + ".tmp", path)
        return path

    def load(self, path: str):
        """Load weights saved by ``save`` (strictly)."""
        self.model.load_state_dict(torch.load(path, map_location=self.device,
                                              weights_only=True))
        return self.model


def per_label_report(y_pred: np.ndarray, y_true: np.ndarray, label_names,
                     out_csv: Optional[str] = None, threshold: float = 0.5):
    """Per-label precision/recall/F1/support of the binarized predictions
    (a CSV too with ``out_csv``).  Returns {label: {precision, recall, f1,
    support}}."""
    preds = (np.asarray(y_pred) > threshold).astype(np.int32)
    truth = np.asarray(y_true).astype(np.int32)
    report, rows = {}, []
    for i, name in enumerate(label_names):
        tp = int(((preds[:, i] == 1) & (truth[:, i] == 1)).sum())
        fp = int(((preds[:, i] == 1) & (truth[:, i] == 0)).sum())
        fn = int(((preds[:, i] == 0) & (truth[:, i] == 1)).sum())
        precision = tp / (tp + fp) if tp + fp else 0.0
        recall = tp / (tp + fn) if tp + fn else 0.0
        f1 = (2 * precision * recall / (precision + recall)
              if precision + recall else 0.0)
        report[name] = {"precision": precision, "recall": recall, "f1": f1,
                        "support": tp + fn}
        rows.append((name, precision, recall, f1, tp + fn))
    if out_csv:
        with open(out_csv, "w") as f:
            f.write("label,precision,recall,f1,support\n")
            for name, p, r, f1v, s in rows:
                f.write(f"{name},{p:.6f},{r:.6f},{f1v:.6f},{s}\n")
    return report
