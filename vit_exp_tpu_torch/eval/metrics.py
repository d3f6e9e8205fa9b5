"""Evaluation metrics (counterpart of vit_exp_tpu/eval/metrics.py):
per-label AUROC over the zero-shot predictions and the inference
artifacts.

The JAX module takes its AUROC from sklearn, which the card's host does not
have; ``rank_auroc`` is the same number in the Mann-Whitney form (average
ranks for ties, which sklearn's trapezoids count as one half).  A label with
a single class present has no AUROC: NaN, left out of the mean.  The
thresholded metrics, the bootstrap and ``evaluate_external`` come with the
zero-shot CLI.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence

import numpy as np


def rank_auroc(truth: np.ndarray, score: np.ndarray) -> float:
    """AUROC of ``score`` against binary ``truth`` (the larger label is the
    positive one, as sklearn's): the Mann-Whitney U over n1·n0 with ties
    given their average rank; NaN when one class is missing."""
    truth, score = np.asarray(truth), np.asarray(score, np.float64)
    pos = truth == truth.max()
    n1 = int(pos.sum())
    n0 = len(truth) - n1
    if n1 == 0 or n0 == 0:
        return float("nan")
    order = np.argsort(score, kind="mergesort")
    ranks = np.empty(len(score))
    ranks[order] = np.arange(1, len(score) + 1)
    _, inverse, counts = np.unique(score, return_inverse=True,
                                   return_counts=True)
    ranks = (np.bincount(inverse, weights=ranks) / counts)[inverse]
    return float((ranks[pos].sum() - n1 * (n1 + 1) / 2) / (n1 * n0))


def evaluate_internal(y_pred: np.ndarray, y_true: np.ndarray,
                      labels: Sequence[str]) -> Dict[str, float]:
    """y_pred/y_true: (N, C).  Returns {label}_auc per label and
    'mean_auc' over the labels that have one."""
    out: Dict[str, float] = {}
    aucs: List[float] = []
    for i, label in enumerate(labels):
        truth = y_true[:, i]
        if truth.min() == truth.max():   # one class only: undefined AUC
            out[f"{label}_auc"] = float("nan")
            continue
        auc = rank_auroc(truth, y_pred[:, i])
        out[f"{label}_auc"] = auc
        aucs.append(auc)
    out["mean_auc"] = float(np.mean(aucs)) if aucs else float("nan")
    return out


def save_inference_artifacts(results_folder: str, y_pred: np.ndarray,
                             y_true: np.ndarray, accessions, res: Dict
                             ) -> None:
    """Write the reference inference artifacts: ``predicted_weights.npz`` and
    ``labels_weights.npz`` (key 'data'), ``predicted.npz`` and
    ``labels.npz`` (key arr_0), ``accessions.txt``, the result dict as
    ``aurocs.json`` and its one-row ``{label}_auc`` table as
    ``aurocs.csv``."""
    os.makedirs(results_folder, exist_ok=True)
    np.savez(os.path.join(results_folder, "predicted_weights.npz"),
             data=y_pred)
    np.savez(os.path.join(results_folder, "labels_weights.npz"), data=y_true)
    np.savez(os.path.join(results_folder, "predicted.npz"), y_pred)
    np.savez(os.path.join(results_folder, "labels.npz"), y_true)
    with open(os.path.join(results_folder, "accessions.txt"), "w") as f:
        f.writelines(f"{a}\n" for a in accessions)
    with open(os.path.join(results_folder, "aurocs.json"), "w") as f:
        json.dump(res, f, indent=2)
    # the table keeps only the AUROC columns; timing keys stay in the json
    keys = [k for k in res if k.endswith("_auc") or k == "mean_auc"]
    with open(os.path.join(results_folder, "aurocs.csv"), "w") as f:
        f.write(",".join(keys) + "\n")
        f.write(",".join(f"{res[k]}" for k in keys) + "\n")
