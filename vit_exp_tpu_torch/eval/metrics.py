"""Evaluation metrics (counterpart of vit_exp_tpu/eval/metrics.py):
per-label AUROC over the zero-shot predictions and the inference
artifacts, the Youden operating point, the bootstrap confidence intervals,
the thresholded F1/accuracy/precision and the external-set AUROC.

The JAX module takes its metrics from sklearn, which the card's host does
not have.  Each is computed here with numpy as sklearn computes it:

- ``rank_auroc`` is ``roc_auc_score`` in the Mann-Whitney form (average
  ranks for ties, which sklearn's trapezoids count as one half);
- ``roc_curve`` is sklearn's with ``drop_intermediate=True``: points
  collinear with their neighbours dropped, and a first threshold of inf;
- the weighted F1 and precision are sklearn's ``average="weighted"`` with
  ``zero_division=0``: per label of the union of truth and prediction,
  weighted by the label's true count.

A label with a single class present has no AUROC: NaN, left out of the
mean.  The bootstrap draws its resamples from
``numpy.random.default_rng(seed).integers``, as the JAX module does.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Tuple

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
    'mean_auc' over the labels that have one.  A label with one class only,
    or with a missing (NaN) truth value (an empty cell of the labels CSV,
    on which sklearn raises), has none."""
    out: Dict[str, float] = {}
    aucs: List[float] = []
    for i, label in enumerate(labels):
        truth = y_true[:, i]
        # one class only, or a missing label: undefined AUC
        if np.isnan(truth).any() or truth.min() == truth.max():
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


def roc_curve(y_true: np.ndarray, y_score: np.ndarray):
    """(fpr, tpr, thresholds) of ``y_score`` against 0/1 ``y_true``, as
    sklearn's ``roc_curve`` with ``drop_intermediate=True`` gives them."""
    y_true = np.asarray(y_true) == 1
    y_score = np.asarray(y_score)
    desc = np.argsort(y_score, kind="mergesort")[::-1]
    y_score, y_true = y_score[desc], y_true[desc]
    idx = np.r_[np.where(np.diff(y_score))[0], y_true.size - 1]
    tps = np.cumsum(y_true, dtype=np.float64)[idx]
    fps = 1 + idx - tps
    thresholds = y_score[idx]
    if len(fps) > 2:   # drop the points collinear with their neighbours
        keep = np.where(np.r_[True, np.logical_or(np.diff(fps, 2),
                                                  np.diff(tps, 2)), True])[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps, fps = np.r_[0.0, tps], np.r_[0.0, fps]
    thresholds = np.r_[np.inf, thresholds.astype(np.float64)]
    fpr = fps / fps[-1] if fps[-1] > 0 else np.full(fps.shape, np.nan)
    tpr = tps / tps[-1] if tps[-1] > 0 else np.full(tps.shape, np.nan)
    return fpr, tpr, thresholds


def choose_operating_point(
    y_true: np.ndarray, y_score: np.ndarray
) -> Tuple[float, float, float]:
    """The Youden-J threshold → (threshold, sensitivity, specificity)."""
    fpr, tpr, thresholds = roc_curve(y_true, y_score)
    idx = int(np.argmax(tpr - fpr))
    return float(thresholds[idx]), float(tpr[idx]), float(1 - fpr[idx])


def bootstrap_auroc(
    y_pred: np.ndarray, y_true: np.ndarray, labels: Sequence[str],
    n_samples: int = 1000, confidence: float = 0.95, seed: int = 0,
) -> Dict[str, Tuple[float, float, float]]:
    """{label: (mean, ci_low, ci_high)} by the percentile bootstrap; a
    resample with one class of a label is skipped for that label."""
    rng = np.random.default_rng(seed)
    n = y_true.shape[0]
    stats: Dict[str, List[float]] = {label: [] for label in labels}
    for _ in range(n_samples):
        idx = rng.integers(0, n, n)
        yp, yt = y_pred[idx], y_true[idx]
        for i, label in enumerate(labels):
            truth = yt[:, i]
            if truth.min() == truth.max():
                continue
            stats[label].append(rank_auroc(truth, yp[:, i]))
    lo_q = (1 - confidence) / 2
    out = {}
    for label, vals in stats.items():
        if not vals:
            out[label] = (float("nan"),) * 3
            continue
        arr = np.asarray(vals)
        out[label] = (float(arr.mean()), float(np.quantile(arr, lo_q)),
                      float(np.quantile(arr, 1 - lo_q)))
    return out


def find_threshold(probabilities: np.ndarray, true_labels: np.ndarray,
                   n_steps: int = 100) -> float:
    """The threshold of a linspace sweep over [0, 1] closest to the ROC
    ideal point (0, 1): sqrt((1 − TPR)² + FPR²), the last of equals (the
    reference's bootstrap_values.py)."""
    best_threshold, best_dist = 0.0, float("inf")
    pos = true_labels == 1
    neg = ~pos
    n_pos, n_neg = int(pos.sum()), int(neg.sum())
    for threshold in np.linspace(0, 1, n_steps):
        pred = probabilities > threshold
        tpr = float((pred & pos).sum()) / n_pos if n_pos else 0.0
        fpr = float((pred & neg).sum()) / n_neg if n_neg else 0.0
        dist = np.sqrt((1 - tpr) ** 2 + fpr ** 2)
        if dist <= best_dist:
            best_dist, best_threshold = dist, float(threshold)
    return best_threshold


def weighted_precision_f1(truth: np.ndarray,
                          pred: np.ndarray) -> Tuple[float, float]:
    """sklearn's precision_score and f1_score with average="weighted" and
    zero_division=0: per label of the union of both, weighted by its true
    count."""
    classes = np.union1d(truth, pred)
    t = truth[:, None] == classes
    p = pred[:, None] == classes
    tp = (t & p).sum(0).astype(np.float64)
    true_sum = t.sum(0).astype(np.float64)
    pred_sum = p.sum(0).astype(np.float64)
    precision = np.divide(tp, pred_sum, out=np.zeros_like(tp),
                          where=pred_sum != 0)
    denom = true_sum + pred_sum
    f1 = np.divide(2 * tp, denom, out=np.zeros_like(tp), where=denom != 0)
    return (float(np.average(precision, weights=true_sum)),
            float(np.average(f1, weights=true_sum)))


def bootstrap_thresholded_metrics(
    y_pred: np.ndarray, y_true: np.ndarray, labels: Sequence[str],
    n_samples: int = 1000, seed: int = 0,
) -> Dict[str, Dict[str, Tuple[float, float, float]]]:
    """Per label, the weighted F1, the accuracy and the weighted precision
    at the ``find_threshold`` operating point over bootstrap resamples →
    (mean, 2.5%, 97.5%) each (the reference's bootstrap_values.py)."""
    rng = np.random.default_rng(seed)
    n = y_true.shape[0]
    thresholds = [find_threshold(y_pred[:, i], y_true[:, i])
                  for i in range(len(labels))]
    stats: Dict[str, Dict[str, List[float]]] = {
        label: {"f1": [], "acc": [], "precision": []} for label in labels}
    for _ in range(n_samples):
        idx = rng.integers(0, n, n)
        yp, yt = y_pred[idx], y_true[idx]
        for i, label in enumerate(labels):
            pred = (yp[:, i] > thresholds[i]).astype(int)
            truth = yt[:, i].astype(int)
            precision, f1 = weighted_precision_f1(truth, pred)
            stats[label]["f1"].append(f1)
            stats[label]["acc"].append(float(np.mean(truth == pred)))
            stats[label]["precision"].append(precision)
    return {label: {metric: (float(np.mean(vals)),
                             float(np.quantile(vals, 0.025)),
                             float(np.quantile(vals, 0.975)))
                    for metric, vals in lists.items()}
            for label, lists in stats.items()}


def evaluate_external(
    y_pred: np.ndarray, y_true: np.ndarray, labels: Sequence[str], *,
    skip_idx: Sequence[int] = (4, 13),
    merge_max: Dict[int, Tuple[int, ...]] = None,
) -> Dict[str, float]:
    """External-set AUROC with the reference's label remap: the prediction
    columns in ``skip_idx`` are dropped (by default 'Coronary artery wall
    calcification', #4, folded into 'Arterial wall calcification', #1, and
    'Mosaic attenuation pattern', #13, which external sets lack);
    ``merge_max`` maps a kept column to the internal columns max-pooled
    into it (default {1: (1, 4)}).  ``y_true`` has one column per kept
    label, in order."""
    if merge_max is None:
        merge_max = {1: (1, 4)}
    out: Dict[str, float] = {}
    aucs: List[float] = []
    counter = 0
    for i, label in enumerate(labels):
        if i in skip_idx:
            continue
        if i in merge_max:
            prob = np.max(y_pred[:, list(merge_max[i])], axis=1)
        else:
            prob = y_pred[:, i]
        truth = y_true[:, counter]
        counter += 1
        if truth.min() == truth.max():
            out[f"{label}_auc"] = float("nan")
            continue
        auc = rank_auroc(truth, prob)
        out[f"{label}_auc"] = auc
        aucs.append(auc)
    out["mean_auc"] = float(np.mean(aucs)) if aucs else float("nan")
    return out
