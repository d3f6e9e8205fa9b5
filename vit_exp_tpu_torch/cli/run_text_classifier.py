"""Report labeller CLI (counterpart of
vit_exp_tpu/cli/run_text_classifier.py, the reference's
text_classifier/{train,infer}.py).

Usage, on the card:
    python -m vit_exp_tpu_torch.cli.run_text_classifier train \\
        --reports reports.csv --labels labels.csv [--augment 1] \\
        [--scheduler cawr|rlop] [--epochs N] [--vocab vocab.txt]
    python -m vit_exp_tpu_torch.cli.run_text_classifier infer \\
        --reports reports.csv --out predictions.csv [--vocab vocab.txt]

BERT-base at the tokenizer's vocabulary, fp32.  train: the BCE
multi-label loop with the sentence-shuffle augmentation over a holdout
split drawn from ``default_rng(0)`` (the JAX CLI's draws, in its order),
early stop and the plateau scale on the holdout's loss, the best weights
written to ``<results_folder>/best_model.pt``; infer: one row of
probabilities per report into ``--out``.  The CSVs are read and written
with ``csv`` (no pandas on the card's host), with the values pandas gives:
a missing report cell is "", a missing label NaN, each probability the
shortest repr of its fp32 value.  ``main`` returns the trainer (train) or
the probabilities (infer).
"""

from __future__ import annotations

import argparse
import csv
import os

import numpy as np

TEXT_COLUMNS = ("text", "Report", "Findings_EN", "report")


def load_frames(reports_csv, labels_csv=None):
    """(names, texts, labels (N, C) float32 or None, label columns)."""
    from vit_exp_tpu_torch.data.datasets import read_csv_rows

    columns, rows = read_csv_rows(reports_csv)
    text_col = next(c for c in TEXT_COLUMNS if c in columns)
    texts = ["" if isinstance(r[text_col], float) else r[text_col]
             for r in rows]
    names = ([r["VolumeName"] for r in rows] if "VolumeName" in columns
             else list(range(len(texts))))
    labels = label_cols = None
    if labels_csv:
        lcols, lrows = read_csv_rows(labels_csv)
        label_cols = [c for c in lcols if c != "VolumeName"]
        labels = np.asarray([[float(r[c]) for c in label_cols] for r in lrows],
                            dtype=np.float32).reshape(len(lrows),
                                                      len(label_cols))
    return names, texts, labels, label_cols


def write_predictions(path: str, names, probs: np.ndarray, cols) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(["VolumeName", *cols])
        for name, row in zip(names, probs):
            w.writerow([name, *(str(np.float32(v)) for v in row)])


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="run_text_classifier")
    parser.add_argument("mode", choices=["train", "infer"])
    parser.add_argument("--reports", required=True)
    parser.add_argument("--labels", default=None)
    parser.add_argument("--out", default="predictions.csv")
    parser.add_argument("--vocab", default=None)
    parser.add_argument("--augment", type=int, default=0)
    parser.add_argument("--scheduler", default="cawr", choices=["cawr", "rlop"])
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--lr", type=float, default=2e-5)
    parser.add_argument("--max_len", type=int, default=512)
    parser.add_argument("--results_folder", default="./results_text_classifier")
    parser.add_argument("--model_path", default=None,
                        help="weights for infer (default: "
                        "<results_folder>/best_model.pt if present)")
    parser.add_argument("--val_frac", type=float, default=0.1,
                        help="held-out fraction driving early stop / RLOP")
    return parser.parse_args(argv)


def main(argv=None, device="cuda"):
    """Train or infer as the flags say.  ``device`` is the card unless a
    caller (a test) asks for another one: there is no flag for it."""
    args = parse_args(argv)
    import torch

    from vit_exp_tpu_torch.data.tokenizer import load_tokenizer
    from vit_exp_tpu_torch.models.bert import BertConfig
    from vit_exp_tpu_torch.text_classifier.augmentation import (
        shuffle_sentences_augment)
    from vit_exp_tpu_torch.models.factory import init_parameters_
    from vit_exp_tpu_torch.text_classifier.classifier import RadBertClassifier
    from vit_exp_tpu_torch.text_classifier.trainer import TextClassifierTrainer

    tokenizer = load_tokenizer(args.vocab)
    names, texts, labels, label_cols = load_frames(args.reports, args.labels)
    n_classes = labels.shape[1] if labels is not None else 18
    model = RadBertClassifier(BertConfig(vocab_size=tokenizer.vocab_size),
                              n_classes, device=device)
    init_parameters_(model, 0)
    trainer = TextClassifierTrainer(model, lr=args.lr,
                                    scheduler=args.scheduler,
                                    results_folder=args.results_folder)

    if args.mode == "train":
        if labels is None:
            raise ValueError("--labels required for training")
        rng = np.random.default_rng(0)
        n = len(texts)
        perm = rng.permutation(n)
        n_val = max(args.batch_size, int(n * args.val_frac)) if n > 1 else 0
        n_val = min(n_val, max(n - 1, 0))
        val_idx, train_idx = perm[:n_val], perm[n_val:]

        def val_batches():
            for i in range(0, len(val_idx), args.batch_size):
                sel = val_idx[i:i + args.batch_size]
                toks = tokenizer([texts[j] for j in sel],
                                 max_length=args.max_len)
                yield toks["input_ids"], toks["attention_mask"], labels[sel]

        for epoch in range(args.epochs):
            order = rng.permutation(train_idx)
            for start in range(0, len(order), args.batch_size):
                idx = order[start:start + args.batch_size]
                batch_texts = [shuffle_sentences_augment(texts[i], rng=rng)
                               if args.augment else texts[i] for i in idx]
                toks = tokenizer(batch_texts, max_length=args.max_len)
                loss = trainer.fit_batch(toks["input_ids"],
                                         toks["attention_mask"], labels[idx])
            metrics = trainer.evaluate(list(val_batches()))
            print(f"epoch {epoch}: train_loss {loss:.4f} "
                  f"val_loss {metrics['val_loss']:.4f} "
                  f"macro_f1 {metrics['macro_f1']:.4f}", flush=True)
            if trainer.end_epoch(metrics["val_loss"]):
                print("early stop", flush=True)
                break
        path = trainer.save()
        print(f"best-val checkpoint: {path}", flush=True)
        return trainer

    ckpt = args.model_path or os.path.join(args.results_folder,
                                           "best_model.pt")
    if os.path.exists(ckpt):
        trainer.load(ckpt)
        print(f"loaded weights from {ckpt}", flush=True)
    else:
        print(f"WARNING: no checkpoint at {ckpt} — predictions come from "
              "randomly initialized weights", flush=True)
    model.eval()
    rows = []
    with torch.inference_mode():
        for start in range(0, len(texts), args.batch_size):
            toks = tokenizer(texts[start:start + args.batch_size],
                             max_length=args.max_len)
            ids = torch.as_tensor(np.asarray(toks["input_ids"])).long()
            mask = torch.as_tensor(np.asarray(toks["attention_mask"]))
            rows.append(torch.sigmoid(model(ids.to(device), mask.to(device))
                                      ).cpu().numpy())
    probs = np.concatenate(rows)
    cols = label_cols or [f"label_{i}" for i in range(probs.shape[1])]
    write_predictions(args.out, names, probs, cols)
    print(f"wrote {args.out} ({len(probs)} rows)", flush=True)
    return probs


if __name__ == "__main__":
    main()
