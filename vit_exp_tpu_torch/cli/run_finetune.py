"""Fine-tuning CLI (counterpart of vit_exp_tpu/cli/run_finetune.py): the
reference's ct_lipro_train.py and ct_vocabfine_train.py, and the probe's
ct_lipro_inference.py evaluation.

Usage, on the card:
    python -m vit_exp_tpu_torch.cli.run_finetune lipro --config cfg.yaml \\
        [--pretrained CKPT [--torch_ckpt]] [--synthetic N] [--epochs N] \\
        [--lr ...] [--save_path head.pt]
    python -m vit_exp_tpu_torch.cli.run_finetune lipro --config cfg.yaml \\
        [--pretrained CKPT] --infer --load_head head.pt --results_folder out/
    python -m vit_exp_tpu_torch.cli.run_finetune vocabfine --config cfg.yaml \\
        [--pretrained CKPT [--torch_ckpt]] [--synthetic N] \\
        [--save_path CTClip.ft.pt]

The model is built as the JAX CLI builds it on its accelerator, with the
online-softmax attention (attn_impl="pallas", K15), bf16, and loaded from
``--pretrained`` (the port's ``ckpt_{step}/`` or ``checkpoints/``
directory, or with ``--torch_ckpt`` a reference ``CTClip.*.pt``; a JAX
Orbax checkpoint is exported to a ``.pt`` on a host with jax first), or
left at its seeded random weights.  Data: ``--synthetic N`` synthetic
volumes, or a CT-RATE npz tree (``--data_folder``, ``--reports_csv``,
``--labels_csv``).

lipro trains the probe on frozen latents, one optimizer step per batch
(horizon epochs · max(n // batch_size, 1)), and saves the head as a torch
file (the JAX package's msgpack heads are not read); ``--infer`` loads a
head and writes the reference artifacts.  vocabfine fine-tunes the whole
model, one step per volume (horizon epochs · n), and saves a
reference-layout ``CTClip.*.pt`` (``save_reference_checkpoint``; with
``--torch_ckpt`` the original's values for the keys the port
synthesizes), which ``run_zero_shot_cls --torch_ckpt`` scores.  ``main``
returns the trainer (or, with ``--infer``, the result dict).
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="run_finetune")
    parser.add_argument("mode", choices=["lipro", "vocabfine"])
    parser.add_argument("--config", required=True)
    parser.add_argument("--pretrained", default=None,
                        help="the port's checkpoint directory (or, with "
                        "--torch_ckpt, a reference .pt); random weights if "
                        "absent")
    parser.add_argument("--torch_ckpt", action="store_true")
    parser.add_argument("--vocab", default=None)
    parser.add_argument("--data_folder", default=None)
    parser.add_argument("--reports_csv", default=None)
    parser.add_argument("--labels_csv", default=None)
    parser.add_argument("--synthetic", type=int, default=0)
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--wd", type=float, default=0.1)
    parser.add_argument("--batch_size", type=int, default=2)
    parser.add_argument("--max_text_len", type=int, default=512,
                        help="vocabfine prompt tokenization length")
    parser.add_argument("--save_path", default=None,
                        help="lipro: the probe head out (a torch file); "
                        "vocabfine: a reference-layout CTClip .pt out")
    parser.add_argument("--infer", action="store_true",
                        help="lipro only: evaluate a trained probe and write "
                        "the artifacts")
    parser.add_argument("--load_head", default=None,
                        help="probe head to load before --infer")
    parser.add_argument("--results_folder", default=None,
                        help="artifact folder for --infer")
    args = parser.parse_args(argv)
    if args.infer and args.mode != "lipro":
        parser.error("--infer is lipro-only; evaluate a vocabfine export "
                     "with run_zero_shot_cls --torch_ckpt")
    if args.infer and not args.load_head:
        parser.error("--infer requires --load_head (a trained probe head); "
                     "without it the random-init head would be evaluated")
    if args.torch_ckpt and not args.pretrained:
        parser.error("--torch_ckpt requires --pretrained (the reference "
                     ".pt checkpoint it qualifies)")
    return args


def build_dataset(args, config, tokenizer):
    if args.synthetic:
        from vit_exp_tpu_torch.data.synthetic import SyntheticInferenceDataset

        return SyntheticInferenceDataset(args.synthetic, arch=config.arch)
    from vit_exp_tpu_torch.data.datasets import CTReportInferenceDataset

    return CTReportInferenceDataset(args.data_folder, args.reports_csv,
                                    args.labels_csv, tokenizer=tokenizer)


def main(argv=None, device="cuda"):
    """Fine-tune as the flags say.  ``device`` is the card unless a caller
    (a test) asks for another one: there is no flag for it."""
    args = parse_args(argv)
    import torch

    from vit_exp_tpu_torch.core.config import load_config
    from vit_exp_tpu_torch.data.tokenizer import load_tokenizer
    from vit_exp_tpu_torch.models.factory import bert_config_for, build_ctclip
    from vit_exp_tpu_torch.train.checkpoint import load_model_weights

    config = load_config(args.config)
    tokenizer = load_tokenizer(args.vocab)
    model = build_ctclip(config, bert_config_for(config, tokenizer),
                         device=device, attn_impl="pallas")
    if args.pretrained:
        load_model_weights(model, args.pretrained, args.torch_ckpt)
    dataset = build_dataset(args, config, tokenizer)

    if args.mode == "lipro":
        from vit_exp_tpu_torch.finetune.lipro import LiProTrainer

        total = args.epochs * max(len(dataset) // args.batch_size, 1)
        trainer = LiProTrainer(model, lr=args.lr or 1e-3, wd=args.wd,
                               total_steps=total)
        if args.infer:
            trainer.load(args.load_head)
            res = trainer.infer(dataset, results_folder=args.results_folder,
                                batch_size=args.batch_size)
            print(json.dumps(res, indent=2))
            return res
        for epoch in range(args.epochs):
            for start in range(0, len(dataset), args.batch_size):
                items = [dataset[i] for i in range(
                    start, min(start + args.batch_size, len(dataset)))]
                loss = trainer.fit_batch(
                    np.stack([it["image"] for it in items]),
                    np.stack([it["onehot"][:18] for it in items]))
            print(f"epoch {epoch}: loss {loss:.4f}", flush=True)
        if args.save_path:
            trainer.save(args.save_path)
            print(f"saved probe head → {args.save_path}", flush=True)
        return trainer

    from vit_exp_tpu_torch.finetune.vocabfine import VocabFineTrainer
    from vit_exp_tpu_torch.models.convert import save_reference_checkpoint

    trainer = VocabFineTrainer(model, tokenizer, lr=args.lr or 5e-6,
                               wd=args.wd,
                               total_steps=args.epochs * len(dataset),
                               max_text_len=args.max_text_len)
    for epoch in range(args.epochs):
        for i in range(len(dataset)):
            item = dataset[i]
            loss = trainer.fit_batch(item["image"][None], item["onehot"][:18])
        print(f"epoch {epoch}: loss {loss:.4f}", flush=True)
    if args.save_path:
        like = (torch.load(args.pretrained, map_location="cpu",
                           weights_only=True) if args.torch_ckpt else None)
        save_reference_checkpoint(args.save_path, model, like=like)
        print(f"saved reference-layout checkpoint → {args.save_path}",
              flush=True)
    return trainer


if __name__ == "__main__":
    main()
