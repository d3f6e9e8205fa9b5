"""Training CLI (counterpart of vit_exp_tpu/cli/run_train.py).

Usage, on the card:
    python -m vit_exp_tpu_torch.cli.run_train --config cfg.yaml \\
        --synthetic N [--steps K] [--resume STEP | --auto_resume] [--debug] \\
        [--vocab path/to/vocab.txt] [--attn_impl {pallas,pallas_static}] \\
        [--ff_impl pallas] [--remat]

YAML config (the JAX package's schema), seeding, the tokenizer, BERT-base
at its vocab size (``text_encoder:`` overrides), CTCLIP with the image
tower at ``attn_impl`` (default "pallas", the online-softmax kernel K15, as
on the JAX package's accelerator; "pallas_static" is the static-max kernel
K1), then ``CTClipTrainer`` with the preemption handler.  ``--debug`` keeps
the logger off wandb.  The JAX CLI's "xla" choices are its CPU path and
have no counterpart here.

Not ported yet, and refused with NotImplementedError: the in-training eval
and sample hooks (``valid_test_list``/``sample_test_list``), every data set
but ``--synthetic`` (packed, CT-RATE, planted, segmentation), and the
multi-device flags (``--mesh`` and the multi-host flags).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

_NOT_PORTED = ("--mesh", "--coordinator_address", "--num_processes",
               "--process_id")


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="run_train")
    parser.add_argument("--config", required=True)
    parser.add_argument("--resume", type=int, default=None)
    parser.add_argument("--auto_resume", action="store_true")
    parser.add_argument("--debug", action="store_true",
                        help="keep the metric logger off wandb")
    parser.add_argument("--steps", type=int, default=None)
    parser.add_argument("--vocab", default=None, help="HF vocab.txt path")
    parser.add_argument("--synthetic", type=int, default=0,
                        help="use N synthetic samples per dataset")
    parser.add_argument("--attn_impl", default="pallas",
                        choices=["pallas", "pallas_static"])
    parser.add_argument("--ff_impl", default="pallas", choices=["pallas"],
                        help="accepted so the JAX CLI's command lines parse; "
                        "the feed-forward always runs the GEGLU kernel K2")
    parser.add_argument("--remat", action="store_true",
                        help="recompute each image-tower block's forward in "
                        "the backward (less activation memory)")
    for flag in _NOT_PORTED:
        parser.add_argument(flag, default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    given = [f for f in _NOT_PORTED if getattr(args, f[2:]) is not None]
    if given:
        raise NotImplementedError(
            f"{given}: multi-device training is not ported yet (the "
            f"multi-GPU and ring-attention slice brings it)")
    return args


def build_datasets(config, tokenizer, synthetic: int = 0):
    """One synthetic image-report data set of ``synthetic`` samples per
    ``train_data_list`` entry; anything else is not ported yet."""
    from vit_exp_tpu_torch.data.synthetic import SyntheticCTDataset

    if not synthetic:
        raise NotImplementedError(
            "only --synthetic data is ported yet; packed shards, CT-RATE, "
            "planted and segmentation data sets come with a later slice")
    return [SyntheticCTDataset(spec.get("type", "imagereport"), n=synthetic,
                               arch=config.arch, tokenizer=tokenizer)
            for spec in (config.train_data_list or [{}])]


def make_trainer(args: argparse.Namespace, device="cuda"):
    """Config → tokenizer → model on ``device`` → data sets → trainer,
    restored from a checkpoint when asked."""
    from vit_exp_tpu_torch.core.config import load_config
    from vit_exp_tpu_torch.data.tokenizer import load_tokenizer
    from vit_exp_tpu_torch.models.factory import bert_config_for, build_ctclip
    from vit_exp_tpu_torch.train.trainer import CTClipTrainer

    config = load_config(args.config)
    if config.valid_test_list or config.sample_test_list:
        raise NotImplementedError(
            "in-training eval and sample hooks (valid_test_list, "
            "sample_test_list) are not ported yet; drop them from the config")
    np.random.seed(config.random_seed)
    torch.manual_seed(config.random_seed)

    tokenizer = load_tokenizer(args.vocab)
    datasets = build_datasets(config, tokenizer, synthetic=args.synthetic)
    model = build_ctclip(config, bert_config_for(config, tokenizer),
                         device=device, attn_impl=args.attn_impl,
                         remat=args.remat, seed=config.random_seed)
    resume = -1 if args.auto_resume else args.resume
    return CTClipTrainer(model, config, datasets=datasets, resume_step=resume,
                         use_wandb=not args.debug)


def main(argv=None, device="cuda"):
    """Train as the flags say; returns the trainer (its ``status`` is
    "completed" or "preempted").  ``device`` is the card unless a caller
    (a test) asks for another one: there is no flag for it."""
    args = parse_args(argv)
    trainer = make_trainer(args, device)
    trainer.install_preemption_handler()
    trainer.train(num_steps=args.steps)
    return trainer


if __name__ == "__main__":
    main()
