"""Training CLI (counterpart of vit_exp_tpu/cli/run_train.py).

Usage, on the card:
    python -m vit_exp_tpu_torch.cli.run_train --config cfg.yaml \\
        [--synthetic N] [--synthetic_eval N] [--steps K] \\
        [--resume STEP | --auto_resume] [--debug] \\
        [--vocab path/to/vocab.txt] [--attn_impl {pallas,pallas_static}] \\
        [--ff_impl pallas] [--remat]

YAML config (the JAX package's schema), seeding, the tokenizer, BERT-base
at its vocab size (``text_encoder:`` overrides), CTCLIP with the image
tower at ``attn_impl`` (default "pallas", the online-softmax kernel K15, as
on the JAX package's accelerator; "pallas_static" is the static-max kernel
K1), then ``CTClipTrainer`` with the preemption handler.  ``--debug`` keeps
the logger off wandb.  The JAX CLI's "xla" choices are its CPU path and
have no counterpart here.

Data: ``--synthetic N`` gives N synthetic samples of each
``train_data_list`` entry's type (imagereport, imageseg or imageopenseg;
the masks have 4 classes whatever the seg head's width, as in the JAX
package); otherwise each entry must be ``planted: true``
(``PlantedCTDataset``, ``PlantedSegDataset`` or ``PlantedOpenSegDataset``
by type, ``n`` samples, default 4096).  The in-training eval hooks of
``valid_test_list`` run every ``eval_model_every`` steps and the sample
hooks of ``sample_test_list`` every ``sample_val_every``
(``eval/hooks.py``): on a planted run over ``PlantedInferenceDataset`` (16
volumes, scored on the four planted attributes at 64 tokens),
``PlantedSegInferenceDataset`` (8) and, with ``use_open_seg``,
``PlantedOpenSegDataset`` (2); under ``--synthetic`` or
``--synthetic_eval N`` over ``SyntheticInferenceDataset`` and, with
``use_open_seg``, 2 synthetic open-vocabulary items.

Not ported yet, and refused with NotImplementedError: packed shards,
CT-RATE and RadGenome files (for training and as ``valid_data``), and the
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
    parser.add_argument("--synthetic_eval", type=int, default=0,
                        help="use N synthetic samples for the eval hooks "
                        "while the train data comes from the config")
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
    """With ``synthetic``, one synthetic data set of that many samples per
    ``train_data_list`` entry, of the entry's type; otherwise one planted
    data set per ``planted: true`` entry.  Anything else is not ported
    yet."""
    if synthetic:
        from vit_exp_tpu_torch.data.synthetic import SyntheticCTDataset

        return [SyntheticCTDataset(spec.get("type", "imagereport"),
                                   n=synthetic, arch=config.arch,
                                   tokenizer=tokenizer)
                for spec in (config.train_data_list or [{}])]
    from vit_exp_tpu_torch.data import planted

    datasets = []
    for spec in config.train_data_list:
        dtype = spec.get("type", "imagereport")
        if not spec.get("planted"):
            raise NotImplementedError(
                f"data set {spec.get('name', dtype)!r}: only --synthetic and "
                f"planted data are ported yet; packed shards, CT-RATE and "
                f"RadGenome files come with the real-data slice (ROADMAP M3)")
        # n defaults large enough that short runs are single-epoch
        n = int(spec.get("n", 4096))
        if dtype == "imagereport":
            datasets.append(planted.PlantedCTDataset(
                n, arch=config.arch, tokenizer=tokenizer, max_text_len=64))
        elif dtype == "imageseg":
            datasets.append(planted.PlantedSegDataset(n, arch=config.arch))
        elif dtype == "imageopenseg":
            datasets.append(planted.PlantedOpenSegDataset(
                n, arch=config.arch, tokenizer=tokenizer, max_text_len=64))
        else:
            raise ValueError(f"unknown planted dataset type {dtype!r}")
    return datasets


def build_hooks(config, args: argparse.Namespace, tokenizer):
    """The eval and sample hooks of ``valid_test_list`` and
    ``sample_test_list`` over the run's validation sets: planted held-out
    volumes on a planted run, synthetic ones under --synthetic or
    --synthetic_eval.  Returns build_eval_hooks' {"eval_hooks",
    "sample_hooks"}."""
    from vit_exp_tpu_torch.eval.hooks import build_eval_hooks

    if not (config.valid_test_list or config.sample_test_list):
        return {"eval_hooks": {}, "sample_hooks": {}}
    cls_ds = seg_ds = open_ds = None
    cls_pathologies, cls_max_text_len = None, 512
    use_open_seg = config.ct_clip_arch.use_open_seg
    if any(spec.get("planted") for spec in config.train_data_list):
        from vit_exp_tpu_torch.data import planted

        cls_ds = planted.PlantedInferenceDataset(16, arch=config.arch)
        seg_ds = planted.PlantedSegInferenceDataset(8, arch=config.arch)
        if use_open_seg:
            open_ds = planted.PlantedOpenSegDataset(
                2, arch=config.arch, tokenizer=tokenizer, max_text_len=64)
        cls_pathologies, cls_max_text_len = list(planted.PLANTED_ATTRS), 64
    elif args.synthetic or args.synthetic_eval:
        from vit_exp_tpu_torch.data.synthetic import (SyntheticCTDataset,
                                                      SyntheticInferenceDataset)

        cls_ds = SyntheticInferenceDataset(
            args.synthetic_eval or max(args.synthetic // 2, 2),
            arch=config.arch)
        if use_open_seg:
            open_ds = SyntheticCTDataset("imageopenseg", n=2,
                                         arch=config.arch,
                                         tokenizer=tokenizer, n_classes=4)
    elif config.extra.get("valid_data"):
        raise NotImplementedError(
            "valid_data on CT-RATE and RadGenome files is not ported yet "
            "(ROADMAP M3)")
    return build_eval_hooks(config, tokenizer, cls_dataset=cls_ds,
                            seg_dataset=seg_ds, open_seg_dataset=open_ds,
                            cls_pathologies=cls_pathologies,
                            cls_max_text_len=cls_max_text_len)


def make_trainer(args: argparse.Namespace, device="cuda"):
    """Config → tokenizer → data sets and eval hooks → model on ``device``
    → trainer, restored from a checkpoint when asked."""
    from vit_exp_tpu_torch.core.config import load_config
    from vit_exp_tpu_torch.data.tokenizer import load_tokenizer
    from vit_exp_tpu_torch.models.factory import bert_config_for, build_ctclip
    from vit_exp_tpu_torch.train.trainer import CTClipTrainer

    config = load_config(args.config)
    np.random.seed(config.random_seed)
    torch.manual_seed(config.random_seed)

    tokenizer = load_tokenizer(args.vocab)
    datasets = build_datasets(config, tokenizer, synthetic=args.synthetic)
    hooks = build_hooks(config, args, tokenizer)
    model = build_ctclip(config, bert_config_for(config, tokenizer),
                         device=device, attn_impl=args.attn_impl,
                         remat=args.remat, seed=config.random_seed)
    resume = -1 if args.auto_resume else args.resume
    return CTClipTrainer(model, config, datasets=datasets, resume_step=resume,
                         use_wandb=not args.debug,
                         eval_hooks=hooks["eval_hooks"],
                         sample_hooks=hooks["sample_hooks"])


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
