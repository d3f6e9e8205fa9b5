"""Training CLI (counterpart of vit_exp_tpu/cli/run_train.py).

Usage, on the card:
    python -m vit_exp_tpu_torch.cli.run_train --config cfg.yaml \\
        [--synthetic N] [--synthetic_eval N] [--steps K] \\
        [--resume STEP | --auto_resume] [--debug] \\
        [--vocab path/to/vocab.txt] [--attn_impl {pallas,pallas_static}] \\
        [--ff_impl pallas] [--remat] [--mesh DATA,FSDP,MODEL] \\
        [--coordinator_address HOST:PORT --num_processes N --process_id I]

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
package).  Otherwise each entry names its data, by type and with the
reference YAML's key names as aliases (a missing key raises KeyError):

- ``planted: true``: ``PlantedCTDataset``, ``PlantedSegDataset`` or
  ``PlantedOpenSegDataset`` by type, ``n`` samples (default 4096);
- imagereport: ``CTReportDataset`` over a CT-RATE npz tree
  (``data_folder``/``data_train``, ``reports_csv``/``reports_file_train``)
  or, with ``packed: true``, ``CTReportPackedDataset`` over a store
  (``data_folder``/``data_train``, the CSV optional);
- imageseg: ``CTSegDataset`` (``data_folder``/``seg_data_train``,
  ``mask_folder``/``seg_mask_train``);
- imageopenseg: ``CTOpenSegDataset`` (those two and
  ``seg_mask_name_table``, ``seg_mask_prompt_type`` default
  "this_region").

The in-training eval hooks of ``valid_test_list`` run every
``eval_model_every`` steps and the sample hooks of ``sample_test_list``
every ``sample_val_every`` (``eval/hooks.py``): on a planted run over
``PlantedInferenceDataset`` (16 volumes, scored on the four planted
attributes at 64 tokens), ``PlantedSegInferenceDataset`` (8) and, with
``use_open_seg``, ``PlantedOpenSegDataset`` (2); under ``--synthetic`` or
``--synthetic_eval N`` over ``SyntheticInferenceDataset`` and, with
``use_open_seg``, 2 synthetic open-vocabulary items; otherwise over the
config's ``valid_data`` sets: ``cls`` (``CTReportInferenceDataset``:
``data_folder``, ``reports_csv``, ``labels_csv``), ``seg``
(``CTSegDataset``) and ``open_seg`` (``CTOpenSegDataset``).  The git
state (``git log -1``, ``git status --short`` of the working directory)
goes to ``<results_folder>/git_state.txt`` first.

Several cards (data parallelism): run the same command once per card,
with ``--coordinator_address`` (rank 0's host and a free port),
``--num_processes`` and ``--process_id`` (or torchrun's variables;
core/multihost.py), which join the NCCL group before any CUDA work; each
process trains on ``cuda:<local rank>``.  ``--mesh DATA,FSDP,MODEL`` (or
the config's ``mesh:`` section) must multiply to the process count; the
batch shards over data × fsdp, fsdp > 1 shards the parameters over the
fsdp ranks and model > 1 cuts the heads and MLP units over the model
ranks (core/mesh.py, parallel/sharding.py).  The trainer shards the data
and takes the global-batch terms over the batch group
(train/trainer.py); rank 0 writes git_state.txt, the metrics and the
checkpoints, whole, so any grid resumes them.  ``main`` leaves the group it joined before it returns.
"""

from __future__ import annotations

import argparse
import os
import subprocess

import numpy as np
import torch

from vit_exp_tpu_torch.core import multihost


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
    multihost.add_cli_args(parser)
    return parser.parse_args(argv)


def _get(spec, *names):
    """The first of ``names`` the data set spec holds (the port's names and
    the reference YAML's)."""
    for n in names:
        if spec.get(n) is not None:
            return spec[n]
    raise KeyError(f"dataset spec needs one of {names}: {spec}")


def _planted_dataset(spec, config, tokenizer):
    from vit_exp_tpu_torch.data import planted

    dtype = spec.get("type", "imagereport")
    # n defaults large enough that short runs are single-epoch
    n = int(spec.get("n", 4096))
    if dtype == "imagereport":
        return planted.PlantedCTDataset(n, arch=config.arch,
                                        tokenizer=tokenizer, max_text_len=64)
    if dtype == "imageseg":
        return planted.PlantedSegDataset(n, arch=config.arch)
    if dtype == "imageopenseg":
        return planted.PlantedOpenSegDataset(
            n, arch=config.arch, tokenizer=tokenizer, max_text_len=64)
    raise ValueError(f"unknown planted dataset type {dtype!r}")


def build_datasets(config, tokenizer, synthetic: int = 0):
    """With ``synthetic``, one synthetic data set of that many samples per
    ``train_data_list`` entry, of the entry's type; otherwise each entry's
    planted data set or data set over files (the module docstring)."""
    if synthetic:
        from vit_exp_tpu_torch.data.synthetic import SyntheticCTDataset

        return [SyntheticCTDataset(spec.get("type", "imagereport"),
                                   n=synthetic, arch=config.arch,
                                   tokenizer=tokenizer)
                for spec in (config.train_data_list or [{}])]
    from vit_exp_tpu_torch.data.datasets import (CTOpenSegDataset,
                                                 CTReportDataset,
                                                 CTSegDataset)
    from vit_exp_tpu_torch.data.packed import CTReportPackedDataset

    datasets = []
    for spec in config.train_data_list:
        dtype = spec.get("type", "imagereport")
        if spec.get("planted"):
            datasets.append(_planted_dataset(spec, config, tokenizer))
        elif dtype == "imagereport" and spec.get("packed"):
            datasets.append(CTReportPackedDataset(
                _get(spec, "data_folder", "data_train"),
                spec.get("reports_csv") or spec.get("reports_file_train"),
                tokenizer=tokenizer))
        elif dtype == "imagereport":
            datasets.append(CTReportDataset(
                _get(spec, "data_folder", "data_train"),
                _get(spec, "reports_csv", "reports_file_train"),
                tokenizer=tokenizer))
        elif dtype == "imageseg":
            datasets.append(CTSegDataset(
                _get(spec, "data_folder", "seg_data_train"),
                _get(spec, "mask_folder", "seg_mask_train")))
        elif dtype == "imageopenseg":
            datasets.append(CTOpenSegDataset(
                _get(spec, "data_folder", "seg_data_train"),
                _get(spec, "mask_folder", "seg_mask_train"),
                _get(spec, "seg_mask_name_table"), tokenizer=tokenizer,
                seg_mask_prompt_type=spec.get("seg_mask_prompt_type",
                                              "this_region")))
        else:
            raise ValueError(f"unknown dataset type {dtype!r}")
    return datasets


def valid_datasets(valid: dict, tokenizer):
    """The (cls, seg, open_seg) validation sets of a config's
    ``valid_data``; None where it names none."""
    from vit_exp_tpu_torch.data.datasets import (CTOpenSegDataset,
                                                 CTReportInferenceDataset,
                                                 CTSegDataset)

    cls_ds = seg_ds = open_ds = None
    if "cls" in valid:
        v = valid["cls"]
        cls_ds = CTReportInferenceDataset(
            v["data_folder"], v["reports_csv"], v["labels_csv"],
            tokenizer=tokenizer)
    if "seg" in valid:
        seg_ds = CTSegDataset(valid["seg"]["data_folder"],
                              valid["seg"]["mask_folder"])
    if "open_seg" in valid:
        v = valid["open_seg"]
        open_ds = CTOpenSegDataset(v["data_folder"], v["mask_folder"],
                                   v["seg_mask_name_table"],
                                   tokenizer=tokenizer)
    return cls_ds, seg_ds, open_ds


def build_hooks(config, args: argparse.Namespace, tokenizer):
    """The eval and sample hooks of ``valid_test_list`` and
    ``sample_test_list`` over the run's validation sets: planted held-out
    volumes on a planted run, synthetic ones under --synthetic or
    --synthetic_eval, else the config's ``valid_data``.  Returns
    build_eval_hooks' {"eval_hooks", "sample_hooks"}."""
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
        cls_ds, seg_ds, open_ds = valid_datasets(config.extra["valid_data"],
                                                 tokenizer)
    return build_eval_hooks(config, tokenizer, cls_dataset=cls_ds,
                            seg_dataset=seg_ds, open_seg_dataset=open_ds,
                            cls_pathologies=cls_pathologies,
                            cls_max_text_len=cls_max_text_len)


def write_git_state(results_folder: str) -> None:
    """``git log -1`` and ``git status --short`` of the working directory
    into ``results_folder``/git_state.txt (empty where git has nothing to
    say; no file where git cannot run)."""
    os.makedirs(results_folder, exist_ok=True)
    try:
        out = [subprocess.run(cmd, capture_output=True, text=True).stdout
               for cmd in (["git", "log", "-1"], ["git", "status",
                                                  "--short"])]
    except OSError:
        return
    with open(os.path.join(results_folder, "git_state.txt"), "w") as f:
        f.writelines(o + "\n" for o in out)


def make_trainer(args: argparse.Namespace, device="cuda"):
    """Config → tokenizer → data sets and eval hooks → model on ``device``
    → trainer, restored from a checkpoint when asked."""
    from vit_exp_tpu_torch.core.config import load_config
    from vit_exp_tpu_torch.core.mesh import MeshConfig, mesh_config_from
    from vit_exp_tpu_torch.data.tokenizer import load_tokenizer
    from vit_exp_tpu_torch.models.factory import bert_config_for, build_ctclip
    from vit_exp_tpu_torch.train.trainer import CTClipTrainer

    config = load_config(args.config)
    mesh_config = mesh_config_from(config, args.mesh)
    # a grid that does not fit raises before any work
    (mesh_config or MeshConfig()).axis_sizes(multihost.process_count())
    if multihost.is_main_process():
        write_git_state(config.results_folder)
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
                         sample_hooks=hooks["sample_hooks"],
                         mesh_config=mesh_config)


def main(argv=None, device="cuda"):
    """Train as the flags say; returns the trainer (its ``status`` is
    "completed" or "preempted").  ``device`` is the card unless a caller
    (a test) asks for another one: there is no flag for it.  With the
    multi-host flags the process group (NCCL on the card, gloo on the CPU)
    is joined first and left at the end."""
    args = parse_args(argv)
    with multihost.process_group(args, device) as device:
        trainer = make_trainer(args, device)
        trainer.install_preemption_handler()
        trainer.train(num_steps=args.steps)
        return trainer


if __name__ == "__main__":
    main()
