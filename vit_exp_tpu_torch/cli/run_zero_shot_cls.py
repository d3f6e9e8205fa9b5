"""Zero-shot classification CLI, the batch scoring entry point (counterpart
of vit_exp_tpu/cli/run_zero_shot_cls.py, the reference's
run_zero_shot_cls_single_gpu.py).

Usage, on the card:
    python -m vit_exp_tpu_torch.cli.run_zero_shot_cls --config cfg.yaml \\
        --results_folder out/ [--model_path CKPT ...] [--torch_ckpt] \\
        (--data_folder TREE | --packed_root STORE) --reports_csv R.csv \\
        --labels_csv L.csv [--no-int8] [--batch_size 4] [--vocab V]
    ... --synthetic N | --planted N
    ... [--mesh DATA,1,1] [--coordinator_address HOST:PORT \\
         --num_processes N --process_id I]

``--int8`` (the default, as in the JAX package) builds the W8A8 serving
path (``int8=True, fuse_qkv=True``); ``--no-int8`` the bf16 one
(attn_impl="pallas_static", ``fuse_qkv=True``).  The data: an npz tree
(``--data_folder``, data/datasets.py) or a packed store (``--packed_root``,
data/packed.py, written by cli/pack_dataset.py) joined to the labels CSV
(and the reports CSV), N synthetic volumes, or N held-out planted volumes
scored on the four planted attributes with 64-token prompts.

``--model_path`` may be given several times: a checkpoint sweep.  One
engine scores them all; each checkpoint is loaded into the same model in
place (``train/checkpoint.py::load_model_weights``: the port's
``ckpt_{step}/`` or ``checkpoints/`` directory, or with ``--torch_ckpt`` a
reference ``CTClip.*.pt``), then ``set_params()`` drops the prompt cache.
The int8 path quantizes its weights on every call, so nothing else holds
the old weights; a future cache of quantized weights must be keyed on the
parameters' version for this loop to stay right.  Without ``--model_path``
the seeded random weights (seed 0) are scored as "random_init".  For each
checkpoint the per-label AUROCs, ``mean_auc`` and ``volumes_per_sec`` are
printed as one JSON line (with "model", the checkpoint's base name) and the
inference artifacts written to ``results_folder/<model>/``.

A JAX (Orbax) checkpoint cannot be read without jax: export it on a host
with jax through ``vit_exp_tpu.models.convert.export_ctclip_state_dict``
and pass the ``.pt`` with ``--torch_ckpt``.

Several cards: the same command once per card with the multi-host flags
(core/multihost.py); each rank encodes ``--batch_size`` volumes of each
global batch and gathers the probabilities (eval/zero_shot.py), so every
rank computes the same AUROCs; rank 0 alone prints and writes the output
files.  ``--mesh`` must multiply to the process count: the volumes
shard over data × fsdp and every rank holds the whole model, as JAX's
engines do, so the M ranks of a model position repeat its rows; the int8
path takes each block's k scale over the whole global batch, as JAX's
mesh does.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict

from vit_exp_tpu_torch.core import multihost


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="run_zero_shot_cls")
    parser.add_argument("--int8", action=argparse.BooleanOptionalAction,
                        default=True,
                        help="W8A8 serving path (default); --no-int8 for "
                        "bf16")
    parser.add_argument("--config", required=True)
    parser.add_argument("--model_path", action="append", default=[],
                        help="a checkpoint to score; repeat for a sweep")
    parser.add_argument("--results_folder", required=True)
    parser.add_argument("--vocab", default=None)
    parser.add_argument("--data_folder", default=None,
                        help="a preprocessed CT-RATE npz tree")
    parser.add_argument("--packed_root", default=None,
                        help="a packed store (cli/pack_dataset.py) instead "
                        "of an npz tree")
    parser.add_argument("--reports_csv", default=None)
    parser.add_argument("--labels_csv", default=None)
    parser.add_argument("--synthetic", type=int, default=0)
    parser.add_argument("--planted", type=int, default=0,
                        help="score N held-out planted volumes (seed 1) on "
                        "the four planted attributes")
    parser.add_argument("--torch_ckpt", action="store_true",
                        help="--model_path is a reference CTClip.*.pt")
    parser.add_argument("--batch_size", type=int, default=4,
                        help="volumes per encode call on each card")
    multihost.add_cli_args(parser)
    args = parser.parse_args(argv)
    if not (args.planted or args.synthetic or args.packed_root
            or args.data_folder):
        parser.error("give --data_folder, --packed_root, --synthetic or "
                     "--planted")
    if (args.packed_root and not args.labels_csv) or (
            args.data_folder and not (args.labels_csv and args.reports_csv)):
        parser.error("--data_folder needs --reports_csv and --labels_csv; "
                     "--packed_root needs --labels_csv")
    return args


def build_dataset(args, config, tokenizer):
    """(data set, the engine's keyword arguments) as the flags say."""
    if args.planted:
        from vit_exp_tpu_torch.data import planted

        return (planted.PlantedInferenceDataset(args.planted,
                                                arch=config.arch, seed=1),
                dict(pathologies=list(planted.PLANTED_ATTRS),
                     max_text_len=64))
    if args.synthetic:
        from vit_exp_tpu_torch.data.synthetic import SyntheticInferenceDataset

        return SyntheticInferenceDataset(args.synthetic, arch=config.arch), {}
    if args.packed_root:
        from vit_exp_tpu_torch.data.packed import CTReportPackedInferenceDataset

        return CTReportPackedInferenceDataset(
            args.packed_root, args.labels_csv, args.reports_csv), {}
    from vit_exp_tpu_torch.data.datasets import CTReportInferenceDataset

    return CTReportInferenceDataset(args.data_folder, args.reports_csv,
                                    args.labels_csv, tokenizer=tokenizer), {}


def main(argv=None, device="cuda") -> Dict[str, Dict[str, float]]:
    """Score as the flags say; prints one JSON line per checkpoint and
    returns {model: result}.  ``device`` is the card unless a caller (a
    test) asks for another one: there is no flag for it."""
    args = parse_args(argv)
    with multihost.process_group(args, device) as device:
        return _score(args, device)


def _score(args, device) -> Dict[str, Dict[str, float]]:
    from vit_exp_tpu_torch.core.config import load_config
    from vit_exp_tpu_torch.core.mesh import data_group, mesh_config_from
    from vit_exp_tpu_torch.data.tokenizer import load_tokenizer
    from vit_exp_tpu_torch.eval.zero_shot import ZeroShotClassifier
    from vit_exp_tpu_torch.models.factory import bert_config_for, build_ctclip
    from vit_exp_tpu_torch.train.checkpoint import load_model_weights

    config = load_config(args.config)
    group = data_group(mesh_config_from(config, args.mesh))
    tokenizer = load_tokenizer(args.vocab)
    mode = (dict(int8=True) if args.int8
            else dict(attn_impl="pallas_static"))
    model = build_ctclip(config, bert_config_for(config, tokenizer),
                         device=device, fuse_qkv=True, **mode)
    dataset, engine_kw = build_dataset(args, config, tokenizer)
    engine = ZeroShotClassifier(model, tokenizer, batch_size=args.batch_size,
                                group=group, **engine_kw)
    out = {}
    for path in args.model_path or [None]:
        tag = "random_init"
        if path is not None:
            load_model_weights(model, path, args.torch_ckpt)
            engine.set_params()
            tag = os.path.basename(os.path.normpath(path))
        res = engine.infer(dataset, results_folder=os.path.join(
            args.results_folder, tag))
        if multihost.is_main_process():
            print(json.dumps({"model": tag, **res}), flush=True)
        out[tag] = res
    return out


if __name__ == "__main__":
    main()
