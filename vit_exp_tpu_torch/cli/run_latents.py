"""Latent dump and retrieval CLI (counterpart of
vit_exp_tpu/cli/run_latents.py).

Usage, on the card:
    python -m vit_exp_tpu_torch.cli.run_latents --config cfg.yaml \\
        --results_folder out/ (--data_folder tree/ --reports_csv R.csv \\
        --labels_csv L.csv | --synthetic N) [--no-int8] \\
        [--model_path CKPT [--torch_ckpt]] [--retrieval {none,volume,report,both}] \\
        [--topk 5] [--batch_size 4] [--vocab V] [--mesh DATA,1,1] \\
        [--coordinator_address HOST:PORT --num_processes N --process_id I]

``--int8`` (the default, as in the JAX package) encodes on the W8A8
serving path (``int8=True, fuse_qkv=True``), so the dumped latents are
production's; ``--no-int8`` on the bf16 one (attn_impl="pallas_static",
``fuse_qkv=True``).  Weights: seeded random (seed 0) without
``--model_path``; with it the port's checkpoint or, with ``--torch_ckpt``,
a reference ``CTClip.*.pt``.  Data: the ``CTReportInferenceDataset`` of a
CT-RATE npz tree and its CSVs, or ``--synthetic N`` volumes.  Writes
latents.npz and accessions.txt (``eval/latents.py::dump_latents``), then
volume_to_volume.npz and report_to_volume.npz as ``--retrieval`` asks, and
prints one JSON line: "n", "v2v_mean_top1_sim",
"report_to_volume_recall_at_k".

Several cards: the same command once per card with the multi-host flags
(core/multihost.py); each rank encodes ``--batch_size`` volumes of each
global batch and gathers the latents (eval/latents.py); rank 0 alone
prints and writes.  ``--mesh`` must multiply to the process count: the
volumes shard over data × fsdp and every rank holds the whole model, so
the M ranks of a model position repeat its rows; the int8 path takes each
block's k scale over the whole global batch.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from vit_exp_tpu_torch.core import multihost


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="run_latents")
    parser.add_argument("--int8", action=argparse.BooleanOptionalAction,
                        default=True,
                        help="W8A8 serving path (default); --no-int8 for "
                        "bf16")
    parser.add_argument("--config", required=True)
    parser.add_argument("--model_path", default=None)
    parser.add_argument("--torch_ckpt", action="store_true",
                        help="--model_path is a reference CTClip.*.pt")
    parser.add_argument("--results_folder", required=True)
    parser.add_argument("--vocab", default=None)
    parser.add_argument("--data_folder", default=None)
    parser.add_argument("--reports_csv", default=None)
    parser.add_argument("--labels_csv", default=None)
    parser.add_argument("--synthetic", type=int, default=0)
    parser.add_argument("--retrieval", default="both",
                        choices=["none", "volume", "report", "both"])
    parser.add_argument("--topk", type=int, default=5)
    parser.add_argument("--batch_size", type=int, default=4,
                        help="volumes per encode call on each card")
    multihost.add_cli_args(parser)
    return parser.parse_args(argv)


def main(argv=None, device="cuda"):
    """Dump and score as the flags say; prints the JSON summary and returns
    it.  ``device`` is the card unless a caller (a test) asks for another
    one: there is no flag for it."""
    args = parse_args(argv)
    with multihost.process_group(args, device) as device:
        return _dump(args, device)


def _dump(args, device):
    from vit_exp_tpu_torch.core.config import load_config
    from vit_exp_tpu_torch.core.mesh import data_group, mesh_config_from
    from vit_exp_tpu_torch.data.tokenizer import load_tokenizer
    from vit_exp_tpu_torch.eval.latents import (dump_latents,
                                                report_to_volume,
                                                volume_to_volume)
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
    if args.model_path:
        load_model_weights(model, args.model_path, args.torch_ckpt)
    if args.synthetic:
        from vit_exp_tpu_torch.data.synthetic import SyntheticInferenceDataset

        dataset = SyntheticInferenceDataset(args.synthetic, arch=config.arch)
    else:
        from vit_exp_tpu_torch.data.datasets import CTReportInferenceDataset

        dataset = CTReportInferenceDataset(
            args.data_folder, args.reports_csv, args.labels_csv,
            tokenizer=tokenizer)
    engine = ZeroShotClassifier(model, tokenizer, batch_size=args.batch_size,
                                group=group)
    out = dump_latents(engine, dataset, args.results_folder)
    main = multihost.is_main_process()
    summary = {"n": int(out["image_latents"].shape[0])}
    if args.retrieval in ("volume", "both"):
        v2v = volume_to_volume(out["image_latents"], k=args.topk)
        if main:
            np.savez(os.path.join(args.results_folder,
                                  "volume_to_volume.npz"), **v2v)
        summary["v2v_mean_top1_sim"] = float(v2v["similarities"][:, 0].mean())
    if args.retrieval in ("report", "both"):
        r2v = report_to_volume(out["text_latents"], out["image_latents"],
                               k=args.topk)
        if main:
            np.savez(os.path.join(args.results_folder,
                                  "report_to_volume.npz"),
                     indices=r2v["indices"],
                     similarities=r2v["similarities"])
        summary["report_to_volume_recall_at_k"] = r2v["recall_at_k"]
    if main:
        print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
