"""Zero-shot segmentation CLI, the seg serving entry point (counterpart of
vit_exp_tpu/cli/run_zero_shot_seg.py).

Usage, on the card:
    python -m vit_exp_tpu_torch.cli.run_zero_shot_seg --config cfg.yaml \\
        --results_folder out/ (--data_folder imgs/ --mask_folder masks/ |
        --synthetic N) [--no-int8] [--model_path CKPT [--torch_ckpt]] \\
        [--batch_size B] [--vocab V] [--mesh DATA,1,1] \\
        [--coordinator_address HOST:PORT --num_processes N --process_id I]

The config must switch on ``use_seg``.  ``--int8`` (the default, as in the
JAX package) builds the W8A8 serving path (``int8=True, fuse_qkv=True``);
``--no-int8`` the bf16 one (attn_impl="pallas_static", ``fuse_qkv=True``);
the seg head is a plain bf16 product either way.  Weights: seeded random
(seed 0) without ``--model_path``; with it, the port's own
checkpoint (a ``ckpt_{step}/`` directory, or a ``checkpoints/`` directory
whose latest step is taken), or with ``--torch_ckpt`` a reference
``CTClip.*.pt`` state dict.  ``--synthetic N`` scores N synthetic volumes
with masks of the seg head's ``out_dim`` classes; without it the
``CTSegDataset`` of ``--data_folder`` and ``--mask_folder`` (pre-cropped
image and mask npz, as the JAX CLI reads them; with neither given it
raises JAX's TypeError).  Prints the dice result (``dice_class_{i}``,
``mean_dice``) as one JSON line and writes dice_scores.npy and
dice_scores.txt into the results folder.

Several cards: the same command once per card with the multi-host flags
(core/multihost.py); each rank scores ``--batch_size`` volumes of each
global batch and gathers the dice rows (eval/zero_shot.py); rank 0 alone
prints and writes.  ``--mesh`` must multiply to the process count: the
volumes shard over data × fsdp and every rank holds the whole model, as
JAX's engines do, so the M ranks of a model position repeat its rows;
the int8 path takes each block's k scale over the whole global batch.
"""

from __future__ import annotations

import argparse
import json

from vit_exp_tpu_torch.core import multihost
from vit_exp_tpu_torch.train.checkpoint import load_model_weights

# the loader all three serving CLIs share, under its former name here
load_weights = load_model_weights


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="run_zero_shot_seg")
    parser.add_argument("--int8", action=argparse.BooleanOptionalAction,
                        default=True,
                        help="W8A8 serving path (default); --no-int8 for "
                        "bf16")
    parser.add_argument("--config", required=True)
    parser.add_argument("--model_path", default=None)
    parser.add_argument("--results_folder", required=True)
    parser.add_argument("--data_folder", default=None)
    parser.add_argument("--mask_folder", default=None)
    parser.add_argument("--synthetic", type=int, default=0)
    parser.add_argument("--torch_ckpt", action="store_true",
                        help="--model_path is a reference CTClip.*.pt")
    parser.add_argument("--vocab", default=None)
    parser.add_argument("--batch_size", type=int, default=1,
                        help="volumes per dice call on each card")
    multihost.add_cli_args(parser)
    return parser.parse_args(argv)


def main(argv=None, device="cuda"):
    """Score as the flags say; prints the JSON result and returns it.
    ``device`` is the card unless a caller (a test) asks for another one:
    there is no flag for it."""
    args = parse_args(argv)
    with multihost.process_group(args, device) as device:
        return _score(args, device)


def _score(args, device):
    from vit_exp_tpu_torch.core.config import load_config
    from vit_exp_tpu_torch.core.mesh import data_group, mesh_config_from
    from vit_exp_tpu_torch.data.datasets import CTSegDataset
    from vit_exp_tpu_torch.data.synthetic import SyntheticCTDataset
    from vit_exp_tpu_torch.data.tokenizer import load_tokenizer
    from vit_exp_tpu_torch.eval.zero_shot import ZeroShotSegmenter
    from vit_exp_tpu_torch.models.factory import bert_config_for, build_ctclip

    config = load_config(args.config)
    if not config.ct_clip_arch.use_seg:
        raise ValueError("run_zero_shot_seg needs a config with use_seg")
    group = data_group(mesh_config_from(config, args.mesh))
    bert = bert_config_for(config, load_tokenizer(args.vocab))
    mode = (dict(int8=True) if args.int8
            else dict(attn_impl="pallas_static"))
    model = build_ctclip(config, bert, device=device, fuse_qkv=True, **mode)
    if args.model_path:
        load_model_weights(model, args.model_path, args.torch_ckpt)
    if args.synthetic:
        dataset = SyntheticCTDataset(
            "imageseg", n=args.synthetic, arch=config.arch,
            n_classes=config.ct_clip_arch.seg_head.out_dim)
    else:
        dataset = CTSegDataset(args.data_folder, args.mask_folder)
    engine = ZeroShotSegmenter(model, batch_size=args.batch_size, group=group)
    res = engine.infer(dataset, results_folder=args.results_folder)
    if multihost.is_main_process():
        print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
