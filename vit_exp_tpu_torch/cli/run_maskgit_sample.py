"""Text → CT video generation CLI (counterpart of
vit_exp_tpu/cli/run_maskgit_sample.py) over a trained CTViT VQGAN and
MaskGit, conditioned on T5 encoder states (models/t5_adapter.py; needs
transformers).

Usage, on the card:
    python -m vit_exp_tpu_torch.cli.run_maskgit_sample --results_folder out/ \\
        --prompt "chest CT with small left pleural effusion" \\
        [--prompt "follow-up scene" ...]   # >1 prompt chains scenes
        [--ctvit_checkpoint DIR_OR_PT --ctvit_step N] \\
        [--maskgit_checkpoint DIR --maskgit_step N] \\
        [--t5_pretrained PATH] [--num_frames 17 --steps 18 --cond_scale 5.0]

``--ctvit_checkpoint`` takes a ``CTViTTrainer`` checkpoints/ directory or a
reference CTViT ``.pt``; ``--maskgit_checkpoint`` a ``MaskGITTrainer.save``
directory (its ``model.pt``).  Without them the weights are seeded random
(seeds 0 and 1).  Without ``--t5_pretrained`` the T5 is a tiny random one
and the prompts go through the port's tokenizer (``--vocab``, else the
hash tokenizer).  Several prompts chain scenes with prime tokens
(``make_video``); the video is written as one NIfTI, sample.nii.gz.  The
draws come from a generator seeded with ``--seed``.  Tests call
``main(argv, device="cpu")``.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--results_folder", required=True)
    parser.add_argument("--prompt", action="append", required=True,
                        help="repeatable; >1 chains scenes via prime tokens")
    parser.add_argument("--dim", type=int, default=512)
    parser.add_argument("--codebook_size", type=int, default=8192)
    parser.add_argument("--image_size", type=int, default=128)
    parser.add_argument("--patch_size", type=int, default=16)
    parser.add_argument("--temporal_patch_size", type=int, default=2)
    parser.add_argument("--num_frames", type=int, default=17,
                        help="frame count ≡ 1 (mod temporal_patch_size)")
    parser.add_argument("--mg_dim", type=int, default=512)
    parser.add_argument("--mg_depth", type=int, default=6)
    parser.add_argument("--mg_heads", type=int, default=8)
    parser.add_argument("--mg_dim_head", type=int, default=64)
    parser.add_argument("--mg_max_seq_len", type=int, default=None,
                        help="MaskGit position-table size; default seq_len "
                        "(+ prime tokens when chaining scenes)")
    parser.add_argument("--ctvit_checkpoint", default=None)
    parser.add_argument("--ctvit_step", type=int, default=None)
    parser.add_argument("--maskgit_checkpoint", default=None)
    parser.add_argument("--maskgit_step", type=int, default=None)
    parser.add_argument("--t5_pretrained", default=None,
                        help="local HF T5 encoder path; default is a tiny "
                        "random T5, shape-correct, not semantically "
                        "conditioned")
    parser.add_argument("--vocab", default=None,
                        help="vocab.txt for WordPiece prompt tokenization "
                        "(default the hash tokenizer)")
    parser.add_argument("--max_text_len", type=int, default=256)
    parser.add_argument("--steps", type=int, default=18)
    parser.add_argument("--cond_scale", type=float, default=5.0)
    parser.add_argument("--prime_length", type=int, default=1,
                        help="trailing frames conditioning the next scene")
    parser.add_argument("--seed", type=int, default=0)
    return parser, parser.parse_args(argv)


def _tokens(args, parser):
    """Prompt ids and mask: the T5's own tokenizer with --t5_pretrained,
    else the port's."""
    import numpy as np

    from vit_exp_tpu_torch.data.tokenizer import load_tokenizer

    if args.t5_pretrained:
        if args.vocab:
            parser.error("--vocab conflicts with --t5_pretrained: prompts "
                         "must use the T5's own paired tokenizer")
        try:
            from transformers import AutoTokenizer

            t5_tok = AutoTokenizer.from_pretrained(args.t5_pretrained)
            out = t5_tok(list(args.prompt), padding="max_length",
                         truncation=True, max_length=args.max_text_len,
                         return_tensors="np")
            return np.asarray(out["input_ids"]), np.asarray(
                out["attention_mask"])
        except Exception as e:   # no tokenizer files or backend
            print(f"WARNING: could not load the T5's paired tokenizer from "
                  f"{args.t5_pretrained} ({e}); falling back to the local "
                  "tokenizer", flush=True)
    toks = load_tokenizer(args.vocab)(list(args.prompt),
                                      max_length=args.max_text_len)
    return np.asarray(toks["input_ids"]), np.asarray(toks["attention_mask"])


def main(argv=None, device="cuda"):
    """Generate and write sample.nii.gz; returns the (F, H, W) volume."""
    parser, args = parse_args(argv)
    import numpy as np
    import torch

    from vit_exp_tpu_torch.cli.run_ctvit_recon import load_ctvit
    from vit_exp_tpu_torch.data.video import write_nifti
    from vit_exp_tpu_torch.models import t5_adapter
    from vit_exp_tpu_torch.models.ctvit import CTViT
    from vit_exp_tpu_torch.models.factory import init_parameters_
    from vit_exp_tpu_torch.models.maskgit import MaskGit
    from vit_exp_tpu_torch.models.maskgit_pipeline import (MaskGITTransformer,
                                                           t5_text_encode)
    from vit_exp_tpu_torch.train.checkpoint import CheckpointManager

    device = torch.device(device)
    tps = args.temporal_patch_size
    if (args.num_frames - 1) % tps:
        parser.error(f"--num_frames must be ≡ 1 (mod {tps})")
    if (args.prime_length - 1) % tps:
        parser.error(f"--prime_length must be ≡ 1 (mod {tps})")
    token_grid = (1 + (args.num_frames - 1) // tps,
                  args.image_size // args.patch_size,
                  args.image_size // args.patch_size)
    seq_len = token_grid[0] * token_grid[1] * token_grid[2]

    ctvit = CTViT(dim=args.dim, codebook_size=args.codebook_size,
                  image_size=args.image_size, patch_size=args.patch_size,
                  temporal_patch_size=tps, device=device)
    init_parameters_(ctvit, seed=0)
    if args.ctvit_checkpoint:
        load_ctvit(ctvit, args.ctvit_checkpoint, args.ctvit_step)
    else:
        print("WARNING: random-init CTViT (no --ctvit_checkpoint) — decoded "
              "volumes are noise", flush=True)
    ctvit.eval()

    if args.t5_pretrained:
        enc = t5_adapter.T5TextEncoder(pretrained=args.t5_pretrained,
                                       device=device)
    else:
        enc = t5_adapter.T5TextEncoder(device=device)
        print("WARNING: random-init tiny T5 (no --t5_pretrained) — prompts "
              "are not semantically grounded", flush=True)
    ids, mask = _tokens(args, parser)
    t5_vocab = int(enc.model.config.vocab_size)
    if int(ids.max()) >= t5_vocab:
        msg = (f"prompt token ids exceed the T5 vocab ({t5_vocab}): the "
               "tokenizer is not paired with the conditioning encoder")
        if args.t5_pretrained:
            raise SystemExit(msg)
        # the tiny random T5 is ungrounded anyway; torch's embedding raises
        # on an id past its table, so the ids are clamped to it
        print(f"WARNING: {msg}", flush=True)
        ids = np.minimum(ids, t5_vocab - 1)

    prime_tokens = 0
    if len(args.prompt) > 1:
        prime_tokens = ((1 + (args.prime_length - 1) // tps)
                        * token_grid[1] * token_grid[2])
    mg = MaskGit(num_tokens=args.codebook_size,
                 max_seq_len=args.mg_max_seq_len or seq_len + prime_tokens,
                 dim=args.mg_dim, depth=args.mg_depth, heads=args.mg_heads,
                 dim_head=args.mg_dim_head, dim_context=enc.ctx_dim,
                 device=device)
    init_parameters_(mg, seed=1)
    if args.maskgit_checkpoint:
        mgr = CheckpointManager(args.maskgit_checkpoint)
        step = (mgr.latest_step() if args.maskgit_step is None
                else args.maskgit_step)
        if step is None:
            parser.error(f"no ckpt_N entries in {args.maskgit_checkpoint}")
        mg.load_state_dict(mgr.restore(step)["model"], strict=True)
    else:
        print("WARNING: random-init MaskGit (no --maskgit_checkpoint)",
              flush=True)
    mg.eval()

    pipe = MaskGITTransformer(ctvit, mg, t5_text_encode(enc))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    prompts = [(torch.from_numpy(ids[i:i + 1]), torch.from_numpy(mask[i:i + 1]))
               for i in range(ids.shape[0])]
    kw = dict(token_grid=token_grid, steps=args.steps,
              cond_scale=args.cond_scale, generator=gen)
    if len(prompts) == 1:
        video = pipe.sample(*prompts[0], **kw)
    else:
        video = pipe.make_video(prompts, prime_length=args.prime_length, **kw)
    os.makedirs(args.results_folder, exist_ok=True)
    vol = video[0, 0].float().cpu().numpy()
    out = os.path.join(args.results_folder, "sample.nii.gz")
    write_nifti(out, np.transpose(vol, (1, 2, 0)))
    print(f"generated {vol.shape} volume from {len(prompts)} prompt(s) → "
          f"{out}", flush=True)
    return vol


if __name__ == "__main__":
    main()
