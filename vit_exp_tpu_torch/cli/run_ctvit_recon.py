"""CTViT reconstruction CLI (counterpart of
vit_exp_tpu/cli/run_ctvit_recon.py): run a volume data set through a CTViT
VQGAN and save each reconstruction as NIfTI under
{results}/samples.{accession}/{name}.nii.gz, the tree
``VideoTextSuperresDataset`` reads as its low-res source.

Usage, on the card:
    python -m vit_exp_tpu_torch.cli.run_ctvit_recon --data_folder vols/ \\
        --results_folder out/ [--checkpoint CKPT [--step N]] \\
        [--num_frames 17] [--image_size 128] [--synthetic N]

``--checkpoint``: the ``checkpoints/`` directory of a ``CTViTTrainer`` (its
``ckpt_{step}``, the latest without ``--step``; the EMA weights and the
codebook) or a reference CTViT ``.pt`` state dict.  Without it the weights
are seeded random (seed 0).  ``--synthetic N`` reconstructs N volumes drawn
from numpy's default_rng(0), as the JAX CLI does.  Tests call
``main(argv, device="cpu")``; there is no device flag.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_folder", default=None)
    parser.add_argument("--results_folder", required=True)
    parser.add_argument("--checkpoint", default=None,
                        help="a CTViTTrainer checkpoints/ directory or a "
                        "reference CTViT .pt")
    parser.add_argument("--step", type=int, default=None)
    parser.add_argument("--dim", type=int, default=512)
    parser.add_argument("--image_size", type=int, default=128)
    parser.add_argument("--patch_size", type=int, default=16)
    parser.add_argument("--temporal_patch_size", type=int, default=2)
    parser.add_argument("--num_frames", type=int, default=17,
                        help="frame count ≡ 1 (mod temporal_patch_size)")
    parser.add_argument("--synthetic", type=int, default=0,
                        help="run on N synthetic volumes instead of data")
    return parser.parse_args(argv)


def load_ctvit(model, path: str, step=None) -> None:
    """A CTViTTrainer checkpoint directory (``ckpt_{step}``, the latest by
    default) strictly, or a reference ``.pt`` (``CTViT.load_reference``)."""
    import torch

    from vit_exp_tpu_torch.train.checkpoint import CheckpointManager

    if os.path.isfile(path):
        model.load_reference(torch.load(path, map_location="cpu",
                                        weights_only=True))
        return
    mgr = CheckpointManager(path)
    step = mgr.latest_step() if step is None else step
    if step is None:
        raise FileNotFoundError(f"no ckpt_N entries in {path}")
    model.load_state_dict(mgr.restore(step)["model"], strict=True)


def main(argv=None, device="cuda"):
    """Reconstruct and write every volume; returns the written paths."""
    args = parse_args(argv)
    import numpy as np
    import torch

    from vit_exp_tpu_torch.data.video import (VideoDataset,
                                              cast_num_frames_mod1,
                                              write_nifti)
    from vit_exp_tpu_torch.models.ctvit import CTViT
    from vit_exp_tpu_torch.models.factory import init_parameters_

    device = torch.device(device)
    model = CTViT(dim=args.dim, image_size=args.image_size,
                  patch_size=args.patch_size,
                  temporal_patch_size=args.temporal_patch_size,
                  device=device)
    init_parameters_(model, seed=0)
    if args.checkpoint:
        load_ctvit(model, args.checkpoint, args.step)
    model.eval()

    if args.synthetic:
        rng = np.random.default_rng(0)
        items = [(f"SYN{i}", f"vol{i}.nii.gz",
                  rng.uniform(-1, 1, (1, args.num_frames, args.image_size,
                                      args.image_size)).astype(np.float32))
                 for i in range(args.synthetic)]
    else:
        if not args.data_folder:
            raise SystemExit("--data_folder or --synthetic required")
        ds = VideoDataset(args.data_folder, target=(
            args.num_frames, args.image_size, args.image_size))
        items = [(os.path.basename(os.path.dirname(ds.paths[i])),
                  os.path.basename(ds.paths[i]), ds[i]["image"])
                 for i in range(len(ds))]

    written = []
    for acc, name, vol in items:
        vol = cast_num_frames_mod1(vol, args.temporal_patch_size)[None]
        with torch.no_grad():
            recon, _, _ = model(torch.from_numpy(np.ascontiguousarray(vol))
                                .to(device), return_encoded_tokens=False,
                                return_recons=True)
        recon = recon[0, 0].float().cpu().numpy()
        out_dir = os.path.join(args.results_folder, f"samples.{acc}")
        os.makedirs(out_dir, exist_ok=True)
        if not name.endswith(".nii.gz"):
            name += ".nii.gz"
        # (D, H, W) → the NIfTI (H, W, S) axis order
        path = os.path.join(out_dir, name)
        write_nifti(path, np.transpose(recon, (1, 2, 0)))
        written.append(path)
        print(f"saved samples.{acc}/{name}", flush=True)
    print(f"reconstructed {len(items)} volumes → {args.results_folder}",
          flush=True)
    return written


if __name__ == "__main__":
    main()
