#!/usr/bin/env python
"""Write synthetic production-shape packed shards with the PyTorch port's
``PackedShardWriter`` (the port's copy of scripts/make_synth_shards.py; it
imports nothing of the JAX package): N volumes (1, 240, 480, 480) float16
with a report text each in their record's meta, in the format
``pack_dataset`` writes from CT-RATE, for configs/prod_sustained_synth.yaml
(``packed: true``, ``data_folder: /tmp/synth_packed``):

    python scripts/make_synth_shards_torch.py --out /tmp/synth_packed \\
        [--n 12] [--shape 240,480,480] [--seed 0]
    python -m vit_exp_tpu_torch.cli.run_train \\
        --config configs/prod_sustained_synth.yaml --synthetic_eval 4

110.6 MB a volume.  The bytes are the JAX script's for the same arguments.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPORTS = [
    "There is a small left pleural effusion. No pericardial effusion.",
    "Bilateral ground glass opacities consistent with infection.",
    "No acute cardiopulmonary abnormality. Lungs are clear.",
    "Calcified granuloma in the right upper lobe. No lymphadenopathy.",
    "Mild emphysematous changes. Trachea and bronchi are patent.",
    "Consolidation in the left lower lobe with air bronchograms.",
]


def synth_volume(i: int, shape, rng: np.random.Generator) -> np.ndarray:
    """Volume ``i``: a separable low-frequency field in [0, 1] plus noise
    drawn from ``rng``, distinct per volume, as (1, D, H, W) float16."""
    d, h, w = shape
    zz = np.linspace(0, np.pi * (1 + i % 3), d, dtype=np.float32)
    yy = np.linspace(0, np.pi * 2, h, dtype=np.float32)
    vol = (0.4 + 0.3 * np.sin(zz)[:, None, None] * np.cos(yy)[None, :, None]
           + 0.1 * rng.standard_normal((d, h, w), np.float32))
    return np.clip(vol, 0.0, 1.0)[None].astype(np.float16)


def main(argv=None) -> str:
    """Write the store; returns its directory."""
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--n", type=int, default=12)
    p.add_argument("--shape", default="240,480,480",
                   help="D,H,W of each volume (channel dim added)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from vit_exp_tpu_torch.data.packed import PackedShardWriter

    shape = tuple(int(x) for x in args.shape.split(","))
    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    with PackedShardWriter(args.out) as wr:
        for i in range(args.n):
            wr.append(f"synth_{i:04d}.nii.gz", synth_volume(i, shape, rng),
                      meta={"text": REPORTS[i % len(REPORTS)]})
            print(f"wrote {i + 1}/{args.n} "
                  f"({(i + 1) / (time.time() - t0):.2f} vol/s)", flush=True)
    print(f"done: {args.n} volumes → {args.out} "
          f"in {time.time() - t0:.0f}s", flush=True)
    return args.out


if __name__ == "__main__":
    main()
