"""Convert a CT-RATE npz tree and its reports CSV to a packed store
(counterpart of vit_exp_tpu/cli/pack_dataset.py; the same format, byte for
byte).

Usage:
    python -m vit_exp_tpu_torch.cli.pack_dataset \\
        --data_folder <npz tree> --csv_file <reports.csv> --out <store> \\
        [--dtype float16] [--shard_gb 1] [--limit N]

Each record holds the runtime-cropped volume, the exact array the loader
would feed the model, (1, 240, 480, 480) cast to ``--dtype`` (float16 halves
the bytes; the readers cast back to fp32), keyed by its ``.nii.gz``
accession, with the report as the CSV joins it in the record's meta, so the
readers need no CSV.  See data/packed.py for the format.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(prog="pack_dataset")
    p.add_argument("--data_folder", required=True)
    p.add_argument("--csv_file", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--dtype", default="float16",
                   help="storage dtype (float16 halves the bytes; the "
                   "readers cast back to float32)")
    p.add_argument("--shard_gb", type=float, default=1.0)
    p.add_argument("--limit", type=int, default=0,
                   help="pack the first N volumes only")
    args = p.parse_args(argv)

    from vit_exp_tpu_torch.data.datasets import CTReportDataset
    from vit_exp_tpu_torch.data.packed import PackedShardWriter

    ds = CTReportDataset(args.data_folder, args.csv_file, keep_percent=100)
    n = len(ds.samples) if not args.limit else min(args.limit, len(ds.samples))
    dtype = np.dtype(args.dtype)
    t0 = time.time()
    with PackedShardWriter(args.out,
                           shard_bytes=int(args.shard_gb * 2**30)) as w:
        for i in range(n):
            path, text = ds.samples[i]
            key = os.path.basename(path).replace(".npz", ".nii.gz")
            w.append(key, ds[i]["image"].astype(dtype), meta={"text": text})
            if (i + 1) % 50 == 0:
                rate = (i + 1) / (time.time() - t0)
                print(f"packed {i + 1}/{n} ({rate:.1f} vol/s)", flush=True)
    print(f"done: {n} volumes -> {args.out} in {time.time() - t0:.0f}s")


if __name__ == "__main__":
    main()
