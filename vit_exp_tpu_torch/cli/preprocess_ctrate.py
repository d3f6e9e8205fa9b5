"""Offline CT-RATE preprocessing: NIfTI volumes → the npz tree (counterpart
of vit_exp_tpu/cli/preprocess_ctrate.py, the reference's
data_preprocess/preprocess_ctrate_*.py).

Usage:
    python -m vit_exp_tpu_torch.cli.preprocess_ctrate --src <dir of .nii.gz> \\
        --metadata metadata.csv --out <npz tree> [--split train] \\
        [--workers 8] [--device]

Per volume: the HU rescale slope·x + intercept from the metadata CSV
(RescaleSlope, RescaleIntercept; XYSpacing as "[x, y]" or a number,
ZSpacing), clip [−1000, 1000], /1000 in fp32, transpose to (D, H, W),
trilinear resample to the spacing (z 1.5, x/y 0.75), saved as ``arr_0`` of
``{split}_{patient}/{split}_{patient}{scan}/{name}.npz``.  The host path
normalises with numpy and resamples with ops/preprocess.py on the CPU;
``--device`` runs both on the card (no CPU fallback: without a card it
raises).  Reading and decoding the NIfTI files (data/nifti.py) runs on
worker threads either way.  A volume without a metadata row is skipped and
one that fails is reported; both are printed.
"""

from __future__ import annotations

import argparse
import ast
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


def _parse_xy_spacing(value) -> float:
    """The metadata writes XYSpacing as "[0.75, 0.75]"; a plain number is
    taken as it is."""
    if isinstance(value, str):
        value = ast.literal_eval(value)
    if isinstance(value, (list, tuple)):
        value = value[0]
    return float(value)


def _out_folder(out_root: str, split: str, name: str) -> str:
    parts = name.split("_")
    if len(parts) >= 3:
        return os.path.join(out_root, f"{split}_{parts[1]}",
                            f"{split}_{parts[1]}{parts[2]}")
    return os.path.join(out_root, name.split(".")[0])


def process_file(path, row, out_root, split, device=None) -> str:
    """Preprocess one NIfTI file with its metadata row (a mapping) into the
    tree; ``device`` None is the host path, else the torch device that
    normalises and resamples.  Returns the npz path."""
    from vit_exp_tpu_torch.data.nifti import read_nifti
    from vit_exp_tpu_torch.ops import preprocess as pp

    img = read_nifti(path)   # (H, W, D)
    slope = float(row["RescaleSlope"])
    intercept = float(row["RescaleIntercept"])
    xy = _parse_xy_spacing(row["XYSpacing"])
    z = float(row["ZSpacing"])
    new_shape = pp.spacing_resample_shape(
        (img.shape[2], img.shape[0], img.shape[1]), (z, xy, xy))
    if device is not None:
        out = pp.preprocess_offline_volume(
            np.ascontiguousarray(img), slope=slope, intercept=intercept,
            new_shape=new_shape, device=device).cpu().numpy()
    else:
        x = np.clip(img.astype(np.float32) * slope + intercept, -1000, 1000)
        x = (x / 1000.0).astype(np.float32).transpose(2, 0, 1)
        out = pp.resize_trilinear(torch.from_numpy(np.ascontiguousarray(x)),
                                  new_shape).numpy()
    name = os.path.basename(path)
    folder = _out_folder(out_root, split, name)
    os.makedirs(folder, exist_ok=True)
    npz = os.path.join(folder, name.split(".")[0] + ".npz")
    np.savez(npz, out)
    return npz


def main(argv=None):
    parser = argparse.ArgumentParser(prog="preprocess_ctrate")
    parser.add_argument("--src", required=True)
    parser.add_argument("--metadata", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--split", default="train")
    parser.add_argument("--workers", type=int, default=8)
    parser.add_argument("--device", action="store_true",
                        help="normalise and resample on the card")
    args = parser.parse_args(argv)
    device = None
    if args.device:
        if not torch.cuda.is_available():
            raise RuntimeError("--device needs a CUDA card; without it, "
                               "leave the flag out for the host path")
        device = torch.device("cuda")

    from vit_exp_tpu_torch.data.datasets import read_csv_rows

    _, rows = read_csv_rows(args.metadata)
    meta = {row["VolumeName"]: row for row in rows}
    files = []
    for dirpath, _, names in os.walk(args.src):
        files += [os.path.join(dirpath, n) for n in sorted(names)
                  if n.endswith(".nii.gz") or n.endswith(".nii")]

    def work(path):
        name = os.path.basename(path)
        if name not in meta:
            print(f"skip {name}: no metadata row")
            return
        try:
            process_file(path, meta[name], args.out, args.split,
                         device=device)
        except Exception as e:  # noqa: BLE001 -- reported per volume
            print(f"failed {name}: {e!r}")

    with ThreadPoolExecutor(args.workers) as pool:
        list(pool.map(work, files))
    print(f"processed {len(files)} volumes -> {args.out}")


if __name__ == "__main__":
    main()
