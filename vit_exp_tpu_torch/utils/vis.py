"""3D volume slice grids for logging (counterpart of
vit_exp_tpu/utils/vis.py), and a grayscale PNG writer.

``slice_grid_3d`` slices a volume at ratios (0.25, 0.5, 0.75) along each of
its three axes, normalises each slice to [0, 1] and tiles the nine into one
grid (rows: axes, columns: ratios).  ``write_png`` stores such a grid as an
8-bit grayscale PNG with the standard library alone (zlib and struct), so
the card's host needs neither matplotlib nor PIL.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, List, Sequence

import numpy as np

RATIOS = (0.25, 0.5, 0.75)


def _norm01(img: np.ndarray) -> np.ndarray:
    lo, hi = float(img.min()), float(img.max())
    if hi - lo < 1e-12:
        return np.zeros_like(img)
    return (img - lo) / (hi - lo)


def slice_grid_3d(volume: np.ndarray,
                  ratios: Sequence[float] = RATIOS) -> np.ndarray:
    """(D, H, W) volume → one 2D float32 grid; slices are zero-padded to a
    common cell before tiling."""
    volume = np.asarray(volume)
    if volume.ndim != 3:
        raise ValueError(f"slice_grid_3d takes a 3D volume, got {volume.shape}")
    cells: List[List[np.ndarray]] = [
        [_norm01(np.take(volume, int(size * r), axis=axis)) for r in ratios]
        for axis, size in enumerate(volume.shape)]
    cell_h = max(c.shape[0] for row in cells for c in row)
    cell_w = max(c.shape[1] for row in cells for c in row)
    grid = np.zeros((3 * cell_h, len(ratios) * cell_w), dtype=np.float32)
    for i, row in enumerate(cells):
        for j, c in enumerate(row):
            grid[i * cell_h:i * cell_h + c.shape[0],
                 j * cell_w:j * cell_w + c.shape[1]] = c
    return grid


def vis_3d_img_list(volumes: Sequence[np.ndarray],
                    img_name: str = "vol") -> Dict[str, np.ndarray]:
    """List of (D, H, W) arrays → {f"{img_name}_{i}": grid}."""
    return {f"{img_name}_{i}": slice_grid_3d(np.asarray(v))
            for i, v in enumerate(volumes)}


def write_png(path: str, img: np.ndarray) -> None:
    """A 2D array in [0, 1] → an 8-bit grayscale PNG (round(255·v)),
    written to a file of this process and renamed into place, so processes
    that write the same image to one path leave a whole file."""
    pixels = np.round(np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)
    h, w = pixels.shape
    # each scanline is prefixed with filter type 0 (none)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), pixels], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)   # 8-bit gray
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
                + chunk(b"IDAT", zlib.compress(raw.tobytes()))
                + chunk(b"IEND", b""))
    os.replace(tmp, path)
