"""Fixed 3D sin-cos position embedding (counterpart of
vit_exp_tpu/ops/posemb.py::sincos_pos_embed_3d).

The same numpy ops in the same order, so the table is bit-identical to the
JAX package's, including its parity quirk: the coordinate grids come from
``np.meshgrid(t, w, h)`` under the default ``'xy'`` indexing (shape
(n_w, n_t, n_h)) and are then reinterpreted as (n_t, n_w, n_h).
"""

from __future__ import annotations

import numpy as np


def _sincos_1d(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    assert embed_dim % 2 == 0
    omega = np.arange(embed_dim // 2, dtype=np.float32)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000**omega
    out = np.einsum("m,d->md", pos.reshape(-1).astype(np.float32), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def sincos_pos_embed_3d(embed_dim: int,
                        grid_size: tuple[int, int, int]) -> np.ndarray:
    """(n_t*n_h*n_w, embed_dim) float32 table; grid_size is (n_t, n_h, n_w)."""
    assert embed_dim % 6 == 0, "dim must split into 3 even sin/cos parts"
    n_t, n_h, n_w = grid_size
    ax_t = np.arange(n_t, dtype=np.float32)
    ax_h = np.arange(n_h, dtype=np.float32)
    ax_w = np.arange(n_w, dtype=np.float32)
    # 'xy' meshgrid → (n_w, n_t, n_h), reinterpreted as (n_t, n_w, n_h)
    grid = np.stack(np.meshgrid(ax_t, ax_w, ax_h), axis=0)
    grid = grid.reshape([3, 1, n_t, n_w, n_h])
    part = embed_dim // 3
    emb = np.concatenate([_sincos_1d(part, g) for g in grid], axis=1)
    return emb.astype(np.float32)
