"""The process grid (counterpart of vit_exp_tpu/core/mesh.py).

The JAX package carves its devices into one mesh of (data, fsdp, model)
axes and lets GSPMD insert the collectives.  The port runs one process per
card, so the grid is over processes: data × fsdp × model must equal the
process count (``MeshError`` otherwise).  The ranks are laid out as JAX
lays out its devices (``reshape(data, fsdp, model)``, model fastest):
rank = (d·F + f)·M + m.  ``grid`` builds the groups through that layout:

- the **batch** group, ranks with the same m (D·F of them): the batch
  shards over (data, fsdp), as JAX's BATCH → (data, fsdp) rule says, so
  the M ranks of a model group read the same rows; batch shard d·F + f;
- the **fsdp** group, ranks with the same (d, m): they hold 1/F of every
  parameter each (parallel/sharding.py, JAX's EMBED → fsdp rule);
- the **model** group, ranks with the same (d, f): tensor parallelism over
  heads and MLP units (JAX's HEADS and MLP → model rules);
- the **replica** group, ranks with the same (f, m): the data axis, whose
  ranks hold the same parameter shards.

A group of one rank is None (every collective is then a no-op) and a group
of every rank is the default group.  The collectives are written out in
parallel/collectives.py.

``seq_axis`` names the axis whose processes shard the image tower's tokens
(ring attention, models/ctvit3d.py).  As in the JAX package no config or
CLI key wires it into a model: a caller builds ``CTViT3D(seq_group=...)``
with ``seq_group(config)`` or any ``torch.distributed`` group itself.

JAX's logical-axis rules and its flax sharding helpers have no counterpart
(they exist for GSPMD); parallel/sharding.py says which parameter shards
over which group.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch.distributed as dist

AXES = ("data", "fsdp", "model")


class MeshError(ValueError):
    """The grid does not match the process count."""


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = -1      # -1: every process the other axes leave
    fsdp: int = 1
    model: int = 1
    seq_axis: Optional[str] = None

    def axis_sizes(self, n_processes: int) -> Tuple[int, int, int]:
        """(data, fsdp, model) over ``n_processes``; MeshError where the
        product is not the process count."""
        fsdp, model, data = self.fsdp, self.model, self.data
        if min(fsdp, model) < 1 or data == 0 or data < -1:
            raise MeshError(f"mesh {data}x{fsdp}x{model}: every axis size "
                            f"must be positive (data may be -1)")
        if data == -1:
            if n_processes % (fsdp * model):
                raise MeshError(f"{n_processes} processes not divisible by "
                                f"fsdp*model={fsdp * model}")
            data = n_processes // (fsdp * model)
        if data * fsdp * model != n_processes:
            raise MeshError(f"mesh {data}x{fsdp}x{model} != {n_processes} "
                            f"processes (one process per card)")
        return data, fsdp, model

    def data_shards(self, n_processes: int) -> int:
        """The batch's shard count, data × fsdp."""
        data, fsdp, _ = self.axis_sizes(n_processes)
        return data * fsdp


def mesh_config_from(config, mesh_arg: Optional[str] = None
                     ) -> Optional[MeshConfig]:
    """MeshConfig from the yaml ``mesh:`` section ({data, fsdp, model,
    seq_axis}) and/or ``--mesh DATA,FSDP,MODEL``, which overrides the axis
    sizes; None when neither is given."""
    spec = dict((getattr(config, "extra", None) or {}).get("mesh") or {})
    if mesh_arg:
        d, f, m = parse_mesh(mesh_arg)
        spec.update(data=d, fsdp=f, model=m)
    if not spec:
        return None
    return MeshConfig(data=spec.get("data", -1), fsdp=spec.get("fsdp", 1),
                      model=spec.get("model", 1),
                      seq_axis=spec.get("seq_axis"))


def parse_mesh(mesh_arg: str) -> Tuple[int, int, int]:
    """``DATA,FSDP,MODEL`` → three ints (MeshError on another form)."""
    try:
        d, f, m = (int(x) for x in mesh_arg.split(","))
    except ValueError:
        raise MeshError(f"--mesh takes DATA,FSDP,MODEL; got {mesh_arg!r}"
                        ) from None
    return d, f, m


@dataclasses.dataclass(frozen=True)
class Grid:
    """This process's place on the grid, (d, f, m), and its groups."""
    sizes: Tuple[int, int, int]
    coords: Tuple[int, int, int]
    batch: Any = None
    fsdp: Any = None
    model: Any = None
    replica: Any = None

    @property
    def batch_shards(self) -> int:
        return self.sizes[0] * self.sizes[1]

    @property
    def batch_index(self) -> int:
        """This rank's shard of the batch, d·F + f."""
        return self.coords[0] * self.sizes[1] + self.coords[1]


def coords_of(rank: int, sizes: Tuple[int, int, int]) -> Tuple[int, int, int]:
    """(d, f, m) of ``rank`` on a grid of ``sizes``, model fastest."""
    _, f_size, m_size = sizes
    return rank // (f_size * m_size), (rank // m_size) % f_size, rank % m_size


def grid(mesh_config: Optional[MeshConfig] = None) -> Grid:
    """This process's Grid on ``mesh_config`` (the data axis over every
    process by default); MeshError where the grid does not match the
    process count.  Every rank calls it, as it makes the groups that
    differ from the default group (``dist.new_group``, in one order on
    every rank)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    sizes = (mesh_config or MeshConfig()).axis_sizes(n)
    if n == 1:
        return Grid(sizes, (0, 0, 0))
    coords = [coords_of(r, sizes) for r in range(n)]
    mine = coords[dist.get_rank()]

    def make(same):
        """One group per value of ``same``; this rank's."""
        out = None
        for value in sorted({same(c) for c in coords}):
            ranks = [r for r, c in enumerate(coords) if same(c) == value]
            if len(ranks) == 1:
                g = None
            elif len(ranks) == n:
                g = dist.group.WORLD
            else:
                g = dist.new_group(ranks)
            if same(mine) == value:
                out = g
        return out

    return Grid(sizes, mine, batch=make(lambda c: c[2]),
                fsdp=make(lambda c: (c[0], c[2])),
                model=make(lambda c: (c[0], c[1])),
                replica=make(lambda c: (c[1], c[2])))


def data_group(mesh_config: Optional[MeshConfig] = None):
    """The batch group of this run (the ranks that share a model position;
    the default group on a pure data grid, None for one process).  Checks
    the grid against the process count (MeshError)."""
    return grid(mesh_config).batch


def seq_group(mesh_config: MeshConfig):
    """The group that shards the tower's tokens: the processes of the axis
    ``seq_axis`` names (``data``: the replica group), or None where there
    is no such axis or it holds one process."""
    if mesh_config.seq_axis is None:
        return None
    if mesh_config.seq_axis not in AXES:
        raise MeshError(f"seq_axis {mesh_config.seq_axis!r} is none of "
                        f"{AXES}")
    g = grid(mesh_config)
    return {"data": g.replica, "fsdp": g.fsdp,
            "model": g.model}[mesh_config.seq_axis]
