"""The process grid (counterpart of vit_exp_tpu/core/mesh.py).

The JAX package carves its devices into one mesh of (data, fsdp, model)
axes and lets GSPMD insert the collectives.  The port runs one process per
card, so the grid is over processes: data × fsdp × model must equal the
process count (``MeshError`` otherwise).  Only the data axis is ported:
``fsdp > 1`` (parameter sharding) and ``model > 1`` (tensor parallelism)
raise NotImplementedError, queued as M7b.  The data group is the default
process group; the collectives that the data axis needs are written out
in parallel/collectives.py.

``seq_axis`` names the axis whose processes shard the image tower's tokens
(ring attention, models/ctvit3d.py).  As in the JAX package no config or
CLI key wires it into a model: a caller builds ``CTViT3D(seq_group=...)``
with ``seq_group(config)`` or any ``torch.distributed`` group itself.

JAX's logical-axis rules and its flax sharding helpers have no counterpart
(they exist for GSPMD).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

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
        """The data-parallel width, data × fsdp, after refusing what is not
        ported (M7b)."""
        if self.fsdp > 1 or self.model > 1:
            raise NotImplementedError(
                f"mesh fsdp={self.fsdp}, model={self.model}: fsdp > 1 "
                f"(parameter sharding) and model > 1 (tensor parallelism) "
                f"are not ported yet (ROADMAP M7b); only the data axis is")
        data, fsdp, _ = self.axis_sizes(n_processes)
        return data * fsdp


def mesh_config_from(config, mesh_arg: Optional[str] = None
                     ) -> Optional[MeshConfig]:
    """MeshConfig from the yaml ``mesh:`` section ({data, fsdp, model,
    seq_axis}) and/or ``--mesh DATA,FSDP,MODEL``, which overrides the axis
    sizes; None when neither is given."""
    spec = dict((getattr(config, "extra", None) or {}).get("mesh") or {})
    if mesh_arg:
        d, f, m = (int(x) for x in mesh_arg.split(","))
        spec.update(data=d, fsdp=f, model=m)
    if not spec:
        return None
    return MeshConfig(data=spec.get("data", -1), fsdp=spec.get("fsdp", 1),
                      model=spec.get("model", 1),
                      seq_axis=spec.get("seq_axis"))


def data_group(mesh_config: Optional[MeshConfig] = None):
    """The data-parallel group of this run: the default group when several
    processes run, None for one.  Checks the grid against the process
    count (MeshError, or NotImplementedError for fsdp/model > 1)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    (mesh_config or MeshConfig()).data_shards(n)
    return dist.group.WORLD if n > 1 else None


def seq_group(mesh_config: MeshConfig):
    """The group that shards the tower's tokens: the processes of the axis
    ``seq_axis`` names, or None where there is no such axis or it holds
    one process (the data axis is the only one ported, so only
    ``seq_axis: data`` on several processes gives a group)."""
    if mesh_config.seq_axis is None:
        return None
    if mesh_config.seq_axis not in AXES:
        raise MeshError(f"seq_axis {mesh_config.seq_axis!r} is none of "
                        f"{AXES}")
    group = data_group(mesh_config)
    return group if mesh_config.seq_axis == "data" else None
