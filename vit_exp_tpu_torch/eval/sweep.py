"""The checkpoint sweep (counterpart of vit_exp_tpu/eval/sweep.py).  The
reference's "multi-GPU" zero-shot launchers are N single-GPU processes,
each taking a slice of the checkpoint list; here one helper shards the list
over processes and scores its share in order on this card, and a scheduler
starts one process per shard.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Sequence


def shard_list(items: Sequence, shard_index: int, num_shards: int) -> List:
    return [x for i, x in enumerate(items) if i % num_shards == shard_index]


def sweep_checkpoints(
    checkpoint_paths: Sequence[str],
    evaluate: Callable[[str], Dict[str, float]],
    *,
    results_folder: str,
    shard_index: int = 0,
    num_shards: int = 1,
) -> Dict[str, Dict[str, float]]:
    """evaluate(path) → metrics dict for each checkpoint of this shard; the
    results so far are rewritten to ``sweep_shard{shard_index}.json`` after
    each one."""
    os.makedirs(results_folder, exist_ok=True)
    mine = shard_list(list(checkpoint_paths), shard_index, num_shards)
    out: Dict[str, Dict[str, float]] = {}
    path_json = os.path.join(results_folder, f"sweep_shard{shard_index}.json")
    for ckpt in mine:
        out[ckpt] = evaluate(ckpt)
        with open(path_json, "w") as f:
            json.dump(out, f, indent=2)
    return out
