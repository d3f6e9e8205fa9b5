"""Multi-dataset step composition (counterpart of
vit_exp_tpu/train/sampler.py).  Each train step draws a per-dataset count
of micro-steps:

- CombinedDatasetSampler: the fixed acc_steps_list every step;
- RandDatasetSampler: one dataset, drawn with probability proportional to
  ratio_list from ``default_rng((seed, step))``, so a resumed run draws
  what the uninterrupted one would have.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


class CombinedDatasetSampler:
    def __init__(self, acc_steps_list: Sequence[int]):
        acc = [int(a) for a in acc_steps_list]
        if not (sum(acc) > 0 and all(a >= 0 for a in acc)):
            raise ValueError(f"acc_steps_list needs non-negative counts and "
                             f"a positive sum, got {acc}")
        self.acc_steps_list = acc
        self.n_datasets = len(acc)

    def sample(self, step: int) -> List[int]:
        return list(self.acc_steps_list)


class RandDatasetSampler:
    def __init__(self, ratio_list: Sequence[float], seed: int = 0):
        total = float(sum(ratio_list))
        if not total > 0:
            raise ValueError(f"ratio_list needs a positive sum, got "
                             f"{list(ratio_list)}")
        self.probs = np.asarray([r / total for r in ratio_list])
        self.n_datasets = len(ratio_list)
        self.seed = seed

    def sample(self, step: int) -> List[int]:
        rng = np.random.default_rng((self.seed, step))
        idx = int(rng.choice(self.n_datasets, p=self.probs))
        out = [0] * self.n_datasets
        out[idx] = 1
        return out


def build_dataset_sampler(config, seed: int = 0):
    """config: a DatasetSamplerConfig (type, acc_steps_list, ratio_list)."""
    if config.type == "Random":
        return RandDatasetSampler(config.ratio_list, seed=seed)
    if config.type == "Combined":
        return CombinedDatasetSampler(config.acc_steps_list)
    raise ValueError(f"unknown DatasetSampler type {config.type!r}")
