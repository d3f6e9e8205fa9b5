"""Metric logging (counterpart of vit_exp_tpu/utils/logging.py): one JSON
line per ``log`` call in ``metrics.jsonl``, with the JAX package's keys
(``_time``, ``step`` and the metrics as floats), so the same readers
(scripts/summarize_mixed_run.py) take both packages' runs; wandb too when
it is importable and the logger is asked for it.  ``enabled=False``
(every rank but 0 of a multi-process run) makes it write nothing."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricLogger:
    def __init__(self, results_folder: str, *, project: str = "vit_exp_tpu",
                 exp_name: str = "default", use_wandb: bool = True,
                 enabled: bool = True):
        self.enabled = enabled
        self._file = self._wandb = None
        if not enabled:
            return
        os.makedirs(results_folder, exist_ok=True)
        self.jsonl_path = os.path.join(results_folder, "metrics.jsonl")
        self._file = open(self.jsonl_path, "a")
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb.init(project=project, name=exp_name,
                                         dir=results_folder)
            except Exception:
                self._wandb = None

    def log(self, metrics: Dict, step: Optional[int] = None):
        if not self.enabled:
            return
        record = {"_time": time.time()}
        if step is not None:
            record["step"] = int(step)
        for k, v in metrics.items():
            try:
                record[k] = float(v)
            except (TypeError, ValueError):
                record[k] = str(v)
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def close(self):
        if not self.enabled:
            return
        self._file.close()
        if self._wandb is not None:
            self._wandb.finish()
