"""Step timing on the host clock (counterpart of
vit_exp_tpu/utils/profiling.py's ``StepTimer``; device traces come from
``torch.profiler``, which the trainer starts for a ``profile_dir``)."""

from __future__ import annotations

import time
from typing import Dict, Optional


class StepTimer:
    """EMA of the host wall time of each timed block; the first ``skip``
    blocks (warm-up, first kernel build) are left out of the EMA."""

    def __init__(self, skip: int = 2, decay: float = 0.95):
        self.skip = skip
        self.decay = decay
        self.count = 0
        self.ema: Optional[float] = None
        self.last = float("nan")
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self.count += 1
        if self.count > self.skip:
            self.ema = dt if self.ema is None else (
                self.decay * self.ema + (1 - self.decay) * dt)
        self.last = dt
        return False

    def metrics(self) -> Dict[str, float]:
        out = {"step_time_s": self.last}
        if self.ema is not None:
            out["step_time_ema_s"] = self.ema
            out["steps_per_sec_ema"] = 1.0 / self.ema
        return out
