"""Checkpoints of the full train state (counterpart of
vit_exp_tpu/train/checkpoint.py, which writes with orbax).

One directory per step, ``ckpt_{step}/``, holding

- ``model.pt``: the CTCLIP state dict in the reference key layout, so a
  weights-only load is ``model.load_state_dict(torch.load(...),
  strict=True)``;
- ``train_state.pt``: the optimizer's state (Adam's moments and count, the
  schedule, the accumulation buffer) and the step.

A save first copies every tensor to host memory (so the training step may
update the parameters in place right away), then writes in a background
thread into ``ckpt_{step}.tmp/`` and renames it when both files are on
disk: ``all_steps`` lists complete checkpoints only.  One write is in flight
at a time; ``wait=True`` returns once the write is durable.  Tensors are
written with ``torch.save`` and read back bit for bit.
"""

from __future__ import annotations

import os
import re
import shutil
import threading
from typing import Any, Dict, Optional

import torch


def to_host(tree: Any) -> Any:
    """A copy of a nested dict/list of tensors with every tensor on the
    host (a fresh copy even for host tensors, so later in-place updates do
    not reach it)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


class CheckpointManager:
    def __init__(self, directory: str, *, max_to_keep: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}")

    def all_steps(self):
        steps = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"ckpt_(\d+)", name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _write(self, step: int, model_state: Dict, train_state: Dict):
        final = self._path(step)
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(model_state, os.path.join(tmp, "model.pt"))
        torch.save(train_state, os.path.join(tmp, "train_state.pt"))
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        if self.max_to_keep:
            for s in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self._path(s), ignore_errors=True)

    def _run(self, *args):
        try:
            self._write(*args)
        except BaseException as e:   # re-raised by wait_until_finished
            self._error = e

    def save(self, step: int, model_state: Dict, train_state: Dict, *,
             wait: bool = False) -> None:
        """Snapshot both state dicts to host memory, then write them as
        ``ckpt_{step}/`` in the background (``wait=True``: before
        returning)."""
        self.wait_until_finished()
        args = (step, to_host(model_state), to_host(train_state))
        self._thread = threading.Thread(target=self._run, args=args,
                                        daemon=False)
        self._thread.start()
        if wait:
            self.wait_until_finished()

    def wait_until_finished(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    def restore(self, step: int) -> Dict[str, Any]:
        """{"model": state dict, "train_state": {...}} of ``ckpt_{step}``,
        every tensor on the host."""
        self.wait_until_finished()
        path = self._path(step)
        return {name: torch.load(os.path.join(path, f"{name}.pt"),
                                 map_location="cpu", weights_only=True)
                for name in ("model", "train_state")}


def load_model_weights(model: torch.nn.Module, path: str,
                       torch_ckpt: bool = False) -> None:
    """Load weights into ``model`` in place: the port's checkpoint (a
    ``ckpt_{step}/`` directory, or a ``checkpoints/`` directory whose latest
    step is taken) strictly, or with ``torch_ckpt`` a reference
    ``CTClip.*.pt`` state dict (``load_reference_state_dict``).  The CLIs
    that score or serve a checkpoint all load through here."""
    from vit_exp_tpu_torch.models.convert import load_reference_state_dict

    if torch_ckpt:
        load_reference_state_dict(
            model, torch.load(path, map_location="cpu", weights_only=True))
        return
    if not os.path.exists(os.path.join(path, "model.pt")):
        step = CheckpointManager(path).latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
        path = os.path.join(path, f"ckpt_{step}")
    model.load_state_dict(torch.load(os.path.join(path, "model.pt"),
                                     map_location="cpu", weights_only=True),
                          strict=True)
