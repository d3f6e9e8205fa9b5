"""The training loop on one device (counterpart of
vit_exp_tpu/train/trainer.py's ``CTClipTrainer``).

- The model trains where it lies and from the weights it holds (no
  re-initialisation: a caller may load weights first); the batches go to
  the model's device.
- One loader per ``train_data_list`` entry, each cycled without end, with
  the entry's batch size, the config's seed and ``drop_last``.
- Each train step draws per-dataset micro-step counts from the dataset
  sampler and runs that many micro-steps of the data set's step function,
  its loss times ``balance_loss_weight``; under gradient accumulation the
  optimizer applies its update on every k-th micro-step.
- The self-supervision draws of a micro-step (train/steps.py) come from
  the config's seed and the optimizer's micro-step count, which the
  checkpoint saves with the optimizer (JAX's ``TrainState.step``), so a
  resumed run draws the masks and views an unbroken one does; the step
  functions read it themselves.  Their metrics ("text_ssl_loss",
  "image_ssl_loss" where on) are logged as every other.
- The step's metrics stay device tensors and are read one step late, so
  the host never waits on the step in flight: after dispatching step i it
  reads step i−1's metrics.  The step timer therefore spans one full step
  in steady state.
- ``save_model_every`` saves in the background; the final save and the
  save on preemption wait for the write.  ``resume_step`` restores a saved
  step; ``-1`` restores the latest.
- ``install_preemption_handler``: SIGTERM/SIGINT set a flag; the loop
  finishes the step in flight, saves and returns "preempted".
- ``profile_dir``: ``torch.profiler`` traces the run (CPU and CUDA) into
  that directory.
- ``eval_hooks`` ({name: hook}, from ``eval/hooks.py::build_eval_hooks``):
  every ``eval_model_every`` steps the pending train line is written first
  (so metrics.jsonl stays in step order), then each hook scores the live
  model, ``hook(model) -> {key: value}``, logged as ``eval/<name>/<key>``
  at that step.  ``sample_hooks`` likewise every ``sample_val_every``
  steps, ``hook(model, step) -> {key: file path}``, logged as
  ``sample/<name>/<key>``.  A hook leaves the model's weights, mode and
  random streams as it found them, so a run with hooks trains the same
  bits as one without.
- Batches go to the device as they come from the loader: token ids as
  int64, volumes and masks in their own dtype (the planted masks are
  uint8, and the losses cast them on the device: a full-width fp32 mask
  of 22 classes would be 4.87 GB a volume on the host).
- The batch copy (the JAX package's asynchronous ``device_put``): on a
  CUDA device each loader collates into a bounded pool of page-locked
  buffers (``data/pinned.py``, PIN_SLOTS sets per loader), and the trainer
  copies the NEXT micro-step's batch on a side stream while the current
  micro-step runs.  ``sampler.sample(step)`` is a function of the seed and
  the step alone, so the micro-step after the last of a step is read from
  the next step's schedule: no draw changes, and each loader yields its
  batches in the order it would without the read-ahead.  The read-ahead
  batch outlives the eval and sample hooks and a save between steps; it
  is not taken past the run's last step, and a restore or a preemption
  drops it.  On the CPU the batches are used where they lie, with no copy.

- Several processes (``mesh_config``, core/mesh.py; one process per
  card, the process group joined before the trainer is built): the batch
  shards over the grid's data × fsdp ranks, and each process loads its
  shard of the global batch of batch_size × data × fsdp (``batch_size`` a
  loader batch) from the loader's stride of one shared permutation
  (shard_id = d·F + f of D·F shards); the M ranks of a model group load
  the same rows.  The model is placed on the grid first
  (parallel/sharding.py: the tensor-parallel cut over the model group,
  the parameters sharded over the fsdp group).  The steps take the
  global-batch terms over the batch group and the optimizer averages the
  gradients over it (train/steps.py, train/optimizer.py).  Rank 0 alone
  writes the metrics and the checkpoints, in the reference layout with
  every parameter and moment gathered whole (every rank takes part in the
  gather); a save that waits ends at a barrier, so every rank then sees
  the file, and a resume loads the same step on every rank, each cutting
  it to its share, so a checkpoint of one grid resumes on any other.  The
  preemption flag is all-reduced (MAX) over every process at each step
  boundary and read at the next, so every rank stops and saves at the same
  step and none is left waiting in a collective.  The eval and sample
  hooks run on every rank on the same module (with the sharded parameters
  gathered; their engines start no collective of their own); only rank 0
  logs them.  The sampler is a function of (seed, step), so every rank
  runs the same sequence of data types.

Not ported: the host-memory watchdog (a guard against a leak of the JAX
package's TPU client).
"""

from __future__ import annotations

import os
import signal
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from vit_exp_tpu_torch.core import multihost
from vit_exp_tpu_torch.core.mesh import MeshConfig, grid
from vit_exp_tpu_torch.data.loader import InfiniteLoader, Loader
from vit_exp_tpu_torch.data.pinned import BatchCopier, DeviceBatch, PinnedPool
from vit_exp_tpu_torch.parallel.collectives import all_reduce_max
from vit_exp_tpu_torch.parallel.sharding import Sharded
from vit_exp_tpu_torch.train.checkpoint import CheckpointManager
from vit_exp_tpu_torch.train.optimizer import build_optimizer
from vit_exp_tpu_torch.train.sampler import build_dataset_sampler
from vit_exp_tpu_torch.train.steps import make_train_steps
from vit_exp_tpu_torch.utils.logging import MetricLogger
from vit_exp_tpu_torch.utils.profiling import StepTimer

_BATCH_KEYS = ("image", "input_ids", "attention_mask", "seg_mask",
               "prompt_ids", "prompt_mask")
_ID_KEYS = {"input_ids", "attention_mask", "prompt_ids", "prompt_mask"}
# page-locked buffer sets per loader: the batch being copied, the one the
# loader's queue holds next, and one being collated
PIN_SLOTS = 3


class CTClipTrainer:
    def __init__(self, model: torch.nn.Module, config, *,
                 datasets: Optional[List[Any]] = None,
                 resume_step: Optional[int] = None, use_wandb: bool = True,
                 eval_hooks: Optional[Dict[str, Callable]] = None,
                 sample_hooks: Optional[Dict[str, Callable]] = None,
                 mesh_config: Optional[MeshConfig] = None):
        self.eval_hooks = dict(eval_hooks or {})
        self.sample_hooks = dict(sample_hooks or {})
        self.model = model.train()
        self.device = next(model.parameters()).device
        self.config = config
        self.trainer_cfg = config.trainer
        self.results_folder = config.results_folder
        os.makedirs(self.results_folder, exist_ok=True)

        self.grid = grid(mesh_config)
        self.group = self.grid.batch
        self.n_data_shards = self.grid.batch_shards
        self.process_count = multihost.process_count()
        # the preemption flag's group: every process
        self.world_group = (torch.distributed.group.WORLD
                            if self.process_count > 1 else None)
        self.is_main = multihost.is_main_process()
        self.sharding = Sharded(model, self.grid)
        self.datasets = datasets or []
        cuda = self.device.type == "cuda"
        self.loaders = []
        for spec, ds in zip(config.train_data_list, self.datasets):
            self.loaders.append(InfiniteLoader(Loader(
                ds, batch_size=int(spec.get("batch_size", 1)),
                shuffle=True, seed=config.random_seed, drop_last=True,
                num_workers=int(spec.get("num_workers", 4)),
                pool=(PinnedPool(PIN_SLOTS, _BATCH_KEYS, register=True)
                      if cuda else None),
                shard_id=self.grid.batch_index,
                num_shards=self.n_data_shards)))
        self.copier = BatchCopier(self.device)
        # the next micro-step's batch, read ahead: (data set, device batch)
        self._ahead: Optional[tuple] = None
        self._stop_at: Optional[int] = None   # no read-ahead from this step
        self.data_types = [spec.get("type", "imagereport")
                           for spec in config.train_data_list]
        self.balance = (list(self.trainer_cfg.balance_loss_weight)
                        or [1.0] * max(len(self.loaders), 1))
        self.sampler = build_dataset_sampler(config.dataset_sampler,
                                             seed=config.random_seed)

        self.optimizer = build_optimizer(self.trainer_cfg, model.parameters(),
                                         sharding=self.sharding)
        self.steps_by_type = make_train_steps(
            model, self.optimizer, config, group=self.group,
            sharding=self.sharding)
        self.step = 0
        # host seconds spent waiting for the loaders, and batches taken
        self.data_wait_s = 0.0
        self.batches = 0

        self.ckpt = CheckpointManager(
            os.path.join(self.results_folder, "checkpoints"))
        if resume_step == -1:   # --auto_resume: the latest saved step
            resume_step = self.ckpt.latest_step()
        if resume_step:
            self.restore(resume_step)

        self.logger = MetricLogger(self.results_folder,
                                   project=config.project_name,
                                   exp_name=config.exp_name,
                                   use_wandb=use_wandb, enabled=self.is_main)
        self.status: Optional[str] = None
        self._preempted = False
        self._flag: Optional[torch.Tensor] = None   # all-reduced, read late
        self._prev_handlers: Dict[int, Any] = {}

    # -- state ---------------------------------------------------------------

    def save(self, *, wait: bool = False) -> None:
        """Every rank gathers the full state, rank 0 writes it; with
        ``wait`` every rank leaves once the write is on disk."""
        model = self.sharding.full_state_dict()
        optimizer = self.sharding.full_optimizer_state(self.optimizer)
        if self.is_main:
            self.ckpt.save(self.step, model,
                           {"optimizer": optimizer, "step": self.step},
                           wait=wait)
        if wait:
            multihost.sync_hosts()

    def restore(self, step: int) -> None:
        self._ahead = None
        saved = self.ckpt.restore(step)
        self.sharding.load_full_state_dict(saved["model"])
        self.sharding.load_full_optimizer_state(
            self.optimizer, saved["train_state"]["optimizer"])
        self.step = int(saved["train_state"]["step"])

    # -- batch plumbing --------------------------------------------------------

    def _schedule(self, step: int) -> List[int]:
        """The data set of each micro-step of ``step``, in order."""
        return [ds_idx for ds_idx, n in enumerate(self.sampler.sample(step))
                for _ in range(int(n))]

    def _start_batch(self, ds_idx: int) -> DeviceBatch:
        """Take the data set's next host batch (the wait counts as loader
        wait) and start its copy to the device."""
        t0 = time.perf_counter()
        batch = next(self.loaders[ds_idx])
        self.data_wait_s += time.perf_counter() - t0
        self.batches += 1
        return self.copier.start(batch, _BATCH_KEYS)

    def _device_batch(self, ds_idx: int) -> Dict[str, torch.Tensor]:
        """The micro-step's batch on the device: the read-ahead one, or
        the data set's next if none was read ahead."""
        ahead, self._ahead = self._ahead, None
        if ahead is None:
            ahead = (ds_idx, self._start_batch(ds_idx))
        elif ahead[0] != ds_idx:   # the schedule is a function of the step
            raise RuntimeError(f"read ahead a batch of data set {ahead[0]} "
                               f"for a micro-step of data set {ds_idx}")
        return {k: (v.long() if k in _ID_KEYS else v)
                for k, v in ahead[1].get().items()}

    # -- the loop --------------------------------------------------------------

    def train_step(self) -> Dict:
        """One optimizer step of sampler-scheduled micro-steps over the
        data sets.  Returns the step's metrics as device tensors (no host
        read).  Each micro-step's work is queued before the next
        micro-step's batch is taken and its copy started."""
        logs: Dict = {}
        schedule = self._schedule(self.step)
        for i, ds_idx in enumerate(schedule):
            step_fn = self.steps_by_type[self.data_types[ds_idx]]
            metrics = step_fn(self._device_batch(ds_idx),
                              float(self.balance[ds_idx]))
            for k, v in metrics.items():
                logs[f"ds{ds_idx}_{k}"] = v
            if i + 1 < len(schedule):
                nxt = schedule[i + 1]
            elif self._stop_at is None or self.step + 1 < self._stop_at:
                nxt = self._schedule(self.step + 1)[0]
            else:
                continue
            self._ahead = (nxt, self._start_batch(nxt))
        self.step += 1
        return logs

    def close(self) -> None:
        """Drop the read-ahead batch, stop the loaders' workers and free
        their page-locked buffers."""
        self._ahead = None
        for loader in self.loaders:
            loader.close()

    def install_preemption_handler(self) -> None:
        """SIGTERM and SIGINT set a flag: the loop finishes the step in
        flight, saves the full state and returns "preempted", resumable
        with --auto_resume.  ``train`` puts the previous handlers back when
        it returns."""
        for sig in (signal.SIGTERM, signal.SIGINT):
            self._prev_handlers[sig] = signal.signal(
                sig, lambda *_: setattr(self, "_preempted", True))

    def _stop_agreed(self) -> bool:
        """Whether to stop for preemption at this step boundary: the local
        flag for one process; under a group the flag all-reduced (MAX) at
        the previous boundary, read now that its step is done, while this
        boundary's all-reduce starts for the next."""
        if self.world_group is None:
            return self._preempted
        prev, self._flag = self._flag, all_reduce_max(torch.tensor(
            [float(self._preempted)], device=self.device), self.world_group)
        return prev is not None and bool(prev.item())

    def train(self, num_steps: Optional[int] = None,
              profile_dir: Optional[str] = None) -> str:
        """Run to ``num_steps`` (default: the config's num_train_steps);
        returns "completed" or "preempted", and keeps it as ``status``."""
        prof = None
        if profile_dir:
            from torch.profiler import ProfilerActivity, profile

            os.makedirs(profile_dir, exist_ok=True)
            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities)
            prof.start()
        total = num_steps or self.trainer_cfg.num_train_steps
        self._stop_at = total
        try:
            self.status = self._loop(total)
            return self.status
        finally:
            if prof is not None:
                prof.stop()
                prof.export_chrome_trace(os.path.join(profile_dir,
                                                      "trace.json"))
            for sig, handler in self._prev_handlers.items():
                signal.signal(sig, handler)
            self._prev_handlers = {}

    def _loop(self, total: int) -> str:
        tcfg = self.trainer_cfg
        timer = StepTimer()
        pending = None   # (step, logs with device tensors), read one late

        def flush_pending():
            nonlocal pending
            if pending is not None:
                pstep, plogs = pending
                self.logger.log({k: float(v) for k, v in plogs.items()},
                                step=pstep)
                pending = None

        while self.step < total:
            if self._stop_agreed():
                self._ahead = None
                flush_pending()
                self.save(wait=True)
                print(f"preempted at step {self.step}: state saved, exiting",
                      flush=True)
                return "preempted"
            with timer:
                logs = self.train_step()
                flush_pending()
            logs.update(timer.metrics())
            pending = (self.step, logs)
            if tcfg.save_model_every and self.step % tcfg.save_model_every == 0:
                self.save()
            if (self.eval_hooks and tcfg.eval_model_every
                    and self.step % tcfg.eval_model_every == 0):
                flush_pending()
                for name, hook in self.eval_hooks.items():
                    with self.sharding.gathered():
                        res = hook(self.model)
                    self.logger.log({f"eval/{name}/{k}": v
                                     for k, v in res.items()}, step=self.step)
            if (self.sample_hooks and tcfg.sample_val_every
                    and self.step % tcfg.sample_val_every == 0):
                flush_pending()
                for name, hook in self.sample_hooks.items():
                    with self.sharding.gathered():
                        paths = hook(self.model, self.step)
                    self.logger.log({f"sample/{name}/{k}": str(v)
                                     for k, v in paths.items()},
                                    step=self.step)
        flush_pending()
        self.save(wait=True)
        print("Training complete", flush=True)
        return "completed"
