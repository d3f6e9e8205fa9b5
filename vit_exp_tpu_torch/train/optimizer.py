"""Optimizer factory (counterpart of vit_exp_tpu/train/optimizer.py, which
builds it with optax):

- wd == 0 → Adam(betas=(0.9, 0.99), eps=1e-8);
- wd > 0  → AdamW, weight decay only on params of ndim >= 2;
- gradients clipped by global norm first, with optax's rule: kept when
  norm < max_norm, else multiplied by max_norm / norm
  (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm and would not
  match);
- a constant learning rate, or a linear warmup from 0 over warmup_steps,
  read at the number of updates already taken (optax's schedule count, so
  the first update of a warmup uses lr 0);
- with gradient_accumulation_steps k > 1, optax.MultiSteps semantics: each
  micro-step folds its gradient into a running mean (Welford's update,
  acc + (g − acc) / (n + 1), as optax writes it), and every k-th
  micro-step clips that mean and applies Adam to it, then resets it; the
  parameters are untouched in between.

``trainer_cfg`` is duck-typed: anything with lr, wd, max_grad_norm,
warmup_steps and gradient_accumulation_steps (the JAX package's
``TrainerConfig``).

``Optimizer.count`` counts micro-steps, kept in its state dict: it is the
JAX package's ``TrainState.step``, from which the train step derives its
random draws (train/steps.py), so a resumed run draws what an unbroken one
does.

``group`` (data parallelism): each micro-step's gradients are averaged
over the group's ranks after the zero fill and before they join the
accumulation (parallel/collectives.py::average_gradients, one all-reduce
of a flat buffer); the mean is linear, so accumulating averaged gradients
is averaging accumulated ones.  ``sharding`` (a parallel/sharding.py
``Sharded`` on a grid): the group is the grid's replica group, the sum is
divided by the batch's D·F shards (the fsdp ranks' part of the sum came
from the gather's reduce-scatter), weight decay is decided from each
parameter's full shape, never a flat shard's, and the global norm is
``Sharded.global_norm``, each element counted once.  The moments, the
accumulator and the zero fill work on the shards as they are.

``AdamWOptax`` is the fine-tuning optimizer (finetune/, text_classifier/),
``optax.adamw(schedule, weight_decay=wd)`` as the JAX package builds it
there, which is NOT the training optimizer above: b2 0.999, weight decay
on every parameter (biases and norms too), no clipping, the learning rate
read from ``schedule`` at the count of updates already taken.
``finetune_schedule`` is optax's ``warmup_cosine_decay_schedule`` from 0
to 0 as the fine-tuners build it (read at count 0 it gives lr 0, so the
first update of a warmup moves nothing but Adam's moments).
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional

import torch

from vit_exp_tpu_torch.parallel.collectives import average_gradients
from vit_exp_tpu_torch.parallel.sharding import full_shape


def global_norm(grads) -> torch.Tensor:
    """L2 norm over every gradient (0-dim fp32 tensor, no host read)."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))


def clip_by_global_norm_(grads, max_norm: float,
                         norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scale ``grads`` in place by max_norm / norm when norm ≥ max_norm
    (``norm``: their global norm where the caller has it, as on a grid);
    returns the norm before clipping."""
    norm = global_norm(grads) if norm is None else norm
    factor = torch.where(norm < max_norm, torch.ones_like(norm),
                         max_norm / norm)
    for g in grads:
        g.mul_(factor.to(g.dtype))
    return norm


class Optimizer:
    """Clip + Adam/AdamW + schedule over one set of parameters, with
    gradient accumulation over ``accumulation_steps`` micro-steps.
    ``step()`` is called once per micro-step and reads ``p.grad`` (a
    parameter without one counts as a zero gradient, as in the JAX package,
    where every parameter has a gradient); it keeps the global norm of the
    applied gradient before clipping as ``grad_norm`` (a 0-dim tensor:
    reading it waits for the device)."""

    def __init__(self, params: Iterable[torch.nn.Parameter], *, lr: float,
                 wd: float, max_grad_norm: float, warmup_steps: int,
                 accumulation_steps: int = 1, group=None, sharding=None):
        self.params = [p for p in params if p.requires_grad]
        self.group = group
        self.mean_over = None
        self.sharding = None
        grid = getattr(sharding, "grid", None)
        if grid is not None:
            self.group, self.mean_over = grid.replica, grid.batch_shards
            if sharding.tp is not None or sharding.fsdp is not None:
                self.sharding = sharding
        self.max_grad_norm = max_grad_norm
        self.grad_norm = None
        self.count = 0   # micro-steps taken
        self.accumulation_steps = max(1, int(accumulation_steps))
        self.mini_step = 0
        self.acc = ([torch.zeros_like(p) for p in self.params]
                    if self.accumulation_steps > 1 else None)
        kw = dict(lr=lr, betas=(0.9, 0.99), eps=1e-8)
        if wd == 0:
            self.opt = torch.optim.Adam(self.params, **kw)
        else:
            decay = [p for p in self.params if len(full_shape(p)) >= 2]
            rest = [p for p in self.params if len(full_shape(p)) < 2]
            self.opt = torch.optim.AdamW(
                [{"params": decay, "weight_decay": wd},
                 {"params": rest, "weight_decay": 0.0}], **kw)
        lam = ((lambda n: min(n / warmup_steps, 1.0)) if warmup_steps > 0
               else (lambda n: 1.0))
        self.schedule = torch.optim.lr_scheduler.LambdaLR(self.opt, lam)

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def step(self) -> None:
        """One micro-step; returns after the update on every
        ``accumulation_steps``-th call, after folding the gradient into the
        running mean on the others."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        average_gradients(self.params, self.group, self.mean_over)
        self.count += 1
        if self.acc is not None:
            n = self.mini_step
            for a, p in zip(self.acc, self.params):
                a.add_((p.grad - a) / (n + 1))
            self.mini_step = (n + 1) % self.accumulation_steps
            if self.mini_step:
                return
            for a, p in zip(self.acc, self.params):
                p.grad.copy_(a)
                a.zero_()
        grads = [p.grad for p in self.params]
        norm = (None if self.sharding is None
                else self.sharding.global_norm(self.params))
        if self.max_grad_norm and self.max_grad_norm > 0:
            self.grad_norm = clip_by_global_norm_(grads, self.max_grad_norm,
                                                  norm)
        else:
            self.grad_norm = global_norm(grads) if norm is None else norm
        self.opt.step()
        self.schedule.step()

    def state_dict(self) -> dict:
        """Adam's moments and count, the schedule, and the accumulator."""
        return {"opt": self.opt.state_dict(),
                "schedule": self.schedule.state_dict(),
                "mini_step": self.mini_step, "acc": self.acc,
                "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.opt.load_state_dict(state["opt"])
        self.schedule.load_state_dict(state["schedule"])
        self.mini_step = int(state["mini_step"])
        # a checkpoint from before the count was kept: its runs drew nothing
        self.count = int(state.get("count", 0))
        if self.acc is not None:
            for a, saved in zip(self.acc, state["acc"]):
                a.copy_(saved)


def build_optimizer(trainer_cfg, params, group=None,
                    sharding=None) -> Optimizer:
    return Optimizer(params, lr=trainer_cfg.lr, wd=trainer_cfg.wd,
                     max_grad_norm=trainer_cfg.max_grad_norm,
                     warmup_steps=getattr(trainer_cfg, "warmup_steps", 0),
                     accumulation_steps=getattr(
                         trainer_cfg, "gradient_accumulation_steps", 1),
                     group=group, sharding=sharding)


def finetune_schedule(lr: float, warmup_steps: int,
                      total_steps: int) -> Callable[[int], float]:
    """The fine-tuners' schedule, optax.warmup_cosine_decay_schedule(0, lr,
    warmup, horizon) (end value 0): linear from 0 over the warmup, then a
    half cosine to 0 at the horizon, held there; the warmup capped at
    max(total_steps // 10, 1), the horizon at least one step past it
    (optax needs decay_steps > warmup_steps)."""
    warmup = min(warmup_steps, max(total_steps // 10, 1))
    horizon = max(total_steps, warmup + 1)

    def schedule(count: int) -> float:
        if count < warmup:
            return lr * count / warmup
        c = min(count - warmup, horizon - warmup)
        return lr * 0.5 * (1.0 + math.cos(math.pi * c / (horizon - warmup)))

    return schedule


class AdamWOptax:
    """optax.adamw(schedule, weight_decay) over ``params``: b1 0.9, b2
    0.999, eps 1e-8, decay on every parameter, no clipping; ``step()`` sets
    the learning rate to schedule(updates taken) first.  A parameter
    without a gradient steps on a zero one (moments, decay), as optax
    steps every leaf of its tree."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 schedule: Callable[[int], float], weight_decay: float):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = schedule
        self.count = 0
        self.opt = torch.optim.AdamW(self.params, lr=schedule(0),
                                     betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=weight_decay)

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def step(self) -> None:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        for group in self.opt.param_groups:
            group["lr"] = self.schedule(self.count)
        self.opt.step()
        self.count += 1
