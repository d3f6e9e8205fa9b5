"""Parameter sharding and tensor parallelism on the process grid
(counterpart of vit_exp_tpu/parallel/sharding.py, whose flax helpers hand
JAX's logical-axis rules to GSPMD; here the same placement is written out
over the groups of core/mesh.py).

**Tensor parallelism (model > 1)**, JAX's HEADS and MLP → model rules.
``apply_tensor_parallel`` cuts, on every rank of the model group, these
parameters to the rank's contiguous share of heads or units (rank m of M
takes [n·m/M, n·(m+1)/M) of n, so an uneven count splits unevenly):

- the image tower's attention: ``to_q``'s rows of the rank's heads, the
  matching rows of both the k half and the v half of ``to_kv``,
  ``null_kv``'s heads and ``to_out``'s columns;
- the tower's GEGLU feed-forward: the rank's rows of both halves of W1
  (value and gate) and the matching columns of W2;
- BERT's attention (query, key and value with their biases, the output
  product's columns) and MLP (the intermediate product with its bias, the
  output product's columns).

Everything else stays whole on every rank: the patch embedding, every
norm, ``q_scale``/``k_scale``, the latents, the heads and the vocabulary.
JAX also shards VOCAB over the model axis; a whole copy computes the same
numbers.  The modules get ``tp_group`` and compute as models/ctvit3d.py,
models/layers.py and models/bert.py say.

**Parameter sharding (fsdp > 1)**, JAX's EMBED → fsdp rule, ZeRO-3:
``Sharded`` keeps on each rank of the fsdp group a flat 1/F of every
parameter (after the tensor-parallel cut), padded at the end, as the
parameter's ``.data``; its gradient and Adam moments follow.  The full
weights exist only while their module runs:

- the image tower's blocks and BERT's layers are units: a unit's forward
  gathers its parameters (``gather_shard``, whose backward reduce-scatters
  the gradient), runs, and puts the shards back.  What autograd saves of a
  gathered weight (the weight, a view of it, or its cast to the compute
  dtype followed by views) is kept as a token and gathered again when the
  backward reads it (saved-tensor hooks).  Under ``remat`` the tower's
  checkpoint keeps nothing of the block and its recompute runs the unit's
  forward again, which gathers again;
- every other parameter (patch embedding, norms, latents, heads,
  embeddings) is gathered for the length of ``gathered()``, which the
  train steps and the trainer's hooks enter, with the same hooks.

A module's results are those of the unsharded module: the gather is exact
and JAX's EMBED → fsdp rule changes no number.

**Gradients.** Over the batch group only (core/mesh.py): the replica
group all-reduces the shard gradients (``average_gradients``) and divides
by D·F, the fsdp ranks' sum having come from the reduce-scatter.  The
global norm counts every element once: a tensor-parallel parameter's
squares summed over the model group, then everything over the fsdp group.

**State.** ``full_state_dict`` gathers the reference key layout (rank 0
writes it), ``load_full_state_dict`` cuts a full one to the rank's share,
and ``full_optimizer_state``/``load_full_optimizer_state`` do the same for the
optimizer's moments and accumulator, so every grid reads every
checkpoint.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch

from vit_exp_tpu_torch.core.mesh import Grid, MeshError
from vit_exp_tpu_torch.parallel.collectives import (gather_dim, gather_rows,
                                                    gather_shard, rank, world)


@dataclasses.dataclass(frozen=True)
class TPSlice:
    """A parameter cut along ``dim``: ``halves`` equal halves of ``count``
    heads or units of ``unit`` entries each, each half cut alike."""
    dim: int
    count: int
    unit: int = 1
    halves: int = 1

    def bounds(self, m: int, parts: int) -> Tuple[int, int]:
        """Rank m's heads or units [a, b)."""
        return self.count * m // parts, self.count * (m + 1) // parts


def tp_slice(t: torch.Tensor, spec: TPSlice, m: int, parts: int
             ) -> torch.Tensor:
    """Rank m's share of a full parameter ``t`` (a new tensor)."""
    a, b = spec.bounds(m, parts)
    halves = t.chunk(spec.halves, dim=spec.dim)
    return torch.cat([h.narrow(spec.dim, a * spec.unit, (b - a) * spec.unit)
                      for h in halves], dim=spec.dim).clone()


def tp_join(parts: List[torch.Tensor], spec: TPSlice) -> torch.Tensor:
    """The full parameter from every rank's share, in rank order (one
    process holding them all)."""
    halves = [p.chunk(spec.halves, dim=spec.dim) for p in parts]
    return torch.cat([torch.cat([h[i] for h in halves], dim=spec.dim)
                      for i in range(spec.halves)], dim=spec.dim)


def tp_gather(t: torch.Tensor, spec: TPSlice, group) -> torch.Tensor:
    """The full parameter from the ranks' shares (collective)."""
    parts = world(group)
    sizes = [(b - a) * spec.unit for a, b in
             (spec.bounds(m, parts) for m in range(parts))]
    halves = t.chunk(spec.halves, dim=spec.dim)
    return torch.cat([gather_dim(h.contiguous(), group, spec.dim, sizes)
                      for h in halves], dim=spec.dim)


def tp_specs(model: torch.nn.Module) -> Dict[str, TPSlice]:
    """{parameter name: its cut} for every tensor-parallel parameter."""
    from vit_exp_tpu_torch.models.bert import BertLayer
    from vit_exp_tpu_torch.models.ctvit3d import CosineSelfAttention
    from vit_exp_tpu_torch.models.layers import GEGLUFeedForward

    out = {}
    for prefix, mod in model.named_modules():
        p = prefix + "." if prefix else ""
        if isinstance(mod, CosineSelfAttention):
            h, dh = mod.heads, mod.dim_head
            out.update({p + "to_q.weight": TPSlice(0, h, dh),
                        p + "to_kv.weight": TPSlice(0, h, dh, 2),
                        p + "null_kv": TPSlice(0, h),
                        p + "to_out.weight": TPSlice(1, h, dh)})
        elif isinstance(mod, GEGLUFeedForward):
            inner = mod._modules["4"].weight.shape[1]
            out.update({p + "1.weight": TPSlice(0, inner, 1, 2),
                        p + "4.weight": TPSlice(1, inner)})
        elif isinstance(mod, BertLayer):
            h = mod.heads
            dh = mod.cfg.hidden_size // mod.cfg.num_attention_heads
            inner = mod.cfg.intermediate_size
            for lin in ("query", "key", "value"):
                for kind in ("weight", "bias"):
                    out[f"{p}attention.self.{lin}.{kind}"] = TPSlice(0, h, dh)
            out.update({
                p + "attention.output.dense.weight": TPSlice(1, h, dh),
                p + "intermediate.dense.weight": TPSlice(0, inner),
                p + "intermediate.dense.bias": TPSlice(0, inner),
                p + "output.dense.weight": TPSlice(1, inner)})
    return out


def tp_width_refusals(model: torch.nn.Module, parts: int) -> List[str]:
    """What the card's GEGLU kernels refuse in this model's slices over
    ``parts`` ranks (K2 takes 2I a multiple of FF_WIDTH_STEP), one line a
    feed-forward; empty when they take every slice."""
    from vit_exp_tpu_torch.models.layers import GEGLUFeedForward
    from vit_exp_tpu_torch.ops.geglu_ff import FF_WIDTH_STEP

    out = []
    for name, mod in model.named_modules():
        if isinstance(mod, GEGLUFeedForward):
            spec = TPSlice(0, mod._modules["4"].weight.shape[1])
            widths = sorted({2 * (b - a) for a, b in
                             (spec.bounds(m, parts) for m in range(parts))})
            if any(w % FF_WIDTH_STEP for w in widths):
                out.append(f"{name}: the GEGLU kernels (K2, K8) take 2I a "
                           f"multiple of {FF_WIDTH_STEP}; a model axis of "
                           f"{parts} gives the ranks 2I {widths}")
    return out


def apply_tensor_parallel(model: torch.nn.Module, group) -> None:
    """Cut ``model``'s tensor-parallel parameters to this rank's share of
    the model group (in place; the rest stays whole) and set the modules'
    ``tp_group`` (``cut_to_rank``).  MeshError where a rank would get no
    head or unit; ValueError on the serving paths (fuse_qkv, int8), which
    keep every parameter whole, and, on the card, where a slice's width
    is one the kernels refuse (``tp_width_refusals``: named before any
    launch; nothing falls back to the plain path)."""
    from vit_exp_tpu_torch.models.bert import BertLayer
    from vit_exp_tpu_torch.models.ctvit3d import CosineSelfAttention
    from vit_exp_tpu_torch.models.layers import GEGLUFeedForward

    parts, m = world(group), rank(group)
    if parts == 1:
        return
    specs = tp_specs(model)
    for spec in specs.values():
        if spec.count < parts:
            raise MeshError(f"model axis {parts} leaves a rank without a "
                            f"head or unit: {spec.count} to share")
    on_card = any(p.is_cuda for p in model.parameters())
    refusals = tp_width_refusals(model, parts) if on_card else []
    if refusals:
        raise ValueError("the card's kernels do not take this model's "
                         "tensor-parallel slices: " + "; ".join(refusals))
    for mod in model.modules():
        if isinstance(mod, CosineSelfAttention) and (mod.fuse_qkv
                                                     or mod.int8):
            raise ValueError("tensor parallelism runs the training path "
                             "(fuse_qkv=False, int8=False)")
        if isinstance(mod, GEGLUFeedForward) and mod.int8:
            raise ValueError("tensor parallelism runs the bf16 "
                             "feed-forward, not the int8 one")
    cut_to_rank(model, m, parts)
    for mod in model.modules():
        if isinstance(mod, (CosineSelfAttention, GEGLUFeedForward,
                            BertLayer)):
            mod.tp_group = group


def cut_to_rank(model: torch.nn.Module, m: int, parts: int
                ) -> Dict[str, TPSlice]:
    """Cut ``model``'s tensor-parallel parameters, and its attention
    modules' head counts, to rank m's share of ``parts`` (in place); each
    parameter cut gets ``tp_spec``.  Returns the cuts by name.  The modules
    keep no group: ``apply_tensor_parallel`` sets it, or a caller sums the
    ranks' partial outputs itself (``chip_smoke.py``'s ``tp_by_rank``)."""
    from vit_exp_tpu_torch.models.bert import BertLayer
    from vit_exp_tpu_torch.models.ctvit3d import CosineSelfAttention

    specs = tp_specs(model)
    for mod in model.modules():
        if isinstance(mod, (CosineSelfAttention, BertLayer)):
            a, b = TPSlice(0, mod.heads).bounds(m, parts)
            mod.heads = b - a
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name in specs:
                p.data = tp_slice(p.data, specs[name], m, parts)
                p.tp_spec = specs[name]
    return specs


# autograd nodes through which a saved tensor still holds a gathered
# weight's values: views, at most one cast, the identity copy
_VIEWS = {"TBackward0", "ViewBackward0", "UnsafeViewBackward0",
          "ExpandBackward0", "PermuteBackward0", "TransposeBackward0",
          "UnsqueezeBackward0", "SqueezeBackward0", "AliasBackward0",
          "SliceBackward0", "SelectBackward0", "_CopyToGroupBackward"}
_TOKEN = object()


class Sharded:
    """A model's placement on ``grid``: its tensor-parallel cut over the
    model group and, with fsdp > 1, its parameters sharded over the fsdp
    group (the module docstring).  One process with no grid (``grid`` None,
    or a grid of one rank) leaves the model as it is and every method the
    identity."""

    def __init__(self, model: torch.nn.Module, grid: Optional[Grid]):
        self.model = model
        self.grid = grid
        self.tp = None if grid is None else grid.model
        self.fsdp = None if grid is None else grid.fsdp
        if self.tp is not None:
            apply_tensor_parallel(model, self.tp)
        self._root: List[tuple] = []
        self._live: Dict[int, torch.nn.Parameter] = {}
        if self.fsdp is not None:
            self._shard()

    # -- fsdp ----------------------------------------------------------------

    def _entries(self, module) -> List[tuple]:
        """(owner module, attribute, parameter) of every parameter under
        ``module``."""
        out = []
        for mod in module.modules():
            for attr, p in mod._parameters.items():
                if p is not None:
                    out.append((mod, attr, p))
        return out

    def _shard(self) -> None:
        from vit_exp_tpu_torch.models.bert import BertLayer
        from vit_exp_tpu_torch.models.ctvit3d import TransformerBlock

        n, f = world(self.fsdp), rank(self.fsdp)
        with torch.no_grad():
            for p in self.model.parameters():
                shape, numel = tuple(p.shape), p.numel()
                chunk = -(-numel // n)
                flat = torch.zeros(chunk * n, dtype=p.dtype, device=p.device)
                flat[:numel] = p.data.reshape(-1)
                p.data = flat[f * chunk:(f + 1) * chunk].clone()
                p.fsdp_shape = shape
        in_unit = set()
        for mod in self.model.modules():
            if isinstance(mod, (TransformerBlock, BertLayer)):
                entries = self._entries(mod)
                in_unit.update(id(p) for _, _, p in entries)
                self._wrap(mod, entries)
        self._root = [e for e in self._entries(self.model)
                      if id(e[2]) not in in_unit]

    def _wrap(self, unit, entries) -> None:
        forward = unit.forward
        vt = getattr(self.model, "visual_transformer", None)
        tower = unit in (() if vt is None else list(vt.enc_3D.layers))

        def run(*args, **kwargs):
            remat = tower and vt.remat and torch.is_grad_enabled()
            with self._gathered(entries, hooks=not remat):
                return forward(*args, **kwargs)

        unit.forward = run

    @contextlib.contextmanager
    def _gathered(self, entries, hooks: bool = True):
        fulls = []
        try:
            for owner, attr, p in entries:
                full = gather_shard(p, self.fsdp, p.fsdp_shape)
                if full.grad_fn is not None:
                    full.grad_fn.fsdp_param = p
                self._live[full.untyped_storage().data_ptr()] = p
                owner._parameters[attr] = full
                fulls.append(full)
            ctx = (torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                            self._unpack)
                   if hooks and torch.is_grad_enabled()
                   else contextlib.nullcontext())
            with ctx:
                yield
        finally:
            for owner, attr, p in entries:
                owner._parameters[attr] = p
            for full in fulls:
                self._live.pop(full.untyped_storage().data_ptr(), None)

    def gathered(self):
        """The parameters outside the units gathered for the length of the
        context (a no-op without fsdp)."""
        if self.fsdp is None:
            return contextlib.nullcontext()
        return self._gathered(self._root)

    def _source(self, t: torch.Tensor):
        """(parameter, dtype) when ``t`` holds a gathered weight's values
        (itself or a view: dtype None; views of its one cast: the cast's
        dtype), else None."""
        p = self._live.get(t.untyped_storage().data_ptr())
        if p is not None:
            return p, None
        fn, casts = t.grad_fn, 0
        while fn is not None:
            p = getattr(fn, "fsdp_param", None)
            if p is not None:
                size = math.prod(p.fsdp_shape) * t.element_size()
                ok = casts == 1 and t.untyped_storage().nbytes() == size
                return (p, t.dtype) if ok else None
            if type(fn).__name__ == "ToCopyBackward0":
                casts += 1
            elif type(fn).__name__ not in _VIEWS:
                return None
            fn = fn.next_functions[0][0] if fn.next_functions else None
        return None

    def _pack(self, t: torch.Tensor):
        src = self._source(t)
        if src is None:
            return t
        return (_TOKEN, src[0], src[1], t.size(), t.stride(),
                t.storage_offset())

    def _unpack(self, packed):
        if not (isinstance(packed, tuple) and packed and packed[0] is _TOKEN):
            return packed
        _, p, dtype, size, stride, offset = packed
        shape = p.fsdp_shape
        full = gather_rows(p.detach(), self.fsdp)[:math.prod(shape)]
        full = full.view(shape)
        if dtype is not None:
            full = full.to(dtype)
        return full.as_strided(size, stride, offset)

    # -- norms, state ----------------------------------------------------------

    def global_norm(self, params) -> torch.Tensor:
        """The L2 norm of the whole model's gradient (0-dim fp32): each
        element once."""
        dev = params[0].grad.device
        split = torch.zeros(2, dtype=torch.float32, device=dev)
        for p in params:
            split[int(hasattr(p, "tp_spec"))] += p.grad.float().square().sum()
        if self.tp is not None:
            cut = split[1:].clone()
            torch.distributed.all_reduce(cut, group=self.tp)
            split[1:] = cut
        total = split.sum().reshape(1)
        if self.fsdp is not None:
            torch.distributed.all_reduce(total, group=self.fsdp)
        return total[0].sqrt()

    def full_tensor(self, local: torch.Tensor, p) -> torch.Tensor:
        """A tensor laid out as parameter ``p``'s share (the parameter,
        a moment, an accumulator) gathered to its full shape (collective
        over the fsdp and model groups)."""
        t = local.detach()
        if hasattr(p, "fsdp_shape") and self.fsdp is not None:
            shape = p.fsdp_shape
            t = gather_rows(t.reshape(-1), self.fsdp)[:math.prod(shape)]
            t = t.view(shape)
        if hasattr(p, "tp_spec") and self.tp is not None:
            t = tp_gather(t, p.tp_spec, self.tp)
        return t

    def local_tensor(self, full: torch.Tensor, p) -> torch.Tensor:
        """This rank's share of a full tensor laid out as parameter ``p``
        (the inverse of ``full_tensor``; no collective)."""
        t = full
        if hasattr(p, "tp_spec") and self.tp is not None:
            t = tp_slice(t, p.tp_spec, rank(self.tp), world(self.tp))
        if hasattr(p, "fsdp_shape") and self.fsdp is not None:
            n, f = world(self.fsdp), rank(self.fsdp)
            numel = t.numel()
            chunk = -(-numel // n)
            flat = torch.zeros(chunk * n, dtype=t.dtype, device=t.device)
            flat[:numel] = t.reshape(-1)
            t = flat[f * chunk:(f + 1) * chunk]
        return t.clone()

    def full_state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's state dict in the reference layout, every parameter
        whole (collective: every rank calls it)."""
        state = self.model.state_dict(keep_vars=True)
        return {k: self.full_tensor(v, v) for k, v in state.items()}

    def load_full_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        """Load a full state dict (strict), each parameter cut to this
        rank's share."""
        own = self.model.state_dict(keep_vars=True)
        missing, extra = set(own) - set(state), set(state) - set(own)
        if missing or extra:
            raise KeyError(f"state dict keys differ: missing "
                           f"{sorted(missing)}, unexpected {sorted(extra)}")
        with torch.no_grad():
            for k, v in own.items():
                local = self.local_tensor(state[k].to(v.device), v)
                if local.shape != v.shape:
                    raise ValueError(f"{k}: {tuple(state[k].shape)} does "
                                     f"not fit {tuple(v.shape)}")
                v.copy_(local)

    def _moment_params(self, optimizer) -> List[torch.nn.Parameter]:
        """The optimizer's parameters in its state dict's index order."""
        return [p for g in optimizer.opt.param_groups for p in g["params"]]

    def full_optimizer_state(self, optimizer) -> dict:
        """``optimizer.state_dict()`` with every moment and accumulator
        gathered whole (collective)."""
        state = optimizer.state_dict()
        if self.grid is None or (self.tp is None and self.fsdp is None):
            return state
        order = self._moment_params(optimizer)
        opt = dict(state["opt"])
        opt["state"] = {
            i: {k: (self.full_tensor(v, order[i])
                    if torch.is_tensor(v) and k != "step" else v)
                for k, v in s.items()} for i, s in opt["state"].items()}
        out = dict(state, opt=opt)
        if state["acc"] is not None:
            out["acc"] = [self.full_tensor(a, p)
                          for a, p in zip(state["acc"], optimizer.params)]
        return out

    def load_full_optimizer_state(self, optimizer, state: dict) -> None:
        """Load a full optimizer state, each moment cut to this rank's
        share."""
        if self.grid is None or (self.tp is None and self.fsdp is None):
            optimizer.load_state_dict(state)
            return
        order = self._moment_params(optimizer)
        opt = dict(state["opt"])
        opt["state"] = {
            i: {k: (self.local_tensor(v.to(order[i].device), order[i])
                    if torch.is_tensor(v) and k != "step" else v)
                for k, v in s.items()} for i, s in opt["state"].items()}
        local = dict(state, opt=opt)
        if state.get("acc") is not None:
            local["acc"] = [self.local_tensor(a.to(p.device), p)
                            for a, p in zip(state["acc"], optimizer.params)]
        optimizer.load_state_dict(local)


def full_shape(p: torch.Tensor) -> Tuple[int, ...]:
    """A parameter's shape before the fsdp flattening (its tensor-parallel
    share's shape)."""
    return tuple(getattr(p, "fsdp_shape", p.shape))
