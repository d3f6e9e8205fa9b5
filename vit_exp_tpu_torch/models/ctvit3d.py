"""CTViT3D image tower, encoder only (counterpart of
vit_exp_tpu/models/ctvit3d.py with ff_impl="pallas": fused patch embed,
cosine attention, fused GEGLU feed-forward, every kernel differentiable).
``attn_impl`` takes the JAX names: "pallas_static" (the default) is the
static-max attention kernel K1, "pallas" (the JAX package's training
default on its accelerator) the online-softmax kernel K15 over the nulls
concatenated to k/v.  ``remat`` recomputes each block's forward in the
backward (``torch.utils.checkpoint``, the JAX ``--remat``).  ``fuse_qkv`` selects the fused
LN+qkv projection (a serving switch, as in the JAX package); training keeps
the unfused ScaleLayerNorm + to_q + to_kv, with the same parameters.
``int8`` is the W8A8 serving path (the JAX attn_impl="pallas_static_int8"
with ff_impl="pallas_int8"): int8 attention and the int8 feed-forward, and
with ``fuse_qkv`` the int8 LN+qkv projection and out-projection too.  The
state dict is the same in every mode.

``seq_group`` shards the tokens over a process group (sequence
parallelism, the JAX ``seq_axis``): every rank runs the patch embedding
and the position embedding on the whole volume, takes its chunk of the
tokens (rank r of R the r-th of R equal chunks; a token count R does not
divide raises), runs the blocks on it with ring attention (the nulls
merged outside the ring; the norms, projections and feed-forward are
per-token, so local), and the full grid is gathered back at the end by the
differentiable all-gather of parallel/collectives.py.  The parameter names
do not change.  As in the JAX package, only a caller that builds the tower
itself sets it; no config or CLI key does.

``k_amax_reduce`` (None by default) is the int8 path's one k scale over a
batch that several ranks or cards encode in parts: each block's k amax goes
through it (ops/flash_attention.py::quantize_qk).  The engines set it for
the length of a call (eval/zero_shot.py::shared_k_scale).

``tp_group`` on an attention or feed-forward module (set by
parallel/sharding.py::apply_tensor_parallel, with the module's parameters
cut to this rank's heads or units) runs tensor parallelism over the model
group: the input through ``copy_to_group``, this rank's slice of the
products, and the partial outputs summed over the group in fp32
(``reduce_from_group``).  ``partial`` is one rank's share before that sum,
with ``copy`` in the place of ``copy_to_group``.

Module and parameter names follow the reference ``visual_transformer``:
``to_patch_emb.{1,2,3}`` (LN in, Linear, LN out), ``enc_3D.layers.{i}.1``
(attention) and ``.3`` (feed-forward), ``enc_3D.norm_out``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from vit_exp_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from vit_exp_tpu_torch.models.layers import (BiasLayerNorm, GEGLUFeedForward,
                                             Linear, ScaleLayerNorm, empty_param)
from vit_exp_tpu_torch.ops.attention import cosine_attention
from vit_exp_tpu_torch.ops.fused_proj import (fused_ln_qkv, fused_ln_qkv_int8,
                                              int8_proj)
from vit_exp_tpu_torch.ops.patches import fused_patch_embed
from vit_exp_tpu_torch.ops.posemb import sincos_pos_embed_3d
from vit_exp_tpu_torch.parallel.collectives import (all_gather,
                                                    copy_to_group, rank,
                                                    reduce_from_group, world)

ATTN_IMPLS = ("pallas_static", "pallas")


class CosineSelfAttention(nn.Module):
    """QK-l2norm self-attention with learned per-dim q/k scales and null kv.

    k/v project from the PRE-LayerNorm x; only q sees the normed x (the
    reference binds the kv input before its norm).  ``null_kv`` is laid out
    'h (n r) d' with r = 2: k rows are the even entries, v rows the odd ones.
    ``fuse_qkv`` runs the norm and both projections as one kernel (K3).
    ``attn_impl`` picks the attention kernel ("pallas_static": K1,
    "pallas": K15).  ``int8`` runs the attention with int8 QKᵀ (static-max
    only); with ``fuse_qkv`` too, the
    route is the W8A8 LN+qkv kernel, int8 attention and the W8A8
    out-projection (K12/K13 → K9/K10 → K14 in the JAX package); without
    it, the unfused projections, int8 attention and the bf16 to_out.
    "xla" is the plain route of ops/attention.py (``xla=True``), the only
    one that takes ``mask``, ``attn_bias`` or ``context``; the legacy
    generative stack builds it with ``use_kernels=False``.  ``dim_context``
    adds the cross-attention's ``context_norm`` (γ-only, over the context
    width) and makes to_kv project the normed context instead of x.
    """

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 32,
                 num_null_kv: int = 2, scale: Optional[float] = None, *,
                 policy: Policy = DEFAULT_POLICY, use_kernels: bool = True,
                 attn_impl: str = "pallas_static", fuse_qkv: bool = False,
                 int8: bool = False, dim_context: Optional[int] = None,
                 device=None):
        super().__init__()
        if attn_impl not in ATTN_IMPLS + ("xla",):
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS} or "
                             f"'xla', got {attn_impl!r}")
        if int8 and attn_impl != "pallas_static":
            raise ValueError("int8 attention is static-max only: pass "
                             "attn_impl='pallas_static'")
        if attn_impl == "xla" and (fuse_qkv or use_kernels):
            raise ValueError("attn_impl='xla' is the plain route: pass "
                             "use_kernels=False and no fuse_qkv")
        inner = heads * dim_head
        self.heads, self.dim_head, self.num_null_kv = heads, dim_head, num_null_kv
        self.scale = scale
        self.policy = policy
        self.use_kernels = use_kernels
        self.static_max = attn_impl == "pallas_static"
        self.xla = attn_impl == "xla"
        self.fuse_qkv = fuse_qkv
        self.int8 = int8
        self.tp_group = None
        kw = dict(policy=policy, device=device)
        self.norm = ScaleLayerNorm(dim, **kw)
        self.null_kv = empty_param(heads, 2 * num_null_kv, dim_head, **kw)
        self.to_q = Linear(dim, inner, bias=False, **kw)
        if dim_context is not None:
            self.context_norm = ScaleLayerNorm(dim_context, **kw)
        self.to_kv = Linear(dim_context or dim, 2 * inner, bias=False, **kw)
        self.q_scale = empty_param(dim_head, **kw)
        self.k_scale = empty_param(dim_head, **kw)
        self.to_out = Linear(inner, dim, bias=False, **kw)

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.null_kv, 0.0, 1.0, generator=generator)
        nn.init.ones_(self.q_scale)
        nn.init.ones_(self.k_scale)

    def forward(self, x: torch.Tensor, ring_group=None,
                k_amax_reduce=None, *, context=None, mask=None,
                attn_bias=None) -> torch.Tensor:
        """x: (b, n, dim), the rank's token shard under ``ring_group``;
        ``context`` (b, m, dim_context), ``mask`` and ``attn_bias``: the
        "xla" route only."""
        if self.xla:
            return self._xla(x, context, mask, attn_bias)
        if context is not None or mask is not None or attn_bias is not None:
            raise ValueError("context, mask and attn_bias need "
                             "attn_impl='xla'")
        g = self.tp_group
        if g is None:
            return self.partial(x, ring_group=ring_group,
                                k_amax_reduce=k_amax_reduce)
        out = self.partial(x, lambda t: copy_to_group(t, g), ring_group)
        return reduce_from_group(out, g).to(self.policy.compute_dtype)

    def _xla(self, x, context, mask, attn_bias) -> torch.Tensor:
        """The JAX module at attn_impl="xla": self-attention k/v from the
        pre-LN x, cross-attention k/v from context_norm(context)."""
        b, n, _ = x.shape
        h, dh = self.heads, self.dim_head
        kv_input = x if context is None else self.context_norm(context)
        q, kv = self.to_q(self.norm(x)), self.to_kv(kv_input)
        k, v = kv.split(h * dh, dim=-1)

        def heads_first(t):
            return t.reshape(b, t.shape[1], h, dh).transpose(1, 2)

        nkv = self.null_kv.reshape(h, self.num_null_kv, 2, dh)
        out = cosine_attention(
            heads_first(q), heads_first(k), heads_first(v),
            null_k=nkv[:, :, 0], null_v=nkv[:, :, 1], q_scale=self.q_scale,
            k_scale=self.k_scale, scale=self.scale, mask=mask,
            attn_bias=attn_bias, xla=True)
        return self.to_out(out.transpose(1, 2).reshape(b, n, h * dh))

    def partial(self, x: torch.Tensor, copy=None, ring_group=None,
                k_amax_reduce=None) -> torch.Tensor:
        """The attention over this module's heads.  Without ``copy`` it is
        the module's whole output in the compute dtype; with it (tensor
        parallelism) the out-projection's partial sum over these heads in
        fp32 (bf16 operands, fp32 products), and ``copy`` applied to the
        inputs of the sharded products and to the shared q/k scales."""
        b, n, _ = x.shape
        h, dh = self.heads, self.dim_head
        cd = self.policy.compute_dtype
        same = copy or (lambda t: t)
        if self.fuse_qkv and self.int8:
            q, k, v = fused_ln_qkv_int8(
                x.to(cd), self.norm.gamma, self.to_q.weight.t(),
                self.to_kv.weight.t(), use_kernel=self.use_kernels)
        else:
            if self.fuse_qkv:
                q, kv = fused_ln_qkv(x.to(cd), self.norm.gamma,
                                     self.to_q.weight.t(),
                                     self.to_kv.weight.t(),
                                     use_kernel=self.use_kernels)
            else:
                q, kv = self.to_q(same(self.norm(x))), self.to_kv(same(x))
            k, v = kv.split(h * dh, dim=-1)

        def heads_first(t):   # a strided view, no copy
            return t.reshape(b, n, h, dh).transpose(1, 2)

        nkv = self.null_kv.reshape(h, self.num_null_kv, 2, dh)
        out = cosine_attention(
            heads_first(q), heads_first(k), heads_first(v),
            null_k=nkv[:, :, 0], null_v=nkv[:, :, 1],
            q_scale=same(self.q_scale), k_scale=same(self.k_scale),
            scale=self.scale, use_kernel=self.use_kernels,
            static_max=self.static_max, quantized=self.int8,
            ring_group=ring_group, k_amax_reduce=k_amax_reduce)
        out = out.transpose(1, 2).reshape(b, n, h * dh)
        if copy is not None:
            return F.linear(out.to(cd).float(),
                            self.to_out.weight.to(cd).float())
        if self.int8 and self.fuse_qkv:
            return int8_proj(out.to(cd), self.to_out.weight.t(),
                             use_kernel=self.use_kernels)
        return self.to_out(out)


class TransformerBlock(nn.Module):
    """x + attn(x), then x + ff(x); children named 1 (attention) and 3
    (feed-forward) as in the reference layer list."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 scale: Optional[float], ff_mult: float = 4.0, *,
                 policy: Policy = DEFAULT_POLICY, use_kernels: bool = True,
                 attn_impl: str = "pallas_static", fuse_qkv: bool = False,
                 int8: bool = False, device=None):
        super().__init__()
        self.add_module("1", CosineSelfAttention(
            dim, heads, dim_head, scale=scale, policy=policy,
            use_kernels=use_kernels, attn_impl=attn_impl, fuse_qkv=fuse_qkv,
            int8=int8, device=device))
        self.add_module("3", GEGLUFeedForward(
            dim, ff_mult, policy=policy, use_kernel=use_kernels, int8=int8,
            device=device))

    def forward(self, x: torch.Tensor, ring_group=None,
                k_amax_reduce=None) -> torch.Tensor:
        x = x + self._modules["1"](x, ring_group, k_amax_reduce)
        return x + self._modules["3"](x)


class _Encoder(nn.Module):
    def __init__(self, layers, norm_out):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.norm_out = norm_out


class CTViT3D(nn.Module):
    def __init__(self, dim: int = 768, image_size: int = 480,
                 patch_size: int = 20, temporal_size: int = 240,
                 temporal_patch_size: int = 10, transformer_blocks: int = 8,
                 dim_head: int = 32, heads: int = 8, channels: int = 1,
                 attn_scale: Optional[float] = None, *,
                 policy: Policy = DEFAULT_POLICY, use_kernels: bool = True,
                 attn_impl: str = "pallas_static", remat: bool = False,
                 fuse_qkv: bool = False, int8: bool = False, device=None,
                 seq_group=None):
        super().__init__()
        self.dim = dim
        self.remat = remat
        self.seq_group = seq_group
        self.k_amax_reduce = None
        self.patch_size, self.temporal_patch_size = patch_size, temporal_patch_size
        self.grid = (temporal_size // temporal_patch_size,
                     image_size // patch_size, image_size // patch_size)
        self.policy = policy
        self.use_kernels = use_kernels
        kw = dict(policy=policy, device=device)
        patch_dim = channels * patch_size * patch_size * temporal_patch_size
        self.to_patch_emb = nn.ModuleDict({
            "1": BiasLayerNorm(patch_dim, **kw),
            "2": Linear(patch_dim, dim, **kw),
            "3": BiasLayerNorm(dim, **kw),
        })
        self.enc_3D = _Encoder(
            [TransformerBlock(dim, heads, dim_head, attn_scale,
                              use_kernels=use_kernels, attn_impl=attn_impl,
                              fuse_qkv=fuse_qkv, int8=int8, **kw)
             for _ in range(transformer_blocks)],
            ScaleLayerNorm(dim, **kw))
        # fixed table; not part of the state dict
        self.register_buffer(
            "pos_embed",
            torch.from_numpy(sincos_pos_embed_3d(dim, self.grid)).to(device),
            persistent=False)

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        """video: (b, c, T, H, W) → encoded tokens (b, t, h, w, dim)."""
        b = video.shape[0]
        n_t, n_h, n_w = self.grid
        ln_in, proj, ln_out = (self.to_patch_emb[k] for k in "123")
        x = fused_patch_embed(
            video, ln_in.weight, ln_in.bias, proj.weight.t(), proj.bias,
            self.temporal_patch_size, self.patch_size, self.patch_size,
            compute_dtype=self.policy.compute_dtype,
            use_kernel=self.use_kernels)
        x = ln_out(x).reshape(b, n_t * n_h * n_w, self.dim)
        x = x + self.pos_embed.to(self.policy.compute_dtype)[None]
        group = self.seq_group
        if group is not None:
            ring, n_tok = world(group), x.shape[1]
            if n_tok % ring:
                raise ValueError(f"{n_tok} tokens not divisible by {ring} "
                                 f"seq shards")
            chunk = n_tok // ring
            x = x[:, rank(group) * chunk:(rank(group) + 1) * chunk]
        reduce = self.k_amax_reduce
        for block in self.enc_3D.layers:
            if self.remat and torch.is_grad_enabled():
                x = torch.utils.checkpoint.checkpoint(block, x, group, reduce,
                                                      use_reentrant=False)
            else:
                x = block(x, group, reduce)
        x = all_gather(self.enc_3D.norm_out(x), group, dim=1)
        return x.reshape(b, n_t, n_h, n_w, self.dim)
