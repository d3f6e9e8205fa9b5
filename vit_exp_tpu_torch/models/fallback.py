"""The fallback towers: the reference's generic TextTransformer and 2D
VisionTransformer, what a CTCLIP builds when no encoder is injected
(counterpart of vit_exp_tpu/models/fallback.py).

- a γ-only LayerNorm (``RefLayerNorm``, biased variance, eps 1e-5 in fp32
  and 1e-3 in half precision);
- rotary embedding on rot_dim = min(dim_head, 32), applied to q, k AND v
  (the reference's quirk), q scaled by dim_head^-0.5 BEFORE the rotation;
- a GEGLU feed-forward with a LayerNorm between the gate and the
  out-projection; the attention's out-projection followed by a LayerNorm;
- pre-norm residual blocks between norm_in and norm_out;
- TextTransformer: learned absolute positions or rotary, optional causal
  mode, a CLS token in front when not causal (the mask padded True);
- VisionTransformer: 2D patches → Linear, learned positions, a static
  ``patch_dropout`` (keep max(1, int(n·(1 − prob))) tokens), the
  mean-pooled CLS projection in front of the tokens.

Plain softmax attention in fp32, as the JAX towers run it: no kernel.
Module and parameter names are the JAX package's (``attn{i}``, ``ff{i}``,
``g``; a Dense kernel is a Linear ``weight``, an Embed table ``weight``),
so models/convert.py::from_jax_fallback_params maps a JAX tree by name.
The patch dropout's draw, normal scores (b, n), is an optional argument.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from vit_exp_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from vit_exp_tpu_torch.models import bert
from vit_exp_tpu_torch.models.layers import Linear, empty_param


class RefLayerNorm(nn.Module):
    def __init__(self, dim: int, *, policy: Policy = DEFAULT_POLICY,
                 device=None):
        super().__init__()
        self.g = empty_param(dim, policy=policy, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        eps = 1e-5 if x.dtype == torch.float32 else 1e-3
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        return ((xf - mean) * torch.rsqrt(var + eps) * self.g.float()).to(
            x.dtype)


class Embedding(bert.Embedding):
    """BERT's table, looked up and cast to the compute dtype."""

    def __init__(self, num: int, dim: int, *, policy: Policy = DEFAULT_POLICY,
                 device=None):
        super().__init__(num, dim, policy=policy, device=device)
        self.policy = policy

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.weight[ids].to(self.policy.compute_dtype)


def rotary_freqs(rot_dim: int, seq_len: int, device=None) -> torch.Tensor:
    """(seq_len, rot_dim), the cat(freqs, freqs) layout."""
    inv = 1.0 / (10000 ** (torch.arange(0, rot_dim, 2, dtype=torch.float32,
                                        device=device) / rot_dim))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = t[:, None] * inv[None, :]
    return torch.cat([freqs, freqs], dim=-1)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rotary_pos_emb(freqs: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Rotate the first rot_dim lanes, pass the rest."""
    rot = freqs.shape[-1]
    t_rot, t_pass = t[..., :rot], t[..., rot:]
    t_rot = t_rot * torch.cos(freqs) + _rotate_half(t_rot) * torch.sin(freqs)
    return torch.cat([t_rot, t_pass], dim=-1)


def patch_dropout(x: torch.Tensor, prob: float,
                  scores: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """Keep the max(1, int(n·(1 − prob))) tokens of each row with the
    highest normal ``scores`` (b, n), in descending score order (the lower
    index first on a tie, as lax.top_k)."""
    b, n = x.shape[:2]
    keep = max(1, int(n * (1.0 - prob)))
    if scores is None:
        scores = torch.randn(b, n, generator=generator, device=x.device)
    idx = scores.to(x.device).argsort(dim=-1, descending=True,
                                      stable=True)[:, :keep]
    return x.gather(1, idx[..., None].expand(b, keep, x.shape[-1]))


class FallbackFeedForward(nn.Module):
    """Linear → GEGLU (exact erf) → LayerNorm(inner) → Linear."""

    def __init__(self, dim: int, mult: int = 4, *,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        inner = int(dim * mult)
        kw = dict(policy=policy, device=device)
        self.wi = Linear(dim, inner * 2, bias=False, **kw)
        self.ln_inner = RefLayerNorm(inner, **kw)
        self.wo = Linear(inner, dim, bias=False, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        val, gate = self.wi(x).chunk(2, dim=-1)
        h = val * torch.nn.functional.gelu(gate.float()).to(val.dtype)
        return self.wo(self.ln_inner(h))


class FallbackAttention(nn.Module):
    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8,
                 causal: bool = False, *, policy: Policy = DEFAULT_POLICY,
                 device=None):
        super().__init__()
        self.heads, self.dim_head, self.causal = heads, dim_head, causal
        kw = dict(policy=policy, device=device)
        inner = heads * dim_head
        self.to_qkv = Linear(dim, inner * 3, bias=False, **kw)
        self.to_out = Linear(inner, dim, bias=False, **kw)
        self.out_norm = RefLayerNorm(dim, **kw)

    def forward(self, x, mask=None, rotary=None):
        b, n, _ = x.shape
        h, dh = self.heads, self.dim_head

        def heads_first(t):
            return t.reshape(b, n, h, dh).transpose(1, 2)

        q, k, v = (heads_first(t) for t in self.to_qkv(x).chunk(3, dim=-1))
        q = q * (dh ** -0.5)
        if rotary is not None:
            q, k, v = (apply_rotary_pos_emb(rotary, t) for t in (q, k, v))
        sim = torch.matmul(q.float(), k.float().transpose(-1, -2))
        neg = torch.finfo(torch.float32).min
        if mask is not None:
            sim = sim.masked_fill(~mask[:, None, None, :].bool(), neg)
        if self.causal:
            causal = torch.ones(n, n, dtype=torch.bool,
                                device=x.device).tril()
            sim = sim.masked_fill(~causal, neg)
        attn = torch.softmax(sim, dim=-1).to(v.dtype)
        out = torch.matmul(attn.float(), v.float()).to(v.dtype)
        out = self.to_out(out.transpose(1, 2).reshape(b, n, h * dh))
        return self.out_norm(out)


class FallbackTransformer(nn.Module):
    """norm_in → depth × [pre-norm attention + x, pre-norm FF + x] →
    norm_out."""

    def __init__(self, dim: int, depth: int, dim_head: int = 64,
                 heads: int = 8, causal: bool = False, ff_mult: int = 4, *,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        self.depth = depth
        kw = dict(policy=policy, device=device)
        self.norm_in = RefLayerNorm(dim, **kw)
        for i in range(depth):
            self.add_module(f"pre_attn{i}", RefLayerNorm(dim, **kw))
            self.add_module(f"attn{i}", FallbackAttention(
                dim, dim_head, heads, causal, **kw))
            self.add_module(f"pre_ff{i}", RefLayerNorm(dim, **kw))
            self.add_module(f"ff{i}", FallbackFeedForward(dim, ff_mult, **kw))
        self.norm_out = RefLayerNorm(dim, **kw)

    def forward(self, x, mask=None, rotary=None):
        m = self._modules
        x = self.norm_in(x)
        for i in range(self.depth):
            x = m[f"attn{i}"](m[f"pre_attn{i}"](x), mask, rotary) + x
            x = m[f"ff{i}"](m[f"pre_ff{i}"](x)) + x
        return self.norm_out(x)


class TextTransformer(nn.Module):
    def __init__(self, dim: int, num_tokens: int, max_seq_len: int,
                 depth: int = 6, dim_head: int = 64, heads: int = 8,
                 rotary_pos_emb: bool = False, causal: bool = False, *,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        self.dim, self.dim_head = dim, dim_head
        self.rotary_pos_emb, self.causal = rotary_pos_emb, causal
        kw = dict(policy=policy, device=device)
        self.token_emb = Embedding(num_tokens, dim, **kw)
        if not rotary_pos_emb:
            self.abs_pos_emb = Embedding(max_seq_len, dim, **kw)
        if not causal:
            self.cls_token = empty_param(dim, **kw)
        self.transformer = FallbackTransformer(dim, depth, dim_head, heads,
                                               causal, **kw)

    def reset_parameters(self, generator: torch.Generator) -> None:
        if not self.causal:
            nn.init.normal_(self.cls_token, 0.0, 1.0, generator=generator)

    def forward(self, ids: torch.Tensor, mask=None) -> torch.Tensor:
        b, n = ids.shape
        x = self.token_emb(ids)
        if not self.rotary_pos_emb:
            x = x + self.abs_pos_emb(torch.arange(n, device=ids.device))[None]
        if not self.causal:
            cls = self.cls_token.to(x.dtype).expand(b, 1, self.dim)
            x = torch.cat([cls, x], dim=1)
            if mask is not None:
                mask = torch.nn.functional.pad(mask.bool(), (1, 0),
                                               value=True)
        rotary = (rotary_freqs(min(self.dim_head, 32), x.shape[1], x.device)
                  if self.rotary_pos_emb else None)
        return self.transformer(x, mask=mask, rotary=rotary)


class VisionTransformer(nn.Module):
    """Output (b, 1 + n_patches, dim): the mean-pooled CLS projection in
    front of the tokens."""

    def __init__(self, dim: int, image_size: int, patch_size: int,
                 channels: int = 3, depth: int = 6, dim_head: int = 64,
                 heads: int = 8, patch_dropout: float = 0.5, *,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        if image_size % patch_size:
            raise ValueError("image_size must be a multiple of patch_size")
        self.patch_size, self.patch_dropout = patch_size, patch_dropout
        self.policy = policy
        grid = (image_size // patch_size) ** 2
        kw = dict(policy=policy, device=device)
        self.to_tokens = Linear(patch_size * patch_size * channels, dim, **kw)
        self.pos_emb = Embedding(grid, dim, **kw)
        self.transformer = FallbackTransformer(dim, depth, dim_head, heads,
                                               **kw)
        self.to_cls = Linear(dim, dim, bias=False, **kw)

    def forward(self, images: torch.Tensor, *, keep_all_patches: bool = True,
                deterministic: bool = True,
                dropout_scores: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        p = self.patch_size
        b, c, hh, ww = images.shape
        gh, gw = hh // p, ww // p
        x = images.reshape(b, c, gh, p, gw, p).permute(0, 2, 4, 3, 5, 1)
        x = self.to_tokens(x.reshape(b, gh * gw, p * p * c).to(
            self.policy.compute_dtype))
        x = x + self.pos_emb(torch.arange(x.shape[1], device=x.device))[None]
        if not (deterministic or keep_all_patches) and self.patch_dropout:
            x = patch_dropout(x, self.patch_dropout, dropout_scores,
                              generator)
        out = self.transformer(x)
        cls = self.to_cls(out.mean(dim=1))
        return torch.cat([cls[:, None], out], dim=1)
