"""MaskGIT over the CTViT token grid, text to CT video (counterpart of
vit_exp_tpu/models/maskgit.py).

- ``MaskGit``: a bidirectional transformer over VQ token ids with one extra
  embedding row for [MASK], cross-attention to the text states through a
  padding mask, and classifier-free guidance (``cond_drop_mask`` zeroes the
  projected context; ``forward_with_cond_scale`` returns uncond + (cond −
  uncond)·scale);
- ``SelfCritic``: a Linear on the MaskGit trunk's embeddings scoring how
  wrong each token looks;
- ``maskgit_train_masking`` / ``maskgit_loss``: cosine-schedule masking and
  the CE over the masked positions;
- ``maskgit_sample``: iterative demasking — gumbel-noised candidates at an
  annealed temperature, confidences from the model or the critic, the least
  confident remasked on the cosine schedule — a Python loop over the steps.

Attention is the plain route of ops/attention.py (attn_impl="xla", which
takes the mask) and the feed-forward its plain version: no kernel, as the
JAX modules run impl="xla".

Every random draw is an optional argument (``draws``): the uniforms of the
masking, and per sampling step the gumbel uniforms and the critic noise.
Without it the draws come from ``generator``.  The schedule's (s+1)/steps,
the temperature and floor(frac·seq_len) are float32, as JAX traces them;
ranks come from stable argsorts, as jnp.argsort's.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from vit_exp_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from vit_exp_tpu_torch.models.ctvit3d import CosineSelfAttention
from vit_exp_tpu_torch.models.layers import (GEGLUFeedForward, Linear,
                                             ScaleLayerNorm, empty_param)


def cosine_schedule(t: torch.Tensor) -> torch.Tensor:
    """Fraction masked at progress t ∈ [0, 1]."""
    return torch.cos(t * math.pi * 0.5)


class MaskGitBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int,
                 cross: bool = False, *, policy: Policy = DEFAULT_POLICY,
                 device=None):
        super().__init__()
        kw = dict(policy=policy, device=device, use_kernels=False,
                  attn_impl="xla")
        self.self_attn = CosineSelfAttention(dim, heads, dim_head, **kw)
        self.cross_attn = (CosineSelfAttention(dim, heads, dim_head,
                                               dim_context=dim, **kw)
                           if cross else None)
        self.ff = GEGLUFeedForward(dim, policy=policy, use_kernel=False,
                                   device=device)

    def forward(self, x, context=None, context_mask=None):
        x = x + self.self_attn(x)
        if context is not None:
            mask = (None if context_mask is None
                    else context_mask[:, None, None, :].bool())
            x = x + self.cross_attn(x, context=context, mask=mask)
        return x + self.ff(x)


class MaskGit(nn.Module):
    """Bidirectional demasking transformer over VQ token ids;
    ``dim_context`` (the text states' width) builds the context projection
    and the cross-attention."""

    def __init__(self, num_tokens: int, max_seq_len: int, dim: int = 512,
                 depth: int = 6, heads: int = 8, dim_head: int = 64,
                 dim_context: Optional[int] = None, *,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        self.num_tokens, self.dim = num_tokens, dim
        self.policy = policy
        kw = dict(policy=policy, device=device)
        self.token_emb = empty_param(num_tokens + 1, dim, **kw)
        self.pos_emb = empty_param(max_seq_len, dim, **kw)
        self.context_proj = (Linear(dim_context, dim, **kw)
                             if dim_context is not None else None)
        self.blocks = nn.ModuleList([
            MaskGitBlock(dim, heads, dim_head, cross=dim_context is not None,
                         **kw) for _ in range(depth)])
        self.norm_out = ScaleLayerNorm(dim, **kw)
        self.to_logits = Linear(dim, num_tokens, bias=False, **kw)

    @property
    def mask_id(self) -> int:
        return self.num_tokens

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.token_emb, 0.0, 0.02, generator=generator)
        nn.init.normal_(self.pos_emb, 0.0, 0.02, generator=generator)

    def forward(self, token_ids: torch.Tensor, *,
                context: Optional[torch.Tensor] = None,
                context_mask: Optional[torch.Tensor] = None,
                cond_drop_mask: Optional[torch.Tensor] = None,
                return_embeds: bool = False) -> torch.Tensor:
        """token_ids (b, n) with mask_id holes → fp32 logits (b, n,
        num_tokens), or the trunk's fp32 embeddings with
        ``return_embeds``."""
        n = token_ids.shape[1]
        x = self.token_emb[token_ids] + self.pos_emb[None, :n]
        x = x.to(self.policy.compute_dtype)
        if context is not None:
            context = self.context_proj(context)
            if cond_drop_mask is not None:
                context = torch.where(cond_drop_mask[:, None, None].bool(),
                                      torch.zeros_like(context), context)
        for block in self.blocks:
            x = block(x, context, context_mask)
        x = self.norm_out(x)
        if return_embeds:
            return x.float()
        return self.to_logits(x).float()

    def forward_with_cond_scale(self, token_ids, *, context, context_mask,
                                cond_scale: float = 3.0) -> torch.Tensor:
        """Classifier-free guidance: uncond + (cond − uncond)·cond_scale."""
        cond = self(token_ids, context=context, context_mask=context_mask)
        if cond_scale == 1.0:
            return cond
        drop = torch.ones(token_ids.shape[0], dtype=torch.bool,
                          device=token_ids.device)
        uncond = self(token_ids, context=context, context_mask=context_mask,
                      cond_drop_mask=drop)
        return uncond + (cond - uncond) * cond_scale


class SelfCritic(nn.Module):
    """Linear(dim, 1) on the MaskGit trunk's embeddings.  ``to_pred`` runs
    at the default (bf16) policy whatever the net's, as the JAX module's
    PDense does."""

    def __init__(self, net: MaskGit, device=None):
        super().__init__()
        self.net = net
        self.to_pred = Linear(net.dim, 1, policy=DEFAULT_POLICY,
                              device=device)

    def forward(self, token_ids: torch.Tensor, **kwargs) -> torch.Tensor:
        embeds = self.net(token_ids, return_embeds=True, **kwargs)
        return self.to_pred(embeds.float())[..., 0]


class MaskingDraws(NamedTuple):
    t: torch.Tensor        # (b,) U[0, 1): the schedule's progress
    scores: torch.Tensor   # (b, n) U[0, 1): which positions to mask


def maskgit_train_masking(token_ids: torch.Tensor, mask_id: int, *,
                          draws: Optional[MaskingDraws] = None,
                          generator: Optional[torch.Generator] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mask max(ceil(cos(t·π/2)·n), 1) random positions of each row:
    (masked ids, mask)."""
    b, n = token_ids.shape
    dev = token_ids.device
    if draws is None:
        draws = MaskingDraws(
            torch.rand(b, generator=generator, device=dev),
            torch.rand(b, n, generator=generator, device=dev))
    t, scores = draws.t.to(dev).float(), draws.scores.to(dev).float()
    num_mask = torch.ceil(cosine_schedule(t) * n).int().clamp_min(1)
    thresh = scores.sort(dim=-1).values.gather(
        -1, (num_mask - 1)[:, None].long())
    mask = scores <= thresh
    return torch.where(mask, mask_id, token_ids), mask


def maskgit_loss(logits: torch.Tensor, targets: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Mean CE over the masked positions."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets[..., None].long())[..., 0]
    m = mask.float()
    return (nll * m).sum() / m.sum().clamp_min(1.0)


class SampleDraws(NamedTuple):
    gumbel_u: torch.Tensor                 # (b, n, num_tokens) U[1e-20, 1)
    critic_noise: Optional[torch.Tensor]   # (b, n) N(0, 1), with a critic


def sample_draws(shape, critic: bool, generator: Optional[torch.Generator],
                 device) -> SampleDraws:
    """One sampling step's draws from ``generator``."""
    u = torch.rand(shape, generator=generator, device=device)
    u = 1e-20 + (1.0 - 1e-20) * u
    noise = (torch.randn(shape[:2], generator=generator, device=device)
             if critic else None)
    return SampleDraws(u, noise)


def maskgit_sample(maskgit: MaskGit, *, batch: int, seq_len: int,
                   context: Optional[torch.Tensor] = None,
                   context_mask: Optional[torch.Tensor] = None,
                   steps: int = 18, cond_scale: float = 3.0,
                   temperature: float = 1.0,
                   critic: Optional[Callable[[torch.Tensor], torch.Tensor]]
                   = None, critic_noise: float = 0.0,
                   prime_ids: Optional[torch.Tensor] = None,
                   draws: Optional[Sequence[SampleDraws]] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """Iterative demasking → (batch, seq_len) ids.  ``critic`` maps ids to
    per-token scores (the confidences are their negation); ``prime_ids``
    (b, n_prime) are prepended every round and their logits dropped;
    ``draws[s]`` are step s's draws."""
    device = maskgit.token_emb.device
    mask_id = maskgit.mask_id
    ids = torch.full((batch, seq_len), mask_id, dtype=torch.long,
                     device=device)
    n_prime = 0 if prime_ids is None else prime_ids.shape[1]

    def with_prime(t):
        return t if n_prime == 0 else torch.cat([prime_ids.long(), t], dim=1)

    for s in range(steps):
        logits = maskgit.forward_with_cond_scale(
            with_prime(ids), context=context, context_mask=context_mask,
            cond_scale=cond_scale)[:, n_prime:]
        d = (draws[s] if draws is not None else sample_draws(
            logits.shape, critic is not None, generator, device))
        temp_s = (torch.tensor(steps - 1 - s, dtype=torch.float32)
                  * temperature / steps)
        gumbel = -torch.log(-torch.log(d.gumbel_u.to(device).float()))
        sampled = (logits / temp_s.clamp_min(1e-6).to(device)
                   + gumbel).argmax(dim=-1)
        is_masked = ids == mask_id
        candidate = torch.where(is_masked, sampled, ids)
        if critic is not None:
            scores = -critic(with_prime(candidate))[:, n_prime:].float()
            scores = scores + critic_noise * d.critic_noise.to(device).float()
        else:
            probs = torch.softmax(logits, dim=-1)
            scores = probs.gather(-1, candidate[..., None])[..., 0]
            scores = torch.where(is_masked, scores, torch.inf)
        frac_next = cosine_schedule(
            torch.tensor(s + 1, dtype=torch.float32) / steps)
        num_mask_next = int(torch.floor(frac_next * seq_len))
        order = scores.argsort(dim=-1, stable=True)
        ranks = order.argsort(dim=-1, stable=True)
        ids = torch.where(ranks < num_mask_next, mask_id, candidate)
    return torch.where(ids == mask_id, 0, ids)
