"""BERT encoder, the text tower (counterpart of vit_exp_tpu/models/bert.py).

HF BERT-base semantics: post-LN blocks, LayerNorm eps 1e-12, exact-erf GELU,
additive attention mask, token types zero.  Attention is a plain matmul +
fp32 softmax, as in the JAX package.  Module names follow HF ``BertModel``
(``embeddings.*``, ``encoder.layer.{i}.attention.self.query`` ...), so an HF
state dict loads by name.

A layer's ``tp_group`` (tensor parallelism, set by
parallel/sharding.py::apply_tensor_parallel with the layer's weights cut
to this rank's heads and intermediate units): query/key/value and the
intermediate product keep this rank's output columns (weights and bias),
the attention output and output products this rank's input rows; their
partial sums are summed over the group in fp32 (bf16 operands, fp32
products) and their biases added once after the sum.  The embeddings, the
LayerNorms and every bias of a row-sharded product stay whole.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from vit_exp_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from vit_exp_tpu_torch.models.layers import BiasLayerNorm, Linear, empty_param
from vit_exp_tpu_torch.parallel.collectives import (copy_to_group,
                                                    reduce_from_group)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12

    @classmethod
    def tiny(cls) -> "BertConfig":
        return cls(vocab_size=128, hidden_size=36, num_hidden_layers=2,
                   num_attention_heads=3, intermediate_size=64,
                   max_position_embeddings=64)


class Embedding(nn.Module):
    def __init__(self, num: int, dim: int, *, policy: Policy, device=None):
        super().__init__()
        self.weight = empty_param(num, dim, policy=policy, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.weight, 0.0, 0.02, generator=generator)


def _node(**children) -> nn.ModuleDict:
    """Named container, so parameter paths match the HF layout."""
    return nn.ModuleDict(children)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, *, policy: Policy, device=None):
        super().__init__()
        self.cfg, self.policy = cfg, policy
        self.heads = cfg.num_attention_heads
        self.tp_group = None
        d, kw = cfg.hidden_size, dict(policy=policy, device=device)

        def ln():
            return BiasLayerNorm(d, cfg.layer_norm_eps, **kw)

        self.attention = nn.ModuleDict({
            "self": _node(query=Linear(d, d, **kw), key=Linear(d, d, **kw),
                          value=Linear(d, d, **kw)),
            "output": _node(dense=Linear(d, d, **kw), LayerNorm=ln())})
        self.intermediate = _node(dense=Linear(d, cfg.intermediate_size, **kw))
        self.output = _node(dense=Linear(cfg.intermediate_size, d, **kw),
                            LayerNorm=ln())

    def forward(self, x: torch.Tensor,
                additive_mask: Optional[torch.Tensor]) -> torch.Tensor:
        b, n, d = x.shape
        h = self.heads
        dh = d // self.cfg.num_attention_heads
        sa = self.attention["self"]
        g = self.tp_group
        xin = x if g is None else copy_to_group(x, g)

        def heads(lin):
            return lin(xin).reshape(b, n, h, dh).transpose(1, 2)

        q, k, v = heads(sa.query), heads(sa.key), heads(sa.value)
        logits = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(dh)
        if additive_mask is not None:
            logits = logits + additive_mask
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        attn = (probs @ v).transpose(1, 2).reshape(b, n, h * dh)
        attn = self._rows(self.attention.output.dense, attn)
        x = self.attention.output.LayerNorm(x + attn)
        xin = x if g is None else copy_to_group(x, g)
        inter = F.gelu(self.intermediate.dense(xin))
        return self.output.LayerNorm(x + self._rows(self.output.dense, inter))

    def _rows(self, lin: Linear, x: torch.Tensor) -> torch.Tensor:
        """``lin`` on x; under tensor parallelism on this rank's input rows,
        the partial sums summed over the group, then the bias."""
        if self.tp_group is None:
            return lin(x)
        cd = self.policy.compute_dtype
        y = F.linear(x.to(cd).float(), lin.weight.to(cd).float())
        y = reduce_from_group(y, self.tp_group).to(cd)
        return y + lin.bias.to(y.dtype)


class BertModel(nn.Module):
    def __init__(self, config: BertConfig, *, policy: Policy = DEFAULT_POLICY,
                 device=None):
        super().__init__()
        self.config, self.policy = config, policy
        kw = dict(policy=policy, device=device)
        self.embeddings = _node(
            word_embeddings=Embedding(config.vocab_size, config.hidden_size,
                                      **kw),
            position_embeddings=Embedding(config.max_position_embeddings,
                                          config.hidden_size, **kw),
            token_type_embeddings=Embedding(config.type_vocab_size,
                                            config.hidden_size, **kw),
            LayerNorm=BiasLayerNorm(config.hidden_size, config.layer_norm_eps,
                                    **kw))
        self.encoder = _node(layer=nn.ModuleList(
            [BertLayer(config, **kw) for _ in range(config.num_hidden_layers)]))

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Returns last_hidden_state (b, n, hidden)."""
        e = self.embeddings
        n = input_ids.shape[1]
        x = (e.word_embeddings.weight[input_ids]
             + e.position_embeddings.weight[None, :n]
             + e.token_type_embeddings.weight[0])
        x = e.LayerNorm(x.to(self.policy.compute_dtype))
        additive_mask = None
        if attention_mask is not None:
            additive_mask = torch.where(
                attention_mask[:, None, None, :].bool(), 0.0,
                torch.finfo(torch.float32).min).float()
        for layer in self.encoder.layer:
            x = layer(x, additive_mask)
        return x
