"""Vector quantization with a cosine-similarity codebook (counterpart of
vit_exp_tpu/models/vq.py).

l2-normalised codes and inputs, nearest code by cosine similarity (fp32;
a tie goes to the first index), the straight-through estimator onto the
normalised input, the commitment loss, and the EMA codebook update: the
assignment counts and the assigned-vector sums each follow an EMA, and the
code is their ratio ``embed_sum / max(counts, 1e-5)``.

The buffers live in ``_codebook`` under vector-quantize-pytorch's names and
grouped layout, ``embed`` (1, K, D), ``cluster_size`` (1, K) and
``embed_avg`` (1, K, D), so a reference state dict loads by name; a state
dict in the ungrouped layout (K, D) / (K,) loads too, and the reference's
``initted`` flag is dropped.  ``codes``, ``counts`` and ``embed_sum`` are
the (K, D), (K,) and (K, D) views the arithmetic reads.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from vit_exp_tpu_torch.ops.attention import l2norm


class Codebook(nn.Module):
    def __init__(self, dim: int, codebook_size: int, device=None):
        super().__init__()
        self.register_buffer("embed", torch.empty(
            1, codebook_size, dim, device=device))
        self.register_buffer("cluster_size", torch.empty(
            1, codebook_size, device=device))
        self.register_buffer("embed_avg", torch.empty(
            1, codebook_size, dim, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Normal codes, counts of one, sums equal to the codes (the ratio
        starts at the codes)."""
        self.embed.normal_(generator=generator)
        self.cluster_size.fill_(1.0)
        self.embed_avg.copy_(self.embed)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + "initted", None)
        for name in ("embed", "cluster_size", "embed_avg"):
            v = state_dict.get(prefix + name)
            if v is not None and v.dim() == getattr(self, name).dim() - 1:
                state_dict[prefix + name] = v[None]
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


class VectorQuantize(nn.Module):
    def __init__(self, dim: int, codebook_size: int,
                 commitment_weight: float = 1.0, ema_decay: float = 0.99,
                 device=None):
        super().__init__()
        self.dim, self.codebook_size = dim, codebook_size
        self.commitment_weight = commitment_weight
        self.ema_decay = ema_decay
        self._codebook = Codebook(dim, codebook_size, device=device)

    @property
    def codes(self) -> torch.Tensor:
        return self._codebook.embed[0]

    @property
    def counts(self) -> torch.Tensor:
        return self._codebook.cluster_size[0]

    @property
    def embed_sum(self) -> torch.Tensor:
        return self._codebook.embed_avg[0]

    def forward(self, x: torch.Tensor, *, update_codebook: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x: (..., dim) → (quantized, indices, commit_loss); quantized from
        the codebook as it was before an update."""
        flat = x.reshape(-1, self.dim)
        xn = l2norm(flat.float())
        cn = l2norm(self.codes.float())
        indices = (xn @ cn.t()).argmax(dim=-1)
        quantized = cn[indices]
        commit = (xn - quantized.detach()).square().sum(dim=-1).mean()
        quantized = xn + (quantized - xn).detach()
        if update_codebook:
            self.ema_update(indices, xn.detach())
        shape = x.shape[:-1]
        return (quantized.reshape(*shape, self.dim).to(x.dtype),
                indices.reshape(shape), commit * self.commitment_weight)

    @torch.no_grad()
    def ema_update(self, indices: torch.Tensor, xn: torch.Tensor) -> None:
        """One EMA step of the counts and sums over the assignments."""
        d = self.ema_decay
        hits = torch.zeros(self.codebook_size, device=xn.device).index_add_(
            0, indices, torch.ones_like(indices, dtype=torch.float32))
        sums = torch.zeros(self.codebook_size, self.dim,
                           device=xn.device).index_add_(0, indices, xn)
        counts = d * self.counts + (1 - d) * hits
        embed_sum = d * self.embed_sum + (1 - d) * sums
        self.counts.copy_(counts)
        self.embed_sum.copy_(embed_sum)
        self.codes.copy_(embed_sum / counts.clamp_min(1e-5)[:, None])

    def codes_from_indices(self, indices: torch.Tensor) -> torch.Tensor:
        """l2-normalised codebook rows at ``indices`` (fp32)."""
        return l2norm(self.codes.float())[indices]
