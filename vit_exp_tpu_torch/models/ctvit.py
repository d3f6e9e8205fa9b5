"""CTViT, the legacy factorized tower of CT-CLIP and GenerateCT (counterpart
of vit_exp_tpu/models/ctvit.py).

- the first frame is patch-embedded on its own (b c 1 (h p1) (w p2)), the
  rest in temporal patches of ``temporal_patch_size`` frames;
- encode: a SPATIAL transformer over each frame's h·w tokens, then a
  TEMPORAL transformer over each position's t tokens; decode the reverse;
- both spatial transformers take the ContinuousPositionBias as an
  additive attention bias;
- a cosine-similarity VectorQuantize codebook (models/vq.py) between
  encode and decode, and the to_pixels heads after decode;
- every block is [causal PEG, cosine attention (scale 8, no null kv), GEGLU
  feed-forward], each residual, then a γ-only LayerNorm.

The attention runs the plain route of ops/attention.py (attn_impl="xla",
which takes the bias) and the feed-forward its plain version
(``use_kernel=False``), as the JAX modules run impl="xla": no kernel.

Modules are named in the reference state-dict layout (what the JAX
package's ``convert_ctvit_state_dict`` reads): ``to_patch_emb_first_frame``
and ``to_patch_emb`` ({1,2,3}: LN in, Linear, LN out),
``{enc,dec}_{spatial,temporal}_transformer.layers.{i}.{0,1,3}`` (PEG,
attention, feed-forward) and ``.norm_out``,
``spatial_rel_pos_bias.net.{0.0,1.0,2}``, ``vq._codebook.*``,
``to_pixels_first_frame.0`` and ``to_pixels.0``.  ``load_reference`` loads
a reference GenerateCT state dict.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from vit_exp_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from vit_exp_tpu_torch.models.ctvit3d import CosineSelfAttention
from vit_exp_tpu_torch.models.layers import (BiasLayerNorm, ConvParams,
                                             GEGLUFeedForward, LeakyReLU,
                                             Linear, ScaleLayerNorm)
from vit_exp_tpu_torch.models.vq import VectorQuantize
from vit_exp_tpu_torch.ops.patches import patchify_3d


class ContinuousPositionBias(nn.Module):
    """An MLP on log-scaled relative (y, x) offsets → a per-head additive
    bias (1, heads, h·w, h·w)."""

    def __init__(self, dim: int, heads: int, num_layers: int = 2, *,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        kw = dict(policy=policy, device=device)
        layers = []
        d_in = 2
        for _ in range(num_layers):
            layers.append(nn.Sequential(Linear(d_in, dim, **kw),
                                        LeakyReLU(0.1)))
            d_in = dim
        layers.append(Linear(dim, heads, **kw))
        self.net = nn.ModuleList(layers)

    def forward(self, h: int, w: int) -> torch.Tensor:
        device = self.net[-1].weight.device
        yy, xx = torch.meshgrid(torch.arange(h, device=device),
                                torch.arange(w, device=device), indexing="ij")
        grid = torch.stack([yy.reshape(-1), xx.reshape(-1)], dim=-1)
        rel = (grid[:, None, :] - grid[None, :, :]).float()
        x = torch.sign(rel) * torch.log1p(rel.abs())
        for layer in self.net:
            x = layer(x)
        return x.permute(2, 0, 1)[None]


class PEG(nn.Module):
    """Depthwise 3D convolution over the (t, h, w) token grid; causal pads
    time with (2, 0) so no token sees a later frame."""

    def __init__(self, dim: int, causal: bool = False, *,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        self.causal = causal
        self.policy = policy
        self.dsconv = ConvParams(dim, 1, 3, 3, 3, policy=policy,
                                 device=device)

    def forward(self, x: torch.Tensor,
                video_shape: Tuple[int, int, int, int]) -> torch.Tensor:
        b, t, h, w = video_shape
        # the JAX module reads x as (b, t, h, w, dim) whatever its layout
        feat = x.reshape(b, t, h, w, -1).permute(0, 4, 1, 2, 3)
        feat = F.pad(feat, (1, 1, 1, 1) + ((2, 0) if self.causal else (1, 1)))
        # flax promotes the input and the fp32 kernel: the output is fp32,
        # and so is the residual stream after the first PEG
        dt = torch.promote_types(feat.dtype, self.dsconv.weight.dtype)
        out = F.conv3d(feat.to(dt), self.dsconv.weight.to(dt),
                       self.dsconv.bias.to(dt), groups=feat.shape[1])
        return out.permute(0, 2, 3, 4, 1).reshape(x.shape)


class StackBlock(nn.Module):
    """One reference layer: children 0 (PEG, when on), 1 (attention), 3
    (feed-forward)."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 scale: Optional[float], num_null_kv: int, peg: bool,
                 peg_causal: bool, *, policy: Policy, device=None):
        super().__init__()
        kw = dict(policy=policy, device=device)
        if peg:
            self.add_module("0", PEG(dim, causal=peg_causal, **kw))
        self.add_module("1", CosineSelfAttention(
            dim, heads, dim_head, num_null_kv=num_null_kv, scale=scale,
            use_kernels=False, attn_impl="xla", **kw))
        self.add_module("3", GEGLUFeedForward(dim, use_kernel=False, **kw))

    def forward(self, x, video_shape=None, attn_bias=None, mask=None):
        if "0" in self._modules:
            x = x + self._modules["0"](x, video_shape)
        x = x + self._modules["1"](x, mask=mask, attn_bias=attn_bias)
        return x + self._modules["3"](x)


class TransformerStack(nn.Module):
    """depth × [PEG, self-attention (+bias), GEGLU] + a γ-only LN out."""

    def __init__(self, dim: int, depth: int, heads: int = 8,
                 dim_head: int = 32, scale: Optional[float] = None,
                 num_null_kv: int = 2, peg: bool = False,
                 peg_causal: bool = False, *,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        self.layers = nn.ModuleList([
            StackBlock(dim, heads, dim_head, scale, num_null_kv, peg,
                       peg_causal, policy=policy, device=device)
            for _ in range(depth)])
        self.norm_out = ScaleLayerNorm(dim, policy=policy, device=device)

    def forward(self, x, video_shape=None, attn_bias=None, mask=None):
        for layer in self.layers:
            x = layer(x, video_shape, attn_bias, mask)
        return self.norm_out(x)


def _patch_embedding(in_dim: int, dim: int, kw) -> nn.ModuleDict:
    return nn.ModuleDict({"1": BiasLayerNorm(in_dim, **kw),
                          "2": Linear(in_dim, dim, **kw),
                          "3": BiasLayerNorm(dim, **kw)})


def _run(seq: nn.ModuleDict, x: torch.Tensor) -> torch.Tensor:
    for m in seq.values():
        x = m(x)
    return x


class CTViT(nn.Module):
    def __init__(self, dim: int = 512, codebook_size: int = 8192,
                 image_size: int = 480, patch_size: int = 20,
                 temporal_patch_size: int = 10, spatial_depth: int = 4,
                 temporal_depth: int = 4, dim_head: int = 32, heads: int = 8,
                 channels: int = 1, attn_scale: Optional[float] = 8.0,
                 attn_num_null_kv: int = 0, use_peg: bool = True, *,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        self.dim, self.image_size, self.channels = dim, image_size, channels
        self.patch_size, self.temporal_patch_size = (patch_size,
                                                     temporal_patch_size)
        self.policy = policy
        p, pt, c = patch_size, temporal_patch_size, channels
        kw = dict(policy=policy, device=device)
        self.to_patch_emb_first_frame = _patch_embedding(c * p * p, dim, kw)
        self.to_patch_emb = _patch_embedding(c * pt * p * p, dim, kw)
        stack = dict(dim=dim, heads=heads, dim_head=dim_head,
                     scale=attn_scale, num_null_kv=attn_num_null_kv,
                     peg=use_peg, peg_causal=use_peg, **kw)
        self.enc_spatial_transformer = TransformerStack(depth=spatial_depth,
                                                        **stack)
        self.enc_temporal_transformer = TransformerStack(depth=temporal_depth,
                                                         **stack)
        self.dec_spatial_transformer = TransformerStack(depth=spatial_depth,
                                                        **stack)
        self.dec_temporal_transformer = TransformerStack(depth=temporal_depth,
                                                         **stack)
        self.spatial_rel_pos_bias = ContinuousPositionBias(dim, heads, **kw)
        self.vq = VectorQuantize(dim, codebook_size, device=device)
        self.to_pixels_first_frame = nn.ModuleDict(
            {"0": Linear(dim, c * p * p, **kw)})
        self.to_pixels = nn.ModuleDict({"0": Linear(dim, c * pt * p * p, **kw)})

    # -- patch embeddings ---------------------------------------------------

    def _patchify_first(self, frame: torch.Tensor) -> torch.Tensor:
        """(b, c, 1, H, W) → (b, 1, h, w, dim)."""
        b, c, _, H, W = frame.shape
        p = self.patch_size
        x = frame.reshape(b, c, 1, H // p, p, W // p, p)
        x = x.permute(0, 2, 3, 5, 1, 4, 6).reshape(b, 1, H // p, W // p,
                                                   c * p * p)
        return _run(self.to_patch_emb_first_frame, x)

    def _patchify_rest(self, video: torch.Tensor) -> torch.Tensor:
        """(b, c, T-1, H, W) → (b, t, h, w, dim)."""
        p = self.patch_size
        x = patchify_3d(video, self.temporal_patch_size, p, p)
        return _run(self.to_patch_emb, x)

    def tokens_from_video(self, video: torch.Tensor) -> torch.Tensor:
        video = video.to(self.policy.compute_dtype)
        return torch.cat([self._patchify_first(video[:, :, :1]),
                          self._patchify_rest(video[:, :, 1:])], dim=1)

    # -- encode / quantize / decode -----------------------------------------

    def encode_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """(b, t, h, w, d): the spatial stack (with the position bias) over
        each frame, then the temporal stack over each position."""
        b, t, h, w, d = tokens.shape
        vs = (b, t, h, w)
        x = tokens.reshape(b * t, h * w, d)
        x = self.enc_spatial_transformer(
            x, vs, attn_bias=self.spatial_rel_pos_bias(h, w))
        x = x.reshape(b, t, h, w, d).permute(0, 2, 3, 1, 4)
        x = self.enc_temporal_transformer(x.reshape(b * h * w, t, d), vs)
        return x.reshape(b, h, w, t, d).permute(0, 3, 1, 2, 4)

    def quantize(self, tokens: torch.Tensor, update_codebook: bool = False):
        return self.vq(tokens, update_codebook=update_codebook)

    def decode_trunk(self, tokens: torch.Tensor) -> torch.Tensor:
        """(b, t, h, w, d) → the decode features before the pixel heads
        (split out so the adaptive GAN weight can differentiate the pixel
        head alone)."""
        b, t, h, w, d = tokens.shape
        vs = (b, t, h, w)
        x = tokens.permute(0, 2, 3, 1, 4).reshape(b * h * w, t, d)
        x = self.dec_temporal_transformer(x, vs)
        x = x.reshape(b, h, w, t, d).permute(0, 3, 1, 2, 4)
        x = self.dec_spatial_transformer(
            x.reshape(b * t, h * w, d), vs,
            attn_bias=self.spatial_rel_pos_bias(h, w))
        return x.reshape(b, t, h, w, d)

    def pixels_from_trunk(self, x: torch.Tensor,
                          pixels_weight: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
        """Decode features → video through the first-frame and rest pixel
        heads; ``pixels_weight`` stands in for to_pixels.0.weight."""
        b, t, h, w, _ = x.shape
        p, pt, c = self.patch_size, self.temporal_patch_size, self.channels
        first = self.to_pixels_first_frame["0"](x[:, :1])
        first = first.reshape(b, 1, h, w, c, p, p).permute(0, 4, 1, 2, 5, 3, 6)
        first = first.reshape(b, c, 1, h * p, w * p)
        head = self.to_pixels["0"]
        if pixels_weight is None:
            rest = head(x[:, 1:])
        else:
            cd = self.policy.compute_dtype
            rest = F.linear(x[:, 1:].to(cd), pixels_weight.to(cd))
            rest = rest + head.bias.to(rest.dtype)
        rest = rest.reshape(b, t - 1, h, w, c, pt, p, p)
        rest = rest.permute(0, 4, 1, 5, 2, 6, 3, 7).reshape(
            b, c, (t - 1) * pt, h * p, w * p)
        return torch.cat([first, rest], dim=2)

    def decode_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.pixels_from_trunk(self.decode_trunk(tokens))

    def forward(self, video: torch.Tensor, *,
                return_encoded_tokens: bool = True,
                return_recons: bool = False, update_codebook: bool = False):
        """The encoded tokens, or with ``return_recons`` (recon, indices,
        commit_loss)."""
        encoded = self.encode_tokens(self.tokens_from_video(video))
        if return_encoded_tokens and not return_recons:
            return encoded
        quantized, indices, commit = self.quantize(
            encoded, update_codebook=update_codebook)
        return self.decode_tokens(quantized), indices, commit

    def decode_from_indices(self, indices: torch.Tensor) -> torch.Tensor:
        codes = self.vq.codes_from_indices(indices)
        return self.decode_tokens(codes.to(self.policy.compute_dtype))

    def load_reference(self, state_dict: Dict[str, torch.Tensor]):
        """Load a reference CTViT state dict ("module." prefix optional).
        Beyond the port's keys it may hold only the zero βs of the γ-only
        LayerNorms and the self-attention context norms the reference
        registers and never runs; anything else raises."""
        if any(k.startswith("module.") for k in state_dict):
            state_dict = {k[len("module."):]: v for k, v in state_dict.items()}
        res = self.load_state_dict(dict(state_dict), strict=False)
        extra = [k for k in res.unexpected_keys if not k.endswith(
            ("norm.beta", "norm_out.beta", "context_norm.gamma"))]
        if res.missing_keys or extra:
            raise ValueError(f"state dict does not match CTViT: missing "
                             f"{res.missing_keys}, unexpected {extra}")
        return res
