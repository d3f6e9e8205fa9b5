"""Model factory (counterpart of vit_exp_tpu/models/factory.py).

``config`` is duck-typed: anything with the fields of the JAX package's
``ExperimentConfig`` (an ``arch`` with dim, image_size, patch_size,
temporal_size, temporal_patch_size, transformer_blocks, dim_head, heads,
channels, use_flash_attention; optionally ``extra["dim_latent"]``), or such
an ``arch`` itself.  The port reads the fields and never imports the JAX
package.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from vit_exp_tpu_torch.core.config import CTClipArchConfig
from vit_exp_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from vit_exp_tpu_torch.models.bert import BertConfig
from vit_exp_tpu_torch.models.ctclip import CTCLIP
from vit_exp_tpu_torch.models.ctvit3d import CTViT3D


def bert_config_for(config, tokenizer) -> BertConfig:
    """BERT-base at the tokenizer's vocab size, with per-field overrides
    from the yaml ``text_encoder:`` section (the JAX package's
    ``bert_config_for``)."""
    extra = getattr(config, "extra", None) or {}
    kwargs = dict(extra.get("text_encoder") or {})
    kwargs.setdefault("vocab_size", tokenizer.vocab_size)
    return BertConfig(**kwargs)


def kernel_refusals(arch, *, fuse_qkv: bool = False,
                    int8: bool = False) -> List[str]:
    """What the card's kernels refuse in this arch's widths, one line per
    kernel family, named with its constraint (empty when they take it):
    the attention kernels' head dim, the GEGLU kernels' D and 2I, K8's
    largest D and, with ``fuse_qkv``, K3's widths in bf16 or, at int8,
    K12/K13's and K14's.  The patch embedding asks the kernel library
    (``patch_embed_refusal``)."""
    from vit_exp_tpu_torch.ops import geglu_ff
    from vit_exp_tpu_torch.ops.flash_attention import MAX_HEAD_DIM
    from vit_exp_tpu_torch.ops.fused_proj import PROJ_WIDTH_STEP

    out = []
    if arch.dim_head > MAX_HEAD_DIM:
        out.append(f"the attention kernels (K1, K15, the backward pair, the "
                   f"int8 attention) take head dims up to {MAX_HEAD_DIM}; "
                   f"got {arch.dim_head}")
    d, step = arch.dim, geglu_ff.FF_WIDTH_STEP
    i2 = 2 * int(4.0 * (2.0 / 3.0) * d)   # GEGLUFeedForward's 2·inner
    if d % step or i2 % step:
        out.append(f"the GEGLU kernels (K2, K8, K11) take D and 2I "
                   f"multiples of {step}; got D {d}, 2I {i2}")
    elif d > geglu_ff.K8_MAX_D:
        out.append(f"K8 takes D up to {geglu_ff.K8_MAX_D}; got D {d}")
    inner = arch.heads * arch.dim_head
    f, step = 3 * inner, PROJ_WIDTH_STEP
    if fuse_qkv and not int8 and (d % step or f % step):
        out.append(f"K3 takes K and F multiples of {step}; got K {d}, F {f}")
    if fuse_qkv and int8:
        if d % step or d > 2048 or f % step:
            out.append(f"K12/K13 take K a multiple of {step} up to 2048 and "
                       f"F a multiple of {step}; got K {d}, F {f}")
        if inner % step or inner > 1024 or d % step:
            out.append(f"K14 takes K a multiple of {step} up to 1024 and F "
                       f"a multiple of {step}; got K {inner}, F {d}")
    return out


def patch_embed_refusal(arch) -> List[str]:
    """The patch-embed kernel's refusal of this arch's patching, asked of
    the kernel library (built on first use)."""
    from vit_exp_tpu_torch.ops import _build

    c, pt, p, size = (getattr(arch, "channels", 1), arch.temporal_patch_size,
                      arch.patch_size, arch.image_size)
    if _build.lib().vit_patch_embed_check(1, c * pt, size, size, p, p,
                                          arch.dim):
        return []
    return [f"the patch-embed kernel does not take patch {p} over {size} "
            f"pixels at D {arch.dim} (ops/patches.py::patch_embed_check "
            f"lists its constraints, D % 16 == 0 among them)"]


def build_image_encoder(arch, *, device="cuda",
                        policy: Policy = DEFAULT_POLICY,
                        use_kernels: bool = True,
                        attn_impl: str = "pallas_static", remat: bool = False,
                        fuse_qkv: bool = False,
                        int8: bool = False) -> CTViT3D:
    """CTViT3D on ``device``.  With the kernels on the card, an arch whose
    widths they refuse raises ValueError here, before any weight exists
    (``kernel_refusals``, ``patch_embed_refusal``); on the CPU, and with
    ``use_kernels=False``, every width builds."""
    if use_kernels and torch.device(device).type == "cuda":
        refusals = (kernel_refusals(arch, fuse_qkv=fuse_qkv, int8=int8)
                    + patch_embed_refusal(arch))
        if refusals:
            raise ValueError("the card's kernels do not take this arch: "
                             + "; ".join(refusals))
    return CTViT3D(
        dim=arch.dim, image_size=arch.image_size, patch_size=arch.patch_size,
        temporal_size=arch.temporal_size,
        temporal_patch_size=arch.temporal_patch_size,
        transformer_blocks=arch.transformer_blocks, dim_head=arch.dim_head,
        heads=arch.heads, channels=getattr(arch, "channels", 1),
        # production checkpoints use the SDPA convention 1/√dim_head
        attn_scale=None if getattr(arch, "use_flash_attention", True) else 8.0,
        policy=policy, use_kernels=use_kernels, attn_impl=attn_impl,
        remat=remat, fuse_qkv=fuse_qkv, int8=int8, device=device)


def init_parameters_(model: torch.nn.Module, seed: int = 0) -> None:
    """Fill every parameter from one seeded generator on the model's device."""
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters(gen)


def build_ctclip(config, bert_config: Optional[BertConfig] = None, *,
                 device="cuda", policy: Policy = DEFAULT_POLICY,
                 dim_latent: Optional[int] = None, use_kernels: bool = True,
                 attn_impl: str = "pallas_static", remat: bool = False,
                 fuse_qkv: bool = False, int8: bool = False,
                 seed: int = 0) -> CTCLIP:
    """CTCLIP with seeded random weights on ``device``: the card unless the
    caller asks for another device (without a card, the default raises
    torch's own error).  ``use_kernels=False`` runs every kernel's plain
    PyTorch version instead (the reference path on the card).
    ``attn_impl`` is "pallas_static" (K1) or "pallas" (K15, the JAX
    package's training default on its accelerator); ``remat=True``
    recomputes each image-tower block in the backward.
    ``fuse_qkv=True`` is the serving switch (fused LN+qkv projection, K3);
    training keeps the default False, as the JAX package does.
    ``int8=True`` is the W8A8 serving path, the JAX package's serving
    default: it switches attention and feed-forward together, so no
    bf16/int8 hybrid runs (with ``fuse_qkv`` the qkv and out-projections
    too); forward only.  The state dict is the same in every mode.
    ``config.ct_clip_arch`` (the port's ``CTClipArchConfig`` defaults when
    the config has none) goes to ``CTCLIP``, with the segmentation heads
    it switches on (plain products in the compute dtype in every mode).
    With the kernels on the card, widths they do not take raise here,
    before any weight exists (``build_image_encoder``)."""
    arch = getattr(config, "arch", config)
    clip_arch = getattr(config, "ct_clip_arch", None) or CTClipArchConfig()
    if dim_latent is None:
        dim_latent = (getattr(config, "extra", None) or {}).get("dim_latent",
                                                                768)
    visual = build_image_encoder(arch, device=device, policy=policy,
                                 use_kernels=use_kernels, attn_impl=attn_impl,
                                 remat=remat, fuse_qkv=fuse_qkv, int8=int8)
    model = CTCLIP(visual, bert_config or BertConfig(), dim_latent=dim_latent,
                   clip_arch=clip_arch, policy=policy, device=device)
    init_parameters_(model, seed)
    return model.eval()
