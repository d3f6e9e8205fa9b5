"""Shared building blocks (counterpart of vit_exp_tpu/models/layers.py).

Parameters are created uninitialised (``torch.empty``) on the requested
device; every module that owns parameters has ``reset_parameters(generator)``
and the factory calls it with one seeded ``torch.Generator``.  Parameter
names follow the reference PyTorch modules (``weight``/``bias`` for Linear
and LayerNorm, ``gamma`` for the γ-only LayerNorm), so a reference
``CTClip.*.pt`` state dict loads by name.
"""

from __future__ import annotations

import math
import torch
import torch.nn as nn
import torch.nn.functional as F

from vit_exp_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from vit_exp_tpu_torch.ops.geglu_ff import fused_geglu_ff, fused_geglu_ff_int8
from vit_exp_tpu_torch.parallel.collectives import (copy_to_group,
                                                    reduce_from_group)


def empty_param(*shape, policy: Policy, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, device=device,
                                    dtype=policy.param_dtype))


# the standard deviation of a standard normal truncated to [-2, 2]
_TRUNCATED_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    """flax's ``lecun_normal`` (variance_scaling(1, "fan_in",
    "truncated_normal")): a normal truncated at two of its standard
    deviations, rescaled so that the variance is 1/fan_in.  No weight
    exceeds 2/(0.8796·√fan_in), which sets the int8 path's per-channel
    weight scales."""
    std = 1.0 / math.sqrt(fan_in) / _TRUNCATED_STD
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


class Linear(nn.Module):
    """y = x @ Wᵀ (+ b) in the compute dtype; weight is (out, in) as in
    torch.nn.Linear."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True, *,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        self.policy = policy
        self.weight = empty_param(d_out, d_in, policy=policy, device=device)
        self.bias = empty_param(d_out, policy=policy, device=device) if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight.shape[1], generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.policy.compute_dtype
        y = F.linear(x.to(cd), self.weight.to(cd))
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class ConvParams(nn.Module):
    """A convolution's ``weight`` (out, in/groups, *kernel) and ``bias``, as
    torch.nn.Conv names them, initialised as the JAX package's flax Conv
    (lecun normal over the fan-in, zero bias); the owner convolves."""

    def __init__(self, c_out: int, c_in: int, *kernel: int,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        self.weight = empty_param(c_out, c_in, *kernel, policy=policy,
                                  device=device)
        self.bias = empty_param(c_out, policy=policy, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        nn.init.zeros_(self.bias)


class LeakyReLU(nn.Module):
    """where(x ≥ 0, x, slope·x): at 0 the gradient is 1, as flax's
    leaky_relu gives it (torch's LeakyReLU gives the slope)."""

    def __init__(self, slope: float):
        super().__init__()
        self.slope = slope

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.slope * x)


class ScaleLayerNorm(nn.Module):
    """γ-only LayerNorm (β pinned to 0), eps 1e-5, fp32 statistics."""

    def __init__(self, dim: int, *, policy: Policy = DEFAULT_POLICY,
                 device=None):
        super().__init__()
        self.policy = policy
        self.gamma = empty_param(dim, policy=policy, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.gamma)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(self.policy.reduce_dtype)
        mean = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mean).square().mean(dim=-1, keepdim=True)
        y = (x32 - mean) / torch.sqrt(var + 1e-5)
        return (y * self.gamma.to(y.dtype)).to(self.policy.compute_dtype)


class BiasLayerNorm(nn.Module):
    """LayerNorm with weight and bias, fp32 statistics."""

    def __init__(self, dim: int, eps: float = 1e-5, *,
                 policy: Policy = DEFAULT_POLICY, device=None):
        super().__init__()
        self.policy = policy
        self.eps = eps
        self.weight = empty_param(dim, policy=policy, device=device)
        self.bias = empty_param(dim, policy=policy, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(self.policy.reduce_dtype)
        mean = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mean).square().mean(dim=-1, keepdim=True)
        y = (x32 - mean) / torch.sqrt(var + self.eps)
        y = y * self.weight.to(y.dtype) + self.bias.to(y.dtype)
        return y.to(self.policy.compute_dtype)


class GEGLUFeedForward(nn.Module):
    """LayerNorm → Linear(dim, 2·inner) → GEGLU (exact erf) → Linear(inner,
    dim), inner = int(mult·2/3·dim); the first Linear's output is laid out
    [val | gate].  Runs as the fused kernel K2, or with ``int8`` as the
    serving-only W8A8 kernel K11 on the same parameters.  Children are
    named as the reference Sequential's indices: 0 (norm), 1 (wi), 4
    (wo).  With ``tp_group`` (tensor parallelism, set with the module's
    weights cut to this rank's units by parallel/sharding.py) K2 runs on
    this rank's columns of both halves of W1 and rows of W2, x, γ and β go
    through ``copy_to_group`` (K8's dx, dγ and dβ hold this rank's units
    only) and the partial outputs, which K2 rounds to bf16, are summed over
    the group in fp32 (``reduce_from_group``)."""

    def __init__(self, dim: int, mult: float = 4.0, *,
                 policy: Policy = DEFAULT_POLICY, use_kernel: bool = True,
                 int8: bool = False, device=None):
        super().__init__()
        inner = int(mult * (2.0 / 3.0) * dim)
        self.policy = policy
        self.use_kernel = use_kernel
        self.int8 = int8
        self.tp_group = None
        self.add_module("0", BiasLayerNorm(dim, policy=policy, device=device))
        self.add_module("1", Linear(dim, 2 * inner, bias=False, policy=policy,
                                    device=device))
        self.add_module("4", Linear(inner, dim, bias=False, policy=policy,
                                    device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.tp_group
        if g is None:
            return self.partial(x)
        return reduce_from_group(self.partial(
            x, lambda t: copy_to_group(t, g)), g)

    def partial(self, x: torch.Tensor, copy=None) -> torch.Tensor:
        """The feed-forward over this module's units, ``copy`` (tensor
        parallelism) applied to x, γ and β."""
        norm, wi, wo = self._modules["0"], self._modules["1"], self._modules["4"]
        same = copy or (lambda t: t)
        fn = fused_geglu_ff_int8 if self.int8 else fused_geglu_ff
        return fn(same(x.to(self.policy.compute_dtype)), same(norm.weight),
                  same(norm.bias), wi.weight.t(), wo.weight.t(),
                  use_kernel=self.use_kernel)


class MLPHead(nn.Sequential):
    """The reference's create_head MLP: ``n_layers`` Linear layers with
    LeakyReLU(0.2) between them, as one Sequential, so the Linear layers
    sit at the even indices of the reference key layout
    (``seg_head.{2k}.weight``).  Products in the compute dtype."""

    def __init__(self, d_in: int, n_layers: int, mid_dim: int, out_dim: int,
                 *, policy: Policy = DEFAULT_POLICY, device=None):
        layers = []
        for i in range(n_layers):
            d_out = out_dim if i == n_layers - 1 else mid_dim
            layers.append(Linear(d_in, d_out, policy=policy, device=device))
            if i < n_layers - 1:
                layers.append(nn.LeakyReLU(0.2))
            d_in = d_out
        super().__init__(*layers)
        self.out_dim = out_dim
