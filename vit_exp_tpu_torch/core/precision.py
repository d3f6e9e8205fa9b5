"""Mixed-precision policy (counterpart of vit_exp_tpu/core/precision.py).

fp32 parameters, bf16 activations and matrix products, fp32 LayerNorm
statistics, softmax and latents.  ``FP32_POLICY`` runs everything in fp32;
the CPU parity tests hold the port against the JAX package under it.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    # dtype for softmax / layernorm / latent reductions
    reduce_dtype: torch.dtype = torch.float32


DEFAULT_POLICY = Policy()
FP32_POLICY = Policy(compute_dtype=torch.float32)


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Arithmetic dtype of the kernels' plain versions for inputs of dtype:
    fp32, or fp64 for fp64 (so gradcheck can see the plain backwards)."""
    return torch.promote_types(dtype, torch.float32)
