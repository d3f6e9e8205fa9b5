"""Card tests of the port's CUDA kernels (K1-K4) against their plain
PyTorch versions at small, ragged shapes.

They need an NVIDIA GPU and nvcc and skip without them.  This file imports
no JAX, so on the card it runs without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: the kernels round to bf16 where the plain versions do, but sum
in another order, so outputs differ by bf16 rounding of the last place:
relative L2 error ≤ 1e-2 on bf16 outputs, 1e-5 on the fp32 statistics of
K4 (its sums are exact in fp32 up to order).
"""

import math

import pytest
import torch

from vit_exp_tpu_torch.ops import fused_proj, geglu_ff, patches
from vit_exp_tpu_torch.ops import flash_attention as fa
from vit_exp_tpu_torch.ops.attention import l2norm

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(g, *shape, std=1.0):
    return (torch.randn(*shape, generator=g, device=g.device) * std).to(
        torch.bfloat16)


def _rel(a, b):
    a, b = a.float(), b.float()
    return (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()


@pytest.mark.parametrize("nq,nkv,n_null", [(100, 70, 2), (64, 64, 0),
                                           (13, 200, 8)])
def test_k1_matches_plain(dev, nq, nkv, n_null):
    g = torch.Generator(device=dev).manual_seed(0)
    b, h, d = 2, 3, 32
    q = l2norm(_randn(g, b, nq, h, d)).transpose(1, 2)      # strided view
    k = l2norm(_randn(g, b, h, nkv, d))
    v = _randn(g, b, h, nkv, d)
    nk = l2norm(_randn(g, h, n_null, d)) if n_null else None
    nv = _randn(g, h, n_null, d) if n_null else None
    scale = 1.0 / math.sqrt(d)
    bound = torch.tensor(scale, device=dev)
    before = fa.attention_static.launches
    out = fa.attention_static(q, k, v, nk, nv, bound, scale)
    ref = fa.attention_static_plain(q, k, v, nk, nv, bound, scale)
    torch.cuda.synchronize()
    assert fa.attention_static.launches == before + 1
    assert out.shape == (b, h, nq, d)
    assert _rel(out, ref) < 1e-2


@pytest.mark.parametrize("m", [50, 96])
def test_k2_matches_plain(dev, m):
    g = torch.Generator(device=dev).manual_seed(1)
    d, inner = 768, 256
    x = _randn(g, m, d)
    mu, inv = geglu_ff.ln_stats(x, 1e-5)
    w1p, w2 = _randn(g, d, 2 * inner, std=d ** -0.5), _randn(g, inner, d)
    d1 = _randn(g, 2 * inner, std=0.1).float()
    out = geglu_ff.geglu_ff(x, mu, inv, w1p, d1, w2)
    ref = geglu_ff.geglu_ff_plain(x, mu, inv, w1p, d1, w2)
    torch.cuda.synchronize()
    assert _rel(out, ref) < 1e-2


@pytest.mark.parametrize("m", [100, 128])
def test_k3_matches_plain(dev, m):
    g = torch.Generator(device=dev).manual_seed(2)
    d, fq, fkv = 96, 64, 128
    x = _randn(g, m, d)
    mu, inv = geglu_ff.ln_stats(x, 1e-5)
    wf, c = fused_proj.qkv_weights(torch.rand(d, device=dev) + 0.5,
                                   _randn(g, d, fq).float(),
                                   _randn(g, d, fkv).float(), torch.bfloat16)
    out = fused_proj.ln_qkv(x, mu, inv, wf, c, fq)
    ref = fused_proj.ln_qkv_plain(x, mu, inv, wf, c, fq)
    torch.cuda.synchronize()
    assert _rel(out, ref) < 1e-2


def test_k4_matches_plain(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    x = _randn(g, 3, 4, 40, 60)
    mu, sq = patches.patch_stats(x, 8, 6)
    mu_p, sq_p = patches.patch_stats_plain(x, 8, 6)
    torch.cuda.synchronize()
    assert mu.shape == (3, 5, 10)
    assert _rel(mu, mu_p) < 1e-5 and _rel(sq, sq_p) < 1e-5


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.zeros(4, 4, 40, 60, device=dev)          # fp32, not bf16
    with pytest.raises(ValueError):
        patches.patch_stats(x, 8, 6)
