"""Card tests of the port's CUDA kernels (K1, K2's three stages, K3, the
fused patch embedding that replaces K4, K15, the attention backward pair,
K8, and the int8 serving kernels: the int8 attention (K9/K10), K11's four
stages, K12/K13's two stages and K14) against their plain PyTorch versions
at small, ragged shapes (K2, K3, K11 and K12/K13 also at 4,113 tokens and
the widths 384 and 768; the patch embedding at p2 20 and W 480, and at
small even p2, with D 128, 384 and 768; K14 up to 55,296 rows), and the
segmentation paths at a small arch (a seg step and two open-seg steps
against use_kernels=False, the int8 seg logits against the plain int8
engine), and the legacy CTViT at GenerateCT's width, which takes no
kernel and trains a step.  The kernels at the widths JAX's kernels take:
the attention kernels at head dims 8, 16, 24 and 64 (forward, backward and
int8, at the blocking's edges, twice bitwise equal), the GEMM families and
the patch embedding at the tiny configs' widths (D 48, 2I 256, F 96; K11
also at 2I 272), the two tiny configs through build_ctclip and a step on
the kernels, and the refusals past the limits (head dim 72, D 40).  The
SASS of the built library: K2's, K3's and K8's product kernels issue bf16
wgmma on TMA loads and no mma.sync, K11's two products, K12/K13's product
and K14 int8 wgmma on TMA loads and no int8 mma.sync; the patch embedding
and the int8 attention still issue mma.sync.

They need an NVIDIA GPU and nvcc and skip without them.  This file imports
no JAX, so on the card it runs without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: the kernels round to bf16 where the plain versions do, but sum
in another order, so outputs differ by bf16 rounding of the last place:
relative L2 error ≤ 1e-2 on bf16 outputs and on gradients (bf16 operands
of fp32 sums on both sides), and on the forwards' outputs also max abs
error ≤ two bf16 ulps of the largest element; 1e-5 on the fp32 patch
statistics (μ and Σx² of the patch embedding) and on K1's and K15's lse
(fp32 sums of the same values, up to order and ex2.approx's last bits).
The int8 kernels quantize with the plain twins' arithmetic and sum exact
integers, so their bf16 outputs are held to the same 1e-2; K12/K13's
stages and K14 do every fp32 operation of their twins in the same order,
so they are held bit for bit.
"""

import math
import re
import subprocess
from pathlib import Path

import pytest
import torch

from vit_exp_tpu_torch.ops import _build, fused_proj, geglu_ff, patches
from vit_exp_tpu_torch.ops import flash_attention as fa
from vit_exp_tpu_torch.ops.attention import l2norm, logit_bound

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


def _close(a, r):
    """Relative L2 within 1e-2 and max abs error within two bf16 ulps of the
    largest element (chip_smoke.REL_L2_TOL, MAX_ABS_TOL)."""
    assert a.shape == r.shape and torch.isfinite(a.float()).all()
    assert _rel(a, r) < 1e-2
    assert (a.float() - r.float()).abs().max() <= 2.0 ** -6 * r.float(
        ).abs().max()


# the edges of the forward's blocking (blocks of 128 queries, 64-key tiles,
# K1's nulls in one 16-key tile): nq 13, 129 and 200 (not multiples of
# 128), kv tails of 1 and 2 keys (65, 130), 0, 2 and 8 nulls
FWD_EDGES = [(100, 70, 2), (64, 64, 0), (13, 200, 8), (129, 65, 2),
             (200, 130, 0), (13, 65, 8), (129, 130, 8), (200, 65, 0)]


@pytest.mark.parametrize("nq,nkv,n_null", FWD_EDGES)
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
    _close(out, ref)


# K2 and K11: token counts on and off the 128-token tiles, the mid arch's
# widths (D 384, 2I 2,048) and production's (768, 4,096)
FF_SHAPES = [(384, 2048), (768, 4096)]
K2_STAGES = (geglu_ff.geglu_ff_x, geglu_ff.geglu_ff_h, geglu_ff.geglu_ff_o)


def _k2_case(dev, m, d, i2, seed=1):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = _randn(g, m, d)
    mu, inv = geglu_ff.ln_stats(x, 1e-5)
    w1p = _randn(g, d, i2, std=d ** -0.5)
    w2 = _randn(g, i2 // 2, d, std=(i2 // 2) ** -0.5)
    d1 = _randn(g, i2, std=0.1).float()
    return x, mu, inv, w1p, d1, w2


@pytest.mark.parametrize("d,i2", FF_SHAPES)
@pytest.mark.parametrize("m", [50, 4113])
def test_k2_matches_plain(dev, m, d, i2):
    args = _k2_case(dev, m, d, i2)
    before = [f.launches for f in K2_STAGES]
    out = geglu_ff.geglu_ff(*args)
    again = geglu_ff.geglu_ff(*args)
    ref = geglu_ff.geglu_ff_plain(*args)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(K2_STAGES, before)] == [2, 2, 2]
    assert torch.equal(out, again)   # no atomics
    _close(out, ref)


@pytest.mark.parametrize("d,i2", FF_SHAPES)
def test_k2_stages_match_their_twins(dev, d, i2):
    """Each K2 stage against its plain twin on the kernel chain's inputs."""
    x, mu, inv, w1p, d1, w2 = _k2_case(dev, 4113, d, i2, seed=12)
    xn = geglu_ff.geglu_ff_x(x, mu, inv)
    act = geglu_ff.geglu_ff_h(xn, w1p, d1)
    checks = [(xn, geglu_ff.geglu_ff_x_plain(x, mu, inv)),
              (act, geglu_ff.geglu_ff_h_plain(xn, w1p, d1)),
              (geglu_ff.geglu_ff_o(act, w2), geglu_ff.geglu_ff_o_plain(act, w2))]
    torch.cuda.synchronize()
    for a, r in checks:
        assert a.dtype == r.dtype == torch.bfloat16
        _close(a, r)


# K3 and K12/K13: token counts on and off the 128-token tiles; (K, F, fq)
# at the mid arch's (K, F) (384, 768) and production's (768, 768) with fq
# 64 (inside a 128-column tile) and 256 (the mid arch's q width), and one
# narrow case each (K 96)
QKV_M = [100, 128, 4113]
QKV_KFQ = [(k, f, fq) for k, f in ((384, 768), (768, 768)) for fq in (64, 256)]


def _k3_case(dev, m, k, f, fq, seed=2):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = _randn(g, m, k) * 2 + 0.5
    mu, inv = geglu_ff.ln_stats(x, 1e-5)
    wf, c = fused_proj.qkv_weights(
        torch.rand(k, device=dev) + 0.5, _randn(g, k, fq, std=k ** -0.5).float(),
        _randn(g, k, f - fq, std=k ** -0.5).float(), torch.bfloat16)
    return x, mu, inv, wf, c, fq


@pytest.mark.parametrize("k,f,fq", QKV_KFQ + [(96, 192, 64)])
@pytest.mark.parametrize("m", QKV_M)
def test_k3_matches_plain(dev, m, k, f, fq):
    args = _k3_case(dev, m, k, f, fq)
    before = fused_proj.ln_qkv.launches
    out = fused_proj.ln_qkv(*args)
    again = fused_proj.ln_qkv(*args)
    ref = fused_proj.ln_qkv_plain(*args)
    torch.cuda.synchronize()
    assert fused_proj.ln_qkv.launches == before + 2
    assert out.dtype == torch.bfloat16 and torch.equal(out, again)
    _close(out, ref)


def _pe_case(dev, bt, cpt, h, w, p1, p2, d, seed=3):
    """The patch embedding's kernel inputs: the video as (bt, cpt, H, W)
    bf16, kc (D, n) bf16, csum and dvec fp32, as fused_patch_embed makes
    them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n = cpt * p1 * p2
    x = _randn(g, bt, cpt, h, w)
    kf = torch.randn(n, d, generator=g, device=dev) / math.sqrt(n)
    kf = kf * (1 + 0.1 * torch.randn(n, 1, generator=g, device=dev))
    dvec = 0.1 * torch.randn(d, generator=g, device=dev)
    return x, kf.t().bfloat16(), kf.sum(0), dvec


# (bt, cpt, H, W, p1, p2, D): p2 20 at W 480 (the production patch row,
# 24 tokens) with token counts that do not fill the last 96-token tile,
# small even p2 (k steps 16, 48 and 80 deep), and the planted arch's patch
# 10 over 120 at D 384, whose CPT·p1 = 100 patch rows end in a part-filled
# k step of R = 8 (as does 1 × 4 rows at p2 6)
PE_SHAPES = [(1, 10, 40, 480, 20, 20, 768), (3, 10, 60, 480, 20, 20, 128),
             (2, 4, 48, 48, 8, 6, 384), (3, 2, 24, 64, 4, 8, 128),
             (2, 4, 40, 80, 10, 10, 256), (3, 10, 120, 120, 10, 10, 384),
             (2, 1, 48, 48, 4, 6, 128)]


@pytest.mark.parametrize("shape", PE_SHAPES)
def test_patch_embed_matches_plain(dev, shape):
    bt, cpt, h, w, p1, p2, d = shape
    args = (*_pe_case(dev, bt, cpt, h, w, p1, p2, d), p1, p2, 1e-5)
    before = patches.patch_embed.launches
    out, mu, sq = patches.patch_embed(*args)
    again = patches.patch_embed(*args)
    ref, mu_p, sq_p = patches.patch_embed_plain(*args)
    torch.cuda.synchronize()
    assert patches.patch_embed.launches == before + 2
    assert out.shape == (bt, h // p1, w // p2, d) and out.dtype == ref.dtype
    assert all(torch.equal(a, b) for a, b in zip((out, mu, sq), again))
    _close(out, ref)
    assert _rel(mu, mu_p) < 1e-5 and _rel(sq, sq_p) < 1e-5


def test_patch_embed_grads_match_plain(dev):
    """fused_patch_embed's parameter gradients through the kernel's
    Function against those through the plain twin."""
    g = torch.Generator(device=dev).manual_seed(5)
    c, pt, p, d = 1, 4, 8, 128
    n = c * pt * p * p
    video = _randn(g, 2, c, 2 * pt, 4 * p, 6 * p)
    params = [1 + 0.1 * torch.randn(n, generator=g, device=dev),
              0.1 * torch.randn(n, generator=g, device=dev),
              torch.randn(n, d, generator=g, device=dev) / math.sqrt(n),
              0.1 * torch.randn(d, generator=g, device=dev)]
    cot = torch.randn(2, 2, 4, 6, d, generator=g, device=dev)
    grads = []
    for use_kernel in (True, False):
        leaves = [t.clone().requires_grad_() for t in params]
        out = patches.fused_patch_embed(video, *leaves, pt, p, p,
                                        use_kernel=use_kernel)
        out.float().backward(cot)
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        assert _rel(a, b) < 1e-2


def test_patch_embed_refuses_before_any_launch(dev):
    """Each shape or type the kernel does not take raises before a
    launch, never through the plain twin."""
    good = (2, 4, 48, 48, 8, 6, 384)
    bad = [dict(p2=5), dict(w=36, p2=6),     # odd p2; W·2 % 16 != 0
           dict(cpt=1, p1=3),                # n = CPT·p1·p2 = 18: not % 8
           dict(d=40), dict(h=44),           # D % 16; H % p1
           dict(w=776, p2=8)]                # 97 tokens per patch row
    names = ("bt", "cpt", "h", "w", "p1", "p2", "d")
    before = patches.patch_embed.launches
    for change in bad:
        shape = dict(zip(names, good), **change)
        x, kc, csum, dvec = _pe_case(dev, *(shape[k] for k in names))
        with pytest.raises(ValueError):
            patches.patch_embed(x, kc, csum, dvec, shape["p1"], shape["p2"],
                                1e-5)
    x, kc, csum, dvec = _pe_case(dev, *good)
    with pytest.raises(ValueError):          # fp32 video
        patches.patch_embed(x.float(), kc, csum, dvec, 8, 6, 1e-5)
    with pytest.raises(ValueError):          # kc of another depth
        patches.patch_embed(x, kc[:, :-16], csum, dvec, 8, 6, 1e-5)
    assert patches.patch_embed.launches == before


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    # K2 and K11 take D and 2I on the multiples of 16 only, and check every
    # operand before the first launch
    for d, i2 in ((40, 256), (128, 72)):
        k2 = _k2_case(dev, 50, d, i2)
        k11 = _k11_case(dev, 50, d, i2)
        before = [f.launches for f in K2_STAGES + K11_STAGES]
        with pytest.raises(ValueError):
            geglu_ff.geglu_ff(*k2)
        with pytest.raises(ValueError):
            geglu_ff.geglu_ff_int8(*k11)
        assert [f.launches for f in K2_STAGES + K11_STAGES] == before
    # the attention kernels take head dims up to 64: 72 is refused by each
    # before a launch
    counters = (fa.attention_static, fa.attention_online,
                fa.attention_bwd_dkv, fa.attention_bwd_dq,
                fa.attention_static_int8)
    before = [f.launches for f in counters]
    q, k, v, nk, nv, scale = _attn_case(dev, 70, 70, 2, d=72)
    bound = torch.tensor(scale, device=dev)
    lse = torch.zeros(2, 3, 70, device=dev)
    for call in (
            lambda: fa.attention_static(q, k, v, nk, nv, bound, scale),
            lambda: fa.attention_online(q, k, v, scale),
            lambda: fa.attention_bwd(q, k, v, q, lse, lse, scale),
            lambda: fa.attention_static_int8(*_int8_attn_case(
                dev, 70, 70, 2, d=72))):
        with pytest.raises(ValueError, match="up to 64"):
            call()
    assert [f.launches for f in counters] == before


def _attn_case(dev, nq, nkv, n_null, seed=4, d=32):
    g = torch.Generator(device=dev).manual_seed(seed)
    b, h = 2, 3
    q = l2norm(_randn(g, b, nq, h, d)).transpose(1, 2)      # strided view
    k = l2norm(_randn(g, b, nkv, h, d)).transpose(1, 2)
    v = _randn(g, b, nkv, h, d).transpose(1, 2)
    nk = l2norm(_randn(g, h, n_null, d)) if n_null else None
    nv = _randn(g, h, n_null, d) if n_null else None
    return q, k, v, nk, nv, 1.0 / math.sqrt(d)


@pytest.mark.parametrize("nq,nkv,n_null", [(100, 70, 2), (13, 200, 8),
                                           (128, 64, 0), (129, 65, 0),
                                           (200, 130, 2), (13, 130, 8)])
def test_k1_lse_matches_plain(dev, nq, nkv, n_null):
    q, k, v, nk, nv, scale = _attn_case(dev, nq, nkv, n_null)
    bound = torch.tensor(scale, device=dev)
    out, lse = fa.attention_static(q, k, v, nk, nv, bound, scale, save_lse=True)
    ref, lse_p = fa.attention_static_plain(q, k, v, nk, nv, bound, scale,
                                           save_lse=True)
    torch.cuda.synchronize()
    assert lse.shape == (2, 3, nq) and lse.dtype == torch.float32
    _close(out, ref)
    assert _rel(lse, lse_p) < 1e-5


def _bwd_inputs(dev, nq, nkv, n_null):
    """The backward pair's inputs from K1 with lse: q, k, v, dout, lse, δ,
    scale, with the nulls and the bound for the whole op.  δ carries a
    seeded lse cotangent (δ − glse, as OnlineAttention passes it), so dS
    is not the near-cancellation p·(dP − δ) that a single key gives."""
    q, k, v, nk, nv, scale = _attn_case(dev, nq, nkv, n_null)
    bound = torch.tensor(scale, device=dev)
    g = torch.Generator(device=dev).manual_seed(5)
    dout = _randn(g, 2, nq, 3, 32).transpose(1, 2)
    glse = torch.randn(2, 3, nq, generator=g, device=dev)
    out, lse = fa.attention_static(q, k, v, nk, nv, bound, scale, save_lse=True)
    delta = (dout.float() * out.float()).sum(-1) - glse
    return (q, k, v, dout, lse, delta, scale), (nk, nv, bound)


# every edge of the kernels' blocking (blocks of 128 rows, tiles of 64):
# one query or one key, ragged tails of 1 and 2 past 128 and 256, fewer
# keys than a tile, exact blocks, and the old square cases
@pytest.mark.parametrize("nq,nkv,n_null", [
    (100, 100, 0), (100, 100, 2), (150, 150, 8), (1, 300, 0), (300, 1, 0),
    (129, 130, 2), (257, 258, 0), (200, 13, 8), (128, 128, 0), (64, 1, 1)])
def test_attention_backward_matches_plain(dev, nq, nkv, n_null):
    """The dk/dv and dq kernels against the plain backward twin, and the
    whole differentiable op (null terms included) against its plain path."""
    bwd, (nk, nv, bound) = _bwd_inputs(dev, nq, nkv, n_null)
    q, k, v, dout, lse, delta, scale = bwd
    before = (fa.attention_bwd_dkv.launches, fa.attention_bwd_dq.launches)
    got = fa.attention_bwd(*bwd)
    ref = fa.attention_bwd_plain(*bwd)
    torch.cuda.synchronize()
    assert (fa.attention_bwd_dkv.launches,
            fa.attention_bwd_dq.launches) == (before[0] + 1, before[1] + 1)
    for a, r in zip(got, ref):
        assert a.shape == r.shape and _rel(a, r) < 1e-2
        # two bf16 ulps of the largest element (chip_smoke.MAX_ABS_TOL)
        assert (a.float() - r.float()).abs().max() <= 2.0 ** -6 * r.float(
            ).abs().max()

    grads = []
    for use_kernel in (True, False):
        leaves = [t.detach().clone().requires_grad_()
                  for t in (q, k, v) + ((nk, nv) if n_null else ())]
        nulls = leaves[3:] if n_null else (None, None)
        o = fa.flash_attention(*leaves[:3], logit_bound=bound, scale=scale,
                               null_k=nulls[0], null_v=nulls[1],
                               use_kernel=use_kernel)
        o.backward(dout)
        grads.append([t.grad for t in leaves])
    for i, (a, r) in enumerate(zip(*grads)):
        if nkv + n_null == 1 and i < 2:
            # one key: the softmax is constant, so q and k have no
            # gradient and both paths give fp32 rounding noise
            assert max(a.abs().max(), r.abs().max()) <= 1e-5 * grads[1][2].abs(
                ).max()
        else:
            assert _rel(a, r) < 1e-2


def test_attention_backward_is_deterministic(dev):
    """No atomics: the pair gives the same bits on the same inputs."""
    bwd, _ = _bwd_inputs(dev, 257, 258, 0)
    before = (fa.attention_bwd_dkv.launches, fa.attention_bwd_dq.launches)
    first = fa.attention_bwd(*bwd)
    second = fa.attention_bwd(*bwd)
    torch.cuda.synchronize()
    assert (fa.attention_bwd_dkv.launches,
            fa.attention_bwd_dq.launches) == (before[0] + 2, before[1] + 2)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _online_case(dev, nq, nkv, n_null, seed=9):
    """K15's inputs as the model makes them: q/k scaled past unit norm so
    the running max moves, the nulls concatenated in front of k/v."""
    q, k, v, nk, nv, scale = _attn_case(dev, nq, nkv, n_null, seed)
    q, k = q * 3, k * 3
    if n_null:
        b = q.shape[0]
        k = torch.cat([nk[None].expand(b, -1, -1, -1) * 3, k], dim=2)
        v = torch.cat([nv[None].expand(b, -1, -1, -1), v], dim=2)
    return q, k, v, scale


@pytest.mark.parametrize("nq,nkv,n_null", [(100, 70, 2), (13, 200, 8),
                                           (128, 64, 0), (64, 1, 1),
                                           (129, 63, 2), (200, 128, 2),
                                           (13, 129, 1), (200, 1, 0)])
def test_k15_matches_plain(dev, nq, nkv, n_null):
    """With and without lse, at ragged q and kv (the tail tile masked)."""
    q, k, v, scale = _online_case(dev, nq, nkv, n_null)
    before = fa.attention_online.launches
    out = fa.attention_online(q, k, v, scale)
    out2, lse = fa.attention_online(q, k, v, scale, save_lse=True)
    ref, lse_p = fa.attention_online_plain(q, k, v, scale, save_lse=True)
    torch.cuda.synchronize()
    assert fa.attention_online.launches == before + 2
    assert out.shape == (2, 3, nq, 32) and lse.shape == (2, 3, nq)
    assert torch.equal(out, out2)
    _close(out, ref)
    assert _rel(lse, lse_p) < 1e-5


def _wide_case(dev, nq, nkv, n_null):
    """Logits spread over [-144, 144] (scale 1, q/k rows of norm 12): most p
    lie far below the row's largest, many below 2^-126, where
    ex2.approx.ftz flushes them to 0."""
    q, k, v, nk, nv, _ = _attn_case(dev, nq, nkv, n_null, seed=12)
    return q * 12, k * 12, v, None if nk is None else nk * 12, nv, 1.0


@pytest.mark.parametrize("online", [False, True], ids=["K1", "K15"])
def test_forward_wide_logit_spread(dev, online):
    q, k, v, nk, nv, scale = _wide_case(dev, 200, 300, 0 if online else 8)
    keys = k if online else torch.cat(
        [nk[None].expand(q.shape[0], -1, -1, -1), k], dim=2)
    logits = q.float() @ keys.float().transpose(-1, -2) * scale
    assert (logits.amax(-1) - logits.amin(-1)).min() > 100   # the spread
    if online:
        out, lse = fa.attention_online(q, k, v, scale, save_lse=True)
        ref, lse_p = fa.attention_online_plain(q, k, v, scale, save_lse=True)
    else:
        # the tightest bound: K1's p of a row's largest logit stays normal
        bound = logits.max()
        out, lse = fa.attention_static(q, k, v, nk, nv, bound, scale,
                                       save_lse=True)
        ref, lse_p = fa.attention_static_plain(q, k, v, nk, nv, bound, scale,
                                               save_lse=True)
    torch.cuda.synchronize()
    _close(out, ref)
    assert _rel(lse, lse_p) < 1e-5


def test_forwards_are_deterministic(dev):
    """No atomics: K1 and K15 give the same bits over two launches."""
    q, k, v, nk, nv, scale = _attn_case(dev, 257, 258, 2)
    bound = torch.tensor(scale, device=dev)
    static = [fa.attention_static(q, k, v, nk, nv, bound, scale,
                                  save_lse=True) for _ in range(2)]
    online = [fa.attention_online(q, k, v, scale, save_lse=True)
              for _ in range(2)]
    torch.cuda.synchronize()
    for first, second in (static, online):
        for a, b in zip(first, second):
            assert torch.equal(a, b)


@pytest.mark.parametrize("n,n_null", [(100, 2), (150, 8)])
def test_online_attention_backward_matches_plain(dev, n, n_null):
    """OnlineAttention on the kernels against its plain path: gradients in
    q, k, v and the nulls through torch.cat."""
    q, k, v, nk, nv, scale = _attn_case(dev, n, n, n_null, seed=10)
    dout = _randn(torch.Generator(device=dev).manual_seed(11), 2, n, 3, 32
                  ).transpose(1, 2)
    grads = []
    for use_kernel in (True, False):
        leaves = [t.detach().clone().requires_grad_()
                  for t in (q, k, v, nk, nv)]
        o = fa.flash_attention_online(*leaves[:3], scale=scale,
                                      null_k=leaves[3], null_v=leaves[4],
                                      use_kernel=use_kernel)
        o.backward(dout)
        grads.append([t.grad for t in leaves])
    for a, r in zip(*grads):
        assert _rel(a, r) < 1e-2


K8_STAGES = (geglu_ff.geglu_bwd_y, geglu_ff.geglu_bwd_dh, geglu_ff.geglu_bwd_dy,
             geglu_ff.geglu_bwd_dx, geglu_ff.wgrad_partials, geglu_ff.sum_rows)


# the edges of K8's blocking: dh/dy tiles of 128 tokens, dx blocks of 64
# rows, weight-GEMM steps of 32 tokens (M 50, 96, 129, 300, 4113); 64
# inner columns per dh tile and 128 × 128 weight tiles (inner 256 and 2048);
# the widths D 384 (the mid arch's), 448 (a 64-column tail in dy's and the
# weight GEMM's 128-column tiles, two dx chunks a lane, the second partly
# past D) and 768 (production's)
K8_WIDTHS = [384, 448, 768]


@pytest.mark.parametrize("d", K8_WIDTHS)
@pytest.mark.parametrize("inner", [256, 2048])
@pytest.mark.parametrize("m", [50, 96, 129, 300, 4113])
def test_k8_matches_plain(dev, m, inner, d):
    g = torch.Generator(device=dev).manual_seed(6)
    x = _randn(g, m, d)
    mu, inv = geglu_ff.ln_stats(x, 1e-5)
    gamma = 1 + 0.1 * torch.randn(d, generator=g, device=dev)
    beta = 0.1 * torch.randn(d, generator=g, device=dev)
    w1 = torch.randn(d, 2 * inner, generator=g, device=dev) * d ** -0.5
    w2 = torch.randn(inner, d, generator=g, device=dev) * inner ** -0.5
    dout = _randn(g, m, d)
    before = [f.launches for f in K8_STAGES]
    got = geglu_ff.geglu_ff_bwd(x, mu, inv, gamma, beta, w1, w2, dout)
    again = geglu_ff.geglu_ff_bwd(x, mu, inv, gamma, beta, w1, w2, dout)
    ref = geglu_ff.geglu_ff_bwd_plain(x, mu, inv, gamma, beta, w1, w2, dout)
    torch.cuda.synchronize()
    # per call: y, dh, dy and dx once, two weight GEMMs, four ordered sums
    assert [f.launches - b for f, b in zip(K8_STAGES, before)] == [
        2, 2, 2, 2, 4, 8]
    for a, a2, r in zip(got, again, ref):
        assert a.shape == r.shape and torch.isfinite(a).all()
        assert torch.equal(a, a2)   # no atomics
        assert _rel(a, r) < 1e-2


@pytest.mark.parametrize("d", K8_WIDTHS)
@pytest.mark.parametrize("m", [129, 4113])
def test_k8_stages_match_their_twins(dev, m, d):
    """Each K8 stage against its plain twin on the kernel chain's inputs."""
    g = torch.Generator(device=dev).manual_seed(16)
    inner = 576
    x = _randn(g, m, d)
    mu, inv = geglu_ff.ln_stats(x, 1e-5)
    gamma = 1 + 0.1 * torch.randn(d, generator=g, device=dev)
    beta = 0.1 * torch.randn(d, generator=g, device=dev)
    w1 = _randn(g, d, 2 * inner, std=d ** -0.5)
    w2 = _randn(g, inner, d, std=inner ** -0.5)
    dout = _randn(g, m, d)
    y = geglu_ff.geglu_bwd_y(x, mu, inv, gamma, beta)
    dh, act = geglu_ff.geglu_bwd_dh(y, dout, w1, w2)
    dy = geglu_ff.geglu_bwd_dy(dh, w1)
    dx = geglu_ff.geglu_bwd_dx(x, mu, inv, gamma, dy)
    plan = geglu_ff.wgrad_plan(m, d, 2 * inner)
    part = geglu_ff.wgrad_partials(y, dh, *plan)
    checks = [
        ((y,), (geglu_ff.geglu_bwd_y_plain(x, mu, inv, gamma, beta),)),
        ((dh, act), geglu_ff.geglu_bwd_dh_plain(y, dout, w1, w2)),
        ((dy,), (geglu_ff.geglu_bwd_dy_plain(dh, w1),)),
        (dx, geglu_ff.geglu_bwd_dx_plain(x, mu, inv, gamma, dy)),
        ((part,), (geglu_ff.wgrad_partials_plain(y, dh, *plan),)),
        ((geglu_ff.sum_rows(part),), (geglu_ff.sum_rows_plain(part),)),
    ]
    torch.cuda.synchronize()
    for got, ref in checks:
        for a, r in zip(got, ref):
            assert a.shape == r.shape and a.dtype == r.dtype
            assert _rel(a, r) < 1e-2


@pytest.mark.parametrize("d", [40, 8, 2112])
def test_k8_refuses_a_width_before_any_launch(dev, d):
    """K8 takes D a multiple of 16 up to K8_MAX_D: any other width is
    refused by the whole kernel and by each stage before a launch."""
    g = torch.Generator(device=dev).manual_seed(17)
    m, inner = 64, 256
    x = _randn(g, m, d)
    mu, inv = geglu_ff.ln_stats(x, 1e-5)
    gamma, beta = torch.ones(d, device=dev), torch.zeros(d, device=dev)
    w1 = _randn(g, d, 2 * inner, std=d ** -0.5)
    w2 = _randn(g, inner, d, std=inner ** -0.5)
    dh = _randn(g, m, 2 * inner)
    dy = torch.zeros(m, d, device=dev)
    before = [f.launches for f in K8_STAGES]
    for call in (
            lambda: geglu_ff.geglu_ff_bwd(x, mu, inv, gamma, beta, w1, w2, x),
            lambda: geglu_ff.geglu_bwd_y(x, mu, inv, gamma, beta),
            lambda: geglu_ff.geglu_bwd_dh(x, x, w1, w2),
            lambda: geglu_ff.geglu_bwd_dy(dh, w1),
            lambda: geglu_ff.geglu_bwd_dx(x, mu, inv, gamma, dy)):
        with pytest.raises(ValueError, match="multiple of 16"):
            call()
    assert [f.launches for f in K8_STAGES] == before


# the products on the wgmma mainloop of csrc/gemm_wgmma.cuh: K2's, K8's and
# K3's in bf16, K11's two, K12/K13's and K14 in int8 (K14 one instance per
# 256 columns of K)
WGMMA_KERNELS = ("geglu_ff_h_kernel", "geglu_ff_o_kernel",
                 "geglu_bwd_dh_kernel", "geglu_bwd_dy_kernel", "wgrad_kernel",
                 "ln_qkv_kernel")
WGMMA_INT8_KERNELS = ("geglu_int8_h_kernel", "geglu_int8_o_kernel",
                      "ln_qkv_int8_mm_kernel", "proj_int8_kernel")


def _sass_all(name, sass):
    """The SASS of each kernel of the library whose symbol holds name (every
    instance of a template), at least one."""
    found = [text for fn, text in sass.items() if name in fn]
    assert found, (name, sorted(sass))
    return found


def _sass_of(name, sass):
    """The SASS of the one kernel of the library whose symbol holds name."""
    found = _sass_all(name, sass)
    assert len(found) == 1, (name, sorted(sass))
    return found[0]


def test_k2_k8_products_run_on_wgmma_fed_by_tma(dev):
    """cuobjdump -sass (beside nvcc) of the built library: each bf16 kernel
    on gemm_wgmma.cuh (K2's two products, K8's three, K3) issues wgmma
    (HGMMA) on operands loaded by TMA (UTMALDG) and no mma.sync (HMMA);
    each int8 one (K11's two products, K12/K13's product, every instance
    of K14) issues int8 wgmma (IGMMA) on TMA loads and no int8 mma.sync
    (IMMA).  The patch embedding (HMMA, no HGMMA, on gemm_mma.cuh) and the
    int8 attention (IMMA through attn_mma.cuh's mma_s8, no IGMMA) are the
    witnesses that the check tells the two routes apart in each type."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "-sass", str(_build.build())],
                         capture_output=True, text=True, check=True).stdout
    sass = {part.split("\n", 1)[0].strip(): part
            for part in re.split(r"Function : ", out)[1:]}
    hmma, imma = re.compile(r"\bHMMA\b"), re.compile(r"\bIMMA\b")
    for name in WGMMA_KERNELS:
        text = _sass_of(name, sass)
        assert "HGMMA" in text and "UTMALDG" in text, name
        assert not hmma.search(text), name
    for name in WGMMA_INT8_KERNELS:
        for text in _sass_all(name, sass):
            assert "IGMMA" in text and "UTMALDG" in text, name
            assert not imma.search(text), name
    for text in _sass_all("patch_embed_kernel", sass):
        assert hmma.search(text) and "HGMMA" not in text
    for text in _sass_all("flash_static_int8_kernel", sass):
        assert imma.search(text) and "IGMMA" not in text


def test_no_wrapper_returns_a_graphless_result(dev):
    """A raw kernel wrapper refuses an input that requires grad; the ops
    route through their autograd Functions, whose outputs carry a graph."""
    g = torch.Generator(device=dev).manual_seed(7)
    x = _randn(g, 64, 768).requires_grad_()
    mu, inv = geglu_ff.ln_stats(x.detach(), 1e-5)
    w1p, w2 = _randn(g, 768, 512), _randn(g, 256, 768)
    with pytest.raises(RuntimeError):
        geglu_ff.geglu_ff(x, mu, inv, w1p, torch.zeros(512, device=dev), w2)
    gamma = torch.ones(768, device=dev, requires_grad=True)
    beta = torch.zeros(768, device=dev, requires_grad=True)
    w1 = torch.randn(768, 512, device=dev, requires_grad=True)
    w2f = torch.randn(256, 768, device=dev, requires_grad=True)
    out = geglu_ff.fused_geglu_ff(x, gamma, beta, w1, w2f)
    assert out.grad_fn is not None
    out.float().sum().backward()
    assert all(t.grad is not None for t in (x, gamma, beta, w1, w2f))
    q, k, v, nk, nv, scale = _attn_case(dev, 70, 70, 2)
    q = q.detach().requires_grad_()
    with pytest.raises(RuntimeError):
        fa.attention_static(q, k, v, nk, nv, torch.tensor(scale, device=dev),
                            scale)
    o = fa.flash_attention(q, k, v, logit_bound=torch.tensor(scale, device=dev),
                           scale=scale, null_k=nk, null_v=nv)
    assert o.grad_fn is not None
    o.float().sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad.float()).all()


def _int8_attn_case(dev, nq, nkv, n_null, seed=8, d=32):
    """The int8 attention's inputs as the model makes them: l2-normalised,
    scaled q/k (strided views of packed projections) through the int8
    prologue, v in place, fp32 null k and bf16 null v."""
    g = torch.Generator(device=dev).manual_seed(seed)
    b, h = 2, 3
    qsc = 1 + 0.1 * torch.randn(d, generator=g, device=dev)
    ksc = 1 + 0.1 * torch.randn(d, generator=g, device=dev)
    q = l2norm(_randn(g, b, nq, h, d)).transpose(1, 2) * qsc.bfloat16()
    k = l2norm(_randn(g, b, nkv, h, d)).transpose(1, 2) * ksc.bfloat16()
    v = _randn(g, b, nkv, h, d).transpose(1, 2)
    scale = 1.0 / math.sqrt(d)
    q8, k8, qe, qn = fa.quantize_qk(q, k, scale)
    nk = nv = None
    if n_null:
        nk = l2norm(torch.randn(h, n_null, d, generator=g, device=dev)) * ksc
        nv = _randn(g, h, n_null, d)
    return q8, k8, v, qe, qn, nk, nv, logit_bound(qsc, ksc, scale)


# the edges of the int8 kernel's blocking (blocks of 128 queries, 64-key
# tiles): nq 13, 100 and 129, kv tails of 6, 8 and 2 keys, 0, 2 and 8
# nulls, and the production key count
@pytest.mark.parametrize("nq,nkv,n_null", [(100, 70, 2), (64, 64, 0),
                                           (13, 200, 8), (129, 13826, 2)])
def test_int8_attention_matches_plain(dev, nq, nkv, n_null):
    args = _int8_attn_case(dev, nq, nkv, n_null)
    before = fa.attention_static_int8.launches
    out = fa.attention_static_int8(*args)
    again = fa.attention_static_int8(*args)
    ref = fa.attention_static_int8_plain(*args)
    torch.cuda.synchronize()
    assert fa.attention_static_int8.launches == before + 2
    assert out.shape == (2, 3, nq, 32) and out.dtype == torch.bfloat16
    assert out.transpose(1, 2).is_contiguous()
    assert torch.equal(out, again)   # no atomics
    assert _rel(out, ref) < 1e-2


def test_int8_attention_wide_logit_spread(dev):
    """Int8 logits spread over more than 100 (q/k rows of norm 12, scale
    1) with the tightest bound: most p lie far below the row's largest,
    many below 2^-126, where ex2.approx.ftz flushes them to 0."""
    q8, k8, v, qe, qn, nk, nv, _ = _int8_attn_case(dev, 200, 300, 8, seed=13)
    qe, qn = qe * 12 * 12 * math.sqrt(32), qn * 12 * math.sqrt(32)
    nk = nk * 12
    logits = q8.float() @ k8.float().transpose(-1, -2) * qe[..., None]
    nulls = q8.float() @ nk.transpose(-1, -2)[None] * qn[..., None]
    assert (logits.amax(-1) - logits.amin(-1)).min() > 100   # the spread
    bound = torch.maximum(logits.max(), nulls.max())
    args = (q8, k8, v, qe, qn, nk, nv, bound)
    out = fa.attention_static_int8(*args)
    ref = fa.attention_static_int8_plain(*args)
    torch.cuda.synchronize()
    _close(out, ref)


K11_STAGES = (geglu_ff.geglu_ff_int8_y, geglu_ff.geglu_ff_int8_h,
              geglu_ff.geglu_ff_int8_q, geglu_ff.geglu_ff_int8_o)


def _k11_case(dev, m, d, i2, seed=9):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = _randn(g, m, d)
    mu, inv = geglu_ff.ln_stats(x, 1e-5)
    gamma = 1 + 0.1 * torch.randn(d, generator=g, device=dev)
    beta = 0.1 * torch.randn(d, generator=g, device=dev)
    w1q, s1 = geglu_ff.quantize_per_channel(
        torch.randn(d, i2, generator=g, device=dev))
    w2q, s2 = geglu_ff.quantize_per_channel(
        torch.randn(i2 // 2, d, generator=g, device=dev))
    return x, mu, inv, gamma, beta, w1q, s1, w2q, s2


@pytest.mark.parametrize("d,i2", FF_SHAPES)
@pytest.mark.parametrize("m", [50, 4113])
def test_k11_matches_plain(dev, m, d, i2):
    args = _k11_case(dev, m, d, i2)
    before = [f.launches for f in K11_STAGES]
    out = geglu_ff.geglu_ff_int8(*args)
    again = geglu_ff.geglu_ff_int8(*args)
    ref = geglu_ff.geglu_ff_int8_plain(*args)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(K11_STAGES, before)] == [2] * 4
    assert out.dtype == torch.bfloat16 and torch.equal(out, again)
    _close(out, ref)


@pytest.mark.parametrize("d,i2", FF_SHAPES)
def test_k11_stages_match_their_twins(dev, d, i2):
    """Each K11 stage against its plain twin on the kernel chain's inputs;
    the codes within one step of the twin's (a different fp32 erf or
    product order may cross a rounding boundary), the scales and the
    partial amaxes as fp32 values."""
    x, mu, inv, gamma, beta, w1q, s1, w2q, s2 = _k11_case(dev, 4113, d, i2,
                                                          seed=14)
    w1t, w2t = w1q.t().contiguous(), w2q.t().contiguous()
    y8, sy = geglu_ff.geglu_ff_int8_y(x, mu, inv, gamma, beta)
    act, part = geglu_ff.geglu_ff_int8_h(y8, sy, w1t, s1)
    a8, sa = geglu_ff.geglu_ff_int8_q(act, part)
    out = geglu_ff.geglu_ff_int8_o(a8, sa, w2t, s2)
    checks = [((y8, sy), geglu_ff.geglu_ff_int8_y_plain(x, mu, inv, gamma,
                                                         beta)),
              ((act, part), geglu_ff.geglu_ff_int8_h_plain(y8, sy, w1t, s1)),
              ((a8, sa), geglu_ff.geglu_ff_int8_q_plain(act, part)),
              ((out,), (geglu_ff.geglu_ff_int8_o_plain(a8, sa, w2t, s2),))]
    torch.cuda.synchronize()
    for got, ref in checks:
        for a, r in zip(got, ref):
            assert a.shape == r.shape and a.dtype == r.dtype
            if a.dtype == torch.int8:
                assert (a.int() - r.int()).abs().max() <= 1
            else:
                _close(a, r)


K13_STAGES = (fused_proj.ln_qkv_int8_x, fused_proj.ln_qkv_int8_mm)


def _k13_case(dev, m, k, f, fq, seed=10):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = _randn(g, m, k) * 2 + 0.5
    mu, inv = geglu_ff.ln_stats(x, 1e-5)
    w8, sc, c = fused_proj.int8_qkv_weights(
        torch.rand(k, device=dev) + 0.5,
        torch.randn(k, fq, generator=g, device=dev),
        torch.randn(k, f - fq, generator=g, device=dev))
    return x, mu, inv, w8, sc, c, fq, (f - fq) // 2


@pytest.mark.parametrize("k,f,fq", QKV_KFQ + [(96, 384, 128), (96, 384, 68)])
@pytest.mark.parametrize("m", QKV_M)
def test_k12_k13_matches_plain(dev, m, k, f, fq):
    """The two stages against their twins on the kernel chain's inputs, bit
    for bit (the same fp32 operations on exact integer sums): x8 and s_x,
    then q, k, v; two launches give the same bits.  The product's column
    tiles go by TMA stores or from the registers
    (fused_proj.k13_store_routes): all by TMA at fq 256 and at (384, 128),
    both kinds at fq 64 (a chunk straddles fq + fk), and at fq 68 every
    output's rows are off 16 bytes (136 and 316 bytes), so all from the
    registers."""
    x, mu, inv, w8, sc, c, fq, fk = _k13_case(dev, m, k, f, fq)
    w8t = w8.t().contiguous()
    before = [fn.launches for fn in K13_STAGES]
    out = fused_proj.ln_qkv_int8(x, mu, inv, w8, sc, c, fq, fk)
    again = fused_proj.ln_qkv_int8(x, mu, inv, w8, sc, c, fq, fk)
    x8, sx = fused_proj.ln_qkv_int8_x(x, mu)
    x8_p, sx_p = fused_proj.ln_qkv_int8_x_plain(x, mu)
    mm = fused_proj.ln_qkv_int8_mm(x8, sx, mu, inv, w8t, sc, c, fq, fk)
    mm_p = fused_proj.ln_qkv_int8_mm_plain(x8, sx, mu, inv, w8t, sc, c, fq, fk)
    ref = fused_proj.ln_qkv_int8_plain(x, mu, inv, w8, sc, c, fq, fk)
    torch.cuda.synchronize()
    assert [fn.launches - b for fn, b in zip(K13_STAGES, before)] == [3, 3]
    assert x8.dtype == torch.int8 and torch.equal(x8, x8_p)
    assert sx.shape == (m, 1) and torch.equal(sx, sx_p)
    for width, a, b, p, r, o in zip((fq, fk, f - fq - fk), out, again, mm,
                                    mm_p, ref):
        assert a.shape == (m, width) and a.dtype == torch.bfloat16
        assert torch.equal(a, b) and torch.equal(p, r) and torch.equal(a, o)


def test_ln_qkv_wrappers_refuse_before_any_launch(dev):
    """K3 and K12/K13 refuse what their kernels do not take before the first
    launch, with the launch counters unchanged."""
    counters = (fused_proj.ln_qkv,) + K13_STAGES
    before = [fn.launches for fn in counters]
    x, mu, inv, wf, c, fq = _k3_case(dev, 50, 384, 768, 64)
    for bad in ((x[:, :40], mu, inv, wf[:40], c, fq),      # K % 16
                (x, mu, inv, wf[:, :88], c[:88], fq),      # F % 16
                (x, mu, inv, wf, c, 769)):                 # fq > F
        with pytest.raises(ValueError):
            fused_proj.ln_qkv(*bad)
    x, mu, inv, w8, sc, c, fq, fk = _k13_case(dev, 50, 384, 768, 64)
    for bad in ((x[:, :40], mu, inv, w8[:40], sc, c, fq, fk),   # K % 16
                (x, mu, inv, w8[:, :696], sc[:696], c[:696], fq, fk),  # F
                (x, mu, inv, w8, sc, c, fq, 768 - fq),      # no v column
                (x, mu, inv, w8, sc, c, 0, fk)):            # no q column
        with pytest.raises(ValueError):
            fused_proj.ln_qkv_int8(*bad)
    assert [fn.launches for fn in counters] == before


@pytest.mark.parametrize("k", [256, 768])
@pytest.mark.parametrize("m", [100, 128, 4113, 55296])
def test_k14_matches_plain(dev, m, k):
    g = torch.Generator(device=dev).manual_seed(11)
    x = _randn(g, m, k)
    w8, sc = geglu_ff.quantize_per_channel(
        torch.randn(k, 768, generator=g, device=dev))
    before = fused_proj.proj_int8.launches
    out = fused_proj.proj_int8(x, w8, sc)
    ref = fused_proj.proj_int8_plain(x, w8, sc)
    torch.cuda.synchronize()
    assert fused_proj.proj_int8.launches == before + 1
    assert out.shape == (m, 768) and torch.equal(out, ref)


@pytest.mark.parametrize("m,k,f", [(4113, 32, 48), (4113, 1024, 768),
                                   (100, 1024, 48), (4113, 400, 96)])
def test_k14_at_the_edges_of_k(dev, m, k, f):
    """K14 bit for bit its twin at the widths its codes and ring bound:
    K 32 (one k step, mostly zero-filled), K 1,024 (eight resident k
    steps), K 400 (a partial last k step), at rows that are not whole
    64-row tiles and at F that ends inside a column tile."""
    g = torch.Generator(device=dev).manual_seed(25)
    x = _randn(g, m, k)
    w8, sc = geglu_ff.quantize_per_channel(
        torch.randn(k, f, generator=g, device=dev))
    out = fused_proj.proj_int8(x, w8, sc)
    again = fused_proj.proj_int8(x, w8, sc)
    ref = fused_proj.proj_int8_plain(x, w8, sc)
    torch.cuda.synchronize()
    assert out.shape == (m, f) and torch.equal(out, ref)
    assert torch.equal(out, again)


def test_k14_refuses_before_any_launch(dev):
    g = torch.Generator(device=dev).manual_seed(12)
    before = fused_proj.proj_int8.launches
    for k, f in ((1040, 256), (200, 256), (256, 328)):   # K > 1024; K, F % 16
        w8, sc = geglu_ff.quantize_per_channel(
            torch.randn(k, f, generator=g, device=dev))
        with pytest.raises(ValueError):
            fused_proj.proj_int8(_randn(g, 64, k), w8, sc)
    assert fused_proj.proj_int8.launches == before


def test_int8_scales_are_one_ieee_division_on_the_card(dev):
    """On CUDA tensors too, every scale of the plain twins and of the int8
    glue is max(amax, 1e-8) / 127 rounded once (torch multiplies a CUDA
    tensor by the reciprocal of a Python divisor, which the kernels and
    JAX do not)."""
    g = torch.Generator(device=dev).manual_seed(13)
    y = torch.randn(512, 64, generator=g, device=dev) * 3
    amax = y.abs().amax(dim=-1, keepdim=True)
    ieee = (amax.double() / 127.0).float()
    assert not torch.equal(amax * (1 / 127), ieee)   # the case is there
    assert torch.equal(geglu_ff.quant_rows(y)[1], ieee)
    assert torch.equal(geglu_ff.quantize_per_channel(y.t())[1],
                       ieee.flatten())
    assert torch.equal(
        geglu_ff.geglu_ff_int8_q_plain(y, geglu_ff.amax_partials(y))[1], ieee)
    k = y.reshape(1, 1, 512, 64)
    ks = (y.abs().amax().double() / 127).float()
    assert torch.equal(fa.quantize_qk(k, k, 1.0)[1], torch.clamp(
        torch.round(y / ks), -127, 127).to(torch.int8).reshape(k.shape))


def test_int8_path_refuses_a_tensor_that_requires_grad(dev):
    """The int8 path has no backward: a CUDA input that requires grad is
    refused, by the raw wrappers and by the ops."""
    g = torch.Generator(device=dev).manual_seed(12)
    x = _randn(g, 64, 256).requires_grad_()
    w8, sc = geglu_ff.quantize_per_channel(
        torch.randn(256, 128, generator=g, device=dev))
    with pytest.raises(RuntimeError, match="requires grad"):
        fused_proj.proj_int8(x, w8, sc)
    with pytest.raises(RuntimeError, match="requires grad"):
        fused_proj.int8_proj(x, torch.randn(256, 128, device=dev))
    args = list(_int8_attn_case(dev, 64, 64, 2))
    args[2] = args[2].detach().requires_grad_()
    with pytest.raises(RuntimeError, match="requires grad"):
        fa.attention_static_int8(*args)


def _train_loss_and_grad_norm(config, bert, batch, use_kernels):
    """The image-report step's loss and global gradient norm at seeded
    random weights (seed 0) on one batch, at attn_impl="pallas"."""
    from vit_exp_tpu_torch.models.factory import build_ctclip
    from vit_exp_tpu_torch.models.losses import infonce_loss

    model = build_ctclip(config, bert, device="cuda", use_kernels=use_kernels,
                         attn_impl="pallas", seed=0).train()
    out = model(*batch)
    b = out["text_latents"].shape[0]
    loss = infonce_loss(out["text_latents"], out["image_latents"],
                        out["temperature"], local_batch_size=b)
    loss.backward()
    norm = torch.linalg.vector_norm(torch.stack([
        torch.linalg.vector_norm(p.grad.float()) for p in model.parameters()
        if p.grad is not None]))
    return float(loss.detach()), float(norm)


def test_dim384_train_step_matches_plain(dev):
    """F3: one contrastive train step at dim 384 and the token count of
    configs/ct_clip_vit_v3_flat_dim384.yaml (its batch of 2 × 13,824
    tokens), through the kernels (K8 at D 384 among them) against
    use_kernels=False from the same state on the same batch: loss within
    1e-2 and global gradient norm within 5% (chip_smoke.LOSS_RTOL,
    GRAD_NORM_RTOL)."""
    from pathlib import Path

    from vit_exp_tpu_torch.core.config import load_config
    from vit_exp_tpu_torch.models.bert import BertConfig

    config = load_config(str(Path(__file__).resolve().parents[1] / "configs"
                             / "ct_clip_vit_v3_flat_dim384.yaml"))
    a, b = config.arch, config.train_data_list[0]["batch_size"]
    assert a.dim == 384 and a.num_tokens == 13824 and b == 2
    bert = BertConfig(num_hidden_layers=2)
    g = torch.Generator(device=dev).manual_seed(1)
    batch = (torch.rand((b, 1, a.temporal_size, a.image_size, a.image_size),
                        generator=g, device=dev),
             torch.randint(0, bert.vocab_size, (b, 64), generator=g,
                           device=dev))
    before = [f.launches for f in K8_STAGES]
    loss_k, norm_k = _train_loss_and_grad_norm(config, bert, batch, True)
    assert [f.launches - n for f, n in zip(K8_STAGES, before)] == [
        a.transformer_blocks, a.transformer_blocks, a.transformer_blocks,
        a.transformer_blocks, 2 * a.transformer_blocks,
        4 * a.transformer_blocks]
    loss_p, norm_p = _train_loss_and_grad_norm(config, bert, batch, False)
    assert math.isfinite(loss_k) and math.isfinite(norm_k)
    assert abs(loss_k - loss_p) <= 1e-2 * abs(loss_p)
    assert abs(norm_k - norm_p) <= 0.05 * norm_p


TINY_CONFIGS = ["ct_clip_debug_synthetic.yaml", "ct_clip_dcl_synthetic.yaml"]


@pytest.mark.parametrize("name", TINY_CONFIGS)
def test_build_ctclip_takes_the_tiny_configs_through_the_kernels(dev, name):
    """The two tiny --synthetic configs (dim 48, head dim 8, 2I 256, 64
    tokens) meet no refusal, build on the card and take a contrastive step
    through the kernels (K15 at head dim 8 padded to 16, the pair, K2, K8
    at D 48, the patch embedding at D 48): loss within 1e-2 and global
    gradient norm within 5% of use_kernels=False from the same state."""
    from pathlib import Path

    from vit_exp_tpu_torch.core.config import load_config
    from vit_exp_tpu_torch.models.bert import BertConfig
    from vit_exp_tpu_torch.models.factory import (kernel_refusals,
                                                  patch_embed_refusal)

    config = load_config(str(Path(__file__).resolve().parents[1] / "configs"
                             / name))
    a = config.arch
    assert (a.dim, a.dim_head) == (48, 8)
    for fuse_qkv, int8 in ((False, False), (True, False), (True, True)):
        assert kernel_refusals(a, fuse_qkv=fuse_qkv, int8=int8) == []
    assert patch_embed_refusal(a) == []
    bert = BertConfig.tiny()
    g = torch.Generator(device=dev).manual_seed(2)
    b = 2
    batch = (torch.rand((b, 1, a.temporal_size, a.image_size, a.image_size),
                        generator=g, device=dev),
             torch.randint(0, bert.vocab_size, (b, 32), generator=g,
                           device=dev))
    counters = (fa.attention_online, fa.attention_bwd_dkv,
                fa.attention_bwd_dq, patches.patch_embed) + K2_STAGES \
        + K8_STAGES
    before = [f.launches for f in counters]
    loss_k, norm_k = _train_loss_and_grad_norm(config, bert, batch, True)
    assert all(f.launches > n for f, n in zip(counters, before))
    loss_p, norm_p = _train_loss_and_grad_norm(config, bert, batch, False)
    assert math.isfinite(loss_k) and math.isfinite(norm_k)
    assert abs(loss_k - loss_p) <= 1e-2 * abs(loss_p)
    assert abs(norm_k - norm_p) <= 0.05 * norm_p


# the attention kernels at head dims off and on their instances (8 and 24
# run zero-padded to 16 and 32; 16 and 64 are instances), at the blocking's
# edges: query counts off the blocks (128 rows at D 16 and 32, 64 at D 64),
# kv tails of 1, 2 and 6 keys past the 64-key tiles (32 at D 64), 0, 2 and
# 8 nulls
ATTN_HEAD_DIMS = [8, 16, 24, 64]
ATTN_WIDTH_EDGES = [(100, 70, 2), (13, 200, 8), (129, 65, 0), (200, 130, 8)]


@pytest.mark.parametrize("nq,nkv,n_null", ATTN_WIDTH_EDGES)
@pytest.mark.parametrize("d", ATTN_HEAD_DIMS)
def test_attention_kernels_at_head_dims(dev, d, nq, nkv, n_null):
    """K1 with lse, K15 with lse over the concatenated nulls and the
    backward pair over each, against their plain twins; each kernel twice
    on the same inputs gives the same bits."""
    q, k, v, nk, nv, scale = _attn_case(dev, nq, nkv, n_null, seed=21, d=d)
    bound = torch.tensor(scale, device=dev)
    g = torch.Generator(device=dev).manual_seed(22)
    dout = _randn(g, 2, nq, 3, d).transpose(1, 2)
    runs = []
    for _ in range(2):
        runs.append(fa.attention_static(q, k, v, nk, nv, bound, scale,
                                        save_lse=True))
    ref, lse_p = fa.attention_static_plain(q, k, v, nk, nv, bound, scale,
                                           save_lse=True)
    torch.cuda.synchronize()
    (out, lse), again = runs
    assert out.shape == (2, 3, nq, d)
    assert all(torch.equal(a, b) for a, b in zip(runs[0], again))
    _close(out, ref)
    assert _rel(lse, lse_p) < 1e-5
    if n_null:
        k = torch.cat([nk[None].expand(2, -1, -1, -1), k], dim=2)
        v = torch.cat([nv[None].expand(2, -1, -1, -1), v], dim=2)
    runs = [fa.attention_online(q, k, v, scale, save_lse=True)
            for _ in range(2)]
    ref_o, lse_o = fa.attention_online_plain(q, k, v, scale, save_lse=True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    _close(runs[0][0], ref_o)
    assert _rel(runs[0][1], lse_o) < 1e-5
    # the pair over the concatenated kv, from the twin's forward
    delta = (dout.float() * ref_o.float()).sum(-1)
    bwd = (q, k, v, dout, lse_o, delta, scale)
    got = [fa.attention_bwd(*bwd) for _ in range(2)]
    ref_b = fa.attention_bwd_plain(*bwd)
    torch.cuda.synchronize()
    for a, a2, r in zip(*got, ref_b):
        assert a.shape == r.shape and torch.isfinite(a.float()).all()
        assert torch.equal(a, a2)
        assert _rel(a, r) < 1e-2


@pytest.mark.parametrize("nq,nkv,n_null", ATTN_WIDTH_EDGES)
@pytest.mark.parametrize("d", ATTN_HEAD_DIMS)
def test_int8_attention_at_head_dims(dev, d, nq, nkv, n_null):
    """The int8 attention at head dims 8, 16 and 24 (zero-padded to its
    D 32 instance: an int8 k step is 32 codes) and 64, against its twin;
    twice on the same inputs gives the same bits."""
    args = _int8_attn_case(dev, nq, nkv, n_null, seed=23, d=d)
    out = fa.attention_static_int8(*args)
    again = fa.attention_static_int8(*args)
    ref = fa.attention_static_int8_plain(*args)
    torch.cuda.synchronize()
    assert out.shape == (2, 3, nq, d) and torch.equal(out, again)
    assert _rel(out, ref) < 1e-2


# the tiny configs' widths: D 48, 2I 256; K3 and K12/K13 at K 48, F 96 with
# fq = fk = 32; K14 at K 32, F 48; the patch embedding at D 48, patch 8 over
# 32 px, CPT 4.  K11 also at 2I 272 (I 136, zero-padded to 144 for its
# int8 rows).
@pytest.mark.parametrize("m", [50, 4113])
def test_k2_k8_k11_at_the_tiny_widths(dev, m):
    test_k2_matches_plain(dev, m, 48, 256)
    test_k8_matches_plain(dev, m, 128, 48)
    for i2 in (256, 272):
        test_k11_matches_plain(dev, m, 48, i2)


# I 1,040 is a multiple of 16 but not of the act kernel's 128-column tile:
# the last tile's val box runs past I, where its map zero-fills (one map
# over [val | gate] would read gate rows there)
@pytest.mark.parametrize("m", [50, 4113])
def test_k11_where_i_ends_inside_an_act_tile(dev, m):
    test_k11_matches_plain(dev, m, 384, 2080)


def test_k11_stages_where_i_ends_inside_an_act_tile(dev):
    test_k11_stages_match_their_twins(dev, 384, 2080)


def test_gemm_stages_at_the_tiny_widths(dev):
    test_k2_stages_match_their_twins(dev, 48, 256)
    test_k8_stages_match_their_twins(dev, 4113, 48)
    test_k11_stages_match_their_twins(dev, 48, 256)


@pytest.mark.parametrize("m", QKV_M)
def test_projections_at_the_tiny_widths(dev, m):
    test_k3_matches_plain(dev, m, 48, 96, 32)
    test_k12_k13_matches_plain(dev, m, 48, 96, 32)
    g = torch.Generator(device=dev).manual_seed(24)
    x = _randn(g, m, 32)
    w8, sc = geglu_ff.quantize_per_channel(
        torch.randn(32, 48, generator=g, device=dev))
    out = fused_proj.proj_int8(x, w8, sc)
    ref = fused_proj.proj_int8_plain(x, w8, sc)
    torch.cuda.synchronize()
    assert out.shape == (m, 48) and torch.equal(out, ref)


@pytest.mark.parametrize("bt", [3, 864])
def test_patch_embed_at_the_tiny_width(dev, bt):
    test_patch_embed_matches_plain(dev, (bt, 4, 32, 32, 8, 8, 48))


# a small arch the kernels take: head dim 32, D 384 (2I 2,048), patch 10 over
# 40 × 40 × 20 voxels (32 tokens)
SEG_ARCH = {"dim": 384, "image_size": 40, "patch_size": 10,
            "temporal_size": 20, "temporal_patch_size": 10,
            "transformer_blocks": 2, "dim_head": 32, "heads": 4}


def _seg_config(**ct_clip_arch):
    from vit_exp_tpu_torch.core.config import ExperimentConfig

    return ExperimentConfig.from_dict({
        "trainer": {"lr": 1e-4, "max_grad_norm": 1.0}, "arch": SEG_ARCH,
        "ct_clip_arch": {"use_seg": True, "seg_head": {"mid_dim": 64,
                                                       "out_dim": 3},
                         "use_open_seg": True, **ct_clip_arch}})


def _seg_step(config, data_type, batch, use_kernels):
    """One seg or open-seg step from seeded weights (seed 0): its loss, the
    pre-clip global gradient norm and the parameters given a gradient."""
    from vit_exp_tpu_torch.models.bert import BertConfig
    from vit_exp_tpu_torch.models.factory import build_ctclip
    from vit_exp_tpu_torch.train.optimizer import build_optimizer
    from vit_exp_tpu_torch.train.steps import make_train_steps

    model = build_ctclip(config, BertConfig.tiny(), device="cuda",
                         use_kernels=use_kernels, attn_impl="pallas",
                         seed=0).train()
    opt = build_optimizer(config.trainer, model.parameters())
    loss = float(make_train_steps(model, opt, config)[data_type](
        batch, 1.0)["loss"])
    return loss, float(opt.grad_norm), {
        n for n, p in model.named_parameters()
        if p.grad is not None and bool(p.grad.abs().max() > 0)}


@pytest.mark.parametrize("data_type,arch", [
    ("imageseg", {}),
    ("imageopenseg", {"open_seg_loss_type": "clip_focal_loss",
                      "open_seg_loss_down_factor": 2}),
    ("imageopenseg", {"open_seg_loss_type": "fusion_focal_loss",
                      "open_seg_loss_hyper_config": {"alpha": 0.75},
                      "fusion_head": {"type": "mlp", "mlp": {
                          "n_layers": 2, "mid_dim": 16, "out_dim": 1}}}),
], ids=["seg", "openseg_clip_focal", "openseg_fusion"])
def test_seg_steps_match_plain(dev, data_type, arch):
    """One seg or open-seg step through the kernels (K15 with lse, the
    backward pair, K2, K8, the patch embedding) against use_kernels=False
    from the same seeded state on one batch: loss within 1e-2, global
    gradient norm within 5% (chip_smoke.LOSS_RTOL, GRAD_NORM_RTOL), and the
    same parameters given a gradient."""
    config = _seg_config(**arch)
    g = torch.Generator(device=dev).manual_seed(2)
    a = config.arch
    batch = {"image": torch.rand((2, 1, a.temporal_size, a.image_size,
                                  a.image_size), generator=g, device=dev),
             "seg_mask": (torch.rand((2, 3, a.temporal_size, a.image_size,
                                      a.image_size), generator=g, device=dev)
                          > 0.8).to(torch.uint8),
             "prompt_ids": torch.randint(1, 128, (3, 12), generator=g,
                                         device=dev),
             "prompt_mask": torch.ones((3, 12), dtype=torch.long,
                                       device=dev)}
    counters = (fa.attention_online, fa.attention_bwd_dq, geglu_ff.geglu_ff_h,
                geglu_ff.geglu_bwd_dh, patches.patch_embed)
    before = [c.launches for c in counters]
    loss_k, norm_k, got_k = _seg_step(config, data_type, batch, True)
    assert all(c.launches > b for c, b in zip(counters, before))
    loss_p, norm_p, got_p = _seg_step(config, data_type, batch, False)
    assert math.isfinite(loss_k) and math.isfinite(norm_k)
    assert abs(loss_k - loss_p) <= 1e-2 * abs(loss_p)
    assert abs(norm_k - norm_p) <= 0.05 * norm_p
    assert got_p and got_p <= got_k


def test_int8_seg_logits_match_the_plain_int8_engine(dev):
    """The seg serving path at its int8 default (K9/K10, K11, K12/K13, K14,
    the patch embedding; the seg head a bf16 product) against the all-plain
    int8 engine on the same weights: relative L2 within 1e-2, or within 1.5
    × the plain int8 path's own response to a 1e-4 relative perturbation
    of the volume where that is larger (each changed int8 code moves a
    value by a whole step: chip_smoke.SEG_NOISE_FACTOR)."""
    from vit_exp_tpu_torch.models.bert import BertConfig
    from vit_exp_tpu_torch.models.factory import build_ctclip

    config = _seg_config()
    models = [build_ctclip(config, BertConfig.tiny(), device="cuda",
                           use_kernels=k, int8=True, fuse_qkv=True, seed=0)
              for k in (True, False)]
    g = torch.Generator(device=dev).manual_seed(3)
    a = config.arch
    video = torch.rand((2, 1, a.temporal_size, a.image_size, a.image_size),
                       generator=g, device=dev)
    noise = torch.randn(video.shape, generator=g, device=dev)
    before = fa.attention_static_int8.launches
    with torch.inference_mode():
        got, ref = (m.seg_forward(video) for m in models)
        floor = _rel(models[1].seg_forward(video * (1 + 1e-4 * noise)), ref)
    assert fa.attention_static_int8.launches == before + a.transformer_blocks
    assert got.shape == (2, 3, a.temporal_size, a.image_size, a.image_size)
    assert torch.isfinite(got.float()).all()
    assert _rel(got, ref) <= max(1e-2, 1.5 * floor)


# --- real-format ingest, run_zero_shot_cls and serve on the card ---------------

FULL_WIDTH_2_BLOCKS = {"dim": 768, "image_size": 480, "patch_size": 20,
                       "temporal_size": 240, "temporal_patch_size": 10,
                       "transformer_blocks": 2, "dim_head": 32, "heads": 8}


def test_offline_preprocessing_on_the_card_matches_the_cpu(dev):
    """A CT-sized raw volume (int16, 384 × 384 × 200 at 0.7/0.7/1.0)
    resampled to the target spacing on the card and on the CPU: relative L2
    within 1e-5 (fp32 lerps, the card may contract them into FMAs); the
    runtime stage on the card equals its numpy twin."""
    import numpy as np

    from vit_exp_tpu_torch.ops import preprocess as pp

    r = np.random.default_rng(0)
    img = r.integers(-1024, 2000, (384, 384, 200)).astype(np.int16)
    shape = pp.spacing_resample_shape((200, 384, 384), (1.0, 0.7, 0.7))
    got = pp.preprocess_offline_volume(img, slope=1.0, intercept=-1024.0,
                                       new_shape=shape, device=dev)
    ref = pp.preprocess_offline_volume(img, slope=1.0, intercept=-1024.0,
                                       new_shape=shape, device="cpu")
    assert got.device.type == "cuda" and got.shape == ref.shape == shape
    assert _rel(got.cpu(), ref) <= 1e-5
    v = r.uniform(-1.2, 1.2, (200, 500, 470)).astype(np.float32)
    np.testing.assert_array_equal(
        pp.preprocess_runtime_volume(v, device=dev).cpu().numpy(),
        pp.preprocess_runtime_numpy(v))


def _full_width_config(tmp_path):
    import json

    path = tmp_path / "full2.yaml"
    path.write_text(json.dumps({"arch": FULL_WIDTH_2_BLOCKS}))
    return str(path)


def _ctrate_store(tmp_path, n=5):
    """n small npz volumes in CT-RATE's tree, their reports and 18-column
    labels CSVs, packed to float16 by the port's packer."""
    import numpy as np

    from vit_exp_tpu_torch.cli import pack_dataset
    from vit_exp_tpu_torch.eval.zero_shot import PATHOLOGIES

    r = np.random.default_rng(1)
    names = []
    for i in range(n):
        folder = tmp_path / "tree" / f"valid_{i}" / f"valid_{i}a"
        folder.mkdir(parents=True)
        np.savez(folder / f"valid_{i}_a_1.npz",
                 r.uniform(-1, 1, (60 + 10 * i, 120, 100)).astype(np.float32))
        names.append(f"valid_{i}_a_1.nii.gz")
    (tmp_path / "reports.csv").write_text(
        "VolumeName,Findings_EN,Impressions_EN\n"
        + "".join(f"{n},finding,impression\n" for n in names))
    y = (r.random((n, 18)) > 0.5).astype(int)
    (tmp_path / "labels.csv").write_text(
        "VolumeName," + ",".join(PATHOLOGIES) + "\n" + "".join(
            nm + "," + ",".join(map(str, row)) + "\n"
            for nm, row in zip(names, y)))
    pack_dataset.main(["--data_folder", str(tmp_path / "tree"), "--csv_file",
                       str(tmp_path / "reports.csv"), "--out",
                       str(tmp_path / "store")])
    return str(tmp_path / "store"), str(tmp_path / "labels.csv")


def test_run_zero_shot_cls_over_a_packed_store_on_the_card(dev, tmp_path):
    """run_zero_shot_cls at its int8 default on a 2-block full-width arch
    over a float16 store of 5 volumes (batches of 4 and 1): the int8
    attention runs once a block a batch, and the saved probabilities equal
    predict_batch's on the same weights within 1e-4."""
    import numpy as np

    from vit_exp_tpu_torch.cli import run_zero_shot_cls
    from vit_exp_tpu_torch.data.packed import PackedVolumeStore
    from vit_exp_tpu_torch.eval.zero_shot import ZeroShotClassifier
    from vit_exp_tpu_torch.models.factory import bert_config_for, build_ctclip
    from vit_exp_tpu_torch.core.config import load_config
    from vit_exp_tpu_torch.data.tokenizer import load_tokenizer

    store, labels = _ctrate_store(tmp_path)
    cfg = _full_width_config(tmp_path)
    before = fa.attention_static_int8.launches
    res = run_zero_shot_cls.main(
        ["--config", cfg, "--packed_root", store, "--labels_csv", labels,
         "--results_folder", str(tmp_path / "out")], device="cuda")
    assert fa.attention_static_int8.launches == before + 2 * 2
    assert np.isfinite(res["random_init"]["mean_auc"])
    pred = np.load(tmp_path / "out" / "random_init" /
                   "predicted_weights.npz")["data"]
    config, tok = load_config(cfg), load_tokenizer()
    model = build_ctclip(config, bert_config_for(config, tok), device="cuda",
                         fuse_qkv=True, int8=True)
    st = PackedVolumeStore(store)
    vols = st.get_batch(st.keys())
    direct = ZeroShotClassifier(model, tok).predict_batch(vols)
    assert pred.shape == direct.shape == (5, 18)
    np.testing.assert_allclose(pred, direct, atol=1e-4, rtol=0)


def test_one_served_request_matches_predict_batch(dev, tmp_path):
    """The server at its int8 default on the 2-block arch: one
    /classify_path request under --data_root answers predict_batch's
    probabilities on that volume within 1e-4."""
    import json
    import threading
    import urllib.request

    import numpy as np

    from vit_exp_tpu_torch.cli import serve

    cfg = _full_width_config(tmp_path)
    args = serve.parse_args(["--config", cfg, "--data_root", str(tmp_path)])
    engine, latent_fn, shape, channels = serve.build_service(args, "cuda")
    vol = np.random.default_rng(2).uniform(0, 1, (1,) + shape).astype(
        np.float32)
    np.save(tmp_path / "vol.npy", vol)
    srv = serve.build_server(engine, latent_fn, shape, 0,
                             data_root=str(tmp_path))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/classify_path",
            data=json.dumps({"path": str(tmp_path / "vol.npy")}).encode())
        with urllib.request.urlopen(req) as r:
            body = json.loads(r.read())
    finally:
        srv.shutdown()
        srv.server_close()
        srv.batcher.close()
    got = [body["probs"][p] for p in engine.pathologies]
    np.testing.assert_allclose(got, engine.predict_batch(vol[None])[0],
                               atol=1e-4, rtol=0)


# --- the page-locked pool and the side-stream batch copy ------------------------


def test_pooled_loader_and_side_stream_copy_on_the_card(dev):
    """A loader collating into 2 registered slots with 3 workers, each
    batch copied on the side stream while a long product runs on the
    current stream: every device batch equals the plain loader's batch of
    the same indices, byte for byte, the buffers are page-locked, and the
    next batch's slot waits for the copy before it is rewritten."""
    import numpy as np

    from vit_exp_tpu_torch.data.loader import Loader
    from vit_exp_tpu_torch.data.pinned import (BatchCopier, HostBatch,
                                               PinnedPool)

    class Items:
        def __len__(self):
            return 10

        def __getitem__(self, i):
            r = np.random.default_rng(i)
            return {"image": r.standard_normal((1, 16, 256, 256),
                                               dtype=np.float32),
                    "input_ids": np.arange(8, dtype=np.int32) + i}

    kw = dict(shuffle=True, seed=4, num_workers=3, prefetch=2)
    want = list(Loader(Items(), 2, **kw))
    pool = PinnedPool(2, ("image", "input_ids"), register=True)
    loader = Loader(Items(), 2, pool=pool, **kw)
    copier = BatchCopier(dev)
    a = torch.randn(4096, 4096, device=dev)
    got = []
    for batch in loader:
        assert isinstance(batch, HostBatch)
        assert torch.from_numpy(batch["image"]).is_pinned()
        busy = a @ a @ a @ a      # the current stream is busy meanwhile
        got.append(copier.start(batch, ("image", "input_ids")))
        del busy
    out = [g.get() for g in got]
    torch.cuda.synchronize()
    assert len(out) == len(want) == 5
    for o, w in zip(out, want):
        for k in ("image", "input_ids"):
            assert torch.equal(o[k].cpu(), torch.from_numpy(w[k])), k
    loader.close()


def test_four_shard_ring_matches_full_k15_with_nulls(dev):
    """The 4-shard ring at 1,024 tokens (16 K15-with-lse chunks, 16
    backward pairs with the lse cotangent) against full-sequence K15 over
    the concatenated nulls and against the plain ring: the output and the
    gradients of q, k, v and the nulls within relative L2 1e-2 (each
    rank's arithmetic in turn, chip_smoke.ring_by_rank)."""
    from chip_smoke import ring_by_rank

    q, k, v, nk, nv, scale = _attn_case(dev, 1024, 1024, 2, seed=14)
    q, k, nk = q * 3, k * 3, nk * 3
    dout = _randn(torch.Generator(device=dev).manual_seed(15), 2, 3, 1024, 32)

    def run(fn):
        leaves = [t.detach().clone().requires_grad_()
                  for t in (q, k, v, nk, nv)]
        out = fn(*leaves)
        out.backward(dout)
        return [out] + [t.grad for t in leaves]

    before = [c.launches for c in (fa.attention_online, fa.attention_bwd_dkv,
                                   fa.attention_bwd_dq)]
    ring = run(lambda *t: ring_by_rank(*t, 4, scale, True))
    torch.cuda.synchronize()
    after = [c.launches for c in (fa.attention_online, fa.attention_bwd_dkv,
                                  fa.attention_bwd_dq)]
    assert [a - b for a, b in zip(after, before)] == [16, 16, 16]
    full = run(lambda q, k, v, nk, nv: fa.flash_attention_online(
        q, k, v, scale=scale, null_k=nk, null_v=nv))
    plain = run(lambda *t: ring_by_rank(*t, 4, scale, False))
    for ref in (full, plain):
        for a, b in zip(ring, ref):
            assert torch.isfinite(a.float()).all()
            assert _rel(a, b) < 1e-2


# the tensor-parallel slices' widths at full width (D 768, 8 heads, I
# 2,048): 2I 2,048 and 4 heads a rank at model 2, 2I 1,024 and 2 heads at
# model 4
@pytest.mark.parametrize("i2", [2048, 1024])
def test_k2_and_k8_at_tensor_parallel_widths(dev, i2):
    args = _k2_case(dev, 4113, 768, i2, seed=16)
    _close(geglu_ff.geglu_ff(*args), geglu_ff.geglu_ff_plain(*args))
    g = torch.Generator(device=dev).manual_seed(17)
    x = args[0]
    mu, inv = args[1], args[2]
    gamma = 1 + 0.1 * torch.randn(768, generator=g, device=dev)
    beta = 0.1 * torch.randn(768, generator=g, device=dev)
    w1 = torch.randn(768, i2, generator=g, device=dev) * 768 ** -0.5
    w2 = torch.randn(i2 // 2, 768, generator=g, device=dev) * (i2 // 2) ** -0.5
    dout = _randn(g, 4113, 768)
    ff = (x, mu, inv, gamma, beta, w1, w2, dout)
    for a, r in zip(geglu_ff.geglu_ff_bwd(*ff), geglu_ff.geglu_ff_bwd_plain(*ff)):
        assert a.shape == r.shape and torch.isfinite(a).all()
        assert _rel(a, r) < 1e-2


@pytest.mark.parametrize("heads", [4, 2])
def test_k15_and_the_pair_at_tensor_parallel_heads(dev, heads):
    """K15 with lse and the backward pair over 2 nulls concatenated to 300
    keys, at a rank's head count."""
    g = torch.Generator(device=dev).manual_seed(18)
    n = 300

    def unit(*shape):
        t = torch.randn(*shape, generator=g, device=dev)
        return (t / t.norm(dim=-1, keepdim=True) * 3).to(torch.bfloat16)

    q = unit(2, heads, n, 32)
    k = unit(2, heads, n + 2, 32)
    v = _randn(g, 2, heads, n + 2, 32)
    dout = _randn(g, 2, heads, n, 32, std=1e-2)
    scale = 32 ** -0.5
    out, lse = fa.attention_online(q, k, v, scale, save_lse=True)
    ref, lse_p = fa.attention_online_plain(q, k, v, scale, save_lse=True)
    _close(out, ref)
    assert _rel(lse, lse_p) < 1e-5
    delta = (dout.float() * ref.float()).sum(-1)
    bwd = (q, k, v, dout, lse_p, delta, scale)
    got = (fa.attention_bwd_dq(*bwd), *fa.attention_bwd_dkv(*bwd))
    for a, r in zip(got, fa.attention_bwd_plain(*bwd)):
        assert torch.isfinite(a.float()).all() and _rel(a, r) < 1e-2


@pytest.mark.parametrize("parts", [2, 4])
def test_tensor_parallel_block_matches_the_whole_block(dev, parts):
    """One tower block (D 768, 8 heads × 32) on 512 tokens as ``parts``
    ranks' slices on the kernels (chip_smoke.tp_by_rank: each rank's K15,
    pair, K2 and K8 once) against the whole block on the kernels: output,
    dx and every parameter gradient within chip_smoke.TP_REL_TOL."""
    from chip_smoke import TP_REL_TOL, tp_by_rank, tp_slices
    from vit_exp_tpu_torch.models.ctvit3d import TransformerBlock
    from vit_exp_tpu_torch.models.factory import init_parameters_

    block = TransformerBlock(768, 8, 32, None, attn_impl="pallas",
                             device=dev)
    init_parameters_(block, 19)
    g = torch.Generator(device=dev).manual_seed(20)
    x = _randn(g, 1, 512, 768)
    dout = _randn(g, 1, 512, 768, std=1e-2)
    xx = x.clone().requires_grad_()
    out = block(xx)
    out.backward(dout)
    slices, specs = tp_slices(block, parts)
    before = fa.attention_online.launches
    got = tp_by_rank(slices, specs, x, dout)
    assert fa.attention_online.launches - before == parts
    assert _rel(got[0], out) < TP_REL_TOL and _rel(got[1], xx.grad) < TP_REL_TOL
    for name, p in block.named_parameters():
        assert got[2][name].shape == p.grad.shape, name
        assert _rel(got[2][name], p.grad) < TP_REL_TOL, name


def test_full_width_ctvit_takes_no_kernel_and_trains_a_step(dev, tmp_path):
    """The legacy CTViT at GenerateCT's width (dim 512, codebook 8,192,
    image 128, patch 16, temporal patch 2, depth 4 + 4, 8 heads × 32):
    every attention and feed-forward on the plain route, so no kernel
    refuses its widths (the GEGLU's 2I is 2,730), and one CTViTTrainer
    step (the VGG perceptual term and the discriminator on, 17 frames)
    launches no kernel and gives finite losses."""
    from vit_exp_tpu_torch.models.ctvit import CTViT
    from vit_exp_tpu_torch.models.ctvit3d import CosineSelfAttention
    from vit_exp_tpu_torch.models.factory import init_parameters_
    from vit_exp_tpu_torch.models.layers import GEGLUFeedForward
    from vit_exp_tpu_torch.train.ctvit_trainer import CTViTTrainer

    model = CTViT(dim=512, codebook_size=8192, image_size=128, patch_size=16,
                  temporal_patch_size=2, device=dev)
    init_parameters_(model, 0)
    attn = [m for m in model.modules() if isinstance(m, CosineSelfAttention)]
    ff = [m for m in model.modules() if isinstance(m, GEGLUFeedForward)]
    assert len(attn) == len(ff) == 16
    assert all(m.xla and not m.use_kernels for m in attn)
    assert not any(m.use_kernel for m in ff)
    counters = [fa.attention_static, fa.attention_online,
                fa.attention_static_int8, fa.attention_bwd_dq,
                fa.attention_bwd_dkv, geglu_ff.geglu_ff_h,
                geglu_ff.geglu_bwd_dh, fused_proj.ln_qkv, patches.patch_embed]
    for c in counters:
        c.launches = 0
    trainer = CTViTTrainer(model, results_folder=str(tmp_path),
                           sample_every=0, gen_steps_per_discr=1)
    g = torch.Generator(device=dev).manual_seed(0)
    video = torch.rand(1, 1, 17, 128, 128, generator=g, device=dev) * 2 - 1
    logs = trainer.train_step(video)
    assert set(logs) >= {"recon_loss", "perceptual_loss", "adaptive_weight",
                         "gen_loss", "discr_loss"}
    assert all(math.isfinite(v) for v in logs.values())
    assert all(c.launches == 0 for c in counters)
