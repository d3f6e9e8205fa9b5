"""Card tests of the port's CUDA kernels (K1, K2's three stages, K3, K4,
K15, the attention backward pair, K8, and the int8 serving kernels: the int8
attention (K9/K10), K11's four stages, K12/K13 and K14) against their plain
PyTorch versions at small, ragged shapes (K2 and K11 also at 4,113 tokens
and the widths D 384 and 768).

They need an NVIDIA GPU and nvcc and skip without them.  This file imports
no JAX, so on the card it runs without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: the kernels round to bf16 where the plain versions do, but sum
in another order, so outputs differ by bf16 rounding of the last place:
relative L2 error ≤ 1e-2 on bf16 outputs and on gradients (bf16 operands
of fp32 sums on both sides), and on the forwards' outputs also max abs
error ≤ two bf16 ulps of the largest element; 1e-5 on the fp32 statistics
of K4 and on K1's and K15's lse (fp32 sums of the same p, up to order and
ex2.approx's last bits).  The int8 kernels
quantize with the plain twins' arithmetic and sum exact integers, so their
bf16 outputs are held to the same 1e-2.
"""

import math

import pytest
import torch

from vit_exp_tpu_torch.ops import fused_proj, geglu_ff, patches
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
    # K2 and K11 take D and 2I on the multiples of 64 only, and check every
    # operand before the first launch
    for d, i2 in ((96, 256), (128, 96)):
        k2 = _k2_case(dev, 50, d, i2)
        k11 = _k11_case(dev, 50, d, i2)
        before = [f.launches for f in K2_STAGES + K11_STAGES]
        with pytest.raises(ValueError):
            geglu_ff.geglu_ff(*k2)
        with pytest.raises(ValueError):
            geglu_ff.geglu_ff_int8(*k11)
        assert [f.launches for f in K2_STAGES + K11_STAGES] == before


def _attn_case(dev, nq, nkv, n_null, seed=4):
    g = torch.Generator(device=dev).manual_seed(seed)
    b, h, d = 2, 3, 32
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
# inner columns per dh tile and 128 × 128 weight tiles (inner 256 and 2048)
@pytest.mark.parametrize("inner", [256, 2048])
@pytest.mark.parametrize("m", [50, 96, 129, 300, 4113])
def test_k8_matches_plain(dev, m, inner):
    g = torch.Generator(device=dev).manual_seed(6)
    d = 768
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


@pytest.mark.parametrize("m", [129, 4113])
def test_k8_stages_match_their_twins(dev, m):
    """Each K8 stage against its plain twin on the kernel chain's inputs."""
    g = torch.Generator(device=dev).manual_seed(16)
    d, inner = 768, 512
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


def _int8_attn_case(dev, nq, nkv, n_null, seed=8):
    """The int8 attention's inputs as the model makes them: l2-normalised,
    scaled q/k (strided views of packed projections) through the int8
    prologue, v in place, fp32 null k and bf16 null v."""
    g = torch.Generator(device=dev).manual_seed(seed)
    b, h, d = 2, 3, 32
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


@pytest.mark.parametrize("m", [100, 128])
def test_k12_k13_matches_plain(dev, m):
    g = torch.Generator(device=dev).manual_seed(10)
    d, f = 96, 128
    x = _randn(g, m, d) * 2 + 0.5
    mu, inv = geglu_ff.ln_stats(x, 1e-5)
    w8, sc, c = fused_proj.int8_qkv_weights(
        torch.rand(d, device=dev) + 0.5,
        torch.randn(d, f, generator=g, device=dev),
        torch.randn(d, 2 * f, generator=g, device=dev))
    args = (x, mu, inv, w8, sc, c, f, f)
    before = fused_proj.ln_qkv_int8.launches
    out = fused_proj.ln_qkv_int8(*args)
    ref = fused_proj.ln_qkv_int8_plain(*args)
    torch.cuda.synchronize()
    assert fused_proj.ln_qkv_int8.launches == before + 1
    for a, r in zip(out, ref):
        assert a.shape == r.shape == (m, f) and _rel(a, r) < 1e-2


@pytest.mark.parametrize("m", [100, 128])
def test_k14_matches_plain(dev, m):
    g = torch.Generator(device=dev).manual_seed(11)
    x = _randn(g, m, 256)
    w8, sc = geglu_ff.quantize_per_channel(
        torch.randn(256, 384, generator=g, device=dev))
    before = fused_proj.proj_int8.launches
    out = fused_proj.proj_int8(x, w8, sc)
    ref = fused_proj.proj_int8_plain(x, w8, sc)
    torch.cuda.synchronize()
    assert fused_proj.proj_int8.launches == before + 1
    assert out.shape == (m, 384) and _rel(out, ref) < 1e-2


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
