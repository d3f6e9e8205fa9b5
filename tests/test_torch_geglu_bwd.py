"""CPU checks of K8's staging and of the int8 attention's accumulator bias.

- The plain twins of K8's stages (y, dh/act, dy, dx with the dγ/dβ
  partials, the weight GEMM's split-K partials, the ordered sums), composed
  (``geglu_ff_bwd_plain``), against the one-pass plain twin the port had
  before K8 was staged and against JAX's ``_ff_bwd_impl`` run with
  ``interpret=True``, all in fp32,
  with token counts that are multiples of no tile (128-token dh/dy tiles,
  64-row dx blocks, 64-token weight-GEMM steps).  Relative L2 ≤ 1e-5:
  fp32 on every side, the sums blocked in another order (measured ≤ 4.3e-7).
- The weight GEMM's split plan covers [0, M) once, in order, in segments
  that start at multiples of the token step, at the production shapes and
  at the edges; that step is the kernel's k step (csrc), so no TMA box
  of a segment reaches into the next one.
- The int8 attention's logits: every S in [−516,128, 516,128] (32 ·
  127²) converts to fp32 exactly, as the kernel converts it; and the
  alternative it was measured against, an s32 accumulator started at
  0x4B400000 whose bits read as a float, minus 12,582,912, give S.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_exp_tpu.ops import geglu_ff as jff
from vit_exp_tpu_torch.ops import geglu_ff as tff

TOL = 1e-5


def _rel(a, b):
    a = np.asarray(a.detach() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _inputs(seed, m, d=48, inner=40):
    r = np.random.default_rng(seed)
    x = (r.standard_normal((m, d)) * 2 + 0.3).astype(np.float32)
    mu = x.mean(-1, keepdims=True)
    inv = 1 / np.sqrt(((x - mu) ** 2).mean(-1, keepdims=True) + 1e-5)
    gamma = (1 + 0.1 * r.standard_normal(d)).astype(np.float32)
    beta = (0.1 * r.standard_normal(d)).astype(np.float32)
    w1 = (r.standard_normal((d, 2 * inner)) / np.sqrt(d)).astype(np.float32)
    w2 = (r.standard_normal((inner, d)) / np.sqrt(inner)).astype(np.float32)
    dout = r.standard_normal((m, d)).astype(np.float32)
    return x, mu.astype(np.float32), inv.astype(np.float32), gamma, beta, \
        w1, w2, dout


def _monolithic_plain(x2, mu, inv, gamma, beta, w1, w2, dout):
    """K8's plain twin as the port had it before K8 was staged (one token
    pass, then the weight products): dx, dW1, dW2, dγ, dβ in fp32 here."""
    inner = w1.shape[1] // 2
    xn = (x2 - mu) * inv
    y = xn * gamma + beta
    h = y @ w1
    val, gate = h[:, :inner], h[:, inner:]
    cdf = 0.5 * (1.0 + torch.erf(gate * (2.0 ** -0.5)))
    gelu = gate * cdf
    dact = dout @ w2.t()
    pdf = torch.exp(-0.5 * gate * gate) * tff.INV_SQRT_2PI
    dh = torch.cat([dact * gelu, dact * val * (cdf + gate * pdf)], dim=1)
    act = gelu * val
    dy = dh @ w1.t()
    dxn = dy * gamma
    m1 = dxn.mean(dim=-1, keepdim=True)
    m2 = (dxn * xn).mean(dim=-1, keepdim=True)
    dx = inv * (dxn - m1 - xn * m2)
    return (dx, y.t() @ dh, act.t() @ dout, (dy * xn).sum(dim=0),
            dy.sum(dim=0))


@pytest.mark.parametrize("m", [50, 129, 300])
def test_k8_stage_twins_compose_to_the_plain_twin_and_jax(m):
    args = _inputs(40 + m, m)
    t_args = [torch.from_numpy(a.copy()) for a in args]
    staged = tff.geglu_ff_bwd_plain(*t_args)
    plain = _monolithic_plain(*t_args)
    ref = jff._ff_bwd_impl(*map(jnp.asarray, args), 64, True)
    for name, s, p, j in zip(("dx", "dW1", "dW2", "dgamma", "dbeta"), staged,
                             plain, ref):
        assert s.shape == p.shape == j.shape, name
        assert _rel(s, p) < TOL, name
        assert _rel(s, j) < TOL, name


@pytest.mark.parametrize("m", [50, 129])
def test_k8_stage_wrappers_run_their_twins_on_cpu_without_counting(m):
    """geglu_ff_bwd on CPU tensors runs the stage twins (it equals
    geglu_ff_bwd_plain bit for bit), and no stage's launch counter
    moves."""
    counters = (tff.geglu_bwd_y, tff.geglu_bwd_dh, tff.geglu_bwd_dy,
                tff.geglu_bwd_dx, tff.wgrad_partials, tff.sum_rows)
    before = [f.launches for f in counters]
    t_args = [torch.from_numpy(a) for a in _inputs(60 + m, m)]
    got = tff.geglu_ff_bwd(*t_args)
    for a, b in zip(got, tff.geglu_ff_bwd_plain(*t_args)):
        assert torch.equal(a, b)
    assert [f.launches for f in counters] == before == [0] * 6


def test_k8_dx_partials_are_blocks_of_rows():
    """The dγ/dβ partials hold one row per block of DX_ROWS rows (the last
    block short), and sum to the column sums."""
    m, d = 2 * tff.DX_ROWS + 5, 16
    r = np.random.default_rng(7)
    x = torch.from_numpy(r.standard_normal((m, d)).astype(np.float32))
    mu, inv = tff.ln_stats(x, 1e-5)
    dy = torch.from_numpy(r.standard_normal((m, d)).astype(np.float32))
    _, dgp, dbp = tff.geglu_bwd_dx_plain(x, mu, inv, torch.ones(d), dy)
    assert dgp.shape == dbp.shape == (3, d)
    torch.testing.assert_close(dbp[2], dy[2 * tff.DX_ROWS:].sum(0))
    torch.testing.assert_close(dgp.sum(0), (dy * (x - mu) * inv).sum(0),
                               rtol=1e-5, atol=1e-5)


# production: 55,296 tokens against dW1 (768 × 4096) and dW2 (2048 × 768);
# edges: one token, a step short, one step, a step and one more, the card
# tests' token counts
@pytest.mark.parametrize("m,p,q", [
    (55296, 768, 4096), (55296, 2048, 768), (1, 768, 4096), (31, 128, 128),
    (32, 768, 512), (33, 256, 768), (50, 768, 512), (129, 768, 4096),
    (300, 2048, 768), (4113, 768, 4096), (4113, 256, 768), (13824, 8, 8)])
def test_wgrad_plan_covers_the_tokens_once_in_order(m, p, q):
    splits, seg = tff.wgrad_plan(m, p, q)
    assert splits >= 1 and seg % tff.WGRAD_STEP == 0
    bounds = [(s * seg, min(m, (s + 1) * seg)) for s in range(splits)]
    assert bounds[0][0] == 0 and bounds[-1][1] == m
    assert all(a < b for a, b in bounds)          # every segment holds a token
    assert all(b == a2 for (_, b), (a2, _) in zip(bounds, bounds[1:]))
    tiles = -(-p // tff.WGRAD_TILE) * -(-q // tff.WGRAD_TILE)
    # at most about WGRAD_BLOCKS blocks, and no more segments than steps
    assert splits <= max(1, -(-tff.WGRAD_BLOCKS // tiles))
    assert splits <= -(-m // tff.WGRAD_STEP)


def test_wgrad_segments_are_whole_k_steps_of_the_kernel():
    """The plan's token step is the weight GEMM's k step in csrc: the
    kernel loads a segment in boxes of STEP_K tokens and refuses a segment
    that is not a multiple of SEG_STEP, so the two must agree."""
    import re
    from pathlib import Path

    csrc = Path(tff.__file__).resolve().parent.parent / "csrc"
    step_k = re.search(r"constexpr int STEP_K = (\d+);",
                       (csrc / "gemm_wgmma.cuh").read_text())
    assert step_k and int(step_k.group(1)) == tff.WGRAD_STEP
    assert "constexpr int SEG_STEP = STEP_K;" in (
        csrc / "geglu_ff_bwd.cu").read_text()
    for m in (1, 63, 64, 65, 4113, 55296):
        splits, seg = tff.wgrad_plan(m, 768, 4096)
        starts = [s * seg for s in range(splits)]
        assert all(t % tff.WGRAD_STEP == 0 for t in starts)


def test_wgrad_partials_sum_to_the_product():
    r = np.random.default_rng(8)
    a = torch.from_numpy(r.standard_normal((300, 24)).astype(np.float32))
    b = torch.from_numpy(r.standard_normal((300, 16)).astype(np.float32))
    splits, seg = tff.wgrad_plan(300, 24, 16)
    part = tff.wgrad_partials_plain(a, b, splits, seg)
    assert part.shape == (splits, 24, 16) and splits > 1
    torch.testing.assert_close(tff.sum_rows_plain(part), a.t() @ b,
                               rtol=1e-5, atol=1e-4)


def test_int8_logits_convert_exactly():
    s = np.arange(-516128, 516129, dtype=np.int64)
    assert np.array_equal(s.astype(np.float32).astype(np.int64), s)
    bits = (np.int64(0x4B400000) + s).astype(np.int32)
    as_float = bits.view(np.float32)
    recovered = as_float - np.float32(12582912.0)
    assert recovered.dtype == np.float32
    assert np.array_equal(recovered.astype(np.int64), s)
    assert np.float32(12582912.0).view(np.int32) == 0x4B400000
