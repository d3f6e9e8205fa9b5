"""CPU checks of the staged GEGLU forwards, K2 (bf16) and K11 (W8A8).

- K2's stage twins (``geglu_ff_x_plain``, ``geglu_ff_h_plain``,
  ``geglu_ff_o_plain``), composed, give ``geglu_ff_plain``'s bits, the
  one-pass twin that stays the oracle, in fp32 and in bf16; so does
  ``geglu_ff``, which on CPU tensors runs the twins.
- K11's four stage twins (y8, act with its partial amaxes, a8, out),
  composed, give ``geglu_ff_int8_plain``'s bits, and the codes and scales
  of y8 and a8 are those of one quantization of the whole row.  One case
  puts every token's largest act in the last column tile, so the partial
  amaxes must be reduced over every tile.
- Both composed chains hold to the JAX package in interpret mode: K2 to
  ``_ff_fwd_impl`` within 1e-4 absolute (fp32 on both sides, sums in
  another order; tests/test_torch_ops.py's tolerance), K11 to
  ``fused_geglu_ff_int8`` within relative L2 1e-3 (the JAX kernel's erf is
  a polynomial good to 1.5e-7, which can move a code by one;
  tests/test_torch_int8.py's tolerance).
- Shapes: a few hundred tokens (multiples of no tile), D 64 and 384 (the
  mid arch's width), inner widths whose last 64-column tile is partial.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_exp_tpu.ops import geglu_ff as jff
from vit_exp_tpu_torch.ops import geglu_ff as tff

# (tokens, D, inner)
SHAPES = [(300, 64, 96), (129, 384, 160), (50, 384, 1024)]


def _rel(a, b):
    a = np.asarray(a.detach().float() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _inputs(seed, m, d, inner):
    r = np.random.default_rng(seed)
    x = (r.standard_normal((m, d)) * 2 + 0.3).astype(np.float32)
    gamma = (1 + 0.1 * r.standard_normal(d)).astype(np.float32)
    beta = (0.1 * r.standard_normal(d)).astype(np.float32)
    w1 = (r.standard_normal((d, 2 * inner)) / np.sqrt(d)).astype(np.float32)
    w2 = (r.standard_normal((inner, d)) / np.sqrt(inner)).astype(np.float32)
    return x, gamma, beta, w1, w2


def _k2_args(inputs, dtype):
    """K2's operands as GEGLUFeedForwardFn makes them: x, μ, inv, W1' =
    γ⊙W1 and W2 in dtype, d1 = β@W1 in fp32."""
    x, gamma, beta, w1, w2 = map(torch.from_numpy, inputs)
    x2 = x.to(dtype)
    mu, inv = tff.ln_stats(x2, 1e-5)
    w1p = (w1 * gamma[:, None]).to(dtype)
    return x2, mu, inv, w1p, beta @ w1, w2.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("m,d,inner", SHAPES)
def test_k2_stage_twins_compose_to_the_one_pass_twin(m, d, inner, dtype):
    x2, mu, inv, w1p, d1, w2 = _k2_args(_inputs(m + d, m, d, inner), dtype)
    xn = tff.geglu_ff_x_plain(x2, mu, inv)
    act = tff.geglu_ff_h_plain(xn, w1p, d1)
    out = tff.geglu_ff_o_plain(act, w2)
    assert xn.dtype == act.dtype == out.dtype == dtype
    assert act.shape == (m, inner) and out.shape == (m, d)
    oracle = tff.geglu_ff_plain(x2, mu, inv, w1p, d1, w2)
    assert torch.equal(out, oracle)
    assert torch.equal(tff.geglu_ff(x2, mu, inv, w1p, d1, w2), oracle)


@pytest.mark.parametrize("m,d,inner", SHAPES)
def test_k2_staged_chain_matches_jax(m, d, inner):
    inputs = _inputs(m + d + 1, m, d, inner)
    x, gamma, beta, w1, w2 = map(jnp.asarray, inputs)
    mu, inv = jff._ln_stats(x, 1e-5)
    ref = jff._ff_fwd_impl(x, mu, inv, gamma, beta, w1, w2, 128, True)
    out = tff.geglu_ff(*_k2_args(inputs, torch.float32))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def _k11_args(inputs, dtype):
    """K11's operands as fused_geglu_ff_int8 makes them."""
    x, gamma, beta, w1, w2 = map(torch.from_numpy, inputs)
    x2 = x.to(dtype)
    mu, inv = tff.ln_stats(x2, 1e-5)
    w1q, s1 = tff.quantize_per_channel(w1)
    w2q, s2 = tff.quantize_per_channel(w2)
    return x2, mu, inv, gamma, beta, w1q, s1, w2q, s2


def _k11_stages(x2, mu, inv, gamma, beta, w1q, s1, w2q, s2):
    """The four twins, composed as geglu_ff_int8 composes the kernels."""
    y8, sy = tff.geglu_ff_int8_y_plain(x2, mu, inv, gamma, beta)
    act, part = tff.geglu_ff_int8_h_plain(y8, sy, w1q.t().contiguous(), s1)
    a8, sa = tff.geglu_ff_int8_q_plain(act, part)
    out = tff.geglu_ff_int8_o_plain(a8, sa, w2q.t().contiguous(), s2,
                                    x2.dtype)
    return (y8, sy), (act, part), (a8, sa), out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("m,d,inner", SHAPES)
def test_k11_stage_twins_compose_to_the_one_pass_twin(m, d, inner, dtype):
    args = _k11_args(_inputs(m + d + 2, m, d, inner), dtype)
    x2, mu, inv, gamma, beta = args[:5]
    (y8, sy), (act, part), (a8, sa), out = _k11_stages(*args)
    # the codes and scales of one quantization of each whole row
    y = (x2.float() - mu) * inv * gamma + beta
    assert all(torch.equal(a, b) for a, b in zip((y8, sy),
                                                  tff.quant_rows(y)))
    assert all(torch.equal(a, b) for a, b in zip((a8, sa),
                                                  tff.quant_rows(act)))
    assert part.shape == (m, -(-inner // tff.AMAX_TILE))
    assert torch.equal(part.amax(dim=-1), act.abs().amax(dim=-1))
    assert out.dtype == dtype and out.shape == (m, d)
    oracle = tff.geglu_ff_int8_plain(*args)
    assert torch.equal(out, oracle)
    assert torch.equal(tff.geglu_ff_int8(*args), oracle)


def test_k11_amax_reduction_spans_every_column_tile():
    """Every token's largest |act| lies in the last (partial) 64-column
    tile: the scale of a8 is right only if the reduction reaches it."""
    m, d, inner = 200, 64, 160
    x, gamma, beta, w1, w2 = _inputs(7, m, d, inner)
    last = slice(2 * tff.AMAX_TILE, inner)
    w1[:, last] *= 8.0                               # val columns
    w1[:, inner + last.start:] *= 8.0                # gate columns
    args = _k11_args((x, gamma, beta, w1, w2), torch.float32)
    _, (act, part), (a8, sa), out = _k11_stages(*args)
    assert part.shape == (m, 3)
    assert bool((act.abs().argmax(dim=-1) >= last.start).all())
    assert torch.equal(part.argmax(dim=-1), torch.full((m,), 2))
    assert torch.equal(sa, tff.quant_rows(act)[1])
    assert not torch.equal(tff.geglu_ff_int8_q_plain(act, part[:, :2])[1], sa)
    assert torch.equal(out, tff.geglu_ff_int8_plain(*args))


@pytest.mark.parametrize("m,d,inner", SHAPES)
def test_k11_staged_chain_matches_jax(m, d, inner):
    inputs = _inputs(m + d + 3, m, d, inner)
    ref = jff.fused_geglu_ff_int8(*map(jnp.asarray, inputs), interpret=True)
    out = tff.fused_geglu_ff_int8(*map(torch.from_numpy, inputs))
    assert out.shape == (m, d)
    assert _rel(out, ref) < 1e-3


def test_k2_k11_operand_checks_take_the_64_grid_only():
    """The card's operand checks (run before any launch) take D and 2I on
    the multiples of 16 (FF_WIDTH_STEP), D 48, 384 and 768 among them, and
    refuse the rest."""
    bf = torch.bfloat16
    assert tff.FF_WIDTH_STEP == 16
    for d, inner in ((384, 1024), (768, 2048), (64, 32), (48, 128),
                     (96, 64), (16, 8)):
        x2, mu, inv, w1p, d1, w2 = _k2_args(_inputs(1, 16, d, inner), bf)
        tff._check_k2(x2, mu, inv, w1p, d1, w2)
        tff._check_k11(*_k11_args(_inputs(1, 16, d, inner), bf))
    for d, inner in ((40, 64), (64, 36), (24, 128), (8, 8)):
        with pytest.raises(ValueError):
            tff._check_k2(*_k2_args(_inputs(1, 16, d, inner), bf))
        with pytest.raises(ValueError):
            tff._check_k11(*_k11_args(_inputs(1, 16, d, inner), bf))
