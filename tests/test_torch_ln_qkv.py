"""CPU checks of the staged W8A8 LN + q/k/v projection, K12/K13.

- K12/K13's two stage twins (``ln_qkv_int8_x_plain``, the row pass, and
  ``ln_qkv_int8_mm_plain``, the product with the dequantization), composed,
  give ``ln_qkv_int8_plain``'s bits, the one-pass twin that stays the
  oracle, in fp32 and in bf16; so does ``ln_qkv_int8``, which on CPU tensors
  runs the twins.  Token counts fill no 128-token tile, and fq and fk lie
  off the multiples of 128 (one pair odd, so a column pair straddles the
  q/k and k/v boundaries).
- The chain holds to the JAX package in interpret mode: to
  ``fused_ln_qkv3_int8`` and ``fused_ln_qkv_int8`` within 1e-5 absolute on
  outputs of order one (tests/test_torch_int8.py's tolerance: both sides
  quantize the same fp32 values and multiply exact integers, and differ in
  the last bit of the dequantizing products at most).
- The row pass's codes and scales equal JAX's canonical quantization
  (``geglu_ff._quant_rows``) of x − μ bit for bit, half-way ties included.
- The product kernel's store routes (``k13_store_routes``: a column tile by
  TMA stores or from the registers) at the widths the card tests and the
  configs use, and its tile width is the kernel's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_exp_tpu.ops import fused_proj as jproj
from vit_exp_tpu.ops import geglu_ff as jff
from vit_exp_tpu_torch.ops import fused_proj as tproj
from vit_exp_tpu_torch.ops import geglu_ff as tff

DTYPES = [torch.float32, torch.bfloat16]


def _inputs(seed, m, d, fq, fkv):
    r = np.random.default_rng(seed)
    x = (r.standard_normal((m, d)) * 2 + 0.5).astype(np.float32)
    gamma = (1 + 0.1 * r.standard_normal(d)).astype(np.float32)
    wq = (r.standard_normal((d, fq)) / np.sqrt(d)).astype(np.float32)
    wkv = (r.standard_normal((d, fkv)) / np.sqrt(d)).astype(np.float32)
    return x, gamma, wq, wkv


def _k13_args(inputs, dtype):
    """K12/K13's operands as fused_ln_qkv_int8 makes them."""
    x, gamma, wq, wkv = map(torch.from_numpy, inputs)
    x2 = x.to(dtype)
    mu, inv = tff.ln_stats(x2, 1e-5)
    w8, sc, c = tproj.int8_qkv_weights(gamma, wq, wkv)
    return x2, mu, inv, w8, sc, c


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("fq,fk,fv", [(96, 144, 144), (37, 91, 128)])
@pytest.mark.parametrize("m", [100, 300])
def test_k13_stage_twins_compose_to_the_one_pass_twin(m, fq, fk, fv, dtype):
    x2, mu, inv, w8, sc, c = _k13_args(
        _inputs(m + fq, m, 64, fq, fk + fv), dtype)
    x8, sx = tproj.ln_qkv_int8_x_plain(x2, mu)
    chain = tproj.ln_qkv_int8_mm_plain(x8, sx, mu, inv, w8.t().contiguous(),
                                       sc, c, fq, fk, dtype)
    ref = tproj.ln_qkv_int8_plain(x2, mu, inv, w8, sc, c, fq, fk)
    routed = tproj.ln_qkv_int8(x2, mu, inv, w8, sc, c, fq, fk)
    for width, a, b, r in zip((fq, fk, fv), chain, routed, ref):
        assert a.shape == r.shape == (m, width) and a.dtype == r.dtype == dtype
        assert torch.equal(a, r) and torch.equal(b, r)


@pytest.mark.parametrize("form", ["two_outputs", "three_outputs"])
@pytest.mark.parametrize("m", [100, 300])
def test_k13_chain_matches_pallas(m, form):
    fq = 128
    x, gamma, wq, wkv = _inputs(40 + m, m, 64, fq, 2 * fq)
    args = tuple(map(jnp.asarray, (x, gamma, wq, wkv)))
    if form == "two_outputs":
        q_j, kv_j = jproj.fused_ln_qkv_int8(*args, interpret=True)
        ref = (q_j, kv_j[:, :fq], kv_j[:, fq:])
    else:
        ref = jproj.fused_ln_qkv3_int8(*args, interpret=True)
    x2, mu, inv, w8, sc, c = _k13_args((x, gamma, wq, wkv), torch.float32)
    x8, sx = tproj.ln_qkv_int8_x(x2, mu)
    out = tproj.ln_qkv_int8_mm(x8, sx, mu, inv, w8.t().contiguous(), sc, c,
                               fq, fq, torch.float32)
    for a, b in zip(out, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("m", [100, 300])
def test_k13_row_pass_is_jax_quantization_of_the_centred_row(m, dtype):
    x = torch.from_numpy(_inputs(60 + m, m, 64, 8, 8)[0]).to(dtype)
    mu, _ = tff.ln_stats(x, 1e-5)
    x8, sx = tproj.ln_qkv_int8_x(x, mu)
    q_j, s_j = jff._quant_rows(jnp.asarray(x.float().numpy())
                               - jnp.asarray(mu.numpy()))
    assert x8.dtype == torch.int8 and x8.shape == (m, 64)
    assert sx.dtype == torch.float32 and sx.shape == (m, 1)
    np.testing.assert_array_equal(x8.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(s_j))


def test_k13_row_pass_rounds_ties_half_to_even():
    """Rows whose centred amax is 127 have scale 1, so their half-way values
    are ties: the codes round them to even, as JAX's quantizer does."""
    ties = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5, -126.5, 126.5]
    mu = torch.tensor([[0.0], [10.0]])
    x = torch.tensor([ties, [t + 10.0 for t in ties]])
    x8, sx = tproj.ln_qkv_int8_x(x, mu)
    q_j, s_j = jff._quant_rows(jnp.asarray(x.numpy()) - jnp.asarray(mu.numpy()))
    assert x8[0].tolist() == [127, 2, -4, 0, 0, 2, -126, 126]
    assert torch.equal(x8[1], x8[0]) and sx.flatten().tolist() == [1.0, 1.0]
    np.testing.assert_array_equal(x8.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(s_j))


@pytest.mark.parametrize("f,fq,fk,routes", [
    (768, 256, 256, ["tma"] * 6),          # the full width
    (96, 32, 32, ["registers"]),           # the tiny configs: chunk 0
                                           # holds q and k
    (768, 64, 352, ["tma"] * 3 + ["registers"] + ["tma"] * 2),  # 416 in
                                           # the chunk at 384
    (384, 128, 128, ["tma"] * 3),
    (384, 68, 158, ["registers"] * 3),     # rows of 136 and 316 bytes
    (768, 100, 300, ["registers"] * 4 + ["tma"] * 2),  # q, k rows of
                                           # 200, 600 bytes; v (736) from
                                           # 512 on
])
def test_k13_store_routes(f, fq, fk, routes):
    assert tproj.k13_store_routes(f, fq, fk) == routes


def test_k13_store_routes_follow_the_kernels_tiles():
    """The routes' tile and chunk are the kernel's (csrc MM_COLS, 64-column
    staging chunks)."""
    import re
    from pathlib import Path

    src = (Path(tproj.__file__).resolve().parent.parent / "csrc"
           / "ln_qkv_int8.cu").read_text()
    cols = re.search(r"constexpr int MM_COLS = (\d+),", src)
    assert cols and int(cols.group(1)) == tproj.K13_TILE_COLS
    assert "for (int ch = 0; ch < MM_COLS / 64; ++ch)" in src
    assert tproj.K13_STORE_CHUNK == 64
