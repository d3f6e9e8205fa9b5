"""CPU parity of the PyTorch port's int8 (W8A8) serving path against the JAX
package's (attn_impl="pallas_static_int8", ff_impl="pallas_int8").

The same inputs, made with numpy from a seed, go through the JAX function
(Pallas in interpret mode) and its counterpart in ``vit_exp_tpu_torch``,
whose kernel wrappers run their plain twins on CPU tensors.  Tolerances,
fp32 unless stated:

- the quantizers: bit-exact codes and scales, half-way ties included;
- K12/K13 and K14: 1e-5 absolute on outputs of order one.  Both sides
  quantize the same fp32 values and multiply exact integers; they differ
  only in the last bit of the dequantizing products (measured 1e-6), while
  a flipped code would move an output by a whole quantization step;
- K11: relative L2 1e-3.  The JAX kernel takes erf from a polynomial
  (|err| ≤ 1.5e-7) where the port calls erf, so a value of act that lies
  within that distance of a rounding boundary can round to the neighbouring
  code (measured 2e-7, no code flipped);
- the int8 attention against K10 (the heads-packed route): relative L2
  1e-4 (measured 0: the same rounding points);
- the int8 attention against K9 (the transpose route, ragged n): relative
  L2 1e-2.  Under the fp32 policy K9 keeps p and v in fp32, while the port
  rounds them to bf16 as K10 does (measured 2.8e-3 to 3.3e-3);
- the slice as a whole, in probability: 1e-4 against JAX's int8 engine at
  the heads-packed arch (the production route K13 → K10 → K14 → K11),
  2e-3 where JAX takes K9: the arch of its K12 → K9 → K14 route and the
  unfused int8 route (K9's rounding, above); and the 0.02 of
  tests/test_int8_parity.py against the port's own fp32 engine.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_config
from tests.test_torch_models import (DIM_LATENT, POLICIES, jax_params,
                                     port_model)
from tests.test_torch_slice import PATHS, TEXT_LEN, _tokenizer
from vit_exp_tpu.eval import zero_shot as jzs
from vit_exp_tpu.models.bert import BertConfig as JaxBertConfig
from vit_exp_tpu.models.factory import build_ctclip as jax_build_ctclip
from vit_exp_tpu.ops import attention as jattn
from vit_exp_tpu.ops import fused_proj as jproj
from vit_exp_tpu.ops import geglu_ff as jff
from vit_exp_tpu.ops.flash_attention import hp_supported

from vit_exp_tpu_torch.eval import zero_shot as tzs
from vit_exp_tpu_torch.ops import attention as tattn
from vit_exp_tpu_torch.ops import flash_attention as tfa
from vit_exp_tpu_torch.ops import fused_proj as tproj
from vit_exp_tpu_torch.ops import geglu_ff as tff


def _rng(seed):
    return np.random.default_rng(seed)


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ---------------------------------------------------------------------------
# the int8 envelope
# ---------------------------------------------------------------------------

# a row (or column) with amax 127 has scale 1, so these values are ties
TIES = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5, -126.5, 126.5]


@pytest.mark.parametrize("seed", [0, 1])
def test_quant_rows_bit_exact(seed):
    y = (_rng(seed).standard_normal((6, 37)) * 3).astype(np.float32)
    y[0, :len(TIES)] = TIES
    y[1] = 0.0          # the 1e-8 floor
    q_j, s_j = jff._quant_rows(jnp.asarray(y))
    q_t, s_t = tff.quant_rows(torch.from_numpy(y))
    assert q_t.dtype == torch.int8 and s_t.shape == (6, 1)
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    assert q_t[0, :len(TIES)].tolist() == [127, 2, -4, 0, 0, 2, -126, 126]


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_per_channel_bit_exact(seed):
    w = (_rng(seed).standard_normal((40, 9)) / 5).astype(np.float32)
    w[:len(TIES), 0] = TIES
    w[:, 1] = 0.0
    q_j, s_j = jff.quantize_per_channel(jnp.asarray(w))
    q_t, s_t = tff.quantize_per_channel(torch.from_numpy(w))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    assert q_t[:len(TIES), 0].tolist() == [127, 2, -4, 0, 0, 2, -126, 126]


@pytest.mark.parametrize("quantizer", ["quant_rows", "quantize_per_channel",
                                       "geglu_ff_int8_q_plain"])
def test_int8_scales_are_one_ieee_division(quantizer):
    """Every scale is max(amax, 1e-8) / 127 rounded once, as the kernels'
    quant_scale and JAX divide: fp32(fp64(amax) / 127) exactly, never
    amax · fp32(1 / 127), which differs in the last bit for some amax."""
    y = torch.from_numpy(_rng(7).standard_normal((512, 64)).astype(
        np.float32) * 3)
    if quantizer == "quant_rows":
        _, s = tff.quant_rows(y)
        amax = y.abs().amax(dim=-1, keepdim=True)
    elif quantizer == "quantize_per_channel":
        _, s = tff.quantize_per_channel(y.t())   # 512 channels
        amax = y.abs().amax(dim=-1)
    else:
        part = tff.amax_partials(y)
        _, s = tff.geglu_ff_int8_q_plain(y, part)
        amax = part.amax(dim=-1, keepdim=True)
    ieee = (amax.double() / 127.0).float()
    assert not torch.equal(amax * np.float32(1 / 127), ieee)   # a case
    assert torch.equal(s, ieee)


def test_int8_matmul_is_exact():
    """The plain twins' int8 product equals the int32 one, even where an
    fp32 sum of the same codes would round (depth 2048, all codes 127)."""
    a = torch.full((2, 2048), 127, dtype=torch.int8)
    b = torch.full((2048, 3), -127, dtype=torch.int8)
    b[0, 0] = 1
    exact = a.long() @ b.long()
    assert torch.equal(tff.int8_matmul(a, b), exact.float())


# ---------------------------------------------------------------------------
# K11, K12/K13, K14: plain twins against the Pallas kernels (interpret)
# ---------------------------------------------------------------------------

# JAX's block_m is 256: one M fills whole blocks, the other pads
MS = [256, 300]


@pytest.mark.parametrize("m", MS)
def test_proj_int8_k14_matches_pallas(m):
    r = _rng(20)
    x = r.standard_normal((m, 64)).astype(np.float32)
    w = (r.standard_normal((64, 48)) / 8).astype(np.float32)
    ref = jproj.int8_proj(jnp.asarray(x), jnp.asarray(w), interpret=True)
    out = tproj.int8_proj(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=1e-5)


def test_proj_int8_k14_zero_row_and_clip_match_pallas():
    """K14 at the production depth and width (K 256, F 768): a row of
    zeros (its scale is the 1e-8 floor) and rows whose largest entries sit
    exactly at ±amax (codes ±127, the clip's edge), among random rows.  The
    special rows are held to JAX's kernel; every row to the IEEE envelope
    computed in numpy (code = round_half_even(x / s), fp64 sums).  JAX's
    kernel in interpret mode divides by a broadcast scale, which XLA's CPU
    compiler turns into a product with its reciprocal, so on a near-tie
    (here row 111, x / s = −63.499996) its code is one step off the IEEE
    division that JAX's own quantizer (``_quant_rows``) and the port use."""
    r = _rng(36)
    x = r.standard_normal((300, 256)).astype(np.float32)
    x[3] = 0.0
    x[7, ::5] = 8.0
    x[11] = np.where(np.arange(256) % 2 == 0, -0.75, 0.75) * 1e-3
    x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    w = (r.standard_normal((256, 768)) / 16).astype(np.float32)
    ref = np.asarray(jproj.int8_proj(jnp.asarray(x), jnp.asarray(w),
                                     interpret=True))
    out = _np(tproj.int8_proj(torch.from_numpy(x), torch.from_numpy(w)))
    special = [3, 7, 11]
    assert not ref[3].any() and not out[3].any()
    np.testing.assert_allclose(out[special], ref[special], atol=1e-5)
    # the envelope in numpy: per-row and per-column IEEE scales
    sr = np.maximum(np.abs(x).max(1, keepdims=True), np.float32(1e-8)) \
        / np.float32(127)
    sw = np.maximum(np.abs(w).max(0), np.float32(1e-8)) / np.float32(127)
    x8 = np.clip(np.round(x / sr), -127, 127)
    w8 = np.clip(np.round(w / sw), -127, 127)
    acc = (x8.astype(np.float64) @ w8.astype(np.float64)).astype(np.float32)
    np.testing.assert_allclose(out, acc * sr * sw, atol=1e-5)
    assert (x8[7, ::5] == 127).all() and (np.abs(x8[11]) == 127).all()


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("form", ["two_outputs", "three_outputs"])
def test_ln_qkv_int8_k12_k13_matches_pallas(m, form):
    r = _rng(21)
    d, fq = 48, 128
    x = (r.standard_normal((m, d)) * 2 + 0.5).astype(np.float32)
    gamma = (1 + 0.1 * r.standard_normal(d)).astype(np.float32)
    wq = (r.standard_normal((d, fq)) / 7).astype(np.float32)
    wkv = (r.standard_normal((d, 2 * fq)) / 7).astype(np.float32)
    args = tuple(map(jnp.asarray, (x, gamma, wq, wkv)))
    if form == "two_outputs":
        q_j, kv_j = jproj.fused_ln_qkv_int8(*args, interpret=True)
        ref = (q_j, kv_j[:, :fq], kv_j[:, fq:])
    else:
        ref = jproj.fused_ln_qkv3_int8(*args, interpret=True)
    out = tproj.fused_ln_qkv_int8(*map(torch.from_numpy, (x, gamma, wq, wkv)))
    for a, b in zip(out, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-5)


def test_ln_qkv_int8_quantizes_the_centred_input():
    """A constant offset of every token moves q not at all and k/v by
    exactly offset · colsum(Wkv) of the dequantized weights."""
    r = _rng(22)
    x = torch.from_numpy(r.standard_normal((16, 48)).astype(np.float32))
    gamma = torch.from_numpy((1 + 0.1 * r.standard_normal(48)).astype(np.float32))
    wq, wkv = (torch.from_numpy((r.standard_normal((48, f)) / 7).astype(
        np.float32)) for f in (32, 64))
    q0, k0, v0 = tproj.fused_ln_qkv_int8(x, gamma, wq, wkv)
    q1, k1, v1 = tproj.fused_ln_qkv_int8(x + 50.0, gamma, wq, wkv)
    _, _, c = tproj.int8_qkv_weights(gamma, wq, wkv)
    torch.testing.assert_close(q1, q0, atol=1e-5, rtol=0)
    torch.testing.assert_close(k1 - k0, (50.0 * c[32:64]).expand_as(k0),
                               atol=1e-4, rtol=0)
    torch.testing.assert_close(v1 - v0, (50.0 * c[64:]).expand_as(v0),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("m", MS)
def test_geglu_ff_int8_k11_matches_pallas(m):
    r = _rng(23)
    d, inner = 48, 32
    x = r.standard_normal((m, d)).astype(np.float32)
    gamma = (1 + 0.1 * r.standard_normal(d)).astype(np.float32)
    beta = (0.1 * r.standard_normal(d)).astype(np.float32)
    w1 = (r.standard_normal((d, 2 * inner)) / np.sqrt(d)).astype(np.float32)
    w2 = (r.standard_normal((inner, d)) / np.sqrt(inner)).astype(np.float32)
    ref = jff.fused_geglu_ff_int8(*map(jnp.asarray, (x, gamma, beta, w1, w2)),
                                  interpret=True)
    out = tff.fused_geglu_ff_int8(*map(torch.from_numpy,
                                       (x, gamma, beta, w1, w2)))
    assert out.shape == (m, d)
    assert _rel(out, ref) < 1e-3


# ---------------------------------------------------------------------------
# the int8 attention: one port kernel for K9 and K10
# ---------------------------------------------------------------------------


def _attn_inputs(seed, b, n, h, d, n_null):
    r = _rng(seed)
    q, k, v = (r.standard_normal((b, n, h * d)).astype(np.float32)
               for _ in range(3))
    nk, nv = (r.standard_normal((h, 8, d)).astype(np.float32)[:, :n_null]
              for _ in range(2))
    qs, ks = ((1 + 0.3 * r.standard_normal(d)).astype(np.float32)
              for _ in range(2))
    return q, k, v, nk, nv, qs, ks


def _port_attention(q, k, v, nk, nv, qs, ks, h, **kw):
    """The port's quantized cosine attention on packed (b, n, h·d) inputs;
    returns (b, h, n, d)."""
    b, n, hd = q.shape

    def heads(t):
        return torch.from_numpy(t).reshape(b, n, h, hd // h).transpose(1, 2)

    nulls = ({"null_k": torch.from_numpy(nk), "null_v": torch.from_numpy(nv)}
             if nk.shape[1] else {})
    return tattn.cosine_attention(
        heads(q), heads(k), heads(v), q_scale=torch.from_numpy(qs),
        k_scale=torch.from_numpy(ks), quantized=True, **nulls, **kw)


def _jax_nulls(nk, nv):
    return ({"null_k": jnp.asarray(nk), "null_v": jnp.asarray(nv)}
            if nk.shape[1] else {})


# (8, 8): the nulls carry about half of every row's weight
@pytest.mark.parametrize("n,n_null", [(40, 0), (40, 2), (40, 8), (8, 8)])
def test_int8_attention_matches_serving_hp_k10(n, n_null):
    b, h, d = 2, 4, 32
    assert hp_supported(n, n, h, d)
    q, k, v, nk, nv, qs, ks = _attn_inputs(30, b, n, h, d, n_null)
    ref = jattn.cosine_attention_packed(
        *map(jnp.asarray, (q, k, v)), h, q_scale=jnp.asarray(qs),
        k_scale=jnp.asarray(ks), quantized=True, **_jax_nulls(nk, nv))
    out = _port_attention(q, k, v, nk, nv, qs, ks, h)
    assert out.dtype == torch.float32
    assert _rel(out.transpose(1, 2).reshape(b, n, h * d), ref) < 1e-4


@pytest.mark.parametrize("n_null", [0, 2, 8])
def test_int8_attention_matches_transpose_route_k9(n_null):
    b, n, h, d = 2, 37, 3, 8
    assert not hp_supported(n, n, h, d)
    q, k, v, nk, nv, qs, ks = _attn_inputs(31, b, n, h, d, n_null)

    def heads(t):
        return jnp.asarray(t).reshape(b, n, h, d).transpose(0, 2, 1, 3)

    ref = jattn.cosine_attention(
        heads(q), heads(k), heads(v), q_scale=jnp.asarray(qs),
        k_scale=jnp.asarray(ks), impl="pallas", static_max=True,
        quantized=True, **_jax_nulls(nk, nv))
    out = _port_attention(q, k, v, nk, nv, qs, ks, h)
    assert out.shape == (b, h, n, d)
    assert _rel(out, ref) < 1e-2


def test_int8_attention_rejects_the_naive_scale_convention():
    q, k, v, nk, nv, qs, ks = _attn_inputs(32, 1, 8, 2, 4, 2)
    with pytest.raises(ValueError, match="scale convention"):
        _port_attention(q, k, v, nk, nv, qs, ks, 2, scale=8.0)
    _port_attention(q, k, v, nk, nv, qs, ks, 2, scale=0.5)   # 1/√4 passes


def test_int8_prologue_scales_and_layout():
    """qe = qn · s_k with s_k = max|k| / 127, k's one global scale, and
    q8/k8 keep the (b, n, h, d) memory layout of the packed projection
    output, which the kernel reads through strides."""
    r = _rng(33)
    q = torch.from_numpy(r.standard_normal((2, 5, 3, 32)).astype(np.float32))
    k = torch.from_numpy(r.standard_normal((2, 5, 3, 32)).astype(np.float32))
    q8, k8, qe, qn = tfa.quantize_qk(q.transpose(1, 2), k.transpose(1, 2),
                                     0.25)
    assert q8.dtype == k8.dtype == torch.int8
    assert q8.stride() == q.transpose(1, 2).stride()
    assert k8.stride() == k.transpose(1, 2).stride()
    ks = k.abs().amax() / 127.0
    torch.testing.assert_close(qe, qn * ks, rtol=1e-6, atol=0)
    assert int(k8.abs().max()) == 127


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

ROUTES = {
    # dim_head 32, heads 4: JAX takes K13 → K10 → K14 (production route)
    "heads_packed": dict(dim_head=32, heads=4),
    # dim_head 8, heads 4 (inner 32): JAX takes K12 → K9 → K14
    "transpose": {},
}


def _config(route):
    config = _flagship_config(tiny=True)
    for key, val in ROUTES[route].items():
        setattr(config.arch, key, val)
    return config


@pytest.fixture(scope="module")
def setups():
    """Per route: (config, perturbed params, two volumes)."""
    out = {}
    for i, route in enumerate(ROUTES):
        config = _config(route)
        a = config.arch
        vols = _rng(40 + i).uniform(
            -1, 1, (2, 1, a.temporal_size, a.image_size, a.image_size)
        ).astype(np.float32)
        out[route] = (config, jax_params(config, seed=5 + i), vols)
    return out


def _jax_probs(config, params, vols, fuse_qkv=True):
    model = jax_build_ctclip(
        config, bert_config=JaxBertConfig.tiny(), policy=POLICIES["fp32"][0],
        dim_latent=DIM_LATENT, attn_impl="pallas_static_int8",
        ff_impl="pallas_int8", fuse_qkv=fuse_qkv)
    return jzs.ZeroShotClassifier(
        model, params, _tokenizer(), pathologies=PATHS,
        max_text_len=TEXT_LEN, batch_size=2).predict_batch(vols)


def _port_probs(config, params, vols, **kw):
    model = port_model(config, params, **kw)
    return tzs.ZeroShotClassifier(model, _tokenizer(), pathologies=PATHS,
                                  max_text_len=TEXT_LEN).predict_batch(vols)


@pytest.mark.parametrize("route,atol", [("heads_packed", 1e-4),
                                        ("transpose", 2e-3)])
def test_int8_engine_matches_jax_int8_engine(setups, route, atol):
    config, params, vols = setups[route]
    a = config.arch
    n = (a.temporal_size // a.temporal_patch_size) * (
        a.image_size // a.patch_size) ** 2
    inner = a.heads * a.dim_head
    assert (inner % 128 == 0 and hp_supported(n, n, a.heads, a.dim_head)) \
        == (route == "heads_packed")
    ref = _jax_probs(config, params, vols)
    out = _port_probs(config, params, vols, int8=True)
    assert out.shape == ref.shape == (2, len(PATHS))
    np.testing.assert_allclose(out, ref, atol=atol)


@pytest.mark.parametrize("route", list(ROUTES))
def test_int8_engine_within_002_of_fp32_engine(setups, route):
    """The port's twin of tests/test_int8_parity.py: quantization moves no
    probability by 0.02 or more against the fp32 engine on the same
    weights."""
    config, params, vols = setups[route]
    p_fp = _port_probs(config, params, vols)
    p_i8 = _port_probs(config, params, vols, int8=True)
    assert np.abs(p_fp - p_i8).max() < 0.02


def test_int8_unfused_route_matches_jax(setups):
    """fuse_qkv=False with int8: unfused projections, int8 attention, bf16
    (here fp32) to_out, as the JAX package runs it.  JAX's attention on
    this route is K9 at every shape, hence K9's tolerance."""
    config, params, vols = setups["heads_packed"]
    ref = _jax_probs(config, params, vols, fuse_qkv=False)
    out = _port_probs(config, params, vols, int8=True, fuse_qkv=False)
    fused = _port_probs(config, params, vols, int8=True)
    np.testing.assert_allclose(out, ref, atol=2e-3)
    assert np.abs(out - fused).max() > 0    # really another route


def test_int8_path_raises_when_an_input_requires_grad(setups):
    config, params, vols = setups["heads_packed"]
    model = port_model(config, params, int8=True)
    video = torch.from_numpy(vols)
    with pytest.raises(RuntimeError, match="requires grad"):
        model.encode_image_tokens(video)      # parameters require grad
    with torch.no_grad():
        assert torch.isfinite(model.encode_image_tokens(video)).all()
    x = torch.randn(4, 48, requires_grad=True)
    w = torch.randn(48, 128)
    with pytest.raises(RuntimeError, match="requires grad"):
        tproj.int8_proj(x, w)
    with pytest.raises(RuntimeError, match="requires grad"):
        tff.fused_geglu_ff_int8(x, torch.ones(48), torch.zeros(48),
                                torch.randn(48, 64), torch.randn(32, 48))
    with pytest.raises(RuntimeError, match="requires grad"):
        tproj.fused_ln_qkv_int8(x, torch.ones(48), w, torch.randn(48, 256))


def test_state_dict_is_the_same_in_every_mode(setups):
    config, params, _ = setups["heads_packed"]
    ref = port_model(config, params).state_dict()
    for kw in (dict(int8=True), dict(int8=True, fuse_qkv=False)):
        sd = port_model(config, params, **kw).state_dict()
        assert list(sd) == list(ref)
        assert all(torch.equal(sd[k], ref[k]) for k in ref)


def test_int8_wrappers_take_the_plain_path_on_cpu_without_counting():
    counters = (tfa.attention_static_int8, tff.geglu_ff_int8_y,
                tff.geglu_ff_int8_h, tff.geglu_ff_int8_q, tff.geglu_ff_int8_o,
                tproj.ln_qkv_int8_x, tproj.ln_qkv_int8_mm, tproj.proj_int8)
    before = [fn.launches for fn in counters]
    r = _rng(34)
    q, k, v, nk, nv, qs, ks = _attn_inputs(35, 1, 16, 2, 32, 2)
    out = _port_attention(q, k, v, nk, nv, qs, ks, 2)
    plain = _port_attention(q, k, v, nk, nv, qs, ks, 2, use_kernel=False)
    assert torch.equal(out, plain)
    x = torch.from_numpy(r.standard_normal((8, 64)).astype(np.float32))
    tproj.int8_proj(x, torch.randn(64, 128))
    tproj.fused_ln_qkv_int8(x, torch.ones(64), torch.randn(64, 32),
                            torch.randn(64, 64))
    tff.fused_geglu_ff_int8(x, torch.ones(64), torch.zeros(64),
                            torch.randn(64, 64), torch.randn(32, 64))
    assert [fn.launches for fn in counters] == before == [0] * 8
    assert math.isfinite(float(out.sum()))
