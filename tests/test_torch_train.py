"""CPU parity of the port's contrastive training step against the JAX package.

The same seeded numpy inputs go through JAX (Pallas kernels in interpret
mode) and through the port, whose autograd Functions take their plain
backward twins on CPU tensors.  Everything runs in fp32, so the two sides
differ only in summation order.  Tolerances:

- relative L2 ≤ 1e-4 per gradient tensor and per op output: fp32 on both
  sides, blocked sums in another order (measured ≤ 1e-6 on most tensors);
- 1e-5 relative on scalar losses;
- a gradient that is exactly zero in exact arithmetic (the BERT key bias:
  softmax is invariant to a per-row shift of the logits) is rounding noise
  of norm ~1e-9 on both sides; in the step comparison each gradient's norm
  is floored at NOISE = 1e-4 (the global norm is above 0.05) before
  dividing, so such a tensor is held to an absolute 1e-8;
- updated parameters: relative L2 ≤ 1e-5 per tensor.  One Adam step moves a
  parameter by lr·g / (|g| + ε), so the new parameters carry the
  gradients' fp32 error scaled by lr / |p|.  Where the gradient is noise
  (norm below NOISE) that step amplifies the noise, and the check is
  max |p_port − p_jax| ≤ lr.
- ``torch.autograd.gradcheck`` in float64 on each hand-written plain
  backward twin (attention, GEGLU, fused LN + qkv, patch statistics), at
  its default tolerances.
"""

import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_config
from vit_exp_tpu.core.config import ExperimentConfig
from vit_exp_tpu.core.precision import FP32_POLICY as JAX_FP32
from vit_exp_tpu.models import losses as jlosses
from vit_exp_tpu.models.bert import BertConfig as JaxBertConfig
from vit_exp_tpu.models.ctclip import CTCLIP as JaxCTCLIP
from vit_exp_tpu.models.factory import build_ctclip as jax_build_ctclip
from vit_exp_tpu.ops import attention as jattn
from vit_exp_tpu.ops import flash_attention as jfa
from vit_exp_tpu.ops import fused_proj as jproj
from vit_exp_tpu.ops import geglu_ff as jff
from vit_exp_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from vit_exp_tpu.train.steps import create_train_state
from vit_exp_tpu.train.steps import make_train_steps as jax_make_train_steps

from tests.test_torch_models import DIM_LATENT, jax_params, port_model
from vit_exp_tpu_torch.models import losses as tlosses
from vit_exp_tpu_torch.models.convert import from_jax_params
from vit_exp_tpu_torch.ops import attention as tattn
from vit_exp_tpu_torch.ops import flash_attention as tfa
from vit_exp_tpu_torch.ops import fused_proj as tproj
from vit_exp_tpu_torch.ops import geglu_ff as tff
from vit_exp_tpu_torch.ops import patches as tpatch
from vit_exp_tpu_torch.train.optimizer import (build_optimizer,
                                               clip_by_global_norm_)
from vit_exp_tpu_torch.train.steps import make_train_steps

GRAD_TOL = 1e-4
NOISE = 1e-4
TEXT_LEN = 14


def _rng(seed):
    return np.random.default_rng(seed)


def _rel(a, b, floor=1e-30):
    a = np.asarray(a.detach() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), floor))


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


# --- attention -------------------------------------------------------------


@pytest.mark.parametrize("n,n_null", [(96, 2), (100, 2), (100, 0)])
def test_attention_grads_match_pallas(n, n_null):
    """n = 96 tiles exactly by 32 (the K5 one-sweep route), n = 100 is
    ragged (the K6/K7 route); gradients in q, k, v and the nulls."""
    r = _rng(20)
    b, h, d = 2, 3, 8
    q, k = (_unit(r.standard_normal((b, h, n, d))) for _ in range(2))
    v = r.standard_normal((b, h, n, d)).astype(np.float32)
    nk = _unit(r.standard_normal((h, max(n_null, 1), d)))[:, :n_null]
    nv = r.standard_normal((h, max(n_null, 1), d)).astype(np.float32)[:, :n_null]
    g = r.standard_normal((b, h, n, d)).astype(np.float32)
    scale = 1.0 / math.sqrt(d)

    def jf(q, k, v, nk, nv):
        nulls = {}
        if n_null:
            nulls = dict(null_k=jnp.broadcast_to(nk[None], (b,) + nk.shape),
                         null_v=jnp.broadcast_to(nv[None], (b,) + nv.shape))
        return jfa.flash_attention(
            q, k, v, scale=scale, logit_bound=jnp.float32(scale),
            null_strategy="init", block_q=32, block_k=32, interpret=True,
            **nulls)

    ref, vjp = jax.vjp(jax.jit(jf), *map(jnp.asarray, (q, k, v, nk, nv)))
    ref_grads = vjp(jnp.asarray(g))

    leaves = [_t(x).requires_grad_() for x in (q, k, v, nk, nv)]
    out = tfa.flash_attention(
        *leaves[:3], logit_bound=torch.tensor(scale), scale=scale,
        null_k=leaves[3] if n_null else None,
        null_v=leaves[4] if n_null else None)
    out.backward(_t(g))
    assert _rel(out, ref) < GRAD_TOL
    for t, rg in zip(leaves[:3 + 2 * bool(n_null)], ref_grads):
        assert _rel(t.grad, rg) < GRAD_TOL


def test_cosine_attention_grads_match_pallas_static():
    """Through the cosine prologue: the q/k scales' gradients come only
    through the normalised q and k, never through the bound."""
    r = _rng(21)
    b, h, n, d = 2, 3, 40, 8
    q, k, v = (r.standard_normal((b, h, n, d)).astype(np.float32)
               for _ in range(3))
    nk, nv = (r.standard_normal((h, 2, d)).astype(np.float32)
              for _ in range(2))
    qs, ks = ((1 + 0.3 * r.standard_normal(d)).astype(np.float32)
              for _ in range(2))
    g = r.standard_normal((b, h, n, d)).astype(np.float32)

    def jf(q, k, v, nk, nv, qs, ks):
        return jattn.cosine_attention(q, k, v, null_k=nk, null_v=nv,
                                      q_scale=qs, k_scale=ks, impl="pallas",
                                      static_max=True)

    ref, vjp = jax.vjp(jax.jit(jf),
                       *map(jnp.asarray, (q, k, v, nk, nv, qs, ks)))
    ref_grads = vjp(jnp.asarray(g))
    leaves = [_t(x).requires_grad_() for x in (q, k, v, nk, nv, qs, ks)]
    out = tattn.cosine_attention(*leaves[:3], null_k=leaves[3],
                                 null_v=leaves[4], q_scale=leaves[5],
                                 k_scale=leaves[6])
    out.backward(_t(g))
    assert _rel(out, ref) < GRAD_TOL
    for t, rg in zip(leaves, ref_grads):
        assert _rel(t.grad, rg) < GRAD_TOL


def test_logit_bound_carries_no_gradient():
    qs = torch.tensor([1.5, -0.5], requires_grad=True)
    ks = torch.tensor([0.7, 2.0], requires_grad=True)
    bound = tattn.logit_bound(qs, ks, 0.25)
    assert not bound.requires_grad
    assert float(bound) == pytest.approx(1.5 * 2.0 * 0.25)


# --- feed-forward and projections -------------------------------------------


@pytest.mark.parametrize("m", [40, 300])
def test_geglu_grads_match_pallas_k8(m):
    r = _rng(22)
    d, inner = 48, 32
    x = r.standard_normal((m, d)).astype(np.float32)
    gamma = (1 + 0.1 * r.standard_normal(d)).astype(np.float32)
    beta = (0.1 * r.standard_normal(d)).astype(np.float32)
    w1 = (r.standard_normal((d, 2 * inner)) / np.sqrt(d)).astype(np.float32)
    w2 = (r.standard_normal((inner, d)) / np.sqrt(inner)).astype(np.float32)
    g = r.standard_normal((m, d)).astype(np.float32)
    ref, vjp = jax.vjp(lambda *a: jff.fused_geglu_ff(*a, interpret=True),
                       *map(jnp.asarray, (x, gamma, beta, w1, w2)))
    ref_grads = vjp(jnp.asarray(g))
    leaves = [_t(a).requires_grad_() for a in (x, gamma, beta, w1, w2)]
    out = tff.fused_geglu_ff(*leaves)
    out.backward(_t(g))
    assert _rel(out, ref) < GRAD_TOL
    for t, rg in zip(leaves, ref_grads):
        assert _rel(t.grad, rg) < GRAD_TOL


def test_fused_ln_qkv_grads_match_jax_core_bwd():
    r = _rng(23)
    m, d, fq = 40, 48, 32
    x = (r.standard_normal((m, d)) * 2 + 0.5).astype(np.float32)
    gamma = (1 + 0.1 * r.standard_normal(d)).astype(np.float32)
    wq = (r.standard_normal((d, fq)) / np.sqrt(d)).astype(np.float32)
    wkv = (r.standard_normal((d, 2 * fq)) / np.sqrt(d)).astype(np.float32)
    gq = r.standard_normal((m, fq)).astype(np.float32)
    gkv = r.standard_normal((m, 2 * fq)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jproj.fused_ln_qkv(*a, interpret=True),
                     *map(jnp.asarray, (x, gamma, wq, wkv)))
    ref_grads = vjp((jnp.asarray(gq), jnp.asarray(gkv)))
    leaves = [_t(a).requires_grad_() for a in (x, gamma, wq, wkv)]
    q, kv = tproj.fused_ln_qkv(*leaves)
    torch.autograd.backward((q, kv), (_t(gq), _t(gkv)))
    for t, rg in zip(leaves, ref_grads):
        assert _rel(t.grad, rg) < GRAD_TOL


def _gradcheck_cases():
    """(name, function, float64 inputs) for each hand-written backward."""
    r = _rng(24)
    f64 = lambda *shape: torch.from_numpy(r.standard_normal(shape))  # noqa: E731
    unit = lambda t: t / t.norm(dim=-1, keepdim=True)  # noqa: E731
    b, h, d, scale = 2, 3, 8, 8 ** -0.5
    attn = [unit(f64(b, h, 10, d)), unit(f64(b, h, 13, d)), f64(b, h, 13, d),
            unit(f64(h, 2, d)), f64(h, 2, d)]
    x, gam, bet = f64(7, 12), 1 + 0.1 * f64(12), 0.1 * f64(12)
    return [
        ("attention", lambda *a: tfa.StaticAttention.apply(
            *a, torch.tensor(scale), scale, False), attn),
        ("geglu", lambda *a: tff.GEGLUFeedForwardFn.apply(*a, 1e-5, False),
         [x, gam, bet, f64(12, 16) / 4, f64(8, 12) / 3]),
        ("ln_qkv", lambda *a: tproj.LNQKVFn.apply(*a, 1e-5, False),
         [x, gam, f64(12, 8) / 3, f64(12, 16) / 3]),
    ]


@pytest.mark.parametrize("case", range(3))
def test_plain_backward_twins_pass_gradcheck(case):
    name, fn, inputs = _gradcheck_cases()[case]
    inputs = [t.clone().requires_grad_() for t in inputs]
    assert torch.autograd.gradcheck(fn, inputs), name


# --- loss and optimizer ------------------------------------------------------


@pytest.mark.parametrize("decoupled,local_b", [(False, None), (True, None),
                                               (False, 3), (True, 2)])
def test_infonce_matches_jax(decoupled, local_b):
    r = _rng(25)
    t, i = (_unit(r.standard_normal((4, 16))) for _ in range(2))
    temp = np.float32(0.7)

    def jf(t, i, temp):
        return jlosses.infonce_loss(t, i, temp, local_batch_size=local_b,
                                    decoupled=decoupled)

    ref, grads = jax.value_and_grad(jf, argnums=(0, 1, 2))(
        jnp.asarray(t), jnp.asarray(i), jnp.asarray(temp))
    leaves = [_t(a).requires_grad_() for a in (t, i, temp)]
    loss = tlosses.infonce_loss(*leaves, local_batch_size=local_b,
                                decoupled=decoupled)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(ref), rel=1e-5)
    for leaf, g in zip(leaves, grads):
        assert _rel(leaf.grad, g) < GRAD_TOL


def test_clip_follows_optax_rule():
    """Kept below max_norm, scaled to exactly max_norm at or above it."""
    g = [torch.tensor([3.0, 4.0])]
    assert float(clip_by_global_norm_(g, 10.0)) == 5.0
    assert g[0].tolist() == [3.0, 4.0]
    assert float(clip_by_global_norm_(g, 1.0)) == 5.0
    torch.testing.assert_close(g[0], torch.tensor([0.6, 0.8]))


def test_optimizer_groups_and_guards():
    lin = torch.nn.Linear(3, 2)
    cfg = types.SimpleNamespace(lr=0.1, wd=0.5, max_grad_norm=0.0,
                                warmup_steps=4, gradient_accumulation_steps=1)
    opt = build_optimizer(cfg, lin.parameters())
    decay = {g["weight_decay"]: [p.ndim for p in g["params"]]
             for g in opt.opt.param_groups}
    assert decay == {0.5: [2], 0.0: [1]}
    assert opt.opt.param_groups[0]["lr"] == 0.0   # warmup starts at 0
    lin(torch.ones(1, 3)).sum().backward()
    opt.step()
    assert opt.opt.param_groups[0]["lr"] == pytest.approx(0.025)
    # accumulation over 2 micro-steps: the first leaves the parameters be
    acc = build_optimizer(types.SimpleNamespace(
        **{**vars(cfg), "gradient_accumulation_steps": 2}), lin.parameters())
    before = [p.detach().clone() for p in lin.parameters()]
    acc.step()
    assert acc.mini_step == 1
    assert all(torch.equal(p, b) for p, b in zip(lin.parameters(), before))


# --- the whole image-report step ----------------------------------------------


def _train_config(max_grad_norm):
    base = _flagship_config(tiny=True)
    arch = {f: getattr(base.arch, f) for f in (
        "dim", "image_size", "patch_size", "temporal_size",
        "temporal_patch_size", "transformer_blocks", "dim_head", "heads",
        "use_flash_attention")}
    return ExperimentConfig.from_dict(
        {"trainer": {"lr": 1e-3, "max_grad_norm": max_grad_norm},
         "arch": arch})


def _batch(config, seed=26):
    r = _rng(seed)
    a = config.arch
    video = r.standard_normal(
        (2, 1, a.temporal_size, a.image_size, a.image_size)).astype(np.float32)
    ids = r.integers(0, 128, (2, TEXT_LEN)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 9:] = 0
    return video, ids, mask


@pytest.fixture(scope="module")
def jax_step():
    """One JAX image-report step at the tiny arch in the training
    configuration: loss, gradients (value_and_grad of the same loss) and the
    parameters after clip + Adam."""
    config = _train_config(max_grad_norm=0.05)
    params = jax_params(config, seed=7)
    model = jax_build_ctclip(
        config, bert_config=JaxBertConfig.tiny(), policy=JAX_FP32,
        dim_latent=DIM_LATENT, attn_impl="pallas_static", ff_impl="pallas",
        fuse_qkv=False)
    video, ids, mask = _batch(config)
    batch = {"image": jnp.asarray(video), "input_ids": jnp.asarray(ids),
             "attention_mask": jnp.asarray(mask)}

    def loss_fn(p):
        out = model.apply({"params": p}, batch["image"], batch["input_ids"],
                          batch["attention_mask"])
        return jlosses.infonce_loss(out["text_latents"], out["image_latents"],
                                    out["temperature"], local_batch_size=2)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    tx = jax_build_optimizer(config.trainer)
    step = jax_make_train_steps(model, tx, config)["imagereport"]
    state, metrics = step(create_train_state(params, tx), batch, 1.0)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    return dict(config=config, params=params, video=video, ids=ids, mask=mask,
                loss=float(loss), step_loss=float(metrics["loss"]),
                grads=from_jax_params(to_np(grads)),
                new=from_jax_params(to_np(state.params)))


def test_imagereport_step_matches_jax(jax_step):
    j = jax_step
    model = port_model(j["config"], j["params"], fuse_qkv=False).train()
    video, ids, mask = (torch.from_numpy(j[k]) for k in ("video", "ids", "mask"))
    ids = ids.long()

    out = model(video, ids, mask)
    loss = tlosses.infonce_loss(out["text_latents"], out["image_latents"],
                                out["temperature"], local_batch_size=2)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(j["loss"], rel=1e-5)
    named = dict(model.named_parameters())
    assert set(named) == set(j["grads"])
    norm = math.sqrt(sum(float(np.square(g.astype(np.float64)).sum())
                         for g in j["grads"].values()))
    assert norm > 0.05, "the clip must engage for this test to cover it"
    for name, p in named.items():
        assert p.grad is not None, name
        assert _rel(p.grad, j["grads"][name], NOISE) < GRAD_TOL, name

    old = {k: v.detach().clone() for k, v in named.items()}
    opt = build_optimizer(j["config"].trainer, model.parameters())
    step = make_train_steps(model, opt, j["config"])["imagereport"]
    metrics = step({"image": video, "input_ids": ids,
                    "attention_mask": mask}, 1.0)
    assert float(metrics["loss"]) == pytest.approx(j["step_loss"], rel=1e-5)
    assert float(metrics["cl_loss"]) == pytest.approx(j["step_loss"], rel=1e-5)
    lr = j["config"].trainer.lr
    for name, p in named.items():
        assert not torch.equal(p.detach(), old[name]), name
        if np.linalg.norm(j["grads"][name]) < NOISE:
            assert np.abs(p.detach().numpy() - j["new"][name]).max() <= lr
        else:
            assert _rel(p, j["new"][name]) < 1e-5, name


def test_unfused_tower_matches_jax_unfused(jax_step):
    """fuse_qkv=False: ScaleLayerNorm → to_q on the normed x, to_kv on the
    pre-LN x, as the JAX tower trains; same state dict as the fused path."""
    j = jax_step
    model = port_model(j["config"], j["params"], fuse_qkv=False)
    fused = port_model(j["config"], j["params"], fuse_qkv=True)
    assert model.state_dict().keys() == fused.state_dict().keys()
    jmodel = jax_build_ctclip(
        j["config"], bert_config=JaxBertConfig.tiny(), policy=JAX_FP32,
        dim_latent=DIM_LATENT, attn_impl="pallas_static", ff_impl="pallas")
    ref = np.asarray(jax.jit(lambda p, v: jmodel.apply(
        {"params": p}, v, method=JaxCTCLIP.encode_image_tokens))(
            j["params"], jnp.asarray(j["video"])))
    with torch.no_grad():
        out = model.encode_image_tokens(torch.from_numpy(j["video"]))
    assert _rel(out, ref) < GRAD_TOL


def test_model_routes_through_the_autograd_functions(jax_step):
    """On the CPU the model's graph holds the kernels' Functions (the card
    test checks that their launches carry a graph)."""
    j = jax_step
    seen = set()
    for fuse in (False, True):
        model = port_model(j["config"], j["params"], fuse_qkv=fuse)
        video = torch.from_numpy(j["video"]).requires_grad_()
        out = model.encode_image_tokens(video)
        stack = [out.grad_fn]
        while stack:
            node = stack.pop()
            if node is None or node in seen:
                continue
            seen.add(node)
            stack += [n for n, _ in node.next_functions]
    names = {type(n).__name__ for n in seen}
    for fn in ("StaticAttentionBackward", "GEGLUFeedForwardFnBackward",
               "LNQKVFnBackward", "PatchEmbedFnBackward"):
        assert fn in names, (fn, sorted(names))
