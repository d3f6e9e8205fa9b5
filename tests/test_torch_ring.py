"""CPU parity of the port's sequence parallelism against the JAX package.

Four ranks of a gloo process group (tests/_torch_dist_runner.py, no jax
in them) run the port; the JAX side runs here on 4 of the conftest's 8
virtual CPU devices under ``shard_map``, as tests/test_ring_attention.py
and tests/test_sharding.py run it.  The ranks run once for the whole file
(a module fixture) and each test reads its part.  Bounds, the JAX suite's
own:

- ``ring_attention`` (plain chunks) against JAX's ``ring_attention``
  (impl "xla") and against full attention: the output within 2e-5
  absolute, the q/k/v gradients of sum(out²) within 5e-5;
- ``cosine_attention`` over the ring with nulls and learned scales
  (scale 8) against JAX's ``impl="ring"``: 3e-5 on the output, 1e-4 on
  the gradients;
- the sequence-sharded CTViT3D encode of a CTCLIP at the JAX test's tiny
  arch (2 blocks, 8 tokens in chunks of 2), JAX's perturbed weights
  carried over by ``from_jax_params``: 3e-5 on the tokens, 2e-4 on the
  parameter gradients of sum(tokens²);
- the contrastive objective through that tower: rtol 1e-5 on the loss,
  atol 2e-4 on every parameter gradient.

A rank's local q/k/v gradients are those of the global loss (its own
shard is not replicated); the parameter gradients are averaged over the
group, the rule of parallel/collectives.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from vit_exp_tpu.core import config as jconfig
from vit_exp_tpu.models import losses as jlosses
from vit_exp_tpu.models.ctclip import CTCLIP as JaxCTCLIP
from vit_exp_tpu.ops.attention import cosine_attention as jax_cosine
from vit_exp_tpu.ops.ring_attention import ring_attention as jax_ring

from tests._torch_dist_runner import spawn
from tests.test_torch_models import jax_params
from vit_exp_tpu_torch.models.convert import from_jax_params

RING = 4
ARCH = {"dim": 24, "image_size": 8, "patch_size": 4, "temporal_size": 8,
        "temporal_patch_size": 4, "transformer_blocks": 2, "dim_head": 4,
        "heads": 2, "use_flash_attention": True}
CONFIG = {"arch": ARCH}


def _mesh():
    return Mesh(np.asarray(jax.devices()[:RING]), ("seq",))


def _full_attention(q, k, v):
    logits = jnp.einsum("bhid,bhjd->bhij", q, k) / math.sqrt(q.shape[-1])
    return jnp.einsum("bhij,bhjd->bhid", jax.nn.softmax(logits, axis=-1), v)


def _shard_map(fn, in_specs, out_specs):
    return shard_map(fn, mesh=_mesh(), in_specs=in_specs,
                     out_specs=out_specs, check_vma=False)


def _ring_case():
    r = np.random.default_rng(0)
    q, k, v = (r.standard_normal((2, 2, 32, 8)).astype(np.float32)
               for _ in range(3))
    tok = P(None, None, "seq", None)
    ring = jax.jit(_shard_map(
        lambda q, k, v: jax_ring(q, k, v, axis_name="seq"), (tok, tok, tok),
        tok))

    def grads(fn):
        return jax.jit(jax.grad(lambda *a: jnp.sum(fn(*a) ** 2),
                                argnums=(0, 1, 2)))(q, k, v)

    return ({"q": q, "k": k, "v": v},
            {"ring": np.asarray(ring(q, k, v)),
             "full": np.asarray(_full_attention(q, k, v)),
             "ring_grads": grads(ring), "full_grads": grads(_full_attention)})


def _cosine_case():
    r = np.random.default_rng(7)
    b, h, n, d = 1, 2, 32, 8
    q, k, v = (r.standard_normal((b, h, n, d)).astype(np.float32)
               for _ in range(3))
    fixed = {"null_k": r.standard_normal((h, 2, d)).astype(np.float32),
             "null_v": r.standard_normal((h, 2, d)).astype(np.float32),
             "q_scale": (1 + 0.1 * r.standard_normal(d)).astype(np.float32),
             "k_scale": (1 + 0.1 * r.standard_normal(d)).astype(np.float32)}
    tok, rep3, rep1 = P(None, None, "seq", None), P(None, None, None), P(None)
    ring = jax.jit(_shard_map(
        lambda q, k, v, nk, nv, qs, ks: jax_cosine(
            q, k, v, null_k=nk, null_v=nv, q_scale=qs, k_scale=ks, scale=8.0,
            impl="ring", ring_chunk_impl="pallas"),
        (tok, tok, tok, rep3, rep3, rep1, rep1), tok))
    args = [fixed[n] for n in ("null_k", "null_v", "q_scale", "k_scale")]
    out = ring(q, k, v, *args)
    grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(jnp.square(
        ring(q, k, v, *args))), argnums=(0, 1, 2)))(q, k, v)
    return {"q": q, "k": k, "v": v, **fixed}, {"out": np.asarray(out),
                                               "grads": grads}


def _tower_case():
    """JAX's CTCLIP at the tiny arch, unsharded (xla attention) and with
    its tower sequence-sharded over 4 devices (ring attention, xla
    chunks); the encode and the contrastive objective, values and
    gradients of the sharded one."""
    from vit_exp_tpu.models.bert import BertConfig as JaxBertConfig
    from vit_exp_tpu.core.precision import FP32_POLICY as JAX_FP32
    from vit_exp_tpu.models.factory import build_ctclip as jax_build_ctclip

    jcfg = jconfig.ExperimentConfig.from_dict(CONFIG)
    params = jax_params(jcfg, seed=3)
    model = jax_build_ctclip(jcfg, bert_config=JaxBertConfig.tiny(),
                             policy=JAX_FP32, dim_latent=16, attn_impl="xla",
                             ff_impl="xla")
    ring_model = model.clone(visual=model.visual.clone(
        attn_impl="ring", seq_axis="seq", ring_chunk_impl="xla"))
    r = np.random.default_rng(3)
    video = r.standard_normal((2, 1, 8, 8, 8)).astype(np.float32)
    ids = r.integers(1, 100, (2, 12)).astype(np.int32)
    mask = np.ones_like(ids)

    def encode(p):
        return ring_model.apply({"params": p}, video,
                                method=JaxCTCLIP.encode_image_tokens)

    def objective(p):
        out = ring_model.apply({"params": p}, video, ids, mask)
        return jlosses.infonce_loss(out["text_latents"],
                                    out["image_latents"],
                                    out["temperature"], local_batch_size=2)

    def encode_loss(p):
        tokens = _shard_map(encode, (P(),), P())(p)
        return jnp.sum(jnp.square(tokens)), tokens

    sharded_objective = _shard_map(objective, (P(),), P())
    (_, tokens), g_encode = jax.jit(jax.value_and_grad(
        encode_loss, has_aux=True))(params)
    loss, g_loss = jax.jit(jax.value_and_grad(sharded_objective))(params)

    def named(tree):
        return from_jax_params(jax.tree_util.tree_map(np.asarray, tree))

    return ({"config": CONFIG, "state": from_jax_params(params),
             "video": video, "ids": ids, "mask": mask},
            {"tokens": np.asarray(tokens), "encode_grads": named(g_encode),
             "loss": float(loss), "loss_grads": named(g_loss)})


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    ring_in, ring_ref = _ring_case()
    cos_in, cos_ref = _cosine_case()
    tower_in, tower_ref = _tower_case()
    outs = spawn("ring", RING, str(tmp_path_factory.mktemp("ring")),
                 inputs={"ring": ring_in, "cosine": cos_in,
                         "tower": tower_in})
    return outs, {"ring": ring_ref, "cosine": cos_ref, "tower": tower_ref}


def _joined(outs, case, key):
    """The ranks' local shards of ``key`` joined along the token axis."""
    return np.concatenate([o[case][key] for o in outs], axis=2)


def test_ring_attention_matches_jax_ring_and_full_attention(ranks):
    outs, ref = ranks
    out = _joined(outs, "ring", "out")
    np.testing.assert_allclose(out, ref["ring"]["ring"], atol=2e-5)
    np.testing.assert_allclose(out, ref["ring"]["full"], atol=2e-5)
    for i, name in enumerate(("dq", "dk", "dv")):
        got = _joined(outs, "ring", name)
        for which in ("ring_grads", "full_grads"):
            np.testing.assert_allclose(got, np.asarray(ref["ring"][which][i]),
                                       atol=5e-5, err_msg=f"{name} {which}")


def test_cosine_attention_over_the_ring_with_nulls_matches_jax(ranks):
    outs, ref = ranks
    np.testing.assert_allclose(_joined(outs, "cosine", "out"),
                               ref["cosine"]["out"], atol=3e-5)
    for i, name in enumerate(("dq", "dk", "dv")):
        np.testing.assert_allclose(_joined(outs, "cosine", name),
                                   np.asarray(ref["cosine"]["grads"][i]),
                                   atol=1e-4, err_msg=name)


def test_sequence_sharded_tower_encode_matches_jax(ranks):
    outs, ref = ranks
    tower = ref["tower"]
    assert tower["tokens"].shape == (2, 2, 2, 2, 24)
    for o in outs:   # every rank holds the whole gathered grid
        np.testing.assert_allclose(o["encode"]["out"], tower["tokens"],
                                   atol=3e-5)
    visual = [n for n in tower["encode_grads"]
              if n.startswith("visual_transformer.")]
    assert len(visual) == 7 + 2 * 11
    for o in outs:
        for n in visual:
            np.testing.assert_allclose(o["encode"]["grads"][n],
                                       tower["encode_grads"][n], atol=2e-4,
                                       err_msg=n)


def test_sequence_sharded_contrastive_objective_matches_jax(ranks):
    outs, ref = ranks
    tower = ref["tower"]
    for o in outs:
        assert o["contrastive"]["loss"] == pytest.approx(tower["loss"],
                                                         rel=1e-5)
        grads = o["contrastive"]["grads"]
        assert set(grads) == set(tower["loss_grads"])
        for n, g in tower["loss_grads"].items():
            np.testing.assert_allclose(grads[n], g, atol=2e-4, err_msg=n)
