"""CPU parity of the port's self-supervision terms (MLM and visual SSL)
against the JAX package, on the same numpy inputs and JAX's own draws.

The random functions of the port take their draws as arguments; each test
recomputes the draws JAX makes from the same key, in the order the JAX
code makes them, and hands them in.  The whole image-report step with
both terms runs at the tiny arch of the JAX package's tests/test_ssl.py
(dim 24, head dim 4, ``BertConfig.tiny()``), fp32, from JAX's parameters
(``from_jax_params``, the SSL heads included), against JAX's
``make_train_steps(..., n_data_shards=1)`` (attn_impl="pallas",
ff_impl="pallas", Pallas in interpret mode).  Tolerances:

- MLM selection and corruption: bit for bit;
- ``mlm_loss``, ``nt_xent_loss``, ``simsiam_loss`` and the two MLPs:
  1e-5 absolute on values of order one;
- ``random_augment_3d``: 1e-6 absolute;
- the step: each loss and metric within 1e-5 relative at both steps; the
  parameters after 2 steps within relative L2 1e-5 per tensor, or, for a
  tensor whose gradient norm stays below NOISE on both steps (rounding
  noise, which Adam turns into a step of up to lr), max |Δ| ≤ 2·lr.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_exp_tpu.core import config as jconfig
from vit_exp_tpu.core.precision import FP32_POLICY as JAX_FP32
from vit_exp_tpu.models import mlm as jmlm
from vit_exp_tpu.models import visual_ssl as jssl
from vit_exp_tpu.models.bert import BertConfig as JaxBertConfig
from vit_exp_tpu.models.factory import build_ctclip as jax_build_ctclip
from vit_exp_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from vit_exp_tpu.train.steps import create_train_state
from vit_exp_tpu.train.steps import make_train_steps as jax_make_train_steps

from tests.test_torch_models import DIM_LATENT, jax_params
from vit_exp_tpu_torch.cli import run_train
from vit_exp_tpu_torch.core import config as tconfig
from vit_exp_tpu_torch.core.precision import FP32_POLICY
from vit_exp_tpu_torch.models import mlm as tmlm
from vit_exp_tpu_torch.models import visual_ssl as tssl
from vit_exp_tpu_torch.models.bert import BertConfig
from vit_exp_tpu_torch.models.convert import from_jax_params, ssl_head_state
from vit_exp_tpu_torch.models.factory import build_ctclip
from vit_exp_tpu_torch.train import steps as tsteps
from vit_exp_tpu_torch.train.optimizer import build_optimizer

TINY_ARCH = {"dim": 24, "image_size": 8, "patch_size": 4, "temporal_size": 8,
             "temporal_patch_size": 4, "transformer_blocks": 1,
             "dim_head": 4, "heads": 2}
LR = 1e-4
NOISE = 1e-4
TEXT_LEN = 12


def _mlm_draws(key, shape, vocab_size):
    """The draws of JAX's mlm_corrupt(key, ...), in its order."""
    sel, rep, _, tok = jax.random.split(key, 4)
    return tmlm.MLMDraws(
        torch.from_numpy(np.array(jax.random.uniform(sel, shape))),
        torch.from_numpy(np.array(jax.random.uniform(rep, shape))),
        torch.from_numpy(np.array(
            jax.random.randint(tok, shape, 0, vocab_size))).long())


def _augment_draws(key, b):
    """The draws of JAX's random_augment_3d(key, ...), in its order."""
    f, s, bb = jax.random.split(key, 3)
    return tssl.AugmentDraws(
        torch.from_numpy(np.array(jax.random.bernoulli(f, 0.5, (b, 2)))),
        torch.from_numpy(np.array(
            jax.random.normal(s, (b, 1, 1, 1, 1))).reshape(b)),
        torch.from_numpy(np.array(
            jax.random.normal(bb, (b, 1, 1, 1, 1))).reshape(b)))


def _step_draws(seed, step, b, shape, vocab_size):
    """The draws of JAX's image-report step at (seed, step)."""
    rng = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    mlm_rng, ssl_rng = jax.random.split(rng)
    r1, r2 = jax.random.split(ssl_rng)
    return {"mlm": _mlm_draws(mlm_rng, shape, vocab_size),
            "views": (_augment_draws(r1, b), _augment_draws(r2, b))}


# --- MLM ------------------------------------------------------------------------


@pytest.mark.parametrize("prob", [0.15, 0.25, 0.5])
def test_mask_subset_matches_jax_bit_for_bit(prob):
    r = np.random.default_rng(0)
    valid = r.random((6, 20)) > 0.3
    valid[0] = True                 # 20 valid: 0.15 · 20 rounds to 3 in fp32
    valid[1, :] = False             # no valid position
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jmlm.mask_subset_with_prob(key, jnp.asarray(valid), prob))
    scores = torch.from_numpy(np.array(jax.random.uniform(key, (6, 20))))
    got = tmlm.mask_subset_with_prob(scores, torch.from_numpy(valid), prob)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref[0].sum() == np.ceil(np.float32(prob) * np.float32(20))


def test_mlm_corrupt_matches_jax_bit_for_bit():
    r = np.random.default_rng(1)
    ids = r.integers(5, 90, (4, 16)).astype(np.int32)
    ids[2, 11:] = 0                 # padding
    ids[:, 0], ids[1, 5] = 101, 102  # special ids
    key = jax.random.PRNGKey(1)
    kw = dict(mask_token_id=103, pad_id=0, special_ids=(101, 102),
              mask_prob=0.3)
    ref_ids, ref_mask = jmlm.mlm_corrupt(key, jnp.asarray(ids),
                                         vocab_size=100, **kw)
    got_ids, got_mask = tmlm.mlm_corrupt(
        torch.from_numpy(ids).long(), _mlm_draws(key, ids.shape, 100), **kw)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(ref_mask))
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(ref_ids))
    assert not got_mask[2, 11:].any() and not got_mask[:, 0].any()
    assert (got_ids != torch.from_numpy(ids).long()).sum() > 0


def test_mlm_loss_matches_jax():
    r = np.random.default_rng(2)
    logits = r.standard_normal((3, 10, 50)).astype(np.float32)
    targets = r.integers(0, 50, (3, 10))
    mask = r.random((3, 10)) > 0.6
    ref = float(jmlm.mlm_loss(jnp.asarray(logits), jnp.asarray(targets),
                              jnp.asarray(mask)))
    got = tmlm.mlm_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                        torch.from_numpy(mask))
    assert abs(float(got) - ref) < 1e-5
    # no masked position: the count is clamped at 1, the loss is 0
    zero = tmlm.mlm_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                         torch.zeros(3, 10, dtype=torch.bool))
    assert float(zero) == 0.0


def test_draw_mlm_is_a_function_of_the_generator():
    a = tmlm.draw_mlm((2, 7), 30, torch.Generator().manual_seed(5))
    b = tmlm.draw_mlm((2, 7), 30, torch.Generator().manual_seed(5))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a.random_ids.max() < 30 and a.scores.dtype == torch.float32


# --- visual SSL -----------------------------------------------------------------


def test_random_augment_matches_jax():
    video = np.random.default_rng(3).uniform(
        0, 1, (4, 1, 4, 6, 6)).astype(np.float32)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        ref = np.asarray(jssl.random_augment_3d(key, jnp.asarray(video)))
        draws = _augment_draws(key, 4)
        got = tssl.random_augment_3d(torch.from_numpy(video), draws)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)
    # a bf16 volume augments in fp32, as JAX's product promotes it
    out = tssl.random_augment_3d(torch.from_numpy(video).bfloat16(), draws)
    assert out.dtype == torch.float32


def test_nt_xent_and_simsiam_match_jax():
    r = np.random.default_rng(4)
    z1, z2, p1, p2 = (r.standard_normal((6, 8)).astype(np.float32)
                      for _ in range(4))
    t = [torch.from_numpy(x) for x in (z1, z2, p1, p2)]
    for temp in (0.1, 0.5):
        ref = float(jssl.nt_xent_loss(jnp.asarray(z1), jnp.asarray(z2), temp))
        assert abs(float(tssl.nt_xent_loss(t[0], t[1], temp)) - ref) < 1e-5
    ref = float(jssl.simsiam_loss(*(jnp.asarray(x) for x in (p1, z1, p2, z2))))
    p1t = t[2].clone().requires_grad_()
    z1t = t[0].clone().requires_grad_()
    got = tssl.simsiam_loss(p1t, z1t, t[3], t[1])
    assert abs(float(got) - ref) < 1e-5
    got.backward()
    assert z1t.grad is None or not z1t.grad.any()   # stop-gradient targets
    assert p1t.grad.abs().sum() > 0


@pytest.mark.parametrize("kind", ["projection", "prediction"])
def test_ssl_mlps_match_jax(kind):
    jm, tm, d_in = ((jssl.ProjectionMLP(), tssl.ProjectionMLP(24, device="cpu"),
                     24) if kind == "projection" else
                    (jssl.PredictionMLP(), tssl.PredictionMLP(device="cpu"),
                     256))
    x = np.random.default_rng(5).standard_normal((3, d_in)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, d_in)))["params"]
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.1 * np.random.default_rng(6)
        .standard_normal(np.shape(p)).astype(np.float32), params)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    res = tm.load_state_dict({k: torch.from_numpy(v) for k, v in
                              ssl_head_state(params).items()})
    assert not res.missing_keys and not res.unexpected_keys
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(), ref,
                               atol=1e-5)


# --- the image-report step with both terms --------------------------------------


def _config_dict(ssl_type):
    return {"random_seed": 5,
            "trainer": {"lr": LR, "max_grad_norm": 1.0},
            "arch": dict(TINY_ARCH),
            "ct_clip_arch": {"use_mlm": True, "use_visual_ssl": True,
                             "visual_ssl_type": ssl_type,
                             "mlm_mask_token_id": 3,
                             "text_ssl_loss_weight": 0.2,
                             "image_ssl_loss_weight": 0.3}}


def _batch(seed=7):
    r = np.random.default_rng(seed)
    video = r.uniform(0, 1, (2, 1, 8, 8, 8)).astype(np.float32)
    ids = r.integers(4, 128, (2, TEXT_LEN)).astype(np.int32)
    mask = np.ones_like(ids)
    ids[1, 8:], mask[1, 8:] = 0, 0
    return video, ids, mask


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.fixture(scope="module", params=["simsiam", "simclr"])
def two_steps(request):
    """Two JAX image-report steps with both terms (steps 0 and 1)."""
    ssl_type = request.param
    jcfg = jconfig.ExperimentConfig.from_dict(_config_dict(ssl_type))
    params = jax_params(jcfg, seed=11)
    model = jax_build_ctclip(jcfg, bert_config=JaxBertConfig.tiny(),
                             policy=JAX_FP32, dim_latent=DIM_LATENT,
                             attn_impl="pallas", ff_impl="pallas")
    tx = jax_build_optimizer(jcfg.trainer)
    step = jax_make_train_steps(model, tx, jcfg, n_data_shards=1)["imagereport"]
    state = create_train_state(jax.tree_util.tree_map(jnp.asarray, params), tx)
    video, ids, mask = _batch()
    batch = {"image": jnp.asarray(video), "input_ids": jnp.asarray(ids),
             "attention_mask": jnp.asarray(mask)}
    metrics = []
    for _ in range(2):
        state, m = step(state, batch, 0.5)
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(ssl_type=ssl_type, params=params, video=video, ids=ids,
                mask=mask, metrics=metrics,
                new=from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                           state.params)))


def _port(ssl_type, params):
    tcfg = tconfig.ExperimentConfig.from_dict(_config_dict(ssl_type))
    model = build_ctclip(tcfg, BertConfig.tiny(), device="cpu",
                         policy=FP32_POLICY, dim_latent=DIM_LATENT,
                         attn_impl="pallas")
    res = model.load_state_dict({k: torch.from_numpy(v) for k, v in
                                 from_jax_params(params).items()})
    assert not res.missing_keys and not res.unexpected_keys
    return tcfg, model.train()


def test_imagereport_ssl_step_matches_jax(two_steps):
    j = two_steps
    tcfg, model = _port(j["ssl_type"], j["params"])
    assert hasattr(model, "mlm_head") and hasattr(model, "ssl_projector")
    assert hasattr(model, "ssl_predictor") == (j["ssl_type"] == "simsiam")
    opt = build_optimizer(tcfg.trainer, model.parameters())
    step = tsteps.make_train_steps(model, opt, tcfg)["imagereport"]
    batch = {"image": torch.from_numpy(j["video"].copy()),
             "input_ids": torch.from_numpy(j["ids"]).long(),
             "attention_mask": torch.from_numpy(j["mask"])}
    grad_norm = {}
    for s in range(2):
        draws = _step_draws(5, s, 2, j["ids"].shape, 128)
        m = step(batch, 0.5, draws=draws)
        assert set(m) == set(j["metrics"][s]) == {
            "cl_loss", "text_ssl_loss", "image_ssl_loss", "loss"}
        for k, v in m.items():
            assert float(v) == pytest.approx(j["metrics"][s][k], rel=1e-5), k
        for n, p in model.named_parameters():
            grad_norm[n] = max(grad_norm.get(n, 0.0), float(p.grad.norm()))
    # the SSL heads and the MLM head were trained
    for head in ("mlm_head.weight", "ssl_projector.fc0.weight",
                 "ssl_projector.out.weight"):
        assert grad_norm[head] > NOISE, head
    for n, p in model.named_parameters():
        if grad_norm[n] < NOISE:
            assert np.abs(p.detach().numpy() - j["new"][n]).max() <= 2 * LR, n
        else:
            assert _rel(p.detach().numpy(), j["new"][n]) < 1e-5, n


def test_ssl_step_draws_from_seed_and_step():
    """Without draws, a step draws from (random_seed, the optimizer's
    micro-step count) alone."""
    a = tsteps.step_draws(5, 3, (2, 9), 100, mlm=True, ssl=True)
    b = tsteps.step_draws(5, 3, (2, 9), 100, mlm=True, ssl=True)
    c = tsteps.step_draws(5, 4, (2, 9), 100, mlm=True, ssl=True)
    assert all(torch.equal(x, y) for x, y in zip(a["mlm"], b["mlm"]))
    assert not torch.equal(a["mlm"].scores, c["mlm"].scores)
    assert a["views"][0].flips.shape == (2, 2)
    assert not torch.equal(a["views"][0].scale, a["views"][1].scale)
    assert set(tsteps.step_draws(5, 0, (2, 9), 100, mlm=False,
                                 ssl=True)) == {"views"}


def test_unknown_ssl_type_raises():
    tcfg = tconfig.ExperimentConfig.from_dict(_config_dict("byol"))
    model = build_ctclip(tcfg, BertConfig.tiny(), device="cpu",
                         policy=FP32_POLICY, dim_latent=DIM_LATENT)
    opt = build_optimizer(tcfg.trainer, model.parameters())
    with pytest.raises(ValueError, match="byol"):
        tsteps.make_train_steps(model, opt, tcfg)


def _ssl_yaml(tmp_path, name):
    cfg = {"random_seed": 0, "results_folder": str(tmp_path / name),
           "trainer": {"lr": LR, "wd": 0.01, "num_train_steps": 2,
                       "save_model_every": 0},
           "arch": dict(TINY_ARCH), "dim_latent": DIM_LATENT,
           "text_encoder": {"hidden_size": 36, "num_hidden_layers": 1,
                            "num_attention_heads": 3,
                            "intermediate_size": 64,
                            "max_position_embeddings": 128},
           "ct_clip_arch": {"use_mlm": True, "use_visual_ssl": True,
                            "visual_ssl_type": "simclr"},
           "train_data_list": [{"type": "imagereport", "batch_size": 2,
                                "num_workers": 1}]}
    path = tmp_path / f"{name}.yaml"
    path.write_text(json.dumps(cfg))
    return str(path)


def test_resumed_ssl_run_train_draws_what_an_unbroken_one_does(tmp_path,
                                                              monkeypatch):
    """run_train with both terms: 2 steps, then --auto_resume to 3, draws at
    step 3 the masks and views an unbroken 3-step run draws there (they
    follow the saved micro-step count, not a generator advanced across the
    run); the metrics carry both terms."""
    calls = []
    inner = tsteps.step_draws

    def recording(seed, step, *args, **kw):
        out = inner(seed, step, *args, **kw)
        calls.append((seed, step, out))
        return out

    monkeypatch.setattr(tsteps, "step_draws", recording)
    base = ["--synthetic", "4", "--debug"]
    whole = run_train.main(["--config", _ssl_yaml(tmp_path, "whole"), *base,
                            "--steps", "3"], device="cpu")
    unbroken, calls[:] = list(calls), []
    cfg = _ssl_yaml(tmp_path, "parts")
    run_train.main(["--config", cfg, *base], device="cpu")
    resumed = run_train.main(["--config", cfg, *base, "--auto_resume",
                              "--steps", "3"], device="cpu")
    assert [c[:2] for c in unbroken] == [(0, 0), (0, 1), (0, 2)]
    assert [c[:2] for c in calls] == [(0, 0), (0, 1), (0, 2)]
    assert whole.optimizer.count == resumed.optimizer.count == 3
    for (_, _, a), (_, _, b) in zip(unbroken, calls):
        assert all(torch.equal(x, y) for x, y in zip(a["mlm"], b["mlm"]))
        for va, vb in zip(a["views"], b["views"]):
            assert all(torch.equal(x, y) for x, y in zip(va, vb))
    for name in ("whole", "parts"):
        lines = [json.loads(x) for x in open(tmp_path / name /
                                             "metrics.jsonl")]
        assert [d["step"] for d in lines] == [1, 2, 3]
        assert all(np.isfinite(d[k]) for d in lines for k in (
            "ds0_cl_loss", "ds0_text_ssl_loss", "ds0_image_ssl_loss"))
