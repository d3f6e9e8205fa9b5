"""CPU parity of the port's fine-tuning (LiPro, VocabFine, the reference
export and ``run_finetune``) against the JAX package, on the same numpy
inputs.

The models run the tiny arch of the JAX package's tests/test_finetune.py
(dim 24, head dim 4, ``BertConfig.tiny()``) in fp32, with JAX's perturbed
parameters carried over by ``from_jax_params``; the probe head's parameters
are copied from JAX's and its dropout keep mask is the one flax's Dropout
draws from the trainer's key.  Both trainers use optax.adamw's defaults (b2
0.999, decay on every parameter, lr 0 on the first warmup update).
Tolerances:

- ``weighted_bce_with_logits``: 1e-6 absolute;
- the probe head after each of 3 steps, the first at lr 0 (bit for bit
  unchanged): relative L2 1e-5 per tensor; its losses 1e-5 relative;
- VocabFine, with and without ``fix_text_encoder``: each loss 1e-5
  relative; every parameter after 2 steps within relative L2 1e-5, or, for
  a tensor whose gradient norm stays below NOISE on both steps (rounding
  noise, which Adam turns into a step of up to lr), max |Δ| ≤ 2·lr;
- ``to_reference_state_dict``: key for key and bit for bit JAX's
  ``export_ctclip_state_dict``, with and without ``like=``;
- the probe's inference artifacts: 1e-5 absolute on probabilities;
- ``run_finetune vocabfine`` from one reference .pt in both packages: the
  exported checkpoints as the VocabFine step above, the keys the export
  synthesizes bit for bit the original's.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_models import DIM_LATENT, jax_params
from tests.test_torch_slice import _tokenizer
from vit_exp_tpu.cli import run_finetune as jft
from vit_exp_tpu.core import config as jconfig
from vit_exp_tpu.core.precision import FP32_POLICY as JAX_FP32
from vit_exp_tpu.data import synthetic as jsynthetic
from vit_exp_tpu.finetune import lipro as jlipro
from vit_exp_tpu.finetune.vocabfine import VocabFineTrainer as JaxVocabFine
from vit_exp_tpu.models import factory as jfactory
from vit_exp_tpu.models.bert import BertConfig as JaxBertConfig
from vit_exp_tpu.models.convert import (export_ctclip_state_dict,
                                        save_ctclip_checkpoint)
from vit_exp_tpu_torch.cli import run_finetune, run_zero_shot_cls
from vit_exp_tpu_torch.core import config as tconfig
from vit_exp_tpu_torch.core.precision import FP32_POLICY
from vit_exp_tpu_torch.data import synthetic as tsynthetic
from vit_exp_tpu_torch.finetune import lipro as tlipro
from vit_exp_tpu_torch.finetune.vocabfine import VocabFineTrainer
from vit_exp_tpu_torch.models import factory as tfactory
from vit_exp_tpu_torch.models.bert import BertConfig
from vit_exp_tpu_torch.models.convert import (from_jax_params,
                                              load_reference_state_dict,
                                              to_reference_state_dict)
from vit_exp_tpu_torch.models.factory import build_ctclip

TINY_ARCH = {"dim": 24, "image_size": 8, "patch_size": 4, "temporal_size": 8,
             "temporal_patch_size": 4, "transformer_blocks": 1,
             "dim_head": 4, "heads": 2}
LR = 1e-4
NOISE = 1e-4


def _configs(**ct_clip_arch):
    d = {"arch": dict(TINY_ARCH), "ct_clip_arch": ct_clip_arch}
    return (jconfig.ExperimentConfig.from_dict(d),
            tconfig.ExperimentConfig.from_dict(d))


def _jax_model(jcfg):
    return jfactory.build_ctclip(jcfg, bert_config=JaxBertConfig.tiny(),
                                 policy=JAX_FP32, dim_latent=DIM_LATENT)


def _port_model(tcfg, params):
    model = build_ctclip(tcfg, BertConfig.tiny(), device="cpu",
                         policy=FP32_POLICY, dim_latent=DIM_LATENT,
                         attn_impl="pallas")
    res = model.load_state_dict({k: torch.from_numpy(v) for k, v in
                                 from_jax_params(params).items()})
    assert not res.missing_keys and not res.unexpected_keys
    return model


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _video(b, seed):
    return np.random.default_rng(seed).uniform(
        0, 1, (b, 1, 8, 8, 8)).astype(np.float32)


# --- LiPro -----------------------------------------------------------------------


def test_weighted_bce_matches_jax():
    r = np.random.default_rng(0)
    x = r.standard_normal((4, 18)).astype(np.float32) * 3
    y = (r.random((4, 18)) > 0.5).astype(np.float32)
    w = jlipro.LIPRO_POS_WEIGHTS
    ref = float(jlipro.weighted_bce_with_logits(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(w)))
    got = tlipro.weighted_bce_with_logits(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(w))
    assert abs(float(got) - ref) < 1e-6
    np.testing.assert_array_equal(tlipro.LIPRO_POS_WEIGHTS, w)


def _jax_keep_mask(jt, drop, dim):
    """The keep mask flax's Dropout draws inside LiProHead from ``drop``."""
    _, inter = jt.head.apply(
        {"params": jt.head_params}, jnp.ones((2, dim)), train=True,
        rngs={"dropout": drop}, capture_intermediates=True)
    return np.asarray(inter["intermediates"]["Dropout_0"]["__call__"][0]) != 0


def test_lipro_steps_match_jax():
    jcfg, tcfg = _configs()
    params = jax_params(jcfg, seed=3)
    jt = jlipro.LiProTrainer(_jax_model(jcfg), params, lr=LR * 10, wd=0.1,
                             warmup_steps=500, total_steps=30, seed=4)
    model = _port_model(tcfg, params)
    frozen = {k: v.clone() for k, v in model.state_dict().items()}
    tt = tlipro.LiProTrainer(model, lr=LR * 10, wd=0.1, warmup_steps=500,
                             total_steps=30)
    tt.head.load_state_dict({
        "classifier.weight": torch.from_numpy(
            np.asarray(jt.head_params["classifier"]["kernel"]).T.copy()),
        "classifier.bias": torch.from_numpy(
            np.asarray(jt.head_params["classifier"]["bias"]))})
    video = _video(2, 5)
    labels = (np.random.default_rng(6).random((2, 18)) > 0.6).astype(
        np.float32)
    lat = tt.image_latents(video)
    np.testing.assert_allclose(lat.numpy(), np.asarray(jt.image_latents(video)),
                               atol=1e-5)
    np.testing.assert_allclose(lat.norm(dim=-1).numpy(), 1.0, atol=1e-6)
    start = {k: v.clone() for k, v in tt.head.state_dict().items()}
    for step in range(3):
        _, drop = jax.random.split(jt._rng)
        mask = _jax_keep_mask(jt, drop, DIM_LATENT)
        assert 0 < mask.mean() < 1
        ref = jt.fit_batch(video, labels)
        got = tt.fit_batch(video, labels, keep_mask=mask)
        assert got == pytest.approx(ref, rel=1e-5)
        new = tt.head.state_dict()
        jk = jt.head_params["classifier"]
        if step == 0:   # lr 0 at the first warmup update
            assert all(torch.equal(new[k], start[k]) for k in start)
        assert _rel(new["classifier.weight"].numpy(),
                    np.asarray(jk["kernel"]).T) < 1e-5
        assert _rel(new["classifier.bias"].numpy(), jk["bias"]) < 1e-5
    assert not torch.equal(tt.head.state_dict()["classifier.weight"],
                           start["classifier.weight"])
    # the tower is frozen: no gradient, no change
    assert all(p.grad is None for p in model.parameters())
    assert all(torch.equal(frozen[k], v) for k, v in model.state_dict().items())
    # an undrawn mask comes from the trainer's own generator
    assert np.isfinite(tt.fit_batch(video, labels))


def test_lipro_save_load_infer_matches_jax(tmp_path):
    jcfg, tcfg = _configs()
    params = jax_params(jcfg, seed=3)
    jt = jlipro.LiProTrainer(_jax_model(jcfg), params, num_classes=5,
                             total_steps=10, seed=2)
    tt = tlipro.LiProTrainer(_port_model(tcfg, params), num_classes=5,
                             total_steps=10, seed=2)
    tt.head.load_state_dict({
        "classifier.weight": torch.from_numpy(
            np.asarray(jt.head_params["classifier"]["kernel"]).T.copy()),
        "classifier.bias": torch.from_numpy(
            np.asarray(jt.head_params["classifier"]["bias"]))})
    path = tmp_path / "head.pt"
    tt.save(str(path))
    other = tlipro.LiProTrainer(tt.clip_model, num_classes=5, seed=9)
    video = _video(2, 7)
    assert not np.allclose(other.predict(video), tt.predict(video))
    other.load(str(path))
    np.testing.assert_array_equal(other.predict(video), tt.predict(video))
    jds = jsynthetic.SyntheticInferenceDataset(5, arch=jcfg.arch)
    tds = tsynthetic.SyntheticInferenceDataset(5, arch=tcfg.arch)
    jt.infer(jds, results_folder=str(tmp_path / "jax"), batch_size=2)
    res = other.infer(tds, results_folder=str(tmp_path / "port"),
                      batch_size=2)
    pred = np.load(tmp_path / "port" / "predicted.npz")["arr_0"]
    ref = np.load(tmp_path / "jax" / "predicted.npz")["arr_0"]
    assert pred.shape == (5, 5)
    np.testing.assert_allclose(pred, ref, atol=1e-5)
    np.testing.assert_array_equal(
        np.load(tmp_path / "port" / "labels.npz")["arr_0"],
        np.load(tmp_path / "jax" / "labels.npz")["arr_0"])
    assert ((tmp_path / "port" / "accessions.txt").read_text()
            == (tmp_path / "jax" / "accessions.txt").read_text())
    direct = np.concatenate([other.predict(tds[i]["image"][None])
                             for i in range(5)])
    np.testing.assert_allclose(pred, direct, rtol=1e-6, atol=1e-7)
    assert res["volumes_per_sec"] > 0 and "mean_auc" in res


# --- VocabFine -------------------------------------------------------------------


@pytest.mark.parametrize("fix_text", [False, True])
def test_vocabfine_steps_match_jax(fix_text):
    jcfg, tcfg = _configs(fix_text_encoder=fix_text)
    params = jax_params(jcfg, seed=8)
    tok = _tokenizer(seed=1)
    paths = ["Cardiomegaly", "Emphysema", "Atelectasis"]
    jt = JaxVocabFine(_jax_model(jcfg), params, tok, pathologies=paths,
                      lr=LR, wd=0.01, warmup_steps=100, total_steps=20,
                      max_text_len=12)
    model = _port_model(tcfg, params)
    tt = VocabFineTrainer(model, tok, pathologies=paths, lr=LR, wd=0.01,
                          warmup_steps=100, total_steps=20, max_text_len=12)
    grad_norm = {}
    for step, labels in enumerate(([1.0, 0.0, 1.0], [0.0, 1.0, 1.0])):
        video = _video(1, 10 + step)
        labels = np.asarray(labels, np.float32)
        ref = jt.fit_batch(video, labels)
        got = tt.fit_batch(video, labels)
        assert got == pytest.approx(ref, rel=1e-5)
        for n, p in model.named_parameters():
            g = 0.0 if p.grad is None else float(p.grad.norm())
            grad_norm[n] = max(grad_norm.get(n, 0.0), g)
    new = from_jax_params(jax.tree_util.tree_map(np.asarray, jt.params))
    text = [n for n in grad_norm if n.startswith("text_transformer.")]
    if fix_text:   # BERT moves by the decay alone
        assert all(grad_norm[n] == 0.0 for n in text)
    else:
        assert max(grad_norm[n] for n in text) > 0.0
    for n, p in model.named_parameters():
        if grad_norm[n] < NOISE:
            assert np.abs(p.detach().numpy() - new[n]).max() <= 2 * LR, n
        else:
            assert _rel(p.detach().numpy(), new[n]) < 1e-5, n


# --- the reference export --------------------------------------------------------


def _export_like(sd):
    """An "original" checkpoint: the export with its synthesized keys
    holding other values, one key the port cannot derive, one key of the
    export left out, and the "module." prefix."""
    r = np.random.default_rng(12)
    like = {}
    for k, v in sd.items():
        if k.endswith(("pos_embed", "context_norm.gamma", "to_pixels.0.weight",
                       "_extra.weight", "pooler.dense.bias")):
            v = v + r.standard_normal(v.shape).astype(np.float32)
        like["module." + k] = torch.from_numpy(np.array(v))
    like["module.text_transformer.embeddings.position_ids"] = torch.arange(
        64)[None]
    del like["module.seg_head.0.bias"]
    return like


def test_to_reference_state_dict_matches_jax_export():
    jcfg, tcfg = _configs(use_seg=True, use_mlm=True, use_visual_ssl=True)
    params = jax_params(jcfg, seed=13)
    model = _port_model(tcfg, params)
    kw = dict(grid=(2, 2, 2), heads=TINY_ARCH["heads"],
              bert_config=JaxBertConfig.tiny())
    ref = export_ctclip_state_dict(params, **kw)
    got = to_reference_state_dict(model)
    assert list(got) == list(ref) or set(got) == set(ref)
    assert not any(k.startswith(("mlm_head", "ssl_")) for k in got)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    like = _export_like(ref)
    ref_like = export_ctclip_state_dict(params, like=like, **kw)
    got_like = to_reference_state_dict(model, like=like)
    assert list(got_like) == list(ref_like)
    for k in ref_like:
        np.testing.assert_array_equal(got_like[k], ref_like[k], err_msg=k)
    assert "seg_head.0.bias" not in got_like
    np.testing.assert_array_equal(
        got_like["visual_transformer.pos_embed"],
        like["module.visual_transformer.pos_embed"].numpy())


def test_reference_export_reloads_into_the_port():
    jcfg, tcfg = _configs()
    params = jax_params(jcfg, seed=14)
    model = _port_model(tcfg, params)
    sd = to_reference_state_dict(model)
    fresh = build_ctclip(tcfg, BertConfig.tiny(), device="cpu",
                         policy=FP32_POLICY, dim_latent=DIM_LATENT, seed=3)
    load_reference_state_dict(fresh, sd)
    a, b = model.state_dict(), fresh.state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


# --- run_finetune ----------------------------------------------------------------


TEXT_ENCODER = {"hidden_size": 36, "num_hidden_layers": 1,
                "num_attention_heads": 3, "intermediate_size": 64,
                "max_position_embeddings": 512}


def _yaml(tmp_path):
    path = tmp_path / "cfg.yaml"
    path.write_text(json.dumps({"trainer": {"lr": 1e-4},
                                "arch": dict(TINY_ARCH),
                                "dim_latent": DIM_LATENT,
                                "text_encoder": TEXT_ENCODER}))
    return str(path)


def test_run_finetune_lipro_train_save_infer(tmp_path, capsys):
    cfg = _yaml(tmp_path)
    head = tmp_path / "head.pt"
    trainer = run_finetune.main(
        ["lipro", "--config", cfg, "--synthetic", "4", "--epochs", "2",
         "--batch_size", "2", "--save_path", str(head)], device="cpu")
    assert head.exists() and trainer.step == 4
    assert "epoch 1: loss" in capsys.readouterr().out
    out = tmp_path / "out"
    res = run_finetune.main(
        ["lipro", "--config", cfg, "--infer", "--load_head", str(head),
         "--synthetic", "4", "--batch_size", "2", "--results_folder",
         str(out)], device="cpu")
    assert (out / "aurocs.json").exists() and "mean_auc" in res
    pred = np.load(out / "predicted.npz")["arr_0"]
    assert pred.shape == (4, 18)
    # the saved head scores as the trained one
    direct = trainer.predict(
        np.stack([tsynthetic.SyntheticInferenceDataset(
            4, arch=tconfig.load_config(cfg).arch)[i]["image"]
            for i in range(4)]))
    np.testing.assert_allclose(pred, direct, rtol=1e-5, atol=1e-6)


def test_run_finetune_vocabfine_matches_jax_then_scores(tmp_path,
                                                        monkeypatch):
    """Both CLIs fine-tune one reference .pt (fp32) for one step on one
    synthetic volume; the port's export holds to JAX's, and
    run_zero_shot_cls --torch_ckpt scores it."""
    cfg = _yaml(tmp_path)
    jcfg = jconfig.load_config(cfg)
    bert = jfactory.bert_config_for(jcfg, type("T", (), {"vocab_size":
                                                         30522})())
    import flax.linen as nn
    from vit_exp_tpu.models.ctclip import CTCLIP as JaxCTCLIP

    jm = jfactory.build_ctclip(jcfg, bert_config=bert, policy=JAX_FP32)
    params = nn.unbox(jm.init(jax.random.PRNGKey(1), jnp.zeros(
        (1, 1, 8, 8, 8)), jnp.ones((1, 8), jnp.int32),
        method=JaxCTCLIP.init_all))["params"]
    src = tmp_path / "CTClip.src.pt"
    save_ctclip_checkpoint(str(src), jax.device_get(params), grid=(2, 2, 2),
                           heads=TINY_ARCH["heads"], bert_config=bert)
    monkeypatch.setattr(jfactory, "build_ctclip", functools.partial(
        jfactory.build_ctclip, policy=JAX_FP32))
    monkeypatch.setattr(tfactory, "build_ctclip", functools.partial(
        tfactory.build_ctclip, policy=FP32_POLICY))
    argv = ["vocabfine", "--config", cfg, "--pretrained", str(src),
            "--torch_ckpt", "--synthetic", "2", "--max_text_len", "16",
            "--lr", "1e-4"]
    jft.main(argv + ["--save_path", str(tmp_path / "jax.pt")])
    run_finetune.main(argv + ["--save_path", str(tmp_path / "port.pt")],
                      device="cpu")
    load = functools.partial(torch.load, map_location="cpu",
                             weights_only=True)
    ref, got, orig = (load(str(tmp_path / n))
                      for n in ("jax.pt", "port.pt", "CTClip.src.pt"))
    assert list(got) == list(ref) == list(orig)
    moved = 0
    for k in ref:
        if k in {"module." + s for s in (
                "visual_transformer.pos_embed",
                "text_transformer.pooler.dense.weight",
                "to_text_latent_extra.weight")}:
            assert torch.equal(got[k], orig[k]), k
        d = float((got[k].double() - ref[k].double()).abs().max())
        assert d <= 2 * LR or _rel(got[k], ref[k]) < 1e-5, k
        moved += not torch.equal(got[k], orig[k])
    assert moved > 10
    res = run_zero_shot_cls.main(
        ["--config", cfg, "--torch_ckpt", "--model_path",
         str(tmp_path / "port.pt"), "--synthetic", "2", "--results_folder",
         str(tmp_path / "zs")], device="cpu")
    probs = np.load(tmp_path / "zs" / "port.pt" / "predicted.npz")["arr_0"]
    assert probs.shape == (2, 18) and np.isfinite(probs).all()
    assert "port.pt" in res


def test_run_finetune_help_and_argument_errors(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        run_finetune.parse_args(["--help"])
    assert e.value.code == 0
    assert "--load_head" in capsys.readouterr().out
    cfg = _yaml(tmp_path)
    for argv in (["lipro", "--config", cfg, "--infer"],
                 ["vocabfine", "--config", cfg, "--infer", "--load_head",
                  "h.pt"],
                 ["lipro", "--config", cfg, "--torch_ckpt"],
                 ["probe", "--config", cfg],
                 ["lipro"]):
        with pytest.raises(SystemExit) as e:
            run_finetune.main(argv, device="cpu")
        assert e.value.code == 2, argv
