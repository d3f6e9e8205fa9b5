"""CPU parity of the port's report labeller (text_classifier/ and
``run_text_classifier``) against the JAX package.

Tolerances:

- ``ReduceLROnPlateau``, the sentence shuffle, ``per_label_report`` (its
  CSV byte for byte), ``load_hf_radbert`` against ``convert_hf_radbert`` and
  the CSVs read as pandas reads them: exact;
- ``cosine_annealing_warm_restarts``: bit for bit in each cycle's warmup
  and at over 90% of the cosine's steps; elsewhere within 1e-7 · base_lr,
  as XLA evaluates its own fp32 cosine polynomial (1 ulp off the correctly
  rounded cosine at ~1% of arguments, which no host cosine reproduces) and
  the port the correctly rounded one;
- the classifier's logits (``BertConfig.tiny()``, fp32): 1e-5 absolute;
- ``TextClassifierTrainer``, both schedulers, from JAX's initial parameters:
  each loss 1e-5 relative; every parameter after 3 steps within relative
  L2 1e-5, or, for a tensor whose gradient norm stays below NOISE (rounding
  noise, which Adam turns into a step of up to lr), max |Δ| ≤ 3·lr;
  ``evaluate``'s metrics 1e-5 absolute.
"""

import csv

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from vit_exp_tpu.cli import run_text_classifier as jcli
from vit_exp_tpu.models.bert import BertConfig as JaxBertConfig
from vit_exp_tpu.text_classifier import augmentation as jaug
from vit_exp_tpu.text_classifier import trainer as jtrainer
from vit_exp_tpu.text_classifier.classifier import (RadBertClassifier as
                                                    JaxRadBert)
from vit_exp_tpu.text_classifier.classifier import convert_hf_radbert
from vit_exp_tpu_torch.cli import run_text_classifier
from vit_exp_tpu_torch.models.bert import BertConfig
from vit_exp_tpu_torch.models.convert import from_jax_text_classifier_params
from vit_exp_tpu_torch.text_classifier import augmentation as taug
from vit_exp_tpu_torch.text_classifier import trainer as ttrainer
from vit_exp_tpu_torch.text_classifier.classifier import (RadBertClassifier,
                                                          load_hf_radbert)

LR = 1e-4
NOISE = 1e-4


# --- schedules -------------------------------------------------------------------


@pytest.mark.parametrize("base_lr,first_cycle,warmup",
                         [(2e-5, 1000, 50), (1e-3, 100, 10), (5e-4, 64, 0)])
def test_cawr_matches_jax(base_lr, first_cycle, warmup):
    ref_fn = jax.jit(jax.vmap(jtrainer.cosine_annealing_warm_restarts(
        base_lr, first_cycle, warmup=warmup)))
    steps = np.arange(0, 3 * first_cycle + 7)
    ref = np.asarray(ref_fn(jnp.asarray(steps)))
    fn = ttrainer.cosine_annealing_warm_restarts(base_lr, first_cycle,
                                                 warmup=warmup)
    got = np.asarray([fn(int(s)) for s in steps], np.float32)
    warm = (steps % first_cycle) < warmup
    np.testing.assert_array_equal(got[warm], ref[warm])
    # one fp32 ulp of the cosine (≤ 6e-8) times 0.5·peak, and the rounding
    # of the product and sum after it
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-7 * base_lr)
    assert (got == ref).mean() > 0.9


def test_rlop_matches_jax():
    metrics = [1.0, 0.9, 0.95, 0.95, 0.97, 0.99, 1.0, 1.0, 0.8, 0.85] * 12
    for kw in ({}, {"factor": 0.1, "patience": 1, "min_lr": 1e-6,
                    "base_lr": 1e-3}):
        a, b = jtrainer.ReduceLROnPlateau(**kw), ttrainer.ReduceLROnPlateau(**kw)
        assert [a.step(m) for m in metrics] == [b.step(m) for m in metrics]
    # the floor is an absolute learning rate
    assert b.scale == pytest.approx(1e-6 / 1e-3)


def test_sentence_shuffle_matches_jax():
    texts = ["No effusion. Heart size normal! Lungs clear? Mild atelectasis.",
             "One sentence only.", "   ", ""]
    for p in (0.0, 0.5, 1.0):
        ra, rb = np.random.default_rng(3), np.random.default_rng(3)
        for _ in range(5):
            for t in texts:
                assert (taug.shuffle_sentences_augment(t, p, rng=rb)
                        == jaug.shuffle_sentences_augment(t, p, rng=ra))
    with pytest.raises(ValueError):
        taug.shuffle_sentences_augment("a.", p=1.5)


# --- the classifier --------------------------------------------------------------


def _hf_state_dict(cfg, n_classes, roberta, seed=0):
    """A generated HF RoBERTa (``model.`` prefix, 2 pad-reserved position
    rows) or BERT (``bert.`` prefix) state dict with a pooler and a head."""
    r = np.random.default_rng(seed)
    h, i = cfg.hidden_size, cfg.intermediate_size
    pos = cfg.max_position_embeddings + (2 if roberta else 0)
    sd = {"embeddings.word_embeddings.weight": (cfg.vocab_size, h),
          "embeddings.position_embeddings.weight": (pos, h),
          "embeddings.token_type_embeddings.weight": (cfg.type_vocab_size, h),
          "embeddings.LayerNorm.weight": (h,), "embeddings.LayerNorm.bias": (h,),
          "pooler.dense.weight": (h, h), "pooler.dense.bias": (h,)}
    for layer in range(cfg.num_hidden_layers):
        q = f"encoder.layer.{layer}."
        for name, shape in (("attention.self.query", (h, h)),
                            ("attention.self.key", (h, h)),
                            ("attention.self.value", (h, h)),
                            ("attention.output.dense", (h, h)),
                            ("intermediate.dense", (i, h)),
                            ("output.dense", (h, i))):
            sd[q + name + ".weight"] = shape
            sd[q + name + ".bias"] = shape[:1]
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[q + name + ".weight"] = sd[q + name + ".bias"] = (h,)
    prefix = "model." if roberta else "bert."
    out = {prefix + k: torch.from_numpy(
        (0.1 * r.standard_normal(s)).astype(np.float32)) for k, s in sd.items()}
    out[prefix + "embeddings.position_ids"] = torch.arange(pos)[None]
    out["classifier.weight"] = torch.from_numpy(
        r.standard_normal((n_classes, h)).astype(np.float32))
    out["classifier.bias"] = torch.zeros(n_classes)
    return out


@pytest.mark.parametrize("roberta", [True, False])
def test_load_hf_radbert_matches_jax(roberta):
    cfg = BertConfig(vocab_size=99, hidden_size=32, num_hidden_layers=2,
                     num_attention_heads=4, intermediate_size=48,
                     max_position_embeddings=38, type_vocab_size=1)
    jcfg = JaxBertConfig(vocab_size=99, hidden_size=32, num_hidden_layers=2,
                         num_attention_heads=4, intermediate_size=48,
                         max_position_embeddings=38, type_vocab_size=1)
    sd = _hf_state_dict(cfg, 3, roberta)
    jparams = convert_hf_radbert(sd, jcfg, 3, roberta=roberta)
    ref = from_jax_text_classifier_params(jparams)
    got = load_hf_radbert(sd, cfg, 3, roberta=roberta)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)
    model = RadBertClassifier(cfg, 3, device="cpu")
    res = model.load_state_dict(got)
    assert not res.missing_keys and not res.unexpected_keys
    ids = np.random.default_rng(1).integers(2, 99, (2, 9))
    mask = np.ones_like(ids)
    mask[1, 6:] = 0
    jlogits = np.asarray(JaxRadBert(jcfg, n_classes=3).apply(
        {"params": jparams}, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        logits = model(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(logits.numpy(), jlogits, atol=1e-5)
    with pytest.raises(ValueError):
        load_hf_radbert(sd, cfg, 4, roberta=roberta)


@pytest.mark.parametrize("scheduler", ["cawr", "rlop"])
def test_text_classifier_steps_match_jax(scheduler, tmp_path):
    jt = jtrainer.TextClassifierTrainer(
        JaxRadBert(JaxBertConfig.tiny(), n_classes=4), lr=LR,
        scheduler=scheduler, first_cycle=60, results_folder=str(tmp_path / "j"))
    model = RadBertClassifier(BertConfig.tiny(), 4, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           from_jax_text_classifier_params(
                               jax.tree_util.tree_map(np.asarray, nn.unbox(jt.params))
                           ).items()})
    tt = ttrainer.TextClassifierTrainer(model, lr=LR, scheduler=scheduler,
                                        first_cycle=60,
                                        results_folder=str(tmp_path / "t"))
    r = np.random.default_rng(2)
    ids = r.integers(1, 128, (4, 10)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[2, 6:] = 0
    labels = (r.random((4, 4)) > 0.5).astype(np.float32)
    # move the scale off 1 first, so the rlop route is read
    if scheduler == "rlop":
        for trainer in (jt, tt):
            trainer._lr_scale = 0.5
    grad_norm = {}
    for _ in range(3):
        ref = jt.fit_batch(ids, mask, labels)
        got = tt.fit_batch(ids, mask, labels)
        assert got == pytest.approx(ref, rel=1e-5)
        for n, p in model.named_parameters():
            grad_norm[n] = max(grad_norm.get(n, 0.0), float(p.grad.norm()))
    new = from_jax_text_classifier_params(
        jax.tree_util.tree_map(np.asarray, nn.unbox(jt.params)))
    for n, p in model.named_parameters():
        a = p.detach().numpy().astype(np.float64)
        if grad_norm[n] < NOISE:
            assert np.abs(a - new[n]).max() <= 3 * LR, n
        else:
            assert (np.linalg.norm(a - new[n])
                    / np.linalg.norm(new[n])) < 1e-5, n
    batches = [(ids[:2], mask[:2], labels[:2]), (ids[2:], mask[2:], labels[2:])]
    jm, tm = jt.evaluate(batches), tt.evaluate(batches)
    assert jm.keys() == tm.keys()
    for k in jm:
        assert tm[k] == pytest.approx(jm[k], abs=1e-5), k
    assert tt._lr_scale == jt._lr_scale
    # best-loss snapshots and early stop
    tt.early_stop = 2
    assert not tt.end_epoch(0.5) and tt.best_loss == 0.5
    path = tmp_path / "t" / "best_model.pt"
    assert path.exists()
    snap = {k: v.clone() for k, v in tt.best_state.items()}
    tt.fit_batch(ids, mask, labels)
    assert not tt.end_epoch(0.7) and tt.end_epoch(0.6)
    fresh = RadBertClassifier(BertConfig.tiny(), 4, device="cpu")
    ttrainer.TextClassifierTrainer(fresh, results_folder=str(tmp_path / "f")
                                   ).load(str(path))
    assert all(torch.equal(fresh.state_dict()[k], snap[k]) for k in snap)


def test_per_label_report_matches_jax(tmp_path):
    r = np.random.default_rng(0)
    y_true = r.integers(0, 2, (40, 3))
    y_prob = np.clip(y_true + r.normal(0, 0.4, (40, 3)), 0, 1)
    y_true[:, 2] = 0
    names = ["a", "b", "c"]
    ref = jtrainer.per_label_report(y_prob, y_true, names,
                                    out_csv=str(tmp_path / "j.csv"))
    got = ttrainer.per_label_report(y_prob, y_true, names,
                                    out_csv=str(tmp_path / "t.csv"))
    assert got == ref
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text()


# --- run_text_classifier ---------------------------------------------------------


def _csvs(tmp_path, n=12, n_labels=3, missing_label=False):
    r = np.random.default_rng(5)
    words = ["effusion", "nodule", "clear", "opacity", "normal", "heart"]
    reports = tmp_path / "reports.csv"
    labels = tmp_path / "labels.csv"
    with open(reports, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["VolumeName", "Findings_EN"])
        for i in range(n):
            text = ". ".join(" ".join(r.choice(words, 3)) for _ in range(3))
            w.writerow([f"train_{i}_a_1.nii.gz", "" if i == 3 else text + "."])
    with open(labels, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["VolumeName"] + [f"L{j}" for j in range(n_labels)])
        for i in range(n):
            cells = [str(int(x)) for x in r.integers(0, 2, n_labels)]
            if i == 5 and missing_label:
                cells[1] = ""
            w.writerow([f"train_{i}_a_1.nii.gz", *cells])
    return str(reports), str(labels)


def test_load_frames_read_what_pandas_reads(tmp_path):
    reports, labels = _csvs(tmp_path, missing_label=True)
    names, texts, y, cols = run_text_classifier.load_frames(reports, labels)
    jnames, jtexts, jy, jcols = jcli._load_frames(reports, labels)
    assert names == jnames and texts == jtexts and cols == jcols
    assert texts[3] == "" and np.isnan(y[5, 1])
    np.testing.assert_array_equal(y, jy)
    assert y.dtype == jy.dtype == np.float32


def test_run_text_classifier_train_then_infer(tmp_path, capsys):
    reports, labels = _csvs(tmp_path)
    results = tmp_path / "results"
    base = ["--reports", reports, "--batch_size", "4", "--max_len", "16",
            "--results_folder", str(results)]
    trainer = run_text_classifier.main(
        ["train", "--labels", labels, "--epochs", "2", "--augment", "1",
         "--scheduler", "rlop", *base], device="cpu")
    out = capsys.readouterr().out
    assert "epoch 1: train_loss" in out and (results / "best_model.pt").exists()
    assert np.isfinite(trainer.best_loss) and trainer.step == 4
    pred = tmp_path / "pred" / "predictions.csv"
    # the label columns give the head's width and the CSV's columns, as in
    # the JAX CLI
    probs = run_text_classifier.main(["infer", "--labels", labels, "--out",
                                      str(pred), *base], device="cpu")
    assert "loaded weights from" in capsys.readouterr().out
    assert probs.shape == (12, 3) and np.isfinite(probs).all()
    # the CSV pandas writes for the same values, byte for byte
    df = pd.DataFrame(probs, columns=["L0", "L1", "L2"])
    names = run_text_classifier.load_frames(reports)[0]
    df.insert(0, "VolumeName", names)
    assert pred.read_text() == df.to_csv(index=False)
    back = pd.read_csv(pred)
    np.testing.assert_array_equal(back.iloc[:, 1:].to_numpy(np.float32), probs)


def test_run_text_classifier_help_and_errors(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        run_text_classifier.parse_args(["--help"])
    assert e.value.code == 0
    assert "--scheduler" in capsys.readouterr().out
    reports, _ = _csvs(tmp_path)
    for argv in (["fit", "--reports", reports], ["train"],
                 ["train", "--reports", reports, "--scheduler", "step"]):
        with pytest.raises(SystemExit) as e:
            run_text_classifier.main(argv, device="cpu")
        assert e.value.code == 2, argv
    with pytest.raises(ValueError, match="--labels"):
        run_text_classifier.main(["train", "--reports", reports, "--max_len",
                                  "8"], device="cpu")
