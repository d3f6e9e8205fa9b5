"""CPU parity of the port's eval engine and in-training hooks against the
JAX package: ``evaluate_internal`` (the port's rank AUROC against JAX's
sklearn one), ``save_inference_artifacts``, ``CTCLIP.forward_infer``,
``SyntheticInferenceDataset``, ``ZeroShotClassifier.infer`` and
``set_params``, and ``build_eval_hooks``.

Tolerances: AUROCs within 1e-12 (the same rank statistic; sklearn sums
trapezoids, the port average ranks); ``forward_infer`` within 1e-6 and the
engine's probabilities within 1e-5 under FP32_POLICY (fp32 on both sides,
only the summation order differs; the JAX engine in its serving
configuration with Pallas in interpret mode); data bytes exact.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_config
from tests.test_metrics import _preds
from tests.test_torch_models import jax_params, jax_serving_model, port_model
from tests.test_torch_slice import PATHS, TEXT_LEN, _tokenizer
from vit_exp_tpu.data import synthetic as jsynthetic
from vit_exp_tpu.eval import metrics as jmetrics
from vit_exp_tpu.eval import zero_shot as jzs
from vit_exp_tpu.models.ctclip import CTCLIP as JaxCTCLIP
from vit_exp_tpu_torch.core import config as tconfig
from vit_exp_tpu_torch.data import synthetic as tsynthetic
from vit_exp_tpu_torch.eval import hooks as thooks
from vit_exp_tpu_torch.eval import metrics as tmetrics
from vit_exp_tpu_torch.eval import zero_shot as tzs


def _port_arch(arch):
    return tconfig.ArchConfig(**dataclasses.asdict(arch))


def _cases():
    """Seeded predictions of tests/test_metrics.py, with ties, a
    single-class label and every label single-class."""
    p, y = _preds(n=60, c=4, seed=3)
    tied = np.round(p * 4) / 4                       # many ties
    one = y.copy()
    one[:, 1] = 1.0                                  # a single-class label
    return {"plain": (p, y), "ties": (tied, y), "single_class": (p, one),
            "all_single_class": (p, np.ones_like(y)),
            "scores_all_tied": (np.full_like(p, 0.5), y)}


@pytest.mark.parametrize("case", sorted(_cases()))
def test_evaluate_internal_matches_jax(case):
    p, y = _cases()[case]
    labels = ["a", "b", "c", "d"]
    got = tmetrics.evaluate_internal(p, y, labels)
    ref = jmetrics.evaluate_internal(p, y, labels)
    assert list(got) == list(ref)
    for k in ref:
        if np.isnan(ref[k]):
            assert np.isnan(got[k]), k
        else:
            assert got[k] == pytest.approx(ref[k], abs=1e-12), k


def test_rank_auroc_is_the_mann_whitney_statistic():
    truth = np.array([0, 0, 1, 1, 0, 1, 1, 0], np.float32)
    score = np.array([0.1, 0.4, 0.4, 0.8, 0.2, 0.9, 0.1, 0.3])
    pairs = [(s1 > s0) + 0.5 * (s1 == s0)
             for s1 in score[truth == 1] for s0 in score[truth == 0]]
    assert tmetrics.rank_auroc(truth, score) == pytest.approx(
        np.mean(pairs), abs=1e-15)
    assert np.isnan(tmetrics.rank_auroc(np.ones(4), np.arange(4.0)))


def test_inference_artifacts_match_jax(tmp_path):
    p, y = _preds(n=12, c=3, seed=5)
    res = {**jmetrics.evaluate_internal(p, y, ["a", "b", "c"]),
           "volumes_per_sec": 3.5}
    accs = [f"v{i}.nii.gz" for i in range(12)]
    tmetrics.save_inference_artifacts(str(tmp_path / "t"), p, y, accs, res)
    jmetrics.save_inference_artifacts(str(tmp_path / "j"), p, y, accs, res)
    names = sorted(f.name for f in (tmp_path / "j").iterdir())
    assert names == sorted(f.name for f in (tmp_path / "t").iterdir())
    for name in names:
        if name.endswith(".npz"):
            a, b = np.load(tmp_path / "t" / name), np.load(tmp_path / "j" / name)
            assert a.files == b.files
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])
        else:
            assert ((tmp_path / "t" / name).read_text()
                    == (tmp_path / "j" / name).read_text()), name


def test_forward_infer_matches_jax():
    config = _flagship_config(tiny=True)
    params = jax_params(config, seed=5)
    rng = np.random.default_rng(6)
    text, img = (rng.standard_normal((5, 16)).astype(np.float32)
                 for _ in range(2))
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    img /= np.linalg.norm(img, axis=-1, keepdims=True)
    ref = jax_serving_model(config).apply({"params": params}, text, img,
                                          method=JaxCTCLIP.forward_infer)
    got = port_model(config, params).forward_infer(torch.from_numpy(text),
                                                   torch.from_numpy(img))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed,n_labels", [(0, 18), (3, 4)])
def test_synthetic_inference_dataset_matches_jax(seed, n_labels):
    arch = _flagship_config(tiny=True).arch
    ref = jsynthetic.SyntheticInferenceDataset(5, arch=arch, seed=seed,
                                               n_labels=n_labels)
    got = tsynthetic.SyntheticInferenceDataset(5, arch=_port_arch(arch),
                                               seed=seed, n_labels=n_labels)
    assert len(got) == len(ref)
    for i in (0, 1, 4):
        a, b = got[i], ref[i]
        assert a.keys() == b.keys()
        for k in b:
            if isinstance(b[k], np.ndarray):
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                assert a[k].tobytes() == b[k].tobytes(), (i, k)
            else:
                assert a[k] == b[k], (i, k)


@pytest.fixture(scope="module")
def engines():
    config = _flagship_config(tiny=True)
    params = jax_params(config, seed=3)
    ref = jzs.ZeroShotClassifier(
        jax_serving_model(config), params, _tokenizer(), pathologies=PATHS,
        max_text_len=TEXT_LEN, batch_size=2)
    eng = tzs.ZeroShotClassifier(port_model(config, params), _tokenizer(),
                                 pathologies=PATHS, max_text_len=TEXT_LEN,
                                 batch_size=2)
    return config, ref, eng


@pytest.mark.parametrize("n,limit", [(5, None), (7, 3)])
def test_infer_matches_jax_engine(engines, tmp_path, n, limit):
    """Five volumes in batches of two (a tail of one) and a limit of three
    (a tail of one after a full batch): probabilities within 1e-5 and the
    same per-label AUROCs; the artifacts hold the same predictions."""
    config, ref, eng = engines
    ds = tsynthetic.SyntheticInferenceDataset(n, arch=_port_arch(config.arch),
                                              seed=2)
    jds = jsynthetic.SyntheticInferenceDataset(n, arch=config.arch, seed=2)
    res_ref = ref.infer(jds, results_folder=str(tmp_path / "j"), limit=limit,
                        num_workers=2)
    res = eng.infer(ds, results_folder=str(tmp_path / "t"), limit=limit,
                    num_workers=2)
    assert set(res) == set(res_ref)
    assert res["volumes_per_sec"] > 0
    for k in res_ref:
        if k.endswith("_auc"):
            np.testing.assert_allclose(res[k], res_ref[k], atol=1e-12,
                                       equal_nan=True)
    pred = np.load(tmp_path / "t" / "predicted_weights.npz")["data"]
    pred_ref = np.load(tmp_path / "j" / "predicted_weights.npz")["data"]
    assert pred.shape == pred_ref.shape == (limit or n, len(PATHS))
    np.testing.assert_allclose(pred, pred_ref, atol=1e-5)
    assert ((tmp_path / "t" / "accessions.txt").read_bytes()
            == (tmp_path / "j" / "accessions.txt").read_bytes())
    np.testing.assert_array_equal(
        np.load(tmp_path / "t" / "labels_weights.npz")["data"],
        np.load(tmp_path / "j" / "labels_weights.npz")["data"])
    saved = json.loads((tmp_path / "t" / "aurocs.json").read_text())
    assert saved.keys() == res.keys()


def test_infer_leaves_mode_grads_and_random_streams_as_found(engines):
    """Scoring runs in eval mode under inference_mode, then the model is in
    its old mode again, no parameter has gained a .grad, and neither
    torch's nor numpy's global random stream has moved."""
    config, _, eng = engines
    ds = tsynthetic.SyntheticInferenceDataset(3, arch=_port_arch(config.arch))
    eng.model.train()
    torch_state, np_state = torch.get_rng_state(), np.random.get_state()
    seen = []
    hook = eng.model.visual_transformer.register_forward_hook(
        lambda m, i, o: seen.append((m.training, torch.is_inference_mode_enabled())))
    try:
        eng.infer(ds, num_workers=1)
    finally:
        hook.remove()
    assert seen and all(s == (False, True) for s in seen)
    assert eng.model.training
    assert all(p.grad is None for p in eng.model.parameters())
    assert torch.equal(torch.get_rng_state(), torch_state)
    after = np.random.get_state()
    assert after[0] == np_state[0] and np.array_equal(after[1], np_state[1])
    eng.model.eval()


def test_set_params_drops_the_prompt_cache(engines):
    """The engine scores weights changed in place once set_params is called
    (the trainer's live model), and a model handed to it."""
    config, _, eng = engines
    vols = np.random.default_rng(1).uniform(
        0, 1, (1, 1, config.arch.temporal_size, config.arch.image_size,
               config.arch.image_size)).astype(np.float32)
    before = eng.predict_batch(vols)
    proj = eng.model.to_text_latent.weight
    saved = proj.detach().clone()
    with torch.no_grad():
        proj.mul_(-1.0)
    try:
        assert np.array_equal(eng.predict_batch(vols), before)   # cached
        eng.set_params()
        flipped = eng.predict_batch(vols)
        assert not np.allclose(flipped, before)
    finally:
        with torch.no_grad():
            proj.copy_(saved)
    eng.set_params(eng.model)
    np.testing.assert_array_equal(eng.predict_batch(vols), before)


def _hook_config(valid=(), sample=()):
    return tconfig.ExperimentConfig.from_dict({
        "valid_test_list": list(valid), "sample_test_list": list(sample)})


def test_build_eval_hooks_resolves_the_cls_name_and_refuses_the_rest(engines):
    config, _, eng = engines
    ds = tsynthetic.SyntheticInferenceDataset(4, arch=_port_arch(config.arch))
    hooks = thooks.build_eval_hooks(
        _hook_config(["ctclip_image_report_zero_shot_cls_test"]),
        _tokenizer(), cls_dataset=ds, cls_pathologies=PATHS,
        cls_max_text_len=TEXT_LEN)
    assert list(hooks["eval_hooks"]) == [
        "ctclip_image_report_zero_shot_cls_test"]
    assert hooks["sample_hooks"] == {}
    res = hooks["eval_hooks"]["ctclip_image_report_zero_shot_cls_test"](
        eng.model)
    assert set(res) == {f"{p}_auc" for p in PATHS} | {"mean_auc",
                                                      "volumes_per_sec"}
    # the seg and sample hooks resolve given their data sets
    # (tests/test_torch_seg_eval.py runs them)
    both = thooks.build_eval_hooks(
        _hook_config(["seg_test_planted"], ["open_seg_vis"]), _tokenizer(),
        seg_dataset=ds, open_seg_dataset=ds, results_folder="unused")
    assert list(both["eval_hooks"]) == ["seg_test_planted"]
    assert list(both["sample_hooks"]) == ["open_seg_vis"]
    for cfg, cls_ds, err in (
            (_hook_config(["seg_test_planted"]), ds, ValueError),   # no data
            (_hook_config(sample=["open_seg_vis"]), ds, ValueError),
            (_hook_config(sample=["seg_vis"]), ds, ValueError),     # no hook
            (_hook_config(["zero_shot"]), ds, ValueError),          # no hook
            (_hook_config(["zero_shot_cls"]), None, ValueError)):   # no data
        with pytest.raises(err):
            thooks.build_eval_hooks(cfg, _tokenizer(), cls_dataset=cls_ds)
