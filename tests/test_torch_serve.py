"""CPU parity of the port's zero-shot scoring and serving against the JAX
package: the rest of eval/metrics.py (sklearn underneath on the JAX side),
eval/sweep.py, ``run_zero_shot_cls.main`` against JAX's ``main`` on the same
weights, the HTTP server of cli/serve.py (the tests of tests/test_serve.py
on the port's server with the port's engine) and its micro-batcher, and the
shared weight loader.

Tolerances: the operating point and ``find_threshold`` exactly; the
bootstraps and ``evaluate_external`` within 1e-12 (the same draws, a rank
AUROC against sklearn's trapezoids); under the fp32 policy the CLI's
per-label AUROCs within 1e-6 and its saved probabilities within 1e-5, and
served probabilities within 1e-5 of JAX's engine (fp32 on both sides, only
the summation order differs).  The CLI comparisons run torch on one
intra-op thread: MKL's threaded sgemm sums in an order that varies from run
to run, which moves the port's text latents of 512-token prompts by up to
4e-5 from one call to the next on the CPU (none on one thread).
"""

import base64
import functools
import http.client
import io
import json
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _flagship_config
from tests.test_metrics import _preds
from tests.test_torch_models import jax_params, jax_serving_model, port_model
from tests.test_torch_slice import PATHS, TEXT_LEN, _tokenizer
from vit_exp_tpu.cli import run_zero_shot_cls as jcls
from vit_exp_tpu.core.config import load_config as jax_load_config
from vit_exp_tpu.core.precision import FP32_POLICY as JAX_FP32
from vit_exp_tpu.data import datasets as jdatasets
from vit_exp_tpu.data import preprocess_host as jhost
from vit_exp_tpu.data.tokenizer import load_tokenizer as jax_load_tokenizer
from vit_exp_tpu.eval import metrics as jmetrics
from vit_exp_tpu.eval import sweep as jsweep
from vit_exp_tpu.eval import zero_shot as jzs
from vit_exp_tpu.models import factory as jfactory
from vit_exp_tpu.models.convert import export_ctclip_state_dict
from vit_exp_tpu.models.ctclip import CTCLIP as JaxCTCLIP
from vit_exp_tpu_torch.cli import pack_dataset, run_zero_shot_cls, serve
from vit_exp_tpu_torch.core.config import load_config
from vit_exp_tpu_torch.core.mesh import MeshError
from vit_exp_tpu_torch.core.precision import FP32_POLICY
from vit_exp_tpu_torch.data import datasets as tdatasets
from vit_exp_tpu_torch.data import preprocess_host as thost
from vit_exp_tpu_torch.data.tokenizer import load_tokenizer
from vit_exp_tpu_torch.eval import metrics as tmetrics
from vit_exp_tpu_torch.eval import sweep as tsweep
from vit_exp_tpu_torch.eval import zero_shot as tzs
from vit_exp_tpu_torch.models import factory as tfactory
from vit_exp_tpu_torch.models.factory import bert_config_for, build_ctclip
from vit_exp_tpu_torch.train.checkpoint import (CheckpointManager,
                                                load_model_weights)

# --- metrics --------------------------------------------------------------------


def _metric_cases():
    p, y = _preds(n=40, c=4, seed=11)
    tied = np.round(p * 4) / 4
    one = y.copy()
    one[:, 2] = 0.0
    return {"plain": (p, y), "ties": (tied, y), "single_class": (p, one),
            "small": _preds(n=7, c=4, seed=12)}


@pytest.mark.parametrize("case", sorted(_metric_cases()))
def test_operating_point_and_threshold_match_jax(case):
    p, y = _metric_cases()[case]
    for i in range(p.shape[1]):
        if y[:, i].min() != y[:, i].max():
            assert (tmetrics.choose_operating_point(y[:, i], p[:, i])
                    == jmetrics.choose_operating_point(y[:, i], p[:, i]))
        assert (tmetrics.find_threshold(p[:, i], y[:, i])
                == jmetrics.find_threshold(p[:, i], y[:, i]))
    from sklearn.metrics import roc_curve

    for got, want in zip(tmetrics.roc_curve(y[:, 0], p[:, 0]),
                         roc_curve(y[:, 0], p[:, 0])):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", sorted(_metric_cases()))
def test_bootstraps_match_jax(case):
    p, y = _metric_cases()[case]
    labels = ["a", "b", "c", "d"]
    got = tmetrics.bootstrap_auroc(p, y, labels, n_samples=50, seed=3)
    ref = jmetrics.bootstrap_auroc(p, y, labels, n_samples=50, seed=3)
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=1e-12, rtol=0,
                                   equal_nan=True)
    got = tmetrics.bootstrap_thresholded_metrics(p, y, labels, n_samples=50,
                                                 seed=4)
    ref = jmetrics.bootstrap_thresholded_metrics(p, y, labels, n_samples=50,
                                                 seed=4)
    assert list(got) == list(ref)
    for k in ref:
        assert list(got[k]) == ["f1", "acc", "precision"]
        for m in ref[k]:
            np.testing.assert_allclose(got[k][m], ref[k][m], atol=1e-12,
                                       rtol=0)


def test_weighted_precision_f1_is_sklearns():
    from sklearn.metrics import f1_score, precision_score

    r = np.random.default_rng(13)
    for _ in range(50):
        n = int(r.integers(1, 12))
        truth = r.integers(0, 2, n)
        pred = r.integers(0, 2, n) * int(r.integers(0, 2))   # all-0 too
        p, f = tmetrics.weighted_precision_f1(truth, pred)
        assert p == precision_score(truth, pred, average="weighted",
                                    zero_division=0)
        assert f == f1_score(truth, pred, average="weighted", zero_division=0)


def test_evaluate_external_matches_jax():
    p, _ = _preds(n=30, c=18, seed=14)
    y = (np.random.default_rng(15).random((30, 16)) > 0.5).astype(np.float32)
    y[:, 3] = 1.0     # a single-class kept label
    labels = [f"l{i}" for i in range(18)]
    for kw in ({}, {"skip_idx": (0,), "merge_max": {2: (2, 3)}}):
        yy = y if not kw else np.concatenate([y, y[:, :1]], axis=1)
        got = tmetrics.evaluate_external(p, yy, labels, **kw)
        ref = jmetrics.evaluate_external(p, yy, labels, **kw)
        assert list(got) == list(ref)
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], atol=1e-12,
                                       equal_nan=True)


def test_sweep_matches_jax(tmp_path):
    paths = [f"ckpt_{i}" for i in range(5)]

    def evaluate(path):
        return {"mean_auc": int(path.split("_")[1]) / 10}

    assert tsweep.shard_list(paths, 1, 3) == jsweep.shard_list(paths, 1, 3)
    for shard in (0, 1):
        got = tsweep.sweep_checkpoints(paths, evaluate, num_shards=2,
                                       shard_index=shard,
                                       results_folder=str(tmp_path / "t"))
        ref = jsweep.sweep_checkpoints(paths, evaluate, num_shards=2,
                                       shard_index=shard,
                                       results_folder=str(tmp_path / "j"))
        assert got == ref and list(got) == paths[shard::2]
        name = f"sweep_shard{shard}.json"
        assert ((tmp_path / "t" / name).read_text()
                == (tmp_path / "j" / name).read_text())


# --- run_zero_shot_cls against JAX's main -----------------------------------------

ARCH = {"dim": 48, "image_size": 32, "patch_size": 8, "temporal_size": 16,
        "temporal_patch_size": 4, "transformer_blocks": 2, "dim_head": 8,
        "heads": 4}
TEXT_ENCODER = {"hidden_size": 36, "num_hidden_layers": 1,
                "num_attention_heads": 3, "intermediate_size": 32,
                "max_position_embeddings": 512}
RUNTIME_HWD = (ARCH["image_size"], ARCH["image_size"], ARCH["temporal_size"])


def _cls_yaml(tmp_path):
    path = tmp_path / "cls.yaml"
    path.write_text(json.dumps({
        "results_folder": str(tmp_path / "run"), "arch": ARCH,
        "dim_latent": 16, "text_encoder": TEXT_ENCODER}))
    return str(path)


@pytest.fixture
def one_thread():
    """torch on one intra-op thread: sums in an order that does not vary
    from run to run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fp32_builds(monkeypatch):
    """Both CLIs build their model under the fp32 policy."""
    monkeypatch.setattr(jfactory, "build_ctclip", functools.partial(
        jfactory.build_ctclip, policy=JAX_FP32))
    monkeypatch.setattr(tfactory, "build_ctclip", functools.partial(
        tfactory.build_ctclip, policy=FP32_POLICY))
    for host, mod in ((jhost, jdatasets), (thost, tdatasets)):
        monkeypatch.setattr(mod, "runtime_volume", functools.partial(
            host.runtime_volume, target_hwd=RUNTIME_HWD))


@pytest.fixture(scope="module")
def cls_setup(tmp_path_factory):
    """The config, a CTClip.*.pt exported from perturbed JAX params, and an
    npz tree of 6 volumes (larger and smaller than the arch on some axis)
    with its reports and 18-column labels CSVs."""
    tmp = tmp_path_factory.mktemp("cls")
    cfg = _cls_yaml(tmp)
    config = jax_load_config(cfg)
    bert = jfactory.bert_config_for(config, jax_load_tokenizer(None))
    model = jfactory.build_ctclip(config, bert_config=bert, policy=JAX_FP32)
    a = config.arch
    video = jnp.zeros((1, 1, a.temporal_size, a.image_size, a.image_size))
    import flax.linen as nn

    params = nn.unbox(jax.jit(lambda k: model.init(
        k, video, jnp.ones((1, 8), jnp.int32),
        method=JaxCTCLIP.init_all))(jax.random.PRNGKey(21)))["params"]
    rng = np.random.default_rng(21)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32) + np.float32(0.1)
        * rng.standard_normal(np.shape(p)).astype(np.float32), params)
    grid = (a.temporal_size // a.temporal_patch_size,
            a.image_size // a.patch_size, a.image_size // a.patch_size)
    sd = export_ctclip_state_dict(params, grid=grid, heads=a.heads,
                                  bert_config=bert)
    pt = tmp / "CTClip.21.pt"
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
               pt)
    names = []
    r = np.random.default_rng(22)
    for i, shape in enumerate([(12, 36, 30), (20, 28, 34), (16, 32, 32),
                               (18, 30, 40), (14, 40, 26), (16, 33, 31)]):
        folder = tmp / "tree" / f"valid_{i}" / f"valid_{i}a"
        folder.mkdir(parents=True)
        np.savez(folder / f"valid_{i}_a_1.npz",
                 r.uniform(-1, 1, shape).astype(np.float32))
        names.append(f"valid_{i}_a_1.nii.gz")
    reports = tmp / "reports.csv"
    reports.write_text("VolumeName,Findings_EN,Impressions_EN\n" + "".join(
        f"{n},finding {i},\n" for i, n in enumerate(names)))
    labels = tmp / "labels.csv"
    y = (r.random((6, 18)) > 0.5).astype(int)
    y[0], y[1] = 1, 0
    labels.write_text("VolumeName," + ",".join(tzs.PATHOLOGIES) + "\n" + "".join(
        n + "," + ",".join(map(str, row)) + "\n" for n, row in zip(names, y)))
    return dict(cfg=cfg, pt=str(pt), tree=str(tmp / "tree"),
                reports=str(reports), labels=str(labels), tmp=tmp)


def _results(folder):
    res = json.loads((folder / "aurocs.json").read_text())
    pred = np.load(folder / "predicted_weights.npz")["data"]
    return res, pred, (folder / "accessions.txt").read_text()


def _hold_to_jax(got_dir, ref_dir, n):
    res, pred, acc = _results(got_dir)
    ref, ref_pred, ref_acc = _results(ref_dir)
    assert set(res) == set(ref) and acc == ref_acc
    assert pred.shape == ref_pred.shape == (n, pred.shape[1])
    np.testing.assert_allclose(pred, ref_pred, atol=1e-5, rtol=0)
    for k in ref:
        if k.endswith("_auc"):
            np.testing.assert_allclose(res[k], ref[k], atol=1e-6,
                                       equal_nan=True, err_msg=k)
    return res


@pytest.mark.parametrize("source", ["npz", "packed"])
def test_run_zero_shot_cls_matches_jax(cls_setup, tmp_path, monkeypatch,
                                       capsys, one_thread, source):
    """The port's CLI and JAX's on the same tree (or a float16 store the
    port packed from it) and the same reference checkpoint, --no-int8 under
    the fp32 policy; batch 4 over 6 volumes leaves a tail of 2."""
    s = cls_setup
    _fp32_builds(monkeypatch)
    if source == "npz":
        data = ["--data_folder", s["tree"], "--reports_csv", s["reports"]]
    else:
        store = tmp_path / "store"
        pack_dataset.main(["--data_folder", s["tree"], "--csv_file",
                           s["reports"], "--out", str(store)])
        data = ["--packed_root", str(store)]
    argv = ["--config", s["cfg"], "--no-int8", "--torch_ckpt",
            "--model_path", s["pt"], "--labels_csv", s["labels"]] + data
    jcls.main(argv + ["--results_folder", str(tmp_path / "jax")])
    capsys.readouterr()
    got = run_zero_shot_cls.main(
        argv + ["--results_folder", str(tmp_path / "port")], device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(got) == ["CTClip.21.pt"] and line["model"] == "CTClip.21.pt"
    res = _hold_to_jax(tmp_path / "port" / "CTClip.21.pt",
                       tmp_path / "jax" / "CTClip.21.pt", 6)
    assert line == {"model": "CTClip.21.pt", **got["CTClip.21.pt"]}
    assert {k: v for k, v in res.items() if k != "volumes_per_sec"} == {
        k: v for k, v in got["CTClip.21.pt"].items()
        if k != "volumes_per_sec"}
    assert np.isfinite(res["mean_auc"])


def test_run_zero_shot_cls_planted_matches_jax(cls_setup, tmp_path,
                                               monkeypatch, one_thread):
    s = cls_setup
    _fp32_builds(monkeypatch)
    argv = ["--config", s["cfg"], "--no-int8", "--torch_ckpt",
            "--model_path", s["pt"], "--planted", "8", "--batch_size", "3"]
    jcls.main(argv + ["--results_folder", str(tmp_path / "jax")])
    got = run_zero_shot_cls.main(
        argv + ["--results_folder", str(tmp_path / "port")], device="cpu")
    res = _hold_to_jax(tmp_path / "port" / "CTClip.21.pt",
                       tmp_path / "jax" / "CTClip.21.pt", 8)
    from vit_exp_tpu_torch.data.planted import PLANTED_ATTRS

    assert set(res) == {f"{a}_auc" for a in PLANTED_ATTRS} | {
        "mean_auc", "volumes_per_sec"}
    assert set(got["CTClip.21.pt"]) == set(res)


def test_run_zero_shot_cls_sweep_reloads_in_place(cls_setup, tmp_path,
                                                  capsys, one_thread):
    """Two of the port's checkpoints as one sweep (int8, the default): one
    model, weights loaded in place, the prompt cache dropped; the second
    result equals a fresh run on that checkpoint alone."""
    s = cls_setup
    config = load_config(s["cfg"])
    bert = bert_config_for(config, load_tokenizer())
    ckpt = CheckpointManager(str(tmp_path / "checkpoints"))
    for step, seed in ((1, 31), (2, 32)):
        ckpt.save(step, build_ctclip(config, bert, device="cpu",
                                     seed=seed).state_dict(), {"step": step},
                  wait=True)
    base = ["--config", s["cfg"], "--synthetic", "5", "--batch_size", "2"]
    paths = [str(tmp_path / "checkpoints" / f"ckpt_{i}") for i in (1, 2)]
    swept = run_zero_shot_cls.main(
        base + ["--results_folder", str(tmp_path / "sweep"),
                "--model_path", paths[0], "--model_path", paths[1]],
        device="cpu")
    lines = [json.loads(x) for x in
             capsys.readouterr().out.strip().splitlines()[-2:]]
    assert [x["model"] for x in lines] == list(swept) == ["ckpt_1", "ckpt_2"]
    fresh = run_zero_shot_cls.main(
        base + ["--results_folder", str(tmp_path / "fresh"),
                "--model_path", paths[1] + "/"], device="cpu")
    def drop(res):   # NaN AUROCs compare equal as JSON text
        return json.dumps({k: v for k, v in res.items()
                           if k != "volumes_per_sec"})

    assert drop(swept["ckpt_2"]) == drop(fresh["ckpt_2"])
    pred = [_results(tmp_path / d / c)[1] for d, c in (
        ("sweep", "ckpt_1"), ("sweep", "ckpt_2"), ("fresh", "ckpt_2"))]
    np.testing.assert_array_equal(pred[1], pred[2])
    assert not np.allclose(pred[0], pred[1])
    rand = run_zero_shot_cls.main(
        base + ["--results_folder", str(tmp_path / "rand"), "--no-int8"],
        device="cpu")
    assert list(rand) == ["random_init"]
    assert (tmp_path / "rand" / "random_init" / "aurocs.csv").exists()


def test_run_zero_shot_cls_refuses_what_is_not_ported(cls_setup, tmp_path):
    base = ["--config", cls_setup["cfg"], "--results_folder", str(tmp_path)]
    for mesh in ("1,2,1", "1,1,2"):   # fsdp and model: a grid of 2 (M7b)
        with pytest.raises(MeshError, match=f"{mesh.replace(',', 'x')} "
                                            f"!= 1"):
            run_zero_shot_cls.main(base + ["--synthetic", "2", "--mesh",
                                           mesh], device="cpu")
    with pytest.raises(ValueError, match="coordinator"):
        run_zero_shot_cls.main(base + ["--synthetic", "2",
                                       "--num_processes", "2"], device="cpu")
    for extra in ([], ["--data_folder", "x"], ["--packed_root", "x"]):
        with pytest.raises(SystemExit):
            run_zero_shot_cls.parse_args(base + extra)


def test_load_model_weights_takes_every_checkpoint_form(cls_setup, tmp_path):
    """A checkpoints/ directory (its latest step), a ckpt_{step}/ directory
    and a reference-layout .pt load through the one shared loader, which
    run_zero_shot_seg still offers under its old name."""
    from vit_exp_tpu_torch.cli import run_zero_shot_seg
    from vit_exp_tpu_torch.models.convert import load_reference_state_dict

    assert run_zero_shot_seg.load_weights is load_model_weights
    config = load_config(cls_setup["cfg"])
    bert = bert_config_for(config, load_tokenizer())
    ckpt = CheckpointManager(str(tmp_path / "checkpoints"))
    states = {}
    for step, seed in ((3, 41), (7, 42)):
        states[step] = build_ctclip(config, bert, device="cpu",
                                    seed=seed).state_dict()
        ckpt.save(step, states[step], {"step": step}, wait=True)

    def loaded(path, torch_ckpt=False):
        model = build_ctclip(config, bert, device="cpu", seed=0)
        load_model_weights(model, str(path), torch_ckpt)
        return model.state_dict()

    def same(a, b):
        return a.keys() == b.keys() and all(torch.equal(a[k], b[k])
                                            for k in a)

    assert same(loaded(tmp_path / "checkpoints"), states[7])
    assert same(loaded(tmp_path / "checkpoints" / "ckpt_3"), states[3])
    ref = build_ctclip(config, bert, device="cpu", seed=0)
    load_reference_state_dict(ref, torch.load(cls_setup["pt"],
                                              weights_only=True))
    assert same(loaded(cls_setup["pt"], True), ref.state_dict())
    with pytest.raises(FileNotFoundError):
        loaded(tmp_path / "empty")


# --- the HTTP server ------------------------------------------------------------

@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The port's server over the port's engine on perturbed JAX params of
    the tiny arch (fp32), beside JAX's engine on the same params."""
    base = tmp_path_factory.mktemp("serve")
    config = _flagship_config(tiny=True)
    params = jax_params(config, seed=8)
    model = port_model(config, params)
    engine = tzs.ZeroShotClassifier(model, _tokenizer(), pathologies=PATHS,
                                    max_text_len=TEXT_LEN, batch_size=1)
    engine.prepare()
    ref = jzs.ZeroShotClassifier(jax_serving_model(config), params,
                                 _tokenizer(), pathologies=PATHS,
                                 max_text_len=TEXT_LEN, batch_size=1)
    a = config.arch
    shape = (a.temporal_size, a.image_size, a.image_size)
    data_root = base / "data"
    data_root.mkdir()
    srv = serve.build_server(engine, serve.make_latent_fn(model, "cpu"),
                             shape, 0, data_root=str(data_root))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield dict(url=f"http://127.0.0.1:{srv.server_address[1]}", shape=shape,
               engine=engine, ref=ref, model=model, params=params,
               jmodel=jax_serving_model(config), base=base,
               data_root=data_root, batcher=srv.batcher)
    srv.shutdown()
    srv.server_close()
    srv.batcher.close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _post(url, path, payload):
    req = urllib.request.Request(url + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _vol(shape, seed):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


def _b64(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return base64.b64encode(buf.getvalue()).decode()


def test_health(served):
    with urllib.request.urlopen(served["url"] + "/health") as r:
        body = json.loads(r.read())
    assert body["status"] == "ok" and body["pathologies"] == PATHS
    assert body["batching"]["max_batch"] == 4
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(served["url"] + "/nope")
    assert e.value.code == 404


def test_classify_nested_list_and_base64_match_jax(served):
    """Both encodings give the probabilities of JAX's engine on the same
    parameters within 1e-5."""
    shape = served["shape"]
    vols = [_vol((1,) + shape, 0), _vol(shape, 1)]
    for vol, payload in ((vols[0], {"volume": vols[0].tolist()}),
                         (vols[1], {"volume": _b64(vols[1])})):
        code, body = _post(served["url"], "/classify", payload)
        assert code == 200 and list(body["probs"]) == PATHS
        assert body["ms"] >= 0
        want = served["ref"].predict_batch(vol.reshape((1, 1) + shape))[0]
        np.testing.assert_allclose([body["probs"][p] for p in PATHS], want,
                                   atol=1e-5, rtol=0)


def test_embed_and_errors(served):
    shape = served["shape"]
    vol = _vol((1,) + shape, 2)
    code, body = _post(served["url"], "/embed", {"volume": _b64(vol)})
    assert code == 200 and len(body["latent"]) == 16
    lat = np.asarray(body["latent"])
    assert abs(np.linalg.norm(lat) - 1.0) < 1e-5
    p = served["params"]
    jm = served["jmodel"]
    tok = jm.apply({"params": p}, jnp.asarray(vol[None]),
                   method=JaxCTCLIP.encode_image_tokens)
    want = np.asarray(jm.apply({"params": p}, tok,
                               method=JaxCTCLIP.image_latents_from_tokens))[0]
    np.testing.assert_allclose(lat, want, atol=1e-5, rtol=0)
    code, body = _post(served["url"], "/classify",
                       {"volume": np.zeros((1, 4, 4, 4)).tolist()})
    assert code == 400 and "shape" in body["error"]
    code, body = _post(served["url"], "/embed", {"volume": "not base64!"})
    assert code == 400 and body["error"]
    code, _ = _post(served["url"], "/nope", {"volume": vol.tolist()})
    assert code == 404


def test_classify_path_restricted_to_data_root(served):
    root = served["data_root"]
    vol = _vol(served["shape"], 3)
    np.save(root / "vol.npy", vol)
    np.savez(root / "vol.npz", vol)
    for name in ("vol.npy", "vol.npz"):
        code, body = _post(served["url"], "/classify_path",
                           {"path": str(root / name)})
        assert code == 200 and "probs" in body
    outside = served["base"] / "outside.npy"
    np.save(outside, vol)
    for path in (outside, root / ".." / "outside.npy"):
        code, body = _post(served["url"], "/classify_path",
                           {"path": str(path)})
        assert code == 400 and "data root" in body["error"]


def test_classify_path_disabled_without_root():
    with pytest.raises(ValueError, match="disabled"):
        serve._decode_volume({"path": "/tmp/anything.npy"}, None, None)


def test_request_size_cap(served):
    """A body over the cap gets 413 before it is read; a Content-Length
    that is not a number 411, a negative one 400."""
    cap = serve.default_request_cap(served["shape"])
    assert cap == int(np.prod(served["shape"])) * 32 + (1 << 20)
    vol = np.zeros((1,) + served["shape"], np.float32)
    code, body = _post(served["url"], "/classify",
                       {"volume": vol.tolist(), "pad": "x" * (cap + 1)})
    assert code == 413 and "cap" in body["error"]
    code, body = _post(served["url"], "/classify", {"volume": vol.tolist()})
    assert code == 200 and "probs" in body
    host = urllib.parse.urlparse(served["url"]).netloc
    for length, status in (("not-a-number", 411), ("-5", 400)):
        conn = http.client.HTTPConnection(host, timeout=10)
        conn.putrequest("POST", "/classify")
        conn.putheader("Content-Type", "application/json")
        conn.putheader("Content-Length", length)
        conn.endheaders()
        assert conn.getresponse().status == status
        conn.close()


def _concurrently(url, jobs):
    results = [None] * len(jobs)

    def worker(i):
        results[i] = _post(url, *jobs[i])

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(jobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    return results


def test_concurrent_classify_matches_sequential(served):
    vols = [_vol(served["shape"], 10 + i) for i in range(6)]
    jobs = [("/classify", {"volume": _b64(v)}) for v in vols]
    sequential = [_post(served["url"], *j)[1]["probs"] for j in jobs]
    for (code, body), want in zip(_concurrently(served["url"], jobs),
                                  sequential):
        assert code == 200
        for k, v in body["probs"].items():
            np.testing.assert_allclose(v, want[k], atol=1e-5)
    assert served["batcher"].stats["volumes"] >= 12


def test_mixed_classify_embed_concurrent(served):
    """Concurrent /classify and /embed (the engine's lock is shared between
    the batches and the embeds) give what sequential sends give."""
    vols = [_vol(served["shape"], 20 + i) for i in range(8)]
    jobs = [("/classify" if i % 2 == 0 else "/embed", {"volume": _b64(v)})
            for i, v in enumerate(vols)]
    sequential = [_post(served["url"], *j)[1] for j in jobs]
    for (code, body), want, (path, _) in zip(
            _concurrently(served["url"], jobs), sequential, jobs):
        assert code == 200
        if path == "/classify":
            for k, v in body["probs"].items():
                np.testing.assert_allclose(v, want["probs"][k], atol=1e-5)
        else:
            np.testing.assert_allclose(body["latent"], want["latent"],
                                       atol=1e-5)


def test_decode_volume_channels():
    vol2 = np.zeros((2, 4, 4, 4), np.float32)
    assert serve._decode_volume({"volume": vol2.tolist()}, (4, 4, 4),
                                channels=2).shape == (2, 4, 4, 4)
    with pytest.raises(ValueError, match="expected \\(2, D, H, W\\)"):
        serve._decode_volume({"volume": np.zeros((4, 4, 4)).tolist()},
                             (4, 4, 4), channels=2)
    with pytest.raises(ValueError, match="expected \\(1, D, H, W\\)"):
        serve._decode_volume({"volume": vol2.tolist()}, (4, 4, 4))


# --- the micro-batcher ------------------------------------------------------------


class _GatedEngine:
    """Holds its first call until ``n`` requests have been queued, then
    answers each volume with its marker values, noting each batch."""

    def __init__(self, n):
        self.batch_sizes, self.n, self.queued = [], n, 0
        self.gated = True

    def predict_batch(self, vols):
        if self.gated:
            self.gated = False
            deadline = time.time() + 10.0
            while self.queued < self.n and time.time() < deadline:
                time.sleep(0.001)
        self.batch_sizes.append(len(vols))
        return vols[:, 0, 0, 0, :2]


@pytest.mark.parametrize("n", [6, 3])
def test_micro_batcher_coalesces_without_padding(n):
    """The engine holds its first call until every request is queued, so
    they coalesce into at most 3 calls, and each call sees exactly the
    requests it took: the engine is handed ``n`` volumes in all (a batch of
    2 or 3 is not padded to 4)."""
    eng = _GatedEngine(n)
    b = serve.MicroBatcher(eng, max_batch=4, window_ms=30.0)
    put = b._q.put

    def counting_put(item):
        put(item)
        if item is not None:
            eng.queued += 1

    b._q.put = counting_put
    vols = [np.full((1, 4, 4, 4), i, np.float32) for i in range(n)]
    out = [None] * n
    threads = [threading.Thread(target=lambda i=i: out.__setitem__(
        i, b.classify(vols[i]))) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    for i in range(n):
        np.testing.assert_array_equal(out[i], [i, i])
    assert sum(eng.batch_sizes) == n
    assert len(eng.batch_sizes) <= 3 and max(eng.batch_sizes) <= 4
    assert b.stats == {"dispatches": len(eng.batch_sizes), "volumes": n,
                       "max_batch_seen": max(eng.batch_sizes)}
    b.close()


def test_micro_batcher_propagates_errors_and_survives():
    calls = []

    class Flaky:
        def predict_batch(self, vols):
            calls.append(len(vols))
            if len(calls) == 1:
                raise RuntimeError("device on fire")
            return vols[:, 0, 0, 0, :2]

    b = serve.MicroBatcher(Flaky(), max_batch=4, window_ms=1.0)
    with pytest.raises(RuntimeError, match="device on fire"):
        b.classify(np.zeros((1, 4, 4, 4), np.float32))
    np.testing.assert_array_equal(
        b.classify(np.full((1, 4, 4, 4), 5, np.float32)), [5, 5])
    assert calls == [1, 1] and b.stats["dispatches"] == 1
    b.close()


def test_micro_batcher_close_rejects_new_requests():
    class Echo:
        def predict_batch(self, vols):
            return vols[:, 0, 0, 0, :2]

    b = serve.MicroBatcher(Echo(), max_batch=4, window_ms=1.0)
    b.close()
    assert not b._thread.is_alive()
    with pytest.raises(RuntimeError, match="shutting down"):
        b.classify(np.zeros((1, 4, 4, 4), np.float32))
    b2 = serve.MicroBatcher(Echo(), max_batch=4, window_ms=1.0)
    b2._closed = True   # close() won the race against a classify()
    b2._q.put(None)
    b2._thread.join(timeout=5)
    done, slot = threading.Event(), {}
    b2._q.put((np.zeros((1, 4, 4, 4), np.float32), slot, done))
    b2._drain_rejected()
    assert done.is_set() and "shutting down" in str(slot["err"])


def test_serve_entry_on_int8_embeds_from_a_handler_thread(cls_setup, tmp_path):
    """build_service as main builds it (int8 by default, a checkpoint
    loaded), warmed; /embed from the server's handler threads runs the int8
    path under inference mode (it refuses to run where autograd records);
    --mesh is refused."""
    cfg = cls_setup["cfg"]
    config = load_config(cfg)
    state = build_ctclip(config, bert_config_for(config, load_tokenizer()),
                         device="cpu", seed=5).state_dict()
    CheckpointManager(str(tmp_path / "ck")).save(1, state, {}, wait=True)
    args = serve.parse_args(["--config", cfg, "--model_path",
                             str(tmp_path / "ck" / "ckpt_1"),
                             "--max_batch", "2"])
    engine, latent_fn, shape, channels = serve.build_service(args, "cpu")
    assert shape == (16, 32, 32) and channels == 1
    assert any(getattr(m, "int8", False) for m in engine.model.modules())
    assert all(torch.equal(engine.model.state_dict()[k], state[k])
               for k in state)
    assert serve.warmup(engine, latent_fn, shape, channels, 2) > 0
    srv = serve.build_server(engine, latent_fn, shape, 0, max_batch=2)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        vol = _vol((1,) + shape, 4)
        code, body = _post(url, "/embed", {"volume": _b64(vol)})
        assert code == 200 and len(body["latent"]) == 16
        code, body = _post(url, "/classify", {"volume": _b64(vol)})
        assert code == 200
        np.testing.assert_allclose(
            [body["probs"][p] for p in tzs.PATHOLOGIES],
            engine.predict_batch(vol[None])[0], atol=1e-6)
    finally:
        srv.shutdown()
        srv.server_close()
        srv.batcher.close()
    # --mesh (M7b): 4 cards, which this host does not have
    with pytest.raises(MeshError, match="drives 4 cards"):
        serve.build_service(serve.parse_args(["--config", cfg, "--mesh",
                                              "4,1,1"]), "cuda")


def test_chip_smoke_real_data_phases_rehearse_on_cpu(cls_setup, tmp_path,
                                                     monkeypatch, one_thread):
    """chip_smoke's real-format phases at the tiny arch on the CPU (every
    wrapper runs its plain twin, so no launch is counted): preprocessing by
    both CLI paths that run here, the CT-RATE files packed to float16, the
    native reader, the four run_zero_shot_cls runs (npz against packed, the
    sweep against a fresh run) and the server under 8 concurrent clients,
    with the result lines.  The models run under the fp32 policy: on the
    CPU a bf16 product's rounding follows the GEMM's blocking, which
    changes with the batch, and the served probabilities are held to
    predict_batch on one volume within 1e-4."""
    import chip_smoke as cs

    monkeypatch.setattr(tfactory, "build_ctclip", functools.partial(
        tfactory.build_ctclip, policy=FP32_POLICY))
    monkeypatch.setattr(tdatasets, "runtime_volume", functools.partial(
        thost.runtime_volume, target_hwd=RUNTIME_HWD))
    config = load_config(cls_setup["cfg"])
    bert = bert_config_for(config, load_tokenizer())
    ckpts = []
    for step in (2, 3):
        CheckpointManager(str(tmp_path / "ckpts")).save(
            step, build_ctclip(config, bert, device="cpu",
                               seed=step).state_dict(), {}, wait=True)
        ckpts.append(str(tmp_path / "ckpts" / f"ckpt_{step}"))
    none = cs.expected_launches({})
    dhw = [(12 + 2 * i, 36 - 2 * i, 28 + i) for i in range(8)]
    real = cs.real_data_phase(
        torch.device("cpu"), tmp_path, cls_setup["cfg"], ckpts, none, none,
        ARCH["transformer_blocks"], raw_hwd=(40, 36, 24),
        nifti_hwd=((30, 28, 12), (24, 26, 10)), dhw=dhw, window_ms=200)
    assert real["prep"]["shape"] == (16, 37, 33)
    assert real["prep"]["rel"] == 0.0 and set(real["prep"]["cli_s"]) == {
        "host"}
    assert real["native"]["gbps"] > 0
    runs = real["cls"]["runs"]
    assert list(runs) == ["npz, int8", "packed, int8", "packed, bf16",
                          "packed, int8, sweep"]
    assert [r["batches"] for r in runs.values()] == [2, 2, 2, 4]
    assert list(runs["packed, int8, sweep"]["res"]) == ["ckpt_2", "ckpt_3"]
    assert real["cls"]["d_store"] <= cs.PROB_TOL
    res = runs["npz, int8"]["res"]["ckpt_3"]
    assert np.isnan(res["Hiatal hernia_auc"])     # the empty label cell
    assert np.isfinite(res["mean_auc"])
    s = real["serve"]
    assert s["max_batch_seen"] == cs.CLS_BATCH and s["embed_dim"] == 16
    assert s["stats"]["volumes"] == cs.SERVE_CLIENTS * cs.SERVE_ROUNDS
    assert s["diff"] <= cs.PROB_TOL and s["launches"] == none
    # the burst, the three lone requests and the base64 /classify
    assert sum(s["sizes"]) == s["stats"]["volumes"] + 3 + 1
    assert len(s["decode_ms"]) == cs.SERVE_CLIENTS * cs.SERVE_ROUNDS
    lines = cs.real_data_lines(real, "card X")
    assert len(lines) == 7 and all(x.endswith("on card X") for x in lines)
