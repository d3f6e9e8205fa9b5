"""CPU parity of the port's segmentation eval and entry points against the
JAX package, at the tiny arch in fp32.

- ``ZeroShotSegmenter.infer`` and ``make_seg_dice_hook`` against JAX's
  engine and hook on the same parameters and planted volumes: per-sample
  dice (dice_scores.npy) and ``dice_class_{i}``/``mean_dice``.  Dice
  thresholds the logits, which agree to ~1e-6: a sample-class pair is held
  exactly equal when none of its voxels has a logit within MARGIN of 0, and
  otherwise within 2 voxels' weight per such voxel.
- ``slice_grid_3d`` against JAX's, exactly; ``write_png`` decodes back (zlib)
  to round(255·grid); the open-vocabulary sample hook's grids against the
  same grids made from JAX's ``open_seg_forward``, within 1e-5.
- ``run_zero_shot_seg.main(..., device="cpu")`` on ``--synthetic 2``, int8
  and bf16, from random weights, the port's checkpoint and a reference
  ``CTClip.*.pt`` written by JAX's exporter.
- ``run_train.main`` on a tiny copy of ``configs/planted_mixed.yaml``: the
  three step types dispatched, the seg hook's lines, and the hooked run's
  parameters bit-equal to an unhooked run's; the synthetic seg masks keep
  4 classes whatever the seg head's width, and both packages then raise.
"""

import json
import math
import struct
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.test_torch_models import DIM_LATENT, jax_params
from tests.test_torch_seg import (_config_dict, _configs, _jax_model,
                                  _port_model)
from tests.test_torch_trainer import TINY_ARCH
from vit_exp_tpu.cli import run_train as jax_run_train
from vit_exp_tpu.data import planted as jplanted
from vit_exp_tpu.eval import hooks as jhooks
from vit_exp_tpu.eval import zero_shot as jzs
from vit_exp_tpu.models import losses as jlosses
from vit_exp_tpu.models.convert import export_ctclip_state_dict
from vit_exp_tpu.models.ctclip import CTCLIP as JaxCTCLIP
from vit_exp_tpu.models.ctclip import downsample_stride as jdownsample
from vit_exp_tpu.utils import vis as jvis
from vit_exp_tpu_torch.cli import run_train, run_zero_shot_seg
from vit_exp_tpu_torch.core.mesh import MeshError
from vit_exp_tpu_torch.core import config as tconfig
from vit_exp_tpu_torch.data import planted as tplanted
from vit_exp_tpu_torch.data import synthetic as tsynthetic
from vit_exp_tpu_torch.eval import hooks as thooks
from vit_exp_tpu_torch.eval import vis_hooks as tvis_hooks
from vit_exp_tpu_torch.eval import zero_shot as tzs
from vit_exp_tpu_torch.models.bert import BertConfig
from vit_exp_tpu_torch.models.convert import from_jax_params
from vit_exp_tpu_torch.models.factory import build_ctclip
from vit_exp_tpu_torch.train.checkpoint import CheckpointManager
from vit_exp_tpu_torch.utils import vis as tvis

ROOT = Path(__file__).resolve().parents[1]
MARGIN = 1e-4
N_VOLUMES = 5
SEG_ARCH = dict(seg_head={"n_layers": 2, "mid_dim": 16, "out_dim": 2})
TEXT_ENCODER = {"hidden_size": 36, "num_hidden_layers": 2,
                "num_attention_heads": 3, "intermediate_size": 64,
                "max_position_embeddings": 128}


@pytest.fixture(scope="module")
def seg_models():
    """JAX and the port on the same perturbed parameters, seg head of 2
    classes (the planted task's), and the planted held-out volumes."""
    jcfg, tcfg = _configs(**SEG_ARCH)
    params = jax_params(jcfg, seed=23)
    ds = tplanted.PlantedSegInferenceDataset(
        N_VOLUMES, arch=tconfig.ArchConfig(**TINY_ARCH))
    jds = jplanted.PlantedSegInferenceDataset(
        N_VOLUMES, arch=jcfg.arch)
    return jcfg, params, _jax_model(jcfg), _port_model(tcfg, params), ds, jds


def _near_zero(model, ds):
    """(samples, classes) counts of voxels whose logit lies within MARGIN of
    0, and the union sizes |P| + |G| (the port's)."""
    near, union = [], []
    with torch.no_grad():
        for i in range(len(ds)):
            item = ds[i]
            logits = model.seg_forward(torch.from_numpy(item["image"][None]))
            pred = torch.sigmoid(logits.float()) > 0.5
            near.append((logits.abs() < MARGIN).sum(dim=(2, 3, 4))[0].numpy())
            union.append((pred.sum(dim=(2, 3, 4))[0]
                          + torch.from_numpy(item["seg_mask"]).sum(
                              dim=(1, 2, 3))).numpy())
    return np.stack(near), np.stack(union)


def _assert_dice_close(got, ref, near, union):
    """Exact where no voxel is near the threshold, else within the weight of
    the voxels that are."""
    assert got.shape == ref.shape
    for idx in np.ndindex(got.shape):
        if near[idx] == 0:
            np.testing.assert_array_equal(got[idx], ref[idx], err_msg=idx)
        else:
            bound = 2.0 * near[idx] / max(union[idx] - near[idx], 1)
            assert abs(got[idx] - ref[idx]) <= bound, idx


@pytest.mark.parametrize("batch_size", [1, 2])
def test_segmenter_infer_matches_jax(seg_models, tmp_path, batch_size):
    """batch 2 over 5 volumes pads the tail batch by repeating its last
    volume."""
    _, params, jmodel, model, ds, jds = seg_models
    ref = jzs.ZeroShotSegmenter(jmodel, params, batch_size=batch_size).infer(
        jds, results_folder=str(tmp_path / "jax"), num_workers=1)
    model.train()
    eng = tzs.ZeroShotSegmenter(model, batch_size=batch_size)
    got = eng.infer(ds, results_folder=str(tmp_path / "port"), num_workers=1)
    assert model.training           # left in the mode it was in
    assert set(got) == set(ref) == {"dice_class_0", "dice_class_1",
                                    "mean_dice"}
    near, union = _near_zero(model, ds)
    per = [np.load(tmp_path / side / "dice_scores.npy")
           for side in ("port", "jax")]
    assert per[0].shape == (N_VOLUMES, 2)
    _assert_dice_close(per[0], per[1], near, union)
    if not near.any():
        assert got == ref
    for k in got:
        assert math.isfinite(got[k])
    txt = (tmp_path / "port" / "dice_scores.txt").read_text().splitlines()
    assert txt == [f"{k}: {v}" for k, v in got.items()]


def test_seg_dice_hook_matches_jax(seg_models):
    _, params, jmodel, model, ds, jds = seg_models
    ref = jhooks.make_seg_dice_hook(jmodel, jds, limit=3)(params)
    hook = thooks.make_seg_dice_hook(ds, limit=3)
    got = hook(model)
    near, union = _near_zero(model, tplanted.PlantedSegInferenceDataset(
        3, arch=ds.arch))
    if not near.any():
        assert got == ref
    else:
        for k in ref:
            assert abs(got[k] - ref[k]) <= 2.0 * near.sum() / union.min()
    assert hook(model) == got       # one engine, the same weights


def test_slice_grid_matches_jax_and_the_png_decodes_to_it(tmp_path):
    r = np.random.default_rng(4)
    vol = r.standard_normal((9, 14, 11)).astype(np.float32)
    grid = tvis.slice_grid_3d(vol)
    np.testing.assert_array_equal(grid, jvis.slice_grid_3d(vol))
    assert grid.shape == (3 * 14, 3 * 14)
    flat = np.zeros((4, 5, 6), np.float32)
    np.testing.assert_array_equal(tvis.slice_grid_3d(flat),
                                  jvis.slice_grid_3d(flat))
    got = tvis.vis_3d_img_list([vol, flat], "v")
    ref = jvis.vis_3d_img_list([vol, flat], "v")
    assert got.keys() == ref.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], ref[k])

    path = tmp_path / "grid.png"
    tvis.write_png(str(path), grid)
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    chunks, pos = {}, 8
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        chunks[tag] = body
        pos += 12 + n
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (w, h, depth, color) == (grid.shape[1], grid.shape[0], 8, 0)
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]),
                         np.uint8).reshape(h, w + 1)
    assert not rows[:, 0].any()      # filter type 0 on every scanline
    np.testing.assert_array_equal(
        rows[:, 1:], np.round(grid * 255).astype(np.uint8))


def test_open_seg_vis_hook_grids_match_jax(seg_models, tmp_path):
    """The hook's grids against grids made the JAX hook's way from JAX's
    open_seg_forward at down factor 2; its PNGs and keys."""
    _, params, jmodel, model, _, _ = seg_models
    from tests.test_torch_slice import _tokenizer

    ds = tplanted.PlantedOpenSegDataset(
        2, arch=tconfig.ArchConfig(**TINY_ARCH), tokenizer=_tokenizer(),
        max_text_len=12)
    item = ds[1]
    res = jax.jit(lambda p, v, i, m: jmodel.apply(
        {"params": p}, v, i, m, 2, method=JaxCTCLIP.open_seg_forward))(
            params, jnp.asarray(item["image"][None]),
            jnp.asarray(item["prompt_ids"]), jnp.asarray(item["prompt_mask"]))
    mask = jdownsample(jnp.asarray(item["seg_mask"][None]), 2)
    d, w, h = mask.shape[2:]
    with torch.no_grad():
        got = tvis_hooks.open_seg_grids(model, item, 2)
    assert len(got) == 2 * 3
    for c in range(2):
        sim = (jlosses.cosine_similarity(
            res["seg_preds"], res["prompt_logits"][:, c][:, None, :]) + 1) / 2
        ref = {"img": jvis.slice_grid_3d(np.asarray(jdownsample(
                   jnp.asarray(item["image"][None]), 2)[0, 0])),
               "sim": jvis.slice_grid_3d(np.asarray(sim[0].reshape(d, w, h))),
               "gt": jvis.slice_grid_3d(np.asarray(mask[0, c]))}
        for name, grid in ref.items():
            np.testing.assert_allclose(got[f"class{c}_{name}"], grid,
                                       atol=1e-5, rtol=0)
    model.train()
    paths = tvis_hooks.make_open_seg_vis_hook(
        ds, out_dir=str(tmp_path / "samples"), n_samples=3,
        down_factor=2)(model, 7)
    assert model.training
    assert set(paths) == {f"sample{s}_class{c}_{n}" for s in range(2)
                          for c in range(2) for n in ("img", "sim", "gt")}
    assert all(Path(p).name.startswith("step7_") and Path(p).stat().st_size
               for p in paths.values())


# --- the entry points -------------------------------------------------------------


def _seg_yaml(tmp_path, out_dim=3):
    cfg = {"random_seed": 0, "results_folder": str(tmp_path / "run"),
           "arch": TINY_ARCH, "dim_latent": DIM_LATENT,
           "text_encoder": TEXT_ENCODER,
           "ct_clip_arch": {"use_seg": True, "seg_head": {
               "n_layers": 2, "mid_dim": 16, "out_dim": out_dim}}}
    path = tmp_path / "seg.yaml"
    path.write_text(json.dumps(cfg))
    return str(path)


def test_run_zero_shot_seg_on_cpu(tmp_path, capsys):
    cfg = _seg_yaml(tmp_path)
    base = ["--config", cfg, "--synthetic", "2"]
    results = {}
    for mode in ("--int8", "--no-int8"):
        out = tmp_path / mode.strip("-")
        results[mode] = run_zero_shot_seg.main(
            base + [mode, "--results_folder", str(out)], device="cpu")
        printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert printed == results[mode]
        assert set(printed) == {"dice_class_0", "dice_class_1",
                                "dice_class_2", "mean_dice"}
        assert np.load(out / "dice_scores.npy").shape == (2, 3)
    # the port's checkpoint directory, then a reference CTClip.*.pt
    from vit_exp_tpu_torch.core.config import load_config
    from vit_exp_tpu_torch.data.tokenizer import load_tokenizer
    from vit_exp_tpu_torch.models.factory import bert_config_for

    config = load_config(cfg)
    model = build_ctclip(config, bert_config_for(config, load_tokenizer()),
                         device="cpu", seed=5, attn_impl="pallas_static",
                         fuse_qkv=True)
    ckpt = CheckpointManager(str(tmp_path / "checkpoints"))
    ckpt.save(3, model.state_dict(), {"step": 3}, wait=True)
    ref = tzs.ZeroShotSegmenter(model).infer(tsynthetic.SyntheticCTDataset(
        "imageseg", n=2, arch=config.arch, n_classes=3), num_workers=1)
    for path in (tmp_path / "checkpoints", tmp_path / "checkpoints" / "ckpt_3"):
        got = run_zero_shot_seg.main(
            base + ["--no-int8", "--results_folder", str(tmp_path / "ck"),
                    "--model_path", str(path)], device="cpu")
        assert got == ref
    assert ref != results["--no-int8"]
    capsys.readouterr()


def test_run_zero_shot_seg_loads_a_reference_checkpoint(tmp_path):
    """A JAX-exported CTClip.*.pt with the seg heads loads through
    --torch_ckpt onto exactly the parameters from_jax_params gives, and
    serves."""
    jcfg, _ = _configs(**SEG_ARCH)
    params = jax_params(jcfg, seed=31)
    a = jcfg.arch
    grid = (a.temporal_size // a.temporal_patch_size,
            a.image_size // a.patch_size, a.image_size // a.patch_size)
    from vit_exp_tpu.models.bert import BertConfig as JaxBertConfig

    sd = export_ctclip_state_dict(params, grid=grid, heads=a.heads,
                                  bert_config=JaxBertConfig.tiny())
    assert "seg_head.2.weight" in sd and "open_text_head.2.bias" in sd
    pt = tmp_path / "CTClip.7.pt"
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
               pt)
    cfg = json.loads(Path(_seg_yaml(tmp_path)).read_text())
    cfg["ct_clip_arch"] = _config_dict(**SEG_ARCH)["ct_clip_arch"]
    cfg["text_encoder"] = dict(vars(BertConfig.tiny()))
    path = tmp_path / "ref.yaml"
    path.write_text(json.dumps(cfg))
    config = tconfig.load_config(str(path))
    model = build_ctclip(config, BertConfig.tiny(), device="cpu")
    run_zero_shot_seg.load_weights(model, str(pt), torch_ckpt=True)
    want = from_jax_params(params)
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    res = run_zero_shot_seg.main(
        ["--config", str(path), "--synthetic", "2", "--no-int8",
         "--results_folder", str(tmp_path / "out"), "--model_path", str(pt),
         "--torch_ckpt"], device="cpu")
    assert set(res) == {"dice_class_0", "dice_class_1", "mean_dice"}


def test_run_zero_shot_seg_refuses_what_is_not_ported(tmp_path):
    cfg = _seg_yaml(tmp_path)
    base = ["--config", cfg, "--results_folder", str(tmp_path / "o")]
    # a grid of 2 processes on 1 (fsdp and model are ported, M7b)
    with pytest.raises(MeshError, match="1x2x1 != 1"):
        run_zero_shot_seg.main(base + ["--synthetic", "2", "--mesh",
                                       "1,2,1"], device="cpu")
    # without --synthetic and without folders: JAX's TypeError (the
    # folders themselves: tests/test_torch_realdata.py)
    with pytest.raises(TypeError):
        run_zero_shot_seg.main(base, device="cpu")
    plain = json.loads(Path(cfg).read_text())
    plain["ct_clip_arch"] = {}
    Path(cfg).write_text(json.dumps(plain))
    with pytest.raises(ValueError, match="use_seg"):
        run_zero_shot_seg.main(base + ["--synthetic", "2"], device="cpu")


def _mixed_yaml(tmp_path, name, hooks=True):
    """configs/planted_mixed.yaml at the tiny arch and text tower: 4 steps,
    the eval hooks every 2, small single-epoch data sets."""
    cfg = yaml.safe_load((ROOT / "configs" / "planted_mixed.yaml").read_text())
    cfg["results_folder"] = str(tmp_path / name)
    cfg["arch"] = dict(TINY_ARCH, arch_name="ctvit_3d")
    cfg["text_encoder"] = TEXT_ENCODER
    cfg["dim_latent"] = DIM_LATENT
    cfg["trainer"].update(num_train_steps=4, eval_model_every=2,
                          save_model_every=0)
    for spec, bs in zip(cfg["train_data_list"], (2, 1, 1)):
        spec.update(batch_size=bs, n=8, num_workers=1)
    if not hooks:
        cfg.pop("valid_test_list")
    path = tmp_path / f"{name}.yaml"
    path.write_text(json.dumps(cfg))
    return str(path)


def test_run_train_planted_mixed(tmp_path):
    hooked = run_train.main(["--config", _mixed_yaml(tmp_path, "hooked"),
                             "--debug"], device="cpu")
    plain = run_train.main(["--config", _mixed_yaml(tmp_path, "plain", False),
                            "--debug"], device="cpu")
    assert hooked.status == plain.status == "completed"
    assert hooked.data_types == ["imagereport", "imageseg", "imageopenseg"]
    assert list(hooked.eval_hooks) == ["zero_shot_cls_planted",
                                       "seg_test_planted"]
    lines = [json.loads(x) for x in open(tmp_path / "hooked" /
                                         "metrics.jsonl")]
    train = [d for d in lines if "ds0_cl_loss" in d]
    assert [d["step"] for d in train] == [1, 2, 3, 4]
    for d in train:
        for k in ("ds0_cl_loss", "ds1_seg_loss", "ds2_open_seg_loss"):
            assert math.isfinite(d[k]), (k, d)
    seg = [d for d in lines if "eval/seg_test_planted/mean_dice" in d]
    assert [d["step"] for d in seg] == [2, 4]
    for d in seg:
        keys = {k for k in d if k.startswith("eval/seg_test_planted/")}
        assert keys == {f"eval/seg_test_planted/{k}" for k in
                        ("dice_class_0", "dice_class_1", "mean_dice")}
    # the hooks train nothing and draw from no random stream
    a, b = hooked.model.state_dict(), plain.model.state_dict()
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_run_train_synthetic_seg_masks_keep_four_classes(tmp_path):
    """As the JAX CLI, --synthetic makes 4-class masks whatever the seg
    head's width: a 3-class head trains on neither side."""
    cfg = json.loads(Path(_seg_yaml(tmp_path, out_dim=3)).read_text())
    cfg.update(trainer={"lr": 1e-4, "num_train_steps": 1,
                        "save_model_every": 0},
               train_data_list=[{"type": "imageseg", "batch_size": 1,
                                 "num_workers": 1}])
    path = tmp_path / "syn.yaml"
    path.write_text(json.dumps(cfg))
    argv = ["--config", str(path), "--synthetic", "2", "--debug"]
    got = run_train.build_datasets(tconfig.load_config(str(path)), None,
                                   synthetic=2)[0][1]
    from vit_exp_tpu.core.config import load_config as jax_load_config

    ref = jax_run_train.build_datasets(jax_load_config(str(path)), None,
                                       synthetic=2)[0][1]
    assert got["seg_mask"].shape[0] == ref["seg_mask"].shape[0] == 4
    np.testing.assert_array_equal(got["seg_mask"], ref["seg_mask"])
    with pytest.raises(ValueError):
        run_train.main(argv, device="cpu")
    # the JAX step's loss on the same shapes
    logits = jnp.zeros((1, 3) + got["seg_mask"].shape[1:])
    with pytest.raises(TypeError, match="broadcasting"):
        jlosses.seg_bce_loss(logits, jnp.asarray(ref["seg_mask"][None]))


def test_chip_smoke_seg_phases_rehearse_on_cpu(tmp_path, monkeypatch):
    """chip_smoke's segmentation phases at the tiny arch on the CPU (every
    wrapper runs its plain twin, so no launch is counted and the kernel
    and plain paths agree exactly): the seg, open-seg and fusion steps,
    run_zero_shot_seg at int8 and bf16, the mixed planted run with its
    per-type counts, and the rows each path copies."""
    import chip_smoke as cs

    cpu = torch.device("cpu")
    none = cs.expected_launches({})
    arch = dict(TINY_ARCH, channels=1)
    monkeypatch.setattr(cs, "ARCH", arch)
    bert = BertConfig.tiny()
    for key, data_type, extra, n_prompts in (
            ("seg", "imageseg", {}, 0),
            ("open-seg", "imageopenseg", dict(
                open_seg_loss_type="clip_focal_loss",
                open_seg_loss_down_factor=4,
                open_seg_loss_hyper_config={"gamma": 2, "alpha": 0.25}), 4),
            ("open-seg fusion", "imageopenseg", dict(
                fix_text_encoder=True, open_seg_loss_type="fusion_focal_loss",
                open_seg_loss_hyper_config={"choose_cls": [5]},
                fusion_head={"type": "mlp", "mlp": {"mid_dim": 16,
                                                    "out_dim": 1}}), 6)):
        cfg = tconfig.ExperimentConfig.from_dict(
            {"arch": TINY_ARCH, "ct_clip_arch": {
                "use_seg": data_type == "imageseg",
                "use_open_seg": data_type != "imageseg",
                "seg_head": {"mid_dim": 16, "out_dim": 3}, **extra}})
        assert cs.arch_dict(cfg) == arch
        r = cs.seg_train_phase(cpu, cfg, bert, data_type, none, key,
                               n_prompts or 3, n_prompts, timed=1)
        assert r["fwd_rel"] == 0 and r["dloss"] == 0 and r["dnorm"] == 0
        assert r["launches"] == none and math.isfinite(r["loss"])
    cfg = json.loads(Path(_seg_yaml(tmp_path)).read_text())
    cfg["text_encoder"] = TEXT_ENCODER
    path = tmp_path / "serve.yaml"
    path.write_text(json.dumps(cfg))
    logits = []
    for int8 in (True, False):
        r, lg = cs.seg_serve_phase(cpu, path, tmp_path, int8, none, timed=1)
        assert r["rel"] == 0 and r["vps"] > 0 and set(r["res"]) == {
            "dice_class_0", "dice_class_1", "dice_class_2", "mean_dice"}
        logits.append(lg)
    assert logits[0].shape == logits[1].shape == (1, 3, 16, 32, 32)

    monkeypatch.setattr(cs, "MIXED_EVAL_EVERY", 2)
    specs = yaml.safe_load(cs.MIXED_CONFIG.read_text())["train_data_list"]
    for spec in specs:
        spec.update(batch_size=1, n=8, num_workers=1)
    mixed = cs.mixed_phase(cpu, tmp_path, overrides={
        "arch": TINY_ARCH, "text_encoder": TEXT_ENCODER,
        "dim_latent": DIM_LATENT, "train_data_list": specs},
        steps=4, count_step=3, skip=1)
    assert mixed["by_type"] == {t: none for t in cs.MIXED_TYPES}
    assert len(mixed["seg_dice"]) == len(mixed["cls_auc"]) == 2
    assert cs.mixed_batches() == (8, 4)

    rows = [{"name": "K2 act", "counter": "K2h", "ms": 1.0}]
    assert cs.path_rows(rows, "seg step", dict(none, K2h=8)) == [
        {"name": "K2 act [seg step]", "ms": 1.0, "launches": 8}]
    with pytest.raises(RuntimeError, match="never launched"):
        cs.path_rows(rows, "seg step", none)
    cases = cs.seg_train_cases(cpu, arch, 1, tag=" (x)")
    assert [c.counter for c in cases] == [
        "K15", "dKdV", "dQ", "K2x", "K2h", "K2o", "K4", "K8y", "K8dh",
        "K8dy", "K8dx", "K8w", "K8sum"]
    assert all(c.name.endswith(" (x)") for c in cases)
    serve = {c.counter for c in cs.seg_serve_cases(cpu, True, arch)}
    assert serve == {"K9/K10", "K11y", "K11h", "K11q", "K11o", "K13x",
                     "K13mm", "K14", "K4"}
    assert {c.counter for c in cs.seg_serve_cases(cpu, False, arch)} == {
        "K1", "K2x", "K2h", "K2o", "K3", "K4"}


def _convergence_script():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "train_convergence_torch",
        ROOT / "scripts" / "train_convergence_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("mode,task", [("planted_seg", "seg"),
                                       ("planted_openseg", "openseg")])
def test_learning_script_seg_modes(tmp_path, monkeypatch, mode, task):
    """JAX's seg recipe (scripts/train_convergence.py:60-260): batch 8, lr
    2e-4 with 30 warmup steps, wd 0.01, clip 1.0; a 2-class seg head, or
    the fusion arm (α 0.75, γ 2, MLP 32 → 32 → 1) at down factor 2.  Then
    the CPU plumbing smoke at the tiny arch: it trains, scores its
    held-out set and misses the 0.5 bound (exit non-zero), writing its
    scores with the loss curve."""
    mod = _convergence_script()
    cfg = mod.planted_config(100, str(tmp_path), "mid", 8, 2, task)
    t = cfg.trainer
    assert (t.lr, t.warmup_steps, t.wd, t.max_grad_norm) == (2e-4, 30, 0.01,
                                                             1.0)
    ca = cfg.ct_clip_arch
    if task == "seg":
        assert ca.use_seg and ca.seg_head.out_dim == 2
    else:
        assert ca.use_open_seg and ca.open_seg_loss_type == "fusion_focal_loss"
        assert ca.open_seg_loss_hyper_config == {"alpha": 0.75, "gamma": 2.0}
        assert ca.open_seg_loss_down_factor == 2
        assert (ca.fusion_head.n_layers, ca.fusion_head.mid_dim,
                ca.fusion_head.out_dim) == (2, 32, 1)
    for k, v in dict(CONV_CPU="1", CONV_SIZE="tiny", CONV_BATCH="2",
                     CONV_EVAL_N="3", CONV_SAVE_EVERY="0",
                     CONV_OUT=str(tmp_path / mode)).items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr("sys.argv", ["train_convergence_torch.py", mode, "3"])
    with pytest.raises(SystemExit, match="below the 0.5 bound"):
        mod.planted_main(task)
    scores = json.loads((tmp_path / mode / "planted_scores_3.json")
                        .read_text())
    assert 0 <= scores["mean_dice"] <= 1 and scores["steps"] == 3
    assert scores["eval_n"] == 3 and scores["loss_curve"] == []
