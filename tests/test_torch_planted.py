"""CPU parity of the port's planted-signal data against the JAX package, and
``run_train`` on planted data with its eval hook.

- ``PlantedCTDataset`` and ``PlantedInferenceDataset``: every field of an
  item byte for byte equal to JAX's (the fp16 volume, the report, the token
  ids of the same tokenizer, labels and accession), at the tiny arch, at
  index 0 of the mid arch of scripts/train_convergence.py, and with
  sentence dropping (``drop_any_p`` 0.25, ``drop_neg_p`` 0.5).
- ``run_train.main(..., device="cpu")`` on a tiny planted config with
  ``valid_test_list: [zero_shot_cls_planted]``: eval lines at the steps
  ``eval_model_every`` names, each after its step's train line, under JAX's
  key names; the final parameters bit-equal to those of the same run
  without the hook; RadGenome segmentation folders and a segmentation
  ``valid_data`` set are refused before training.
- ``build_ctclip`` builds the two tiny --synthetic configs on the CPU, and
  ``kernel_refusals`` names nothing the card's kernels refuse in them (head
  dim 8, D 48, 2I 256; plain, fused and fused int8) or in the shipped
  dim-384 and dim-768 configs.
"""

import dataclasses
import json
import math
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_trainer import TINY_ARCH, _tiny_yaml
from vit_exp_tpu.core import config as jconfig
from vit_exp_tpu.data import planted as jplanted
from vit_exp_tpu.data import tokenizer as jtokenizer
from vit_exp_tpu.eval import metrics as jmetrics
from vit_exp_tpu_torch.cli import run_train
from vit_exp_tpu_torch.core import config as tconfig
from vit_exp_tpu_torch.data import planted as tplanted
from vit_exp_tpu_torch.data import tokenizer as ttokenizer
from vit_exp_tpu_torch.models.bert import BertConfig
from vit_exp_tpu_torch.models.factory import build_ctclip, kernel_refusals

ROOT = Path(__file__).resolve().parents[1]
MID_ARCH = {"dim": 384, "image_size": 120, "patch_size": 10,
            "temporal_size": 120, "temporal_patch_size": 10,
            "transformer_blocks": 4, "dim_head": 32, "heads": 8}


def _archs(arch):
    return tconfig.ArchConfig(**arch), jconfig.ArchConfig(**arch)


def _assert_same_item(a, b):
    assert a.keys() == b.keys()
    for k in b:
        if isinstance(b[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert a[k].tobytes() == b[k].tobytes(), k
        else:
            assert a[k] == b[k], k


def test_planted_constants_match_jax():
    assert tplanted.PLANTED_ATTRS == jplanted.PLANTED_ATTRS
    assert tplanted._CENTERS == jplanted._CENTERS
    assert tplanted._APPEARANCE == jplanted._APPEARANCE


@pytest.mark.parametrize("arch,indices,drop", [
    (TINY_ARCH, (0, 1, 7, 30), {}),
    (TINY_ARCH, (0, 3, 11), {"drop_any_p": 0.25}),
    (TINY_ARCH, (2, 5), {"drop_neg_p": 0.5}),
    (MID_ARCH, (0,), {}),
], ids=["tiny", "tiny_drop_any", "tiny_drop_neg", "mid"])
def test_planted_train_set_matches_jax(arch, indices, drop):
    tarch, jarch = _archs(arch)
    ttok, jtok = ttokenizer.load_tokenizer(), jtokenizer.load_tokenizer()
    got = tplanted.PlantedCTDataset(64, arch=tarch, tokenizer=ttok,
                                    max_text_len=64, seed=0, **drop)
    ref = jplanted.PlantedCTDataset(64, arch=jarch, tokenizer=jtok,
                                    max_text_len=64, seed=0, **drop)
    for i in indices:
        a, b = got[i], ref[i]
        assert a["image"].dtype == np.float16
        _assert_same_item(a, b)


@pytest.mark.parametrize("arch,indices,seed", [
    (TINY_ARCH, (0, 1, 15), 1), (TINY_ARCH, (4,), 3), (MID_ARCH, (0,), 1)],
    ids=["tiny", "tiny_seed3", "mid"])
def test_planted_inference_set_matches_jax(arch, indices, seed):
    tarch, jarch = _archs(arch)
    got = tplanted.PlantedInferenceDataset(16, arch=tarch, seed=seed)
    ref = jplanted.PlantedInferenceDataset(16, arch=jarch, seed=seed)
    for i in indices:
        _assert_same_item(got[i], ref[i])


def test_planted_report_refuses_dropping_without_rng():
    with pytest.raises(ValueError):
        tplanted.planted_report([1, 0, 1, 0], drop_any_p=0.25)


def _planted_yaml(tmp_path, name, valid=(), **extra):
    cfg = json.loads(Path(_tiny_yaml(tmp_path, num_train_steps=4,
                                     eval_model_every=2)).read_text())
    cfg["results_folder"] = str(tmp_path / name)
    cfg["train_data_list"] = [{"name": "planted", "type": "imagereport",
                               "planted": True, "n": 16, "batch_size": 2,
                               "num_workers": 2}]
    cfg["valid_test_list"] = list(valid)
    cfg.update(extra)
    path = tmp_path / f"{name}.yaml"
    path.write_text(json.dumps(cfg))
    return str(path)


def test_run_train_planted_with_the_eval_hook(tmp_path):
    name = "zero_shot_cls_planted"
    hooked = run_train.main(["--config", _planted_yaml(
        tmp_path, "hooked", [name]), "--debug"], device="cpu")
    plain = run_train.main(["--config", _planted_yaml(tmp_path, "plain"),
                            "--debug"], device="cpu")
    assert hooked.status == plain.status == "completed"
    assert list(hooked.eval_hooks) == [name] and not plain.eval_hooks
    lines = [json.loads(x) for x in open(tmp_path / "hooked" / "metrics.jsonl")]
    kinds = [(d["step"], any(k.startswith("eval/") for k in d)) for d in lines]
    assert kinds == [(1, False), (2, False), (2, True), (3, False), (4, False),
                     (4, True)]
    # JAX's keys: evaluate_internal's over the planted attributes, and the
    # engine's throughput, under eval/<name>/
    ref_keys = set(jmetrics.evaluate_internal(
        np.zeros((2, 4)), np.eye(2, 4), list(jplanted.PLANTED_ATTRS)))
    for d in (lines[2], lines[5]):
        evals = {k[len(f"eval/{name}/"):]: v for k, v in d.items()
                 if k.startswith("eval/")}
        assert set(evals) == ref_keys | {"volumes_per_sec"}
        assert all(math.isfinite(v) for v in evals.values()), evals
    # the hook trains nothing and draws from no random stream
    assert hooked.model.training
    a, b = hooked.model.state_dict(), plain.model.state_dict()
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_run_train_refuses_segmentation_before_training(tmp_path):
    """Planted segmentation data and the seg hook run
    (tests/test_torch_seg_eval.py), and so do RadGenome folders
    (tests/test_torch_realdata.py); a RadGenome set whose image and mask
    counts differ, as a train entry or as a segmentation valid_data set,
    raises JAX's AssertionError before training."""
    images, masks = tmp_path / "images", tmp_path / "masks"
    images.mkdir()
    masks.mkdir()
    for i in range(2):
        np.savez(images / f"case_{i}.npz", np.zeros((4, 4, 4), np.float32))
    np.savez(masks / "case_0.npz", np.zeros((2, 4, 4, 4), np.uint8))
    folders = {"data_folder": str(images), "mask_folder": str(masks)}
    tree = tmp_path / "tree" / "t_0" / "t_0a"
    tree.mkdir(parents=True)
    np.savez(tree / "t_0_a_1.npz", np.zeros((4, 4, 4), np.float32))
    (tmp_path / "reports.csv").write_text(
        "VolumeName,Findings_EN,Impressions_EN\nt_0_a_1.nii.gz,a,b\n")
    for cfg in (_planted_yaml(tmp_path, "seg", train_data_list=[
                    {"type": "imageseg", "batch_size": 2, **folders}]),
                _planted_yaml(tmp_path, "segvalid", ["seg_test"],
                              train_data_list=[{
                                  "type": "imagereport", "batch_size": 1,
                                  "data_folder": str(tmp_path / "tree"),
                                  "reports_csv": str(tmp_path /
                                                     "reports.csv")}],
                              valid_data={"seg": folders})):
        with pytest.raises(AssertionError, match="2 images vs 1 masks"):
            run_train.make_trainer(run_train.parse_args(
                ["--config", cfg, "--debug"]), device="cpu")
        for sub in (images / "tmp_cache_data_list",
                    masks / "tmp_cache_mask_list"):
            shutil.rmtree(sub)
    assert not (tmp_path / "seg" / "metrics.jsonl").exists()


@pytest.mark.parametrize("name", ["ct_clip_debug_synthetic.yaml",
                                  "ct_clip_dcl_synthetic.yaml"])
def test_tiny_configs_build_on_the_cpu_and_name_their_refusals(name):
    """The tiny configs build, and the card's kernels refuse none of their
    widths: kernel_refusals names nothing, unfused, fused and fused int8."""
    config = tconfig.load_config(str(ROOT / "configs" / name))
    model = build_ctclip(config, BertConfig.tiny(), device="cpu")
    assert model.visual_transformer.dim == 48
    for fuse_qkv, int8 in ((False, False), (True, False), (True, True)):
        assert kernel_refusals(config.arch, fuse_qkv=fuse_qkv,
                               int8=int8) == []


@pytest.mark.parametrize("name", ["ct_clip_vit_v3_flat_dim384.yaml",
                                  "planted_mixed.yaml",
                                  "ct_clip_vit_from_scratch.yaml"])
def test_shipped_widths_pass_the_kernel_checks(name):
    arch = tconfig.load_config(str(ROOT / "configs" / name)).arch
    assert kernel_refusals(arch, fuse_qkv=True) == []
    assert kernel_refusals(tconfig.ArchConfig(**MID_ARCH), fuse_qkv=True) == []


def test_mid_arch_matches_the_jax_recipe():
    """scripts/train_convergence_torch.py's mid arch is the JAX recipe's."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "train_convergence_torch", ROOT / "scripts" / "train_convergence_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    arch, text = mod.SIZES["mid"]
    assert {k: v for k, v in arch.items() if k != "arch_name"} == MID_ARCH
    assert text == {"num_hidden_layers": 4, "hidden_size": 384,
                    "num_attention_heads": 6, "intermediate_size": 1536}
    assert dataclasses.asdict(mod.planted_config(
        8, "out", "mid", 32, 2).trainer)["max_grad_norm"] == 1.0


def test_chip_smoke_planted_phase_rehearses_on_cpu(tmp_path, monkeypatch):
    """chip_smoke's planted phase at the tiny arch on the CPU (every wrapper
    runs its plain twin, so no launch is counted): run_train with the hook
    writes its eval lines in order, the recipe's scoring engine agrees with
    the all-plain one, and the K8 rows of the planted shape carry their
    work."""
    import chip_smoke as cs

    cpu = torch.device("cpu")
    monkeypatch.setattr(cs, "PLANTED_ARCH", dict(TINY_ARCH, dim_head=32,
                                                 heads=2))
    monkeypatch.setattr(cs, "PLANTED_TEXT", {
        "hidden_size": 36, "num_hidden_layers": 1, "num_attention_heads": 3,
        "intermediate_size": 32, "max_position_embeddings": 128})
    for name, value in (("PLANTED_BATCH", 2), ("PLANTED_STEPS", 4),
                        ("PLANTED_EVAL_EVERY", 2), ("PLANTED_COUNT_STEP", 3),
                        ("PLANTED_SCORE_N", 4)):
        monkeypatch.setattr(cs, name, value)
    pl = cs.planted_phase(cpu, tmp_path, skip=1)
    assert len(pl["evals"]) == 2 and len(pl["hook_s"]) == 2
    assert pl["launches"] == cs.expected_launches({})
    assert all(c == cs.expected_launches({}) for c in pl["hook_launches"])
    assert pl["sps"] > 0 and pl["wait_s"] >= 0 and len(pl["losses"]) == 4
    assert pl["score_dprob"] <= 1e-6 and 0 <= pl["score"]["mean_auc"] <= 1
    cases = cs.planted_kernel_cases(cpu)
    assert [c.counter for c in cases] == ["K8y", "K8dh", "K8dy", "K8dx",
                                          "K8w", "K8sum"]
    assert all(c.name.endswith("(D 48, the planted path)") for c in cases)
