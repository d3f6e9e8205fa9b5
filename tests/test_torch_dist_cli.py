"""The port's multi-process entry points on the CPU, as processes of gloo
groups (tests/_torch_dist_runner.py; no jax in them):

- ``run_train --synthetic`` as 2 processes through the multi-host flags
  (the counterpart of tests/test_multihost.py): the same step and logged
  losses on both ranks (abs 1e-6), rank 0 alone writing metrics.jsonl and
  the checkpoint, the same latest checkpoint on both, a resume from it
  continuing on both, and loader shards that are disjoint and cover the
  data set; a SIGTERM to one rank stopping both at the same step;
- ``run_zero_shot_cls`` as 2 processes (1 volume a rank) writes the same
  files, byte for byte, as one process at the same global batch: bf16 at
  1 volume a batch (the same computation per volume), and int8 at 2 (F6:
  the k scale is taken over the global batch, as JAX's mesh takes it,
  although the ranks' own k amaxes differ); the second rank writes none;
- the loader's process shards, and that the new modules import no jax.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from tests._torch_dist_runner import ROOT, free_port, spawn
from vit_exp_tpu_torch.data.loader import Loader

TINY_ARCH = {"dim": 24, "image_size": 8, "patch_size": 4, "temporal_size": 8,
             "temporal_patch_size": 4, "transformer_blocks": 1,
             "dim_head": 4, "heads": 2}
LR = 1e-4
RANKS = 2


def _flags(rank, port, world=RANKS):
    return ["--coordinator_address", f"localhost:{port}", "--num_processes",
            str(world), "--process_id", str(rank)]


def _yaml(tmp_path, name, extra=None):
    cfg = {"random_seed": 0, "results_folder": str(tmp_path / name),
           "trainer": {"lr": LR, "wd": 0.01, "num_train_steps": 2,
                       "save_model_every": 0},
           "arch": dict(TINY_ARCH), "dim_latent": 16,
           "text_encoder": {"hidden_size": 36, "num_hidden_layers": 1,
                            "num_attention_heads": 3,
                            "intermediate_size": 64,
                            "max_position_embeddings": 512},
           "train_data_list": [{"type": "imagereport", "batch_size": 2,
                                "num_workers": 1}], **(extra or {})}
    path = tmp_path / f"{name}.yaml"
    path.write_text(json.dumps(cfg))
    return str(path)


def test_two_process_run_train(tmp_path):
    cfg = _yaml(tmp_path, "run")
    base = ["--config", cfg, "--synthetic", "8", "--debug"]
    port = free_port()
    first = spawn("train", RANKS, str(tmp_path / "w1"),
                  args=lambda r: base + _flags(r, port))
    for r, out in enumerate(first):
        assert out["status"] == "completed" and out["step"] == 2
        assert out["latest"] == 2
        assert out["logger_enabled"] == (r == 0)
        assert out["written"] == ([2] if r == 0 else [])
        assert out["shard"] == (r, RANKS, 2)
    # the same global losses, logged (and written) by rank 0 alone
    train = [[(s, m) for s, m in o["logged"] if "ds0_loss" in m]
             for o in first]
    assert [s for s, _ in train[0]] == [s for s, _ in train[1]] == [1, 2]
    for (_, m0), (_, m1) in zip(*train):
        for k in ("ds0_cl_loss", "ds0_loss"):
            assert m0[k] == pytest.approx(m1[k], abs=1e-6), k
            assert np.isfinite(m0[k])
    lines = [json.loads(x) for x in open(tmp_path / "run" / "metrics.jsonl")]
    assert [d["step"] for d in lines] == [1, 2]
    assert lines[-1]["ds0_loss"] == pytest.approx(train[0][-1][1]["ds0_loss"])
    assert os.listdir(tmp_path / "run" / "checkpoints") == ["ckpt_2"]
    # the loader shards: disjoint, and together the whole data set
    shards = [{i for b in o["indices"] for i in b} for o in first]
    assert not shards[0] & shards[1] and shards[0] | shards[1] == set(range(8))
    # a resume from the shared latest checkpoint continues on both ranks
    port = free_port()
    resumed = spawn("train", RANKS, str(tmp_path / "w2"),
                    args=lambda r: base + ["--auto_resume", "--steps", "3"]
                    + _flags(r, port))
    for r, out in enumerate(resumed):
        assert out["step"] == 3 and out["latest"] == 3
        assert [s for s, m in out["logged"] if "ds0_loss" in m] == [3]
        assert out["written"] == ([3] if r == 0 else [])


def test_a_sigterm_to_one_rank_stops_both_at_the_same_step(tmp_path):
    """Rank 1 gets a SIGTERM after step 1: the flag, all-reduced at the next
    boundary and read at the one after, stops both ranks after step 2;
    rank 0 saves ckpt_2 and neither waits in a collective."""
    cfg = _yaml(tmp_path, "run", {"trainer": {
        "lr": LR, "num_train_steps": 5, "save_model_every": 0}})
    port = free_port()
    outs = spawn("sigterm_rank1", RANKS, str(tmp_path / "w"),
                 args=lambda r: ["--config", cfg, "--synthetic", "8",
                                 "--debug"] + _flags(r, port))
    for r, out in enumerate(outs):
        assert (out["status"], out["step"], out["latest"]) == \
            ("preempted", 2, 2)
        assert out["written"] == ([2] if r == 0 else [])


@pytest.mark.parametrize("int8", [False, True])
def test_two_process_run_zero_shot_cls_writes_what_one_process_does(
        tmp_path, int8):
    cfg = _yaml(tmp_path, "cls")
    base = ["--config", cfg, "--synthetic", "5",
            "--int8" if int8 else "--no-int8"]
    one = spawn("cls", 1, str(tmp_path / "w1"),
                args=lambda r: base + ["--batch_size", "2" if int8 else "1",
                                       "--results_folder",
                                       str(tmp_path / "one")])
    port = free_port()
    two = spawn("cls", RANKS, str(tmp_path / "w2"),
                args=lambda r: base + ["--batch_size", "1"]
                + _flags(r, port) + [
                    "--results_folder", str(tmp_path / f"two{r}")])
    if int8:   # a scale per rank would fail: the ranks' own amaxes differ
        assert two[0]["local_k_amax"] != two[1]["local_k_amax"]
        assert len(two[0]["local_k_amax"]) == len(two[1]["local_k_amax"])
    assert not (tmp_path / "two1").exists()   # rank 1 writes nothing
    a, b = tmp_path / "one" / "random_init", tmp_path / "two0" / "random_init"
    for name in ("predicted.npz", "labels.npz", "predicted_weights.npz",
                 "labels_weights.npz", "accessions.txt", "aurocs.csv"):
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    ja, jb = (json.loads((d / "aurocs.json").read_text()) for d in (a, b))
    ja.pop("volumes_per_sec"), jb.pop("volumes_per_sec")
    assert ja == jb
    assert len((b / "accessions.txt").read_text().split()) == 5
    for out in two:   # every rank computed the same result
        res = dict(out["result"]["random_init"])
        res.pop("volumes_per_sec")
        assert res == ja


@pytest.mark.parametrize("n, shards", [(8, 2), (10, 3), (2, 3)])
def test_loader_shards_are_disjoint_and_cover_the_data_set(n, shards):
    data = list(range(n))
    parts = [Loader(data, 1, shuffle=True, seed=4, num_shards=shards,
                    shard_id=s)._batch_indices() for s in range(shards)]
    per = -(-n // shards)
    assert all(len(p) == per for p in parts)   # the same batches on each
    flat = [[i for b in p for i in b] for p in parts]
    # each shard's own stride, before the wrap-round padding
    own = [set(f[:len(range(s, n, shards))]) for s, f in enumerate(flat)]
    assert set().union(*own) == set(range(n))
    assert sum(len(o) for o in own) == n
    whole = Loader(data, 1, shuffle=True, seed=4)._batch_indices()
    assert [i for b in whole for i in b][0::shards] == flat[0][:len(own[0])]


_GUARD = """
import sys
from vit_exp_tpu_torch.core import mesh, multihost
from vit_exp_tpu_torch.parallel import collectives
from vit_exp_tpu_torch.ops import ring_attention
from vit_exp_tpu_torch.cli import run_latents, run_train, run_zero_shot_cls
from vit_exp_tpu_torch.cli import run_zero_shot_seg
print(sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "flax", "vit_exp_tpu", "triton")))
"""


def test_the_new_modules_import_no_jax():
    res = subprocess.run([sys.executable, "-c", _GUARD], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"
