"""The port's grids through its entry points on the CPU, as gloo processes
(tests/_torch_dist_runner.py; no jax in them):

- checkpoints cross grids: ``run_train`` (the seg step, whose loss is a
  mean over samples, at the same global batch of 2 on every grid) writes
  ckpt_1 in one process; ``--mesh 1,2,1`` (parameters sharded) and
  ``1,1,2`` (tensor parallel) resume it and write it back bit for bit,
  and take step 2 as the one process does; ckpt_1 written on those grids
  resumes in one process to the same step 2 (bf16 compute: the loss
  within STEP_RTOL, each parameter by ``_close``);
- a 4-rank ``run_train --mesh 2,1,2``: the group layout, the loader's
  shards (the model group's 2 ranks read the same rows), the same losses
  on every rank;
- F6: ``run_zero_shot_seg`` at its int8 default as 2 processes at 1 volume
  a rank writes what one process writes at 2 volumes a batch (the k scale
  taken over the global batch);
- ``serve --mesh 2,1,1`` on two CPU "devices": the split engine's int8
  answers are ``predict_batch`` of the whole batch on one, bit for bit;
- the modules of the grid import no jax.
"""

import json
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests._torch_dist_runner import ROOT, free_port, start
from tests.test_torch_dist_cli import LR, TINY_ARCH, _flags, _yaml

SEG = {"use_seg": True,
       "seg_head": {"n_layers": 2, "mid_dim": 16, "out_dim": 4}}
# bf16 compute on the CPU: the grids' sums round in other orders
STEP_RTOL = 2e-2


def _seg_yaml(tmp_path, name, batch):
    return _yaml(tmp_path, name, {
        "ct_clip_arch": SEG,
        "trainer": {"lr": LR, "wd": 0.01, "num_train_steps": 2,
                    "save_model_every": 0},
        "train_data_list": [{"type": "imageseg", "batch_size": batch,
                             "num_workers": 1}]})


def _ckpt(folder, step):
    path = folder / "checkpoints" / f"ckpt_{step}"
    return {name: torch.load(path / f"{name}.pt", weights_only=True)
            for name in ("model", "train_state")}


def _flat(tree, prefix=""):
    """{path: tensor} of a nested dict/list of tensors and numbers."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def _losses(folder):
    return [json.loads(line)["ds0_loss"]
            for line in open(folder / "metrics.jsonl")]


def _close(a, b):
    """Within STEP_RTOL relative L2, or, for a tensor whose Adam step is
    rounding noise (a bias at zero), within 2·lr of each element (one
    step from one state moves an element by at most about lr)."""
    a, b = a.double(), b.double()
    rel = float((a - b).norm() / b.norm().clamp_min(1e-30))
    return rel < STEP_RTOL or float((a - b).abs().max()) <= 2 * LR


def test_checkpoints_cross_grids(tmp_path):
    from vit_exp_tpu_torch.cli import run_train

    base = ["--synthetic", "8", "--debug"]
    run_train.main(["--config", _seg_yaml(tmp_path, "x", 2), *base,
                    "--steps", "1"], device="cpu")
    # name: (grid, loader batch a rank, resumes x, steps)
    runs = {"b": ("1,2,1", 1, True, 2), "c": ("1,1,2", 2, True, 2),
            "bb": ("1,2,1", 1, True, 1), "cc": ("1,1,2", 2, True, 1),
            "d": ("1,2,1", 1, False, 1), "e": ("1,1,2", 2, False, 1)}
    finish = []
    for name, (grid, batch, resume, steps) in runs.items():
        cfg = _seg_yaml(tmp_path, name, batch)
        if resume:
            shutil.copytree(tmp_path / "x" / "checkpoints",
                            tmp_path / name / "checkpoints")
        port = free_port()
        finish.append(start(
            "train", 2, str(tmp_path / f"w_{name}"),
            args=lambda r, cfg=cfg, grid=grid, steps=steps, port=port: [
                "--config", cfg, *base, "--steps", str(steps),
                "--auto_resume", "--mesh", grid] + _flags(r, port)))
    outs = dict(zip(runs, (f() for f in finish)))
    # one process resumes x, and the sharded grids' ckpt_1
    for name, src in (("a", "x"), ("f", "d"), ("g", "e")):
        cfg = _seg_yaml(tmp_path, name, 2)
        shutil.copytree(tmp_path / src / "checkpoints",
                        tmp_path / name / "checkpoints")
        shutil.rmtree(tmp_path / name / "checkpoints" / "ckpt_2",
                      ignore_errors=True)
        run_train.main(["--config", cfg, *base, "--auto_resume"],
                       device="cpu")
    for name, (grid, _, _, _) in runs.items():
        for r, out in enumerate(outs[name]):
            assert out["status"] == "completed", (name, r)
            assert out["written"] == ([runs[name][3]] if r == 0 else [])
    # loaded and written back on each grid: the file's every bit
    x1 = _flat(_ckpt(tmp_path / "x", 1))
    for name in ("bb", "cc"):
        got = _flat(_ckpt(tmp_path / name, 1))
        assert set(got) == set(x1), name
        for k, v in x1.items():
            if torch.is_tensor(v):
                assert torch.equal(got[k], v), (name, k)
            else:
                assert got[k] == v, (name, k)
    # the same step 2 from x's ckpt_1 on every grid, and from the sharded
    # grids' ckpt_1 in one process
    ref_loss = _losses(tmp_path / "a")[-1]
    ref = _ckpt(tmp_path / "a", 2)["model"]
    for name in ("b", "c", "f", "g"):
        assert _losses(tmp_path / name)[-1] == pytest.approx(
            ref_loss, rel=STEP_RTOL), name
        got = _ckpt(tmp_path / name, 2)["model"]
        assert set(got) == set(ref)
        for k, v in ref.items():
            assert got[k].shape == v.shape, (name, k)
            assert _close(got[k], v), (name, k)
    # a sharded grid's first step is one process's
    x_model = _ckpt(tmp_path / "x", 1)["model"]
    for name in ("d", "e"):
        got = _ckpt(tmp_path / name, 1)["model"]
        for k, v in x_model.items():
            assert _close(got[k], v), (name, k)


def test_run_train_on_a_2_1_2_grid(tmp_path):
    """Rank r sits at (r // 2, 0, r % 2): ranks 0 and 1 form a model group
    and read batch shard 0, ranks 2 and 3 shard 1; the batch groups are
    {0, 2} and {1, 3}; every rank logs the same global losses."""
    cfg = _yaml(tmp_path, "run")
    port = free_port()
    outs = start("train", 4, str(tmp_path / "w"), args=lambda r: [
        "--config", cfg, "--synthetic", "8", "--debug", "--steps", "2",
        "--mesh", "2,1,2"] + _flags(r, port, 4))()
    for r, out in enumerate(outs):
        d, m = divmod(r, 2)
        assert out["grid"]["coords"] == (d, 0, m)
        groups = out["grid"]["groups"]
        assert groups["model"] == [2 * d, 2 * d + 1]
        assert groups["batch"] == groups["replica"] == [m, m + 2]
        assert groups["fsdp"] is None
        assert out["shard"] == (d, 2, 2)
        assert out["status"] == "completed" and out["step"] == 2
    assert outs[0]["indices"] == outs[1]["indices"]
    assert outs[2]["indices"] == outs[3]["indices"]
    shards = [{i for b in outs[r]["indices"] for i in b} for r in (0, 2)]
    assert not shards[0] & shards[1] and shards[0] | shards[1] == set(range(8))
    losses = [[m["ds0_loss"] for _, m in o["logged"] if "ds0_loss" in m]
              for o in outs]
    for other in losses[1:]:
        assert other == pytest.approx(losses[0], abs=1e-6)
    assert len(losses[0]) == 2 and all(np.isfinite(losses[0]))


def test_two_process_int8_seg_scores_the_global_batch(tmp_path):
    """F6 for the dice engine: 2 ranks at 1 volume a rank, int8, write the
    dice of one process at 2 volumes a batch."""
    from vit_exp_tpu_torch.cli import run_zero_shot_seg

    cfg = _seg_yaml(tmp_path, "seg", 1)
    base = ["--config", cfg, "--synthetic", "4", "--int8"]
    port = free_port()
    two = start("seg", 2, str(tmp_path / "w"), args=lambda r: base + [
        "--batch_size", "1", "--results_folder", str(tmp_path / f"two{r}")]
        + _flags(r, port))()
    one = run_zero_shot_seg.main(base + ["--batch_size", "2",
                                         "--results_folder",
                                         str(tmp_path / "one")],
                                 device="cpu")
    assert not (tmp_path / "two1").exists()
    a = np.load(tmp_path / "one" / "dice_scores.npy")
    b = np.load(tmp_path / "two0" / "dice_scores.npy")
    assert a.shape == b.shape == (4, 4)
    np.testing.assert_array_equal(b, a)
    for out in two:
        assert out["result"] == one


def test_serve_mesh_splits_each_dispatch_bit_for_bit(tmp_path):
    """``serve --mesh 2,1,1`` on the CPU: two copies of the model, each
    dispatch of 5 volumes split 3 + 2 over them with one int8 k scale;
    the answers are the one-device engine's on the whole batch, bit for
    bit, although the two parts' own k amaxes differ (scored alone, the
    parts give other answers)."""
    from vit_exp_tpu_torch.cli import serve
    from vit_exp_tpu_torch.eval.zero_shot import SplitClassifier
    from vit_exp_tpu_torch.ops import attention

    torch.set_num_threads(1)
    cfg = _yaml(tmp_path, "serve")
    split, _, shape, ch = serve.build_service(serve.parse_args(
        ["--config", cfg, "--mesh", "2,1,1", "--max_batch", "4"]), "cpu")
    one, _, _, _ = serve.build_service(serve.parse_args(["--config", cfg]),
                                       "cpu")
    assert isinstance(split, SplitClassifier) and len(split.engines) == 2
    assert split.engines[1].model is not split.engines[0].model
    vols = np.random.default_rng(3).uniform(
        0, 1, (5, ch) + tuple(shape)).astype(np.float32)
    amaxes, quantize = [], attention.quantize_qk

    def record(q, k, scale, amax_reduce=None):
        amaxes.append((q.shape[0], float(k.float().abs().amax())))
        return quantize(q, k, scale, amax_reduce)

    attention.quantize_qk = record
    try:
        got = split.predict_batch(vols)
    finally:
        attention.quantize_qk = quantize
    want = one.predict_batch(vols)
    np.testing.assert_array_equal(got, want)
    parts = {b: [a for n, a in amaxes if n == b] for b in (3, 2)}
    assert len(parts[3]) == len(parts[2]) == TINY_ARCH["transformer_blocks"]
    assert parts[3] != parts[2]
    alone = np.concatenate([one.predict_batch(vols[:3]),
                            one.predict_batch(vols[3:])])
    assert not np.array_equal(alone, want)


_GUARD = """
import sys
from vit_exp_tpu_torch.core import mesh
from vit_exp_tpu_torch.parallel import collectives, sharding
from vit_exp_tpu_torch.ops import attention, flash_attention, geglu_ff
from vit_exp_tpu_torch.models import bert, ctclip, ctvit3d, factory, layers
from vit_exp_tpu_torch.eval import latents, zero_shot
from vit_exp_tpu_torch.train import checkpoint, optimizer, steps, trainer
from vit_exp_tpu_torch.data import loader
from vit_exp_tpu_torch.cli import run_latents, run_train, run_zero_shot_cls
from vit_exp_tpu_torch.cli import run_zero_shot_seg, serve
print(sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "flax", "optax", "vit_exp_tpu", "triton")))
"""


def test_the_grid_modules_import_no_jax():
    res = subprocess.run([sys.executable, "-c", _GUARD], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_tensor_parallel_widths_the_kernels_refuse_are_named():
    """At full width (I 2,048) a model axis of 2, 4 or 8 gives every rank
    a 2I K2 takes; 3 does not (1,364 and 1,366), and the refusal names
    the kernels (on the card, before any launch)."""
    from vit_exp_tpu_torch.models.layers import GEGLUFeedForward
    from vit_exp_tpu_torch.parallel.sharding import tp_width_refusals

    ff = GEGLUFeedForward(768, device="meta")
    for parts in (1, 2, 4, 8):
        assert tp_width_refusals(ff, parts) == []
    (line,) = tp_width_refusals(ff, 3)
    assert "K2, K8" in line and "[1364, 1366]" in line


def test_split_engine_under_more_threads_than_cores(tmp_path):
    """SplitClassifier over 12 CPU copies (more threads than cores) with a
    short switch interval: every dispatch completes, its parts meet at
    each block's barrier, and the answers are one engine's on the whole
    batch; a part that fails breaks the barrier, so the call raises
    rather than waits."""
    import os
    import threading

    from vit_exp_tpu_torch.cli import serve
    from vit_exp_tpu_torch.eval.zero_shot import SplitClassifier

    n = max(12, (os.cpu_count() or 1) + 2)
    cfg = _yaml(tmp_path, "stress")
    split, _, shape, ch = serve.build_service(serve.parse_args(
        ["--config", cfg, "--mesh", f"{n},1,1", "--max_batch", str(n)]),
        "cpu")
    assert isinstance(split, SplitClassifier) and len(split.engines) == n
    vols = np.random.default_rng(4).uniform(
        0, 1, (n + 3, ch) + tuple(shape)).astype(np.float32)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        out = {}
        worker = threading.Thread(
            target=lambda: out.update(got=split.predict_batch(vols)))
        worker.start()
        worker.join(timeout=120)
        assert not worker.is_alive()
        broken = split.engines[-1]
        broken.predict_batch = lambda v: 1 / 0
        with pytest.raises(ZeroDivisionError):
            split.predict_batch(vols)
    finally:
        sys.setswitchinterval(interval)
    np.testing.assert_array_equal(out["got"],
                                  split.engines[0].predict_batch(vols))
