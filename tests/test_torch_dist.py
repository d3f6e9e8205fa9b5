"""CPU parity of the port's data parallelism and multi-process entry points
against the JAX package, in gloo process groups of 2 ranks
(tests/_torch_dist_runner.py; no jax in the ranks).

- The data-parallel train step: 2 ranks at local batch 2 against JAX's
  ``make_train_steps(..., n_data_shards=2)`` at global batch 4 (the
  global program; XLA attention and feed-forward, the port's plain
  twins), fp32, loss weight 0.5, for the image-report step, the seg step,
  the open-seg step (clip_focal_loss), the image-report step with the MLM
  and SimCLR terms (JAX's draws of the global batch handed in, as
  tests/test_torch_ssl.py does) and the open-seg step on the Tversky arm.
  Every metric within 2e-5 relative (tests/test_sharding.py's bound) on
  both ranks; the parameters after one update bit-equal across the ranks
  and, against JAX, within relative L2 1e-5 per tensor, or, for a tensor
  whose gradient is rounding noise (norm below NOISE in the port's own
  one-process step at the global batch; Adam turns noise into a step of
  up to lr), within max |Δ| ≤ 2·lr.
  (The CLIs as processes: tests/test_torch_dist_cli.py.)
- The grid (M7b): the ranks' places on an fsdp or model axis of 2, and
  ``serve --mesh`` refusing a card count or a --max_batch that does not
  fit (tests/test_torch_mesh*.py run the grids); the refusals: a process
  count or id without a coordinator, a grid that does not match the
  process count, and a CUDA group on a host without a card (no gloo
  fallback).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_exp_tpu.core import config as jconfig
from vit_exp_tpu.core.precision import FP32_POLICY as JAX_FP32
from vit_exp_tpu.models.bert import BertConfig as JaxBertConfig
from vit_exp_tpu.models.factory import build_ctclip as jax_build_ctclip
from vit_exp_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from vit_exp_tpu.train.steps import create_train_state
from vit_exp_tpu.train.steps import make_train_steps as jax_make_train_steps

from tests._torch_dist_runner import free_port, start
from tests.test_torch_models import jax_params
from tests.test_torch_ssl import _step_draws
from vit_exp_tpu_torch.cli import serve
from vit_exp_tpu_torch.core import mesh, multihost
from vit_exp_tpu_torch.core import config as tconfig
from vit_exp_tpu_torch.models.convert import from_jax_params

TINY_ARCH = {"dim": 24, "image_size": 8, "patch_size": 4, "temporal_size": 8,
             "temporal_patch_size": 4, "transformer_blocks": 1,
             "dim_head": 4, "heads": 2}
LR = 1e-4
NOISE = 1e-4
RANKS, LOCAL_BATCH, TEXT_LEN, N_CLASSES = 2, 2, 12, 3
HEAD = {"n_layers": 2, "mid_dim": 16, "out_dim": 8}
SEG = {"use_seg": True, "seg_head": {**HEAD, "out_dim": N_CLASSES},
       "use_open_seg": True, "open_seg_head": HEAD, "open_text_head": HEAD,
       "open_seg_loss_down_factor": 2}
# name → (step type, ct_clip_arch); the cases with the seg heads share
# their initial parameters (the image-report step leaves the heads unused)
CASES = {
    "imagereport": ("imagereport", SEG),
    "imageseg": ("imageseg", SEG),
    "imageopenseg": ("imageopenseg",
                     {**SEG, "open_seg_loss_type": "clip_focal_loss"}),
    "imagereport_mlm_simclr": ("imagereport", {
        "use_mlm": True, "use_visual_ssl": True, "visual_ssl_type": "simclr",
        "mlm_mask_token_id": 3, "text_ssl_loss_weight": 0.2,
        "image_ssl_loss_weight": 0.3}),
    "imageopenseg_tversky": ("imageopenseg", {
        **SEG, "open_seg_loss_type": "tversky_loss",
        "open_seg_loss_hyper_config": {"alpha": 0.3, "beta": 0.7,
                                       "gamma": 2.0}}),
}


def _config(ct_clip_arch):
    return {"random_seed": 5,
            "trainer": {"lr": LR, "wd": 0.01, "max_grad_norm": 1.0},
            "arch": dict(TINY_ARCH), "ct_clip_arch": dict(ct_clip_arch)}


def _global_batch(data_type, seed=9):
    b = RANKS * LOCAL_BATCH
    r = np.random.default_rng(seed)
    video = r.uniform(0, 1, (b, 1, 8, 8, 8)).astype(np.float32)
    if data_type == "imagereport":
        ids = r.integers(4, 128, (b, TEXT_LEN)).astype(np.int32)
        mask = np.ones_like(ids)
        ids[1, 8:], mask[1, 8:] = 0, 0
        ids[3, 5:], mask[3, 5:] = 0, 0
        return {"image": video, "input_ids": ids, "attention_mask": mask}
    seg = (r.uniform(size=(b, N_CLASSES, 8, 8, 8)) > 0.7).astype(np.uint8)
    if data_type == "imageseg":
        return {"image": video, "seg_mask": seg}
    ids = r.integers(1, 128, (N_CLASSES, TEXT_LEN)).astype(np.int32)
    pmask = np.ones_like(ids)
    pmask[1, 6:] = 0
    return {"image": video, "seg_mask": seg, "prompt_ids": ids,
            "prompt_mask": pmask}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _noise_grads(case):
    """Per-tensor gradient norms of the port's own one-process step at the
    global batch (unweighted; the optimizer not stepped)."""
    from tests._torch_dist_runner import LONG_KEYS, _model
    from vit_exp_tpu_torch.train.optimizer import build_optimizer
    from vit_exp_tpu_torch.train.steps import make_train_steps

    cfg, model = _model(case["config"], case["state"])
    probe = build_optimizer(cfg.trainer, model.parameters())
    probe.step = lambda: None
    step = make_train_steps(model, probe, cfg)[case["type"]]
    tb = {k: torch.from_numpy(np.array(v)) for k, v in case["batch"].items()}
    tb = {k: v.long() if k in LONG_KEYS else v for k, v in tb.items()}
    step(tb, 1.0, **({"draws": case["draws"]} if case["draws"] else {}))
    return {n: 0.0 if p.grad is None else float(p.grad.norm())
            for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """The ranks start on the cases' inputs first and run while JAX
    compiles and runs its global steps."""
    inputs, init = {}, {}
    for name, (data_type, ct_clip_arch) in CASES.items():
        cfg = _config(ct_clip_arch)
        use_mlm = bool(ct_clip_arch.get("use_mlm"))
        if use_mlm not in init:
            init[use_mlm] = jax_params(jconfig.ExperimentConfig.from_dict(cfg),
                                       seed=11)
        batch = _global_batch(data_type)
        draws = (_step_draws(5, 0, RANKS * LOCAL_BATCH,
                             batch["input_ids"].shape, 128)
                 if use_mlm else None)
        inputs[name] = {"type": data_type, "config": cfg,
                        "state": from_jax_params(init[use_mlm]),
                        "batch": batch, "local_batch": LOCAL_BATCH,
                        "draws": draws, "params": init[use_mlm]}
    finish = start("dp", RANKS, str(tmp_path_factory.mktemp("dp")),
                   inputs={n: {k: v for k, v in c.items() if k != "params"}
                           for n, c in inputs.items()})
    refs = {}
    for name, case in inputs.items():
        jcfg = jconfig.ExperimentConfig.from_dict(case["config"])
        model = jax_build_ctclip(jcfg, bert_config=JaxBertConfig.tiny(),
                                 policy=JAX_FP32, dim_latent=16,
                                 attn_impl="xla", ff_impl="xla")
        tx = jax_build_optimizer(jcfg.trainer)
        step = jax_make_train_steps(model, tx, jcfg,
                                    n_data_shards=RANKS)[case["type"]]
        state = create_train_state(
            jax.tree_util.tree_map(jnp.asarray, case["params"]), tx)
        new, metrics = step(state, {k: jnp.asarray(v)
                                    for k, v in case["batch"].items()}, 0.5)
        refs[name] = {
            "metrics": {k: float(v) for k, v in metrics.items()},
            "params": from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                             new.params)),
            "grad_norm": _noise_grads(case)}
    return finish(), refs


@pytest.mark.parametrize("name", sorted(CASES))
def test_data_parallel_step_matches_jax_global_batch(dp_runs, name):
    outs, refs = dp_runs
    ref = refs[name]
    for rank, out in enumerate(outs):
        got = out[name]
        assert set(got["metrics"]) == set(ref["metrics"]), rank
        for k, v in got["metrics"].items():
            assert v == pytest.approx(ref["metrics"][k], rel=2e-5), (rank, k)
    p0, p1 = (o[name]["params"] for o in outs)
    assert set(p0) == set(ref["params"])
    moved = 0
    for n, want in ref["params"].items():
        np.testing.assert_array_equal(p0[n], p1[n], err_msg=n)
        if ref["grad_norm"][n] < NOISE:
            assert np.abs(p0[n] - want).max() <= 2 * LR, n
        else:
            assert _rel(p0[n], want) < 1e-5, n
            moved += 1
    assert moved > 10


# --- the refusals and the group set-up -------------------------------------------


@pytest.mark.parametrize("fsdp, model", [(2, 1), (1, 2)])
def test_fsdp_and_model_axes_raise_naming_m7b(fsdp, model):
    """The grid of one fsdp or model axis of 2 (M7b, ported): the ranks'
    places, model fastest, and the groups they share; on one process the
    grid must still match the process count."""
    cfg = mesh.MeshConfig(data=1, fsdp=fsdp, model=model)
    assert cfg.data_shards(2) == fsdp
    assert [mesh.coords_of(r, (1, fsdp, model)) for r in range(2)] == (
        [(0, 0, 0), (0, 1, 0)] if fsdp == 2 else [(0, 0, 0), (0, 0, 1)])
    with pytest.raises(mesh.MeshError, match=f"1x{fsdp}x{model} != 1"):
        mesh.data_group(cfg)
    one = mesh.grid(mesh.MeshConfig(data=1))
    assert (one.batch, one.fsdp, one.model, one.replica) == (None,) * 4
    assert (one.batch_index, one.batch_shards) == (0, 1)


def test_serve_mesh_raises_naming_m7b():
    """``serve --mesh`` (M7b, ported) refuses a card count other than
    DATA·FSDP·MODEL and a --max_batch that DATA·FSDP does not divide."""
    if torch.cuda.device_count() != 4:
        with pytest.raises(mesh.MeshError, match="drives 4 cards"):
            serve.mesh_devices("2,1,2", "cuda")
    with pytest.raises(mesh.MeshError, match="max_batch 4"):
        serve.parse_args(["--config", "c.yaml", "--mesh", "3,1,1"])
    args = serve.parse_args(["--config", "c.yaml", "--mesh", "2,1,2"])
    assert args.mesh == "2,1,2"
    assert serve.mesh_devices("2,1,2", "cpu") == [torch.device("cpu")] * 2
    assert serve.mesh_devices(None, "cpu") == [torch.device("cpu")]


def test_grid_must_match_the_process_count():
    with pytest.raises(mesh.MeshError, match="2x1x1 != 1"):
        mesh.data_group(mesh.MeshConfig(data=2))
    assert mesh.data_group(mesh.MeshConfig(data=1)) is None
    assert mesh.MeshConfig().axis_sizes(4) == (4, 1, 1)
    cfg = tconfig.ExperimentConfig.from_dict(
        {"mesh": {"data": 1, "seq_axis": "data"}})
    assert mesh.mesh_config_from(cfg) == mesh.MeshConfig(1, 1, 1, "data")
    assert mesh.mesh_config_from(cfg, "4,1,1").data == 4
    assert mesh.mesh_config_from(tconfig.ExperimentConfig.from_dict({})) \
        is None
    assert mesh.seq_group(mesh.MeshConfig(seq_axis="data")) is None


def test_process_count_without_coordinator_raises(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="coordinator"):
        multihost.initialize(None, 2, None, device="cpu")
    with pytest.raises(ValueError, match="coordinator"):
        multihost.initialize(None, None, 1, device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="coordinator"):
        multihost.initialize(device="cpu")
    monkeypatch.delenv("WORLD_SIZE")
    assert multihost.initialize(None, 1, 0, device="cpu") is False
    assert multihost.process_count() == 1 and multihost.is_main_process()


def test_explicit_flags_win_over_the_environment(monkeypatch):
    """A process id of 0 given as a flag wins over RANK; the CPU joins a
    gloo group of one."""
    port = free_port()
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(port))
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    try:
        assert multihost.initialize(None, 1, 0, device="cpu")
        assert torch.distributed.get_backend() == "gloo"
        assert (multihost.process_index(), multihost.process_count()) == (0, 1)
        multihost.sync_hosts()
    finally:
        multihost.shutdown()
    assert not torch.distributed.is_initialized()


def test_a_cuda_group_without_a_card_raises_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="NCCL"):
        multihost.initialize(f"localhost:{free_port()}", 1, 0,
                             device="cuda")
    assert not torch.distributed.is_initialized()
