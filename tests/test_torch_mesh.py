"""CPU parity of the port's parameter sharding (here) and tensor
parallelism (tests/test_torch_mesh_tp.py, through ``grid_runs``) against
the JAX package, in gloo process groups of 2 ranks
(tests/_torch_dist_runner.py ``mesh`` job; no jax in the ranks).

- fsdp at ``1,2,1``: 2 ranks at local batch 2, every parameter, gradient
  and moment sharded over the fsdp group, against JAX's
  ``make_train_steps(..., n_data_shards=2)`` at global batch 4 (the
  batch shards over data × fsdp, as in tests/test_torch_dist.py);
- tensor parallelism at ``1,1,2``: 2 ranks on the same batch of 4, the
  tower's heads and GEGLU units and BERT's heads (3: split 2 and 1) and
  MLP units cut over the model group, against JAX's single-device step at
  batch 4 (n_data_shards=1), as tests/test_sharding.py holds JAX's own
  model=2 step;

each on the five cases of tests/test_torch_dist.py (fp32, XLA attention
and feed-forward in JAX, the plain twins in the port, loss weight 0.5).
Every metric within 2e-5 relative on both ranks; the parameters gathered
after one update equal on both ranks and, against JAX, within relative L2
1e-5 per tensor, or within max |Δ| ≤ 2·lr for a tensor whose gradient is
rounding noise (test_torch_dist.py's rule); the per-rank bytes of
parameters, gradients and moments at fsdp 2 about half of one process's.
(The grid's CLIs, checkpoints, serve engine: tests/test_torch_mesh_cli.py.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vit_exp_tpu.core import config as jconfig
from vit_exp_tpu.core.precision import FP32_POLICY as JAX_FP32
from vit_exp_tpu.models.bert import BertConfig as JaxBertConfig
from vit_exp_tpu.models.factory import build_ctclip as jax_build_ctclip
from vit_exp_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from vit_exp_tpu.train.steps import create_train_state
from vit_exp_tpu.train.steps import make_train_steps as jax_make_train_steps

from tests._torch_dist_runner import start
from tests.test_torch_dist import (CASES, LOCAL_BATCH, LR, NOISE, RANKS,
                                   _config, _global_batch, _noise_grads,
                                   _rel)
from tests.test_torch_models import jax_params
from tests.test_torch_ssl import _step_draws
from vit_exp_tpu_torch.models.convert import from_jax_params

# grid → (local batch, JAX's n_data_shards) at the global batch of 4
GRIDS = {"1,2,1": (LOCAL_BATCH, RANKS), "1,1,2": (RANKS * LOCAL_BATCH, 1)}


def grid_runs(grid, workdir):
    """Run ``grid``'s ranks on the five cases, and JAX's step at its
    n_data_shards while they run; returns (the ranks' outputs, the JAX
    references by case)."""
    local_batch, shards = GRIDS[grid]
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
                        "batch": batch, "draws": draws,
                        "local_batch": local_batch,
                        "params": init[use_mlm]}
    finish = start(
        "mesh", RANKS, workdir,
        inputs={"mesh": tuple(int(x) for x in grid.split(",")),
                "cases": {n: {k: v for k, v in c.items() if k != "params"}
                          for n, c in inputs.items()}})
    refs = {}
    for name, case in inputs.items():
        jcfg = jconfig.ExperimentConfig.from_dict(case["config"])
        model = jax_build_ctclip(jcfg, bert_config=JaxBertConfig.tiny(),
                                 policy=JAX_FP32, dim_latent=16,
                                 attn_impl="xla", ff_impl="xla")
        tx = jax_build_optimizer(jcfg.trainer)
        step = jax_make_train_steps(model, tx, jcfg,
                                    n_data_shards=shards)[case["type"]]
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


def check_against_jax(outs, ref, name):
    """The ranks' metrics, gathered parameters and grad norms against one
    JAX reference (the module docstring's bounds)."""
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
        assert p0[n].shape == want.shape, n
        if ref["grad_norm"][n] < NOISE:
            assert np.abs(p0[n] - want).max() <= 2 * LR, n
        else:
            assert _rel(p0[n], want) < 1e-5, n
            moved += 1
    assert moved > 10
    assert outs[0][name]["grad_norm"] == outs[1][name]["grad_norm"]


@pytest.fixture(scope="module")
def fsdp_runs(tmp_path_factory):
    return grid_runs("1,2,1", str(tmp_path_factory.mktemp("fsdp")))


@pytest.mark.parametrize("name", sorted(CASES))
def test_fsdp_step_matches_jax_global_batch(fsdp_runs, name):
    outs, refs = fsdp_runs
    check_against_jax(outs, refs[name], name)


def test_fsdp_grid_groups_and_each_ranks_share(fsdp_runs):
    """The layout (rank = (d·F + f)·M + m) and what each rank holds at
    fsdp 2: half the whole model's parameters, gradients and moments, up
    to the padding of one element a tensor."""
    outs, _ = fsdp_runs
    whole = sum(v.size * v.itemsize for v in
                outs[0]["imagereport"]["params"].values())
    n_tensors = len(outs[0]["imagereport"]["params"])
    for r, out in enumerate(outs):
        assert out["coords"] == (0, r, 0) and out["batch_index"] == r
        assert out["groups"]["fsdp"] == out["groups"]["batch"] == [0, 1]
        assert out["groups"]["model"] is None
        assert out["groups"]["replica"] is None
        b = out["imagereport"]["bytes"]
        assert whole / 2 <= b["params"] <= whole / 2 + 4 * n_tensors
        assert b["grads"] == b["params"]
        assert b["moments"] == 2 * b["params"]
