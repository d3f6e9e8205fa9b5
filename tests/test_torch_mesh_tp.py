"""CPU parity of the port's tensor parallelism against the JAX package: 2
gloo ranks at ``1,1,2`` on the same batch of 4, the image tower's heads
and GEGLU units and BERT's heads (3 of them: split 2 and 1) and MLP units
cut over the model group, against JAX's single-device step at batch 4
(n_data_shards=1), as tests/test_sharding.py holds JAX's own model=2 step,
on the five cases and bounds of tests/test_torch_mesh.py."""

import pytest

from tests.test_torch_dist import CASES
from tests.test_torch_mesh import check_against_jax, grid_runs


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    return grid_runs("1,1,2", str(tmp_path_factory.mktemp("tp")))


@pytest.mark.parametrize("name", sorted(CASES))
def test_tensor_parallel_step_matches_jax_single_device(tp_runs, name):
    outs, refs = tp_runs
    check_against_jax(outs, refs[name], name)


def test_tensor_parallel_groups_and_each_ranks_share(tp_runs):
    """Both ranks read the whole batch (batch shard 0); each holds its cut
    of the sharded tensors and the rest whole: between half and all of the
    model's bytes; rank 0 holds BERT's first head of 3, rank 1 the other
    two."""
    outs, _ = tp_runs
    whole = sum(v.size * v.itemsize for v in
                outs[0]["imagereport"]["params"].values())
    for r, out in enumerate(outs):
        assert out["coords"] == (0, 0, r) and out["batch_index"] == 0
        assert out["groups"]["model"] == [0, 1]
        assert out["groups"]["batch"] is None
        assert out["groups"]["fsdp"] is None
        b = out["imagereport"]["bytes"]
        assert whole / 2 < b["params"] < whole
        assert b["grads"] == b["params"]
    assert (outs[0]["imagereport"]["bytes"]["params"]
            < outs[1]["imagereport"]["bytes"]["params"])
