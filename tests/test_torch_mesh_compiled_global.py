"""The compiled iteration at dp2 x mp2 under the global shuffle on the
CPU, over four spawned gloo ranks: the cases (b) and (c) of
tests/test_torch_graphs_parallel.py (its docstring) for
``permutation_groups = 1`` on the xla path with the all-terms fold and
the command curriculum (JAX's own CLI run on a dp x mp mesh, ``train
--num_mp 2`` on four devices), with the symmetry loss, and on GR1T1_lstm
on the engine; the graphs stood in. The update's inputs are all-gathered
over the dp group only (the mp peers hold the same env shard), each rank
then updating its shard of the net on the global batch: one all-gather,
no gradient all-reduce over dp, mp's all-reduces in the update, and the
dp peers of each mp index end with the same learner state.
"""

import pytest
import torch

from test_torch_graphs_parallel import check_case, run_case

MESH = ["dp2_mp2_global_xla", "dp2_mp2_global_symmetry", "dp2_mp2_global_lstm_engine"]


@pytest.fixture(scope="module", params=MESH)
def case(request, tmp_path_factory):
    return request.param, run_case(request.param, tmp_path_factory)


def test_global_shuffle_under_dp_x_mp_compiled_equals_eager(case):
    name, ranks = case
    check_case(ranks, name)
    for res in ranks:
        seq = res["collectives"]["compiled"]
        assert all(c[2][0] < 1000 for c in seq if c[0] == "all_reduce_sum" and c[1] == "dp"), (name, seq)
        assert any(c[1] == "mp" for c in seq), name
    # the dp peers of each mp index hold the same learner state
    assert torch.equal(ranks[0]["digests"], ranks[2]["digests"])
    assert torch.equal(ranks[1]["digests"], ranks[3]["digests"])
