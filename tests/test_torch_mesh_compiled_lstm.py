"""The compiled iteration of GR1T1_lstm with the symmetry loss at dp2 x
mp2 on the CPU, over four spawned gloo ranks: the cases (b) and (c) of
tests/test_torch_graphs_parallel.py (its docstring) for the recurrent
mirror loss (``make_mirror_loss_recurrent``: the heads split, the
memories replicated) with rank 0's shuffle of each rank's env columns,
and under the global shuffle (the start memories gathered with the
batch); the graphs stood in. mp's all-reduces run in the update, and the
dp peers of each mp index end with the same learner state.
"""

import pytest
import torch

from test_torch_graphs_parallel import check_case, run_case

LSTM = ["dp2_mp2_lstm_symmetry", "dp2_mp2_global_lstm_symmetry"]


@pytest.fixture(scope="module", params=LSTM)
def case(request, tmp_path_factory):
    return request.param, run_case(request.param, tmp_path_factory)


def test_recurrent_symmetry_under_dp_x_mp_compiled_equals_eager(case):
    name, ranks = case
    check_case(ranks, name)
    for res in ranks:
        assert any(c[1] == "mp" for c in res["collectives"]["compiled"]), name
    assert torch.equal(ranks[0]["digests"], ranks[2]["digests"])
    assert torch.equal(ranks[1]["digests"], ranks[3]["digests"])
