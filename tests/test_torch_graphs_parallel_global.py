"""The compiled iteration under the reference's global shuffle on the CPU
(``permutation_groups`` that the dp group's size does not divide: every
rank updates on the global batch, gathered once in the collection's tail):
the cases (b) and (c) of tests/test_torch_graphs_parallel.py (its
docstring) for dp2 on the mega path (K3's plain version over the gathered
batch) with the command curriculum on, dp2 on the step path, dp4 with
``permutation_groups = 2`` on the xla path over four gloo ranks, and dp2
on GR1T1_lstm on the engine (the start memories gathered with the batch),
the graphs stood in: on each rank ``_train_iter`` equals ``iteration`` bit
for bit over two iterations with injected and with generator draws, a
third compiled iteration makes no host traffic and issues eager's
collectives in eager's order, one all-gather among them and no gradient
all-reduce, and the ranks end with the same learner state.
"""

import pytest
import torch

from test_torch_graphs_parallel import check_case, run_case

GLOBAL = ["dp2_global_mega", "dp2_global_step", "dp4_global_xla", "dp2_global_lstm_engine"]


@pytest.fixture(scope="module", params=GLOBAL)
def case(request, tmp_path_factory):
    return request.param, run_case(request.param, tmp_path_factory)


def test_global_shuffle_compiled_equals_eager(case):
    name, ranks = case
    check_case(ranks, name)
    for res in ranks:
        # no all-reduce of a gradient: the widest all-reduce is the metric
        # sums' or GAE's, never one as wide as the parameters
        sums = [c for c in res["collectives"]["compiled"] if c[0] == "all_reduce_sum" and c[1] == "dp"]
        assert all(c[2][0] < 1000 for c in sums), (name, sums)
    assert all(torch.equal(ranks[0]["digests"], r["digests"]) for r in ranks)
