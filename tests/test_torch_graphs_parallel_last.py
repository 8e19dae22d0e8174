"""The compiled iteration for the last runs JAX jits across ranks, on the
CPU: the cases (b) and (c) of tests/test_torch_graphs_parallel.py (its
docstring) for dp2 under the global shuffle (``permutation_groups = 1``)
with the symmetry loss, dp2 on GR1T1_lstm with the symmetry loss (the
recurrent mirror loss, ``make_mirror_loss_recurrent``) alone and under the
global shuffle, mp2 on GR1T1_lstm with the symmetry loss on the engine
(``use_pallas = False``: ``_CopyToMP`` / ``_ReduceFromMP`` inside the
replayed rollout step), each over two spawned gloo ranks, and GR1T1_lstm
with the symmetry loss over a one-rank group; the graphs stood in. On each
rank ``_train_iter`` equals ``iteration`` bit for bit over two iterations
with injected and with generator draws, a third compiled iteration makes
no host traffic and issues eager's collectives in eager's order (under the
global shuffle one all-gather and no gradient all-reduce), and the dp
peers end with the same learner state. The four-rank cases are
tests/test_torch_mesh_compiled_global.py's and
tests/test_torch_mesh_compiled_lstm.py's (named apart from the other spawned
cases so that --dist loadfile does not run them all at once).
"""

import pytest

from test_torch_graphs_parallel import check_case, run_case

LAST = ["dp2_global_symmetry", "dp2_lstm_symmetry", "dp2_global_lstm_symmetry", "mp2_lstm_symmetry_engine",
        "world1_lstm_symmetry"]


@pytest.fixture(scope="module", params=LAST)
def case(request, tmp_path_factory):
    return request.param, run_case(request.param, tmp_path_factory)


def test_last_runs_compiled_equals_eager(case):
    name, ranks = case
    check_case(ranks, name)
    for res in ranks:
        seq = res["collectives"]["compiled"]
        if "global" in name:
            # no all-reduce of a gradient: the widest all-reduce is the metric
            # sums' or GAE's, never one as wide as the parameters
            assert all(c[2][0] < 1000 for c in seq if c[0] == "all_reduce_sum" and c[1] == "dp"), (name, seq)
        if name.startswith("mp2"):
            # mp's forward and backward all-reduces, in the rollout step and the update
            assert any(c[1] == "mp" for c in seq), name
