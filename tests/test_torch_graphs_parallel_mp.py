"""The compiled iteration under tensor parallelism with the symmetry loss,
the LSTM and the engine on the CPU: the cases (b) and (c) of
tests/test_torch_graphs_parallel.py (its docstring) for mp2 with the
symmetry loss on the engine (``use_pallas = False``), mp2 on GR1T1_lstm
(the heads split, the memories replicated), and the same two at dp2 x mp2
over four gloo ranks (the engine's with the all-terms fold and the command
curriculum: its all-reduce over the dp group in each replay of the rollout
step's graph), the graphs stood in: on each rank ``_train_iter`` equals
``iteration`` bit for bit over two iterations with injected and with
generator draws, a third compiled iteration makes no host traffic and
issues eager's collectives in eager's order, and the dp peers end with the
same learner state (the mp peers with the same replicated leaves).
"""

import pytest
import torch

from test_torch_graphs_parallel import check_case, run_case

MP = ["mp2_symmetry_engine", "mp2_lstm", "dp2_mp2_symmetry_engine", "dp2_mp2_lstm"]


@pytest.fixture(scope="module", params=MP)
def case(request, tmp_path_factory):
    return request.param, run_case(request.param, tmp_path_factory)


def test_mp_paths_compiled_equals_eager(case):
    name, ranks = case
    check_case(ranks, name)
    for res in ranks:
        # mp's forward and backward all-reduces, captured in the update
        assert any(c[1] == "mp" for c in res["collectives"]["compiled"]), name
    if len(ranks) == 4:   # the dp peers of each mp index hold the same learner state
        assert torch.equal(ranks[0]["digests"], ranks[2]["digests"])
        assert torch.equal(ranks[1]["digests"], ranks[3]["digests"])
