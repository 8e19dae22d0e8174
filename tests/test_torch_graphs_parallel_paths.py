"""The compiled iteration under data and tensor parallelism on the CPU:
the cases (b) and (c) of tests/test_torch_graphs_parallel.py (its
docstring) for mp2 on the xla path, dp2 on GR1T1_lstm, dp2 on the engine
(with the all-terms fold and the command curriculum on: its all-reduce in
each replay of the rollout step's graph), each over two spawned gloo
ranks, and dp2 x mp2 on the xla path over four, the graphs stood in.
"""

import pytest
import torch

from test_torch_graphs_parallel import STEPS, check_case, run_case


@pytest.fixture(scope="module")
def mp2_xla(tmp_path_factory):
    return run_case("mp2_xla", tmp_path_factory)


@pytest.fixture(scope="module")
def dp2_lstm(tmp_path_factory):
    return run_case("dp2_lstm", tmp_path_factory)


@pytest.fixture(scope="module")
def dp2_engine(tmp_path_factory):
    return run_case("dp2_engine", tmp_path_factory)


def test_mp2_xla_path_compiled_equals_eager(mp2_xla):
    check_case(mp2_xla, "mp2_xla")


def test_dp2_recurrent_compiled_equals_eager(dp2_lstm):
    check_case(dp2_lstm, "dp2_lstm")


def test_dp2_engine_compiled_equals_eager(dp2_engine):
    check_case(dp2_engine, "dp2_engine")
    # the curriculum's all-reduce in each replay of the rollout step's graph
    assert sum(c == ("all_reduce_sum", "dp", (2,)) for c in dp2_engine[0]["collectives"]["compiled"]) == STEPS


@pytest.fixture(scope="module")
def dp2_mp2_xla(tmp_path_factory):
    return run_case("dp2_mp2_xla", tmp_path_factory)


def test_dp2_mp2_xla_path_on_four_ranks_compiled_equals_eager(dp2_mp2_xla):
    check_case(dp2_mp2_xla, "dp2_mp2_xla")
    # the dp peers of each mp index hold the same learner state
    assert torch.equal(dp2_mp2_xla[0]["digests"], dp2_mp2_xla[2]["digests"])
    assert torch.equal(dp2_mp2_xla[1]["digests"], dp2_mp2_xla[3]["digests"])
