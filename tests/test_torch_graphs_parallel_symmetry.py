"""The compiled iteration with the mirror-symmetry loss under data
parallelism on the CPU: the cases (b) and (c) of
tests/test_torch_graphs_parallel.py (its docstring) for dp2 with
``symmetry_coef > 0`` (the xla path with the loss as an extra term), over
two spawned gloo ranks, the graphs stood in: on each rank ``_train_iter``
equals ``iteration`` bit for bit over two iterations with injected and with
generator draws, a third compiled iteration makes no host traffic and
issues eager's collectives in eager's order, and the ranks end with the
same learner state.
"""

import pytest
import torch

from test_torch_graphs_parallel import check_case, run_case


@pytest.fixture(scope="module")
def dp2_symmetry(tmp_path_factory):
    return run_case("dp2_symmetry", tmp_path_factory)


def test_dp2_symmetry_loss_compiled_equals_eager(dp2_symmetry):
    check_case(dp2_symmetry, "dp2_symmetry")
    # one all-reduce of the gradient (with the loss and 3 aux values) a grad
    # step, 2 minibatches x 1 epoch, on both ranks
    for res in dp2_symmetry:
        seq = res["collectives"]["compiled"]
        widest = max(c[2] for c in seq if c[0] == "all_reduce_sum")
        assert sum(c == ("all_reduce_sum", "dp", widest) for c in seq) == 2, seq
    assert torch.equal(dp2_symmetry[0]["digests"], dp2_symmetry[1]["digests"])
