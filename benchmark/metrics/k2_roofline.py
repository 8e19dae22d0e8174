"""K2 (``csrc/ppo_grads.cu``): the gradient chain's least time over its
traced time, over every kernel of that file. Least time a grad step: the
products' operations at the bf16 tensor-core peak, or the minibatch,
params and gradient bytes at HBM's rate, whichever is longer, at this
rank's rows a minibatch (``benchmark/yardstick.py``)."""

from benchmark import trace, yardstick

K2_KERNELS = ["gemm_kernel", "wgrad_reduce", "loss_rows", "loss_reduce", "wg_gemm", "pack_params", "k2_reduce"]


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    secs = trace.matching(tr["kernels"], K2_KERNELS)
    if not secs:
        return None
    _, steps = yardstick.update_rows(ctx["config"], ctx["geometry"]["n"] // ctx["geometry"]["groups"])
    least = yardstick.k2_least_s(ctx["config"], ctx["geometry"]["rows"], steps * tr["iterations"])
    return 100.0 * least / sum(secs)
