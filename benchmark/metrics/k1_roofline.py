"""K1 (``sim/cuda_step.py``, ``csrc/decimation.cu``): the team kernel's
least time over its traced time. Least time a launch: the K1 program's
frozen operations per env step at the FP32 peak, or its input and output
words read and written once at HBM's rate, whichever is longer
(``benchmark/yardstick.py``)."""

from benchmark import trace, yardstick


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    secs = trace.matching(tr["kernels"], ["decimation_team_kernel"])
    if not secs:
        return None
    least = yardstick.k1_least_s(ctx["work"], ctx["geometry"]["n"], len(secs))
    return 100.0 * least / sum(secs)
