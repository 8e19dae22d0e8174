"""K3 (``csrc/ppo_update.cu`` ``k3_fused_step``): the optimizer step's
least time over its traced time. Least time a step: p, m and v read and
written and the gradient read, f32, at HBM's rate (``benchmark/yardstick.py``).
Silent where K3 does not run (across ranks the update takes the step path)."""

from benchmark import trace, yardstick


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    secs = trace.matching(tr["kernels"], ["k3_fused_step"])
    if not secs:
        return None
    return 100.0 * yardstick.k3_least_s(ctx["config"], len(secs)) / sum(secs)
