"""Device: the whole iteration's least time over its measured wall time on
a card: the actor-critic's products (the rollout's forwards and the
update's rows at three forwards) at the bf16 peak plus K1's frozen
operations at the FP32 peak (``yardstick.iteration_least_s``), over the
mean wall time of the window's untraced iterations."""

import statistics

from benchmark import yardstick


def read(ctx):
    its = ctx["iterations"]
    if not its:
        return None
    least = yardstick.iteration_least_s(ctx["config"], ctx["work"], ctx["geometry"]["n"])["total"]
    return 100.0 * least / statistics.mean(i["wall_s"] for i in its)
