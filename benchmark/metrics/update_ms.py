"""PPO update (``learn/ppo.py``, ``learn/fused_update.py``: K2 and K3, or
K2 with the gradient all-reduce across ranks): mean ms an iteration, from
the runner's CUDA events (``last_timing["update_s"]``)."""

import statistics


def read(ctx):
    its = ctx["iterations"]
    return statistics.mean(i["update_s"] for i in its) * 1e3 if its else None
