"""Env (``envs/legged_env.py`` ``LeggedEnv.step`` without K1's call: action
boxes, delay, command resampling, rewards, resets, observations and their
noise): mean ms an iteration, from the marks captured in the collection
graph (``last_timing["env_s"]``, ``learn/spans.py``); None where the program
has no such span."""

import statistics


def read(ctx):
    its = ctx["iterations"]
    if not its or any("env_s" not in i for i in its):
        return None
    return statistics.mean(i["env_s"] for i in its) * 1e3
