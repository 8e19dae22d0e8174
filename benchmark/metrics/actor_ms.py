"""Actor (``learn/runner.py`` ``rollout_step`` inside the collection graph:
the action noise, the policy and value forwards, the log-prob, the time-out
bootstrap, the rollout buffers' and accumulators' stores): mean ms an
iteration, from the marks captured in the collection graph
(``last_timing["actor_s"]``, ``learn/spans.py``); None where the program
has no such span."""

import statistics


def read(ctx):
    its = ctx["iterations"]
    if not its or any("actor_s" not in i for i in its):
        return None
    return statistics.mean(i["actor_s"] for i in its) * 1e3
