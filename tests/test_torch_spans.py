"""The spans inside the compiled collection (``learn/spans.py``) on the CPU,
with the CUDA graphs stood in (tests/test_torch_graphs.py's
``stand_in_graphs``: a replay runs the body again with the graph's spans
installed, and a mark writes the host's clock into its slot).

1. On the K1 path (its plain version here), the marks of the collection
   graph fall in the order actor -> env -> K1 -> env -> actor for each of
   the T steps (a mark of the phase already running records nothing, so a
   step starts where the last one ended), then GAE and the shuffle.
2. The phases tile the collection: every interval from the stamp before the
   launch to the stamp after it goes to exactly one of the six phases.
3. ``last_timing`` after a compiled call: the first call (the warm-up and
   the capture, no replay) holds ``collection_s``, ``update_s`` and
   ``launch_s``; every later call the six phases too, fresh each call; a
   readout left unread until the next call raises. ``learn``'s TensorBoard
   scalars carry the phases under ``Perf/``.
4. The eager ``iteration`` and ``step_graph`` record no mark and keep
   ``collection_s`` and ``update_s`` alone; the engine's per-step
   collection records no mark and gains ``launch_s`` alone.
"""

import pytest
import torch

from test_torch_graphs import _draws, host_stamp, on_engine, small, stand_in_graphs
from wiki_grx_gym_tpu_torch.learn import spans

T = 3   # test_torch_graphs.small's steps an env
EVENT_KEYS = {"collection_s", "update_s"}
SPAN_KEYS = {f"{p}_s" for p in spans.PHASES}


class Stamps:
    """The host stand-in of a mark, counted."""

    def __init__(self):
        self.n = 0

    def __call__(self, slots, i):
        self.n += 1
        host_stamp(slots, i)


@pytest.fixture(scope="module")
def k1_calls():
    """Three compiled calls of the K1 path (the lane program here) with
    injected draws: each call's ``last_timing`` (the second's left unread
    until after the third), its marks' phases and slots."""
    with pytest.MonkeyPatch.context() as mp:
        stand_in_graphs(mp)
        env, runner = small()
        state = runner.init_state()
        calls = []
        for it in range(3):
            state, _ = runner._train_iter(state, **dict(zip(("noise", "u", "perm"), _draws(env, runner, it))))
            sp = runner.compiled.collect["inject"].spans
            timing = runner.last_timing
            calls.append({"timing": timing, "phases": list(sp.phases), "slots": sp.slots.clone(),
                          "values": None if it == 1 else dict(timing)})
        stale = calls[1]["timing"]
        try:
            dict(stale)
        except RuntimeError as e:
            calls[1]["stale"] = str(e)
        writer = Writer()
        runner.writer = writer
        runner._log(3, {"value_loss": 0.0, "surrogate_loss": 0.0, "lr": 1e-3, "kl": 0.0, "mean_action_std": 1.0,
                        "mean_step_reward": 0.0, "done_count": 0.0, "mean_ep_len_done": 0.0}, 1.0, 24)
        runner.writer = None
        yield {"runner": runner, "env": env, "calls": calls, "tags": writer.tags}


class Writer:
    def __init__(self):
        self.tags = {}

    def add_scalar(self, tag, value, it):
        self.tags[tag] = value


def test_marks_follow_each_step_then_the_tail(k1_calls):
    want = ["entry", "actor"] + ["env", "k1", "env", "actor"] * T + ["gae", "stage"]
    for call in k1_calls["calls"][1:]:
        assert call["phases"] == want
    runner, env = k1_calls["runner"], k1_calls["env"]
    assert runner.spans is None and env.spans is None   # installed only while recording


def test_phases_tile_the_collection(k1_calls):
    call = k1_calls["calls"][2]
    n = len(call["phases"]) + 1
    ns = call["slots"][:n].tolist()
    assert all(b >= a for a, b in zip(ns, ns[1:])) and ns[-1] > ns[0]
    assert torch.all(call["slots"][n:] == 0)   # no slot written past the end stamp
    values = call["values"]
    assert sum(values[k] for k in SPAN_KEYS) == pytest.approx((ns[-1] - ns[0]) / 1e9, rel=1e-12, abs=1e-15)
    assert all(values[k] > 0 for k in SPAN_KEYS - {"entry_s"})


def test_last_timing_keys_after_each_call(k1_calls):
    first, second, third = k1_calls["calls"]
    assert set(first["values"]) == EVENT_KEYS | {"launch_s"}   # warm-up and capture: no replay, no marks
    assert list(third["values"]) == ["collection_s", "update_s", *(f"{p}_s" for p in spans.PHASES), "launch_s"]
    assert "call 2 read after call 3" in second["stale"]
    assert third["slots"][0] > second["slots"][len(second["phases"])]   # fresh marks
    assert third["values"]["launch_s"] > 0


def test_learn_logs_the_spans(k1_calls):
    tags = k1_calls["tags"]
    values = k1_calls["calls"][2]["values"]
    for key, tag in (("k1_s", "collection_k1_time"), ("env_s", "collection_env_time"),
                     ("actor_s", "collection_actor_time"), ("gae_s", "collection_gae_time"),
                     ("stage_s", "collection_stage_time"), ("entry_s", "collection_entry_time"),
                     ("launch_s", "graph_launch_time")):
        assert tags[f"Perf/{tag}"] == values[key]
    assert tags["Perf/collection_time"] == values["collection_s"]


def test_eager_iteration_and_step_graph_record_no_mark(monkeypatch):
    stand_in_graphs(monkeypatch)
    stamps = Stamps()
    monkeypatch.setattr(spans, "stamp", stamps)
    env, runner = small(n=4)
    state = runner.init_state()
    runner.iteration(state)
    assert set(runner.last_timing) == EVENT_KEYS and isinstance(runner.last_timing, dict)
    es = state.env_state
    for _ in range(2):   # the capture, then a replay
        es, _ = env.step_graph(es, torch.zeros(4, env.num_actions))
    assert stamps.n == 0


def test_engine_records_no_mark_and_gains_launch_s(monkeypatch):
    stand_in_graphs(monkeypatch)
    stamps = Stamps()
    monkeypatch.setattr(spans, "stamp", stamps)
    env, runner = small(mutate=on_engine(), n=4)
    state = runner.init_state()
    for it in range(2):
        state, _ = runner._train_iter(state, **dict(zip(("noise", "u", "perm"), _draws(env, runner, it))))
        assert set(runner.last_timing) == EVENT_KEYS | {"launch_s"}
    assert stamps.n == 0 and runner.compiled.collect["inject"].spans is None
