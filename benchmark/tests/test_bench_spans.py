"""The readers of the collection's spans and the graphs' launch time
(``actor_ms``, ``env_glue_ms``, ``gae_shuffle_ms``, ``graph_launch_ms``)
over synthetic iterations, and the cells that report them."""

import pytest

from benchmark import spec

SPANS = ("actor_ms", "env_glue_ms", "gae_shuffle_ms", "graph_launch_ms")


def iteration(k):
    return {"wall_s": 0.2, "collection_s": 0.09, "update_s": 0.1, "entry_s": 1e-4 * k, "actor_s": 0.010 + 0.002 * k,
            "env_s": 0.030 + 0.001 * k, "k1_s": 0.034, "gae_s": 0.001 * k, "stage_s": 0.002, "launch_s": 0.0005 * k}


def test_means_of_the_window():
    ctx = {"iterations": [iteration(k) for k in (1, 2, 3)]}
    read = {m: spec.reader(m)(ctx) for m in SPANS}
    assert read["actor_ms"] == pytest.approx(14.0)
    assert read["env_glue_ms"] == pytest.approx(32.0)
    assert read["gae_shuffle_ms"] == pytest.approx(2.0 + 2.0)   # gae_s + stage_s
    assert read["graph_launch_ms"] == pytest.approx(1.0)


def test_none_where_the_program_has_no_span():
    events_only = [{"wall_s": 0.2, "collection_s": 0.09, "update_s": 0.1}]
    engine = [{"wall_s": 0.2, "collection_s": 0.09, "update_s": 0.1, "launch_s": 0.001}]
    for m in SPANS:
        assert spec.reader(m)({"iterations": events_only}) is None
        assert spec.reader(m)({"iterations": []}) is None
    for m in ("actor_ms", "env_glue_ms", "gae_shuffle_ms"):
        assert spec.reader(m)({"iterations": engine}) is None
    assert spec.reader("graph_launch_ms")({"iterations": engine}) == pytest.approx(1.0)
    no_stage = iteration(1)
    del no_stage["stage_s"]
    assert spec.reader("gae_shuffle_ms")({"iterations": [no_stage]}) is None


def test_both_cells_report_them():
    bench = spec.load_benchmark()
    for cell in ("gr1t1.plane", "gr1t1_full.plane"):
        names = [m["name"] for m in spec.per_layer(bench, cell)]
        assert set(SPANS) <= set(names), cell
    entries = {m["name"]: m for m in bench["per_layer"]}
    for m in SPANS:
        assert entries[m]["source"] == "program_span" and entries[m]["moves"] == "train_env_steps_per_s"
        assert "workloads" not in entries[m]
