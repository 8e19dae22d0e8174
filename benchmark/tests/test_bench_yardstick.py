"""The frozen counts against hand-worked values, and the least-time
arithmetic of the rooflines and ``iter_mfu``."""

import importlib.util

import pytest

from benchmark import spec, yardstick


@pytest.fixture(scope="module")
def gr1t1():
    return spec.cell("gr1t1.plane")


def _reader(name):
    return spec.reader(name)


def test_k2_work_at_20960_rows(gr1t1):
    # weights: actor 39*512 + 512*256 + 256*128 + 128*10 = 185,088; critic
    # 168*512 + 512*256 + 256*128 + 128 = 249,984; input layers 105,984
    ops, nbytes = yardstick.k2_work(gr1t1["config"], 20960)
    w, w_in = 185088 + 249984, 19968 + 86016
    assert ops == 20960 * (4 * w + 2 * (w - w_in)) == 50_271_805_440   # 50.272 GFLOP
    # bf16 obs (39 + 168), 34 f32 scalars a row, params read + gradient written
    assert nbytes == 20960 * 207 * 2 + 20960 * 34 * 4 + 2 * 436885 * 4 == 15_023_080


def test_k3_step_bytes(gr1t1):
    assert yardstick.num_params(gr1t1["config"]) == 436885 == gr1t1["config"]["num_params"]
    assert yardstick.k3_step_bytes(gr1t1["config"]) == 7 * 4 * 436885 == 12_232_780   # 12.23 MB


def test_num_params_full_body():
    full = spec.cell("gr1t1_full.plane")["config"]
    assert yardstick.num_params(full) == full["num_params"] == 507329


def test_update_rows_at_8192_envs(gr1t1):
    assert yardstick.update_rows(gr1t1["config"], 8192) == (20960, 200)


def test_k1_least_time(gr1t1):
    work = gr1t1["work"]
    # 156,675 ops x 8192 envs at 67 TFLOP/s beats 487 words x 4 B x 8192 at 3.35 TB/s
    one = yardstick.k1_least_s(work, 8192, 1)
    assert one == pytest.approx(156675 * 8192 / 67e12)
    assert yardstick.k1_least_s(work, 8192, 64) == pytest.approx(64 * one)


def test_iteration_least_time(gr1t1):
    parts = yardstick.iteration_least_s(gr1t1["config"], gr1t1["work"], 8192)
    macs = 185088 + 249984
    rollout = 2 * (64 * 8192 * macs + 8192 * 249984)
    update = 6 * 200 * 20960 * macs
    assert parts["actor_critic"] == pytest.approx((rollout + update) / 989e12)
    assert parts["k1"] == pytest.approx(64 * 8192 * 156675 / 67e12)
    assert parts["total"] == pytest.approx(parts["actor_critic"] + parts["k1"])


def _ctx(cell, walls, kernels=(), iterations=3):
    geo = {"t": 64, "n": 8192, "groups": 1, "rows": 20960}
    return {"config": cell["config"], "work": cell["work"], "geometry": geo, "ranks": 1,
            "iterations": [{"wall_s": w, "collection_s": w / 2, "update_s": w / 2 - 1e-3} for w in walls],
            "trace": {"kernels": list(kernels), "iterations": iterations, "busy_s": 0.5, "window_s": 0.6}}


def test_iter_mfu_stays_under_100_on_a_synthetic_trace(gr1t1):
    least = yardstick.iteration_least_s(gr1t1["config"], gr1t1["work"], 8192)["total"]
    read = _reader("iter_mfu")
    assert read(_ctx(gr1t1, [least] * 4)) == pytest.approx(100.0)
    for slower in (1.01, 2.0, 30.0):
        assert 0 < read(_ctx(gr1t1, [least * slower] * 4)) < 100.0
    assert read(_ctx(gr1t1, [0.19] * 4)) < 10.0   # ~190 ms a GR1T1 iteration is a few percent


def test_rooflines_from_a_synthetic_trace(gr1t1):
    k1_least = yardstick.k1_least_s(gr1t1["work"], 8192, 1)
    kernels = [("void (anonymous namespace)::decimation_team_kernel<S, 16, 8>(...)", 10 * k1_least)] * 192
    kernels += [("k3_fused_step(K3Args, int)", 4 * yardstick.k3_least_s(gr1t1["config"], 1))] * 600
    kernels += [("wg_gemm(WgLaunch)", 1e-4)] * 600 + [("ampere_sgemm_128x64_nn", 1.0)]
    ctx = _ctx(gr1t1, [0.2] * 4, kernels)
    assert _reader("k1_roofline")(ctx) == pytest.approx(10.0)
    assert _reader("k3_roofline")(ctx) == pytest.approx(25.0)
    k2 = _reader("k2_roofline")(ctx)
    assert k2 == pytest.approx(100 * yardstick.k2_least_s(gr1t1["config"], 20960, 600) / 0.06)
    assert _reader("device_idle_pct")(ctx) == pytest.approx(100 * (1 - 0.5 / 0.6))


def test_a_reader_with_nothing_to_read_returns_nothing(gr1t1):
    ctx = _ctx(gr1t1, [0.2] * 4, kernels=[("ampere_sgemm_128x64_nn", 1.0)])
    for name in ("k1_roofline", "k2_roofline", "k3_roofline"):
        assert _reader(name)(ctx) is None
    ctx["trace"] = None
    assert all(_reader(n)(ctx) is None for n in ("k1_roofline", "device_idle_pct"))


def test_readers_import_nothing_of_the_port():
    for m in spec.load_benchmark()["per_layer"]:
        src = (spec.CHECKOUT / "benchmark" / "metrics" / f"{m['name']}.py").read_text()
        assert "wiki_grx_gym_tpu" not in src
    assert importlib.util.find_spec("benchmark.yardstick")
