"""The trace's reduction: busy time as the union of intervals, idle gaps
labelled by the host span open when each began; and the metric readers on
records with and without what they read."""

import pytest

from benchmark import trace
from benchmark.harness import Window, metric_reader, load_cell, ROOT, load_json


def test_union_and_gaps():
    busy, merged = trace.union([(0, 2), (1, 3), (5, 6), (9, 12)], 0, 10)
    assert busy == 3 + 1 + 1
    assert merged == [(0, 3), (5, 6), (9, 10)]
    assert trace.gaps(merged, 0, 10) == [(3, 5), (6, 9)]


def test_reduce_events_labels_idle_by_host_span():
    kernels = [("sm90_xmma_gemm", 0.0, 1.0), ("elementwise_kernel", 0.5, 2.0),
               ("_stats_kernel", 4.0, 5.0)]
    spans = [("step", 0.0, 3.5), ("loader", 3.5, 4.0), ("step", 4.0, 6.0)]
    r = trace.reduce_events(kernels, spans, 0.0, 6.0)
    assert r["busy_s"] == pytest.approx(3.0)
    assert r["window_s"] == 6.0
    assert r["group_s"]["conv / matmul"] == 1.0
    assert r["group_s"]["group norm fwd (Triton)"] == 1.0
    labels = {name.split(" (")[0]: s for name, s in r["idle_gaps"]}
    assert labels == {"step": pytest.approx(2.0 + 1.0)}
    spans = [("step", 0.0, 2.0), ("loader", 2.0, 4.0)]
    r = trace.reduce_events(kernels, spans, 0.0, 5.0)
    assert {n.split(" (")[0] for n, _ in r["idle_gaps"]} == {"loader"}


def test_kernel_groups_first_match_wins():
    assert trace.kernel_group("multi_tensor_apply_kernel") == "optimizer"
    assert trace.kernel_group("_apply_kernel") == "group norm fwd (Triton)"
    assert trace.kernel_group("mystery") == "other"


PER_LAYER = [m["name"] for m in load_json(ROOT / "BENCHMARK.json")["per_layer"]]


@pytest.mark.parametrize("name", PER_LAYER)
def test_reader_returns_none_without_its_input(name):
    cell = load_cell(next(w["name"] for w in load_json(
        ROOT / "BENCHMARK.json")["workloads"]))
    record = {"cell": cell, "window": Window(0.0, 1.0, 0, {},
                                             {"work_span": "step"}),
              "spans": [], "trace": None, "traced_host": (0.0, 0.0)}
    assert metric_reader(name)(record) is None


def test_readers_on_a_record():
    w = Window(0.0, 10.0, 4, {}, {"work_span": "step", "timings": [
        {"token_ms": [30.0, 90.0, 4.0, 5.0, 6.0]}]})
    spans = [("loader", 0.0, 0.1), ("step", 0.1, 1.0),
             ("loader", 1.0, 1.3), ("step", 1.3, 2.0)]
    t = {"busy_s": 1.5, "window_s": 2.0, "kernel_s": {"_stats_kernel": 0.1}}
    record = {"cell": None, "window": w, "spans": spans, "trace": t,
              "traced_host": (0.0, 2.0)}
    assert metric_reader("loader_wait_ms.train")(record) == \
        pytest.approx(200.0)
    assert metric_reader("step_device_ms.train")(record) == \
        pytest.approx(750.0)
    assert metric_reader("device_idle.train")(record) == pytest.approx(25.0)
    assert metric_reader("token_ms")(record) == 5.0
    assert metric_reader("first_tokens_ms")(record) == 120.0


def test_gn_roofline_leaves_out_the_optimizer():
    from benchmark import metrics_common, roofline
    w = Window(0.0, 10.0, 2, {}, {"work_span": "step"})
    spans = [("step", 0.0, 1.0), ("step", 1.0, 2.0)]
    gn = {"_stats_kernel": 0.002, "_apply_kernel": 0.003,
          "gn_bwd_sums_kernel": 0.004, "_bwd_dx_kernel": 0.005}
    adam = {"void at::native::multi_tensor_apply_kernel<Adam>": 0.5}
    nbytes = {"fwd": 0.007 * roofline.HBM_BYTES_PER_S}
    record = {"cell": None, "window": w, "spans": spans,
              "trace": {"kernel_s": {**gn, **adam}},
              "traced_host": (0.0, 2.0), "counts": {"gn": nbytes}}
    # 7 ms of bound a step against 14 ms of GroupNorm kernels over 2 steps
    assert metrics_common.gn_roofline_pct(record, "gn") == \
        pytest.approx(100.0)
