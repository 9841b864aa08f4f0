"""The idle split (`idle_split.py`) on hand-made timelines, the events it
reads from a profiler, and the readers of the port's counters
(`port_counters.py`, `metrics/data_*.recon.py`, `graph_capture_ms.gen.py`)
on records with and without what they read."""

import json
import time
import types

import pytest

from benchmark import idle_split, port_counters, trace
from benchmark.harness import Window, metric_reader

COUNTER_METRICS = ["data_wait_ms.recon", "data_decode_ms.recon",
                   "data_ready.recon", "graph_capture_ms.gen"]


def test_split_on_a_hand_made_timeline():
    ops = [(0.0, 1.0, 1), (4.0, 5.0, 2), (5.5, 6.0, 3), (8.0, 9.0, 4)]
    launches = {1: (0.0, 7), 2: (3.0, 7), 3: (4.2, 7)}   # 4 has no launch
    spans = {7: [("request", 0.0, 2.5, False),
                 ("codec.decode", 0.5, 2.0, True),
                 ("loader", 2.5, 3.5, False),
                 ("data.wait", 2.6, 3.4, True)]}
    s = idle_split.split_idle(ops, launches, spans, 0.0, 10.0)
    # [1, 4): starved until the launch at 3, from under codec.decode on
    # into data.wait, then queued; [5, 5.5): its kernel was queued at 4.2;
    # [6, 8): no launch; [9, 10): the window's end
    assert s["starved_s"] == pytest.approx({
        "codec.decode": 1.0, "request": 0.5, "loader": 0.1,
        "data.wait": 0.4, "host": 3.0})
    assert s["queued_s"] == pytest.approx(1.0 + 0.5)
    assert s["idle_s"] == pytest.approx(6.5)
    assert sum(s["starved_s"].values()) + s["queued_s"] == \
        pytest.approx(s["idle_s"])
    assert (s["gaps"], s["unlaunched"], s["window_s"]) == (4, 2, 10.0)


def test_split_prefers_a_program_span_and_the_launching_thread():
    ops = [(0.0, 1.0, 1), (6.0, 7.0, 2), (9.0, 10.0, 3)]
    launches = {1: (0.0, 1), 2: (5.0, 1), 3: (8.0, 2)}
    spans = {1: [("request", 0.0, 6.0, False),
                 ("codec.encode", 1.0, 4.0, True),
                 ("inner", 2.0, 3.0, False)]}
    s = idle_split.split_idle(ops, launches, spans, 0.0, 10.0)
    # a benchmark span inside a program span does not take its time; a
    # thread without spans is the host
    assert s["starved_s"] == pytest.approx({"codec.encode": 3.0,
                                            "request": 1.0, "host": 1.0})
    assert s["queued_s"] == pytest.approx(1.0 + 1.0)
    assert s["unlaunched"] == 0


def test_labels_outside_every_span_are_host():
    labels = idle_split.Labels([("data.wait", 2.0, 3.0, True)])
    got = {"host": 0.0, "data.wait": 0.0}
    labels.add(1.0, 4.0, got)
    assert got == {"host": 2.0, "data.wait": 1.0}


class _Event:
    def __init__(self, name, start_s, dur_s, cuda=False, corr=0, tid=1,
                 kind=None, user=False):
        import torch
        self._name, self._start, self._dur = name, start_s, dur_s
        self._dev = torch.autograd.DeviceType.CUDA if cuda else \
            torch.autograd.DeviceType.CPU
        self._corr, self._tid, self._user = corr, tid, user
        if kind is not None:
            self.activity_type = lambda: kind

    def name(self):
        return self._name

    def start_ns(self):
        return int(self._start * 1e9)

    def duration_ns(self):
        return int(self._dur * 1e9)

    def device_type(self):
        return self._dev

    def is_user_annotation(self):
        return self._user

    def correlation_id(self):
        return self._corr

    def start_thread_id(self):
        return self._tid


def _prof(events):
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results))


def test_timeline_leaves_out_annotation_ranges_on_the_device():
    events = [
        _Event("bench:traced", 0.0, 10.0, user=True),
        _Event("bench:request", 0.0, 5.0, user=True),
        _Event("favae:codec.decode", 1.0, 2.0),
        _Event("cudaLaunchKernel", 1.5, 0.1, corr=11, kind="cuda_runtime"),
        _Event("cuLaunchKernel", 2.0, 0.1, corr=12),   # kind unknown
        _Event("aten::mm", 1.4, 0.3, corr=11, kind="cpu_op"),
        _Event("gemm_kernel", 3.0, 1.0, cuda=True, corr=11),
        _Event("_stats_kernel", 4.0, 1.0, cuda=True, corr=12),
        _Event("bench:request", 3.0, 2.0, cuda=True, user=True),
        _Event("favae:codec.decode", 3.0, 2.0, cuda=True),
    ]
    ops, launches, spans, window = idle_split.timeline(_prof(events))
    assert window == (0.0, 10.0)
    assert sorted(c for _, _, c in ops) == [11, 12]
    assert launches == {11: (1.5, 1), 12: (2.0, 1)}
    assert spans == {1: [("request", 0.0, 5.0, False),
                         ("codec.decode", 1.0, 3.0, True)]}
    s = idle_split.split_idle(ops, launches, spans, *window)
    assert s["idle_s"] == pytest.approx(10.0 - 2.0)
    assert s["queued_s"] == pytest.approx(3.0 - 1.5)


def test_host_spans_of_the_program_leave_the_trace_reduction_as_it_was():
    kernels = [("sm90_xmma_gemm", 1.0, 2.0), ("_stats_kernel", 4.0, 5.0)]
    bench = [("request", 0.0, 3.0), ("loader", 3.0, 4.0)]
    plain = trace.reduce_events(kernels, bench, 0.0, 6.0)

    class Prof:
        def __init__(self, program):
            import torch
            cuda = torch.autograd.DeviceType.CUDA
            cpu = torch.autograd.DeviceType.CPU
            rows = [(n, a, b, cuda) for n, a, b in kernels]
            rows += [("bench:" + n, a, b, cpu) for n, a, b in bench]
            rows += [("bench:traced", 0.0, 6.0, cpu)]
            rows += [("favae:" + n, a, b, cpu) for n, a, b in program]
            self.rows = rows

        def events(self):
            return [types.SimpleNamespace(
                name=n, device_type=d, time_range=types.SimpleNamespace(
                    start=a * 1e6, end=b * 1e6)) for n, a, b, d in self.rows]

    program = [("codec.encode", 0.5, 1.5), ("data.wait", 3.1, 3.9),
               ("codec.decode", 1.5, 2.9)]
    assert trace.Tracer._reduce(Prof(program)) == \
        trace.Tracer._reduce(Prof([])) == plain


def test_split_tracer_adds_the_split_to_the_reduction():
    events = [
        _Event("bench:traced", 0.0, 10.0, user=True),
        _Event("bench:request", 0.0, 5.0, user=True),
        _Event("favae:codec.decode", 1.0, 2.0),
        _Event("cudaLaunchKernel", 1.5, 0.1, corr=11, kind="cuda_runtime"),
        _Event("gemm_kernel", 3.0, 1.0, cuda=True, corr=11),
    ]
    prof = _prof(events)
    prof.events = lambda: [types.SimpleNamespace(
        name=e.name(), device_type=e.device_type(),
        time_range=types.SimpleNamespace(start=e.start_ns() / 1e3,
                                         end=(e.start_ns() + e.duration_ns())
                                         / 1e3)) for e in events]
    got = idle_split.SplitTracer._reduce(prof)
    split = got.pop("idle_split")
    assert got == trace.Tracer._reduce(prof)
    assert split["idle_s"] == pytest.approx(9.0)
    # [0, 3) starved until the launch at 1.5 (the request's, then the
    # decode's), then queued; [4, 10) runs to the window's end
    assert split["starved_s"] == pytest.approx(
        {"request": 1.0, "codec.decode": 0.5, "host": 6.0})
    assert split["queued_s"] == pytest.approx(1.5)


def test_timeline_of_a_cpu_profile():
    import torch
    from favae_tpu_torch import profiling
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("bench:traced"):
            with profiling.span("data.wait"):
                time.sleep(0.001)
    ops, launches, spans, (lo, hi) = idle_split.timeline(prof)
    assert ops == [] and hi > lo
    [(tid, got)] = spans.items()
    assert [(n, p) for n, _, _, p in got] == [("data.wait", True)]


def _record(trace_summary, spans=(), traced_host=(0.0, 2.0)):
    w = Window(0.0, 10.0, 2, {}, {"work_span": "request"})
    return {"cell": None, "window": w, "spans": list(spans),
            "trace": trace_summary, "traced_host": traced_host}


def test_report_per_traced_item():
    summary = {"busy_s": 1.0, "window_s": 4.0,
               "idle_split": {"window_s": 4.0, "idle_s": 3.0,
                              "queued_s": 1.0, "gaps": 5, "unlaunched": 1,
                              "starved_s": {"data.wait": 0.8,
                                            "codec.decode": 0.6,
                                            "codec.encode": 0.2,
                                            "graphs.capture": 0.1,
                                            "request": 0.2, "host": 0.1}}}
    # two requests inside the traced 3 s, a loader span and a request after
    spans = [("loader", 0.0, 0.5), ("request", 0.5, 1.0),
             ("request", 1.0, 2.0), ("request", 3.5, 4.0)]
    r = idle_split.report(_record(summary, spans, (0.0, 3.0)))
    assert r["traced_items"] == 2 and r["item_host_ms"] == 1500.0
    assert r["idle_data_ms"] == pytest.approx(400.0)
    assert r["idle_codec_ms"] == pytest.approx(400.0)
    assert r["idle_setup_ms"] == pytest.approx(50.0)
    assert r["idle_unspanned_ms"] == pytest.approx(150.0)
    assert r["idle_queued"] == pytest.approx(25.0)
    assert r["idle_pct"] == r["device_idle_pct"] == pytest.approx(75.0)
    # the work span is the run's own: a training driver's is "step"
    steps = [("step" if n == "request" else n, a, b) for n, a, b in spans]
    record = _record(summary, steps, (0.0, 3.0))
    record["window"].extra["work_span"] = "step"
    assert idle_split.report(record)["idle_data_ms"] == pytest.approx(400.0)


def test_main_reports_the_run_it_traced(monkeypatch, capsys):
    from benchmark import run
    # restored after the test: main sets both for its process
    monkeypatch.setattr(run, "Tracer", run.Tracer)
    monkeypatch.setattr(run, "metric_reader", run.metric_reader)
    summary = {"busy_s": 1.0, "window_s": 4.0,
               "idle_split": {"window_s": 4.0, "idle_s": 3.0,
                              "queued_s": 1.0, "gaps": 2, "unlaunched": 0,
                              "starved_s": {"codec.decode": 2.0}}}

    def fake_main(argv):
        assert run.Tracer is idle_split.SplitTracer
        assert argv[-2:] == ["--trace", "1"]
        spans = [("step", 0.0, 1.0), ("step", 1.0, 2.0)]
        record = _record(summary, spans)
        record["window"].extra["work_span"] = "step"
        assert run.metric_reader("device_idle.gen")(record) == \
            pytest.approx(75.0)
        return 0

    monkeypatch.setattr(run, "main", fake_main)
    assert idle_split.main(["--workload", "expe5-recon", "--seed", "3",
                            "--seconds", "5"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (line["seed"], line["traced_items"]) == (3, 2)
    assert line["idle_codec_ms"] == pytest.approx(1000.0)
    assert line["idle_split"] == summary["idle_split"]
    monkeypatch.setattr(run, "main", lambda argv: 2)
    assert idle_split.main(["--workload", "expe5-recon", "--seed", "3",
                            "--seconds", "5"]) == 2


@pytest.mark.parametrize("name", COUNTER_METRICS)
def test_counter_readers_need_a_trace_and_counters(name, monkeypatch):
    assert metric_reader(name)(_record(None)) is None
    monkeypatch.setattr(port_counters, "snapshot", lambda: None)
    assert metric_reader(name)(_record({"busy_s": 1.0})) is None


def test_counter_readers_over_the_process(monkeypatch):
    monkeypatch.setattr(port_counters, "snapshot", lambda: {
        "data.batches": 0, "data.wait_s": 0.0, "data.ready": 0,
        "data.decode_s": 0.0, "graphs.capture_s": 0.0})
    spans = [("loader", 0.0, 0.5), ("request", 0.5, 1.0),
             ("request", 1.0, 2.0), ("request", 5.0, 6.0)]
    record = _record({"busy_s": 1.0}, spans)
    # no batch: nothing to read; no capture: 0.0 over every request
    assert metric_reader("data_wait_ms.recon")(record) is None
    assert metric_reader("graph_capture_ms.gen")(record) == 0.0
    monkeypatch.setattr(port_counters, "snapshot", lambda: {
        "data.batches": 4, "data.wait_s": 0.4, "data.ready": 1,
        "data.decode_s": 0.2, "graphs.capture_s": 0.3})
    assert metric_reader("data_wait_ms.recon")(record) == \
        pytest.approx(100.0)
    assert metric_reader("data_decode_ms.recon")(record) == \
        pytest.approx(50.0)
    assert metric_reader("data_ready.recon")(record) == pytest.approx(25.0)
    assert metric_reader("graph_capture_ms.gen")(record) == \
        pytest.approx(100.0)
    # a trace's summary is not a second source
    record["trace"]["counters"] = {"data.batches": 1, "data.wait_s": 9.0}
    assert metric_reader("data_wait_ms.recon")(record) == \
        pytest.approx(100.0)


def test_timeline_on_the_card(card):
    """The card's profiler: launch calls for the kernels, no device-side
    range for the program's spans, and the split's parts summing to the
    idle time."""
    import torch
    from favae_tpu_torch import profiling
    x = torch.randn(1024, 1024, device=card)
    (x @ x).sum().item()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("bench:traced"):
            for _ in range(5):
                with profiling.span("codec.decode"):
                    y = x @ x
                with profiling.span("data.wait"):
                    time.sleep(0.01)
            y.sum().item()
    assert not [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.name.startswith("favae:")]
    ops, launches, spans, window = idle_split.timeline(prof)
    assert len(ops) >= 6
    assert sum(c in launches for _, _, c in ops) == len(ops)
    s = idle_split.split_idle(ops, launches, spans, *window)
    assert sum(s["starved_s"].values()) + s["queued_s"] == \
        pytest.approx(s["idle_s"])
    assert s["starved_s"].get("data.wait", 0.0) > 0.03
