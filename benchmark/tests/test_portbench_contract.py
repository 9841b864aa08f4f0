"""BENCHMARK.json against the benchmark's contract: names, units, keys and
limits, and every cell's files found by name."""

import re

import pytest

from benchmark.harness import BENCH, ROOT, load_cell, load_json

B = load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
CELLS = [w["name"] for w in B["workloads"]]
METRICS = B["end_to_end"] + B["per_layer"]


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(B["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p for p in B["paths"])
    assert 1 <= len(B["command"]) <= 32
    assert 1 <= B["run_seconds"] <= 51 and isinstance(B["run_seconds"], int)
    assert len(__import__("json").dumps(B)) <= 64 * 1024


@pytest.mark.parametrize("entry", B["configs"] + B["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200
            assert "\n" not in entry[key] and "\t" not in entry[key]
    for key in entry.get("reduced", []):
        assert NAME.match(key)


def test_names_unique():
    for group in (B["configs"], B["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


def test_end_to_end():
    names = {m["name"] for m in B["end_to_end"]}
    assert "setup_s" in names
    for m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_files(cell):
    c = load_cell(cell)
    assert c.entry["chips"] in (1, 4)
    assert (BENCH / "drivers" / f"{c.traffic['driver']}.py").exists()
    e2e = {m["name"] for m in c.end_to_end()}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer()
    for m in c.per_layer():
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
        # the metric's cells report the end-to-end metric it moves
        assert m["moves"] in e2e
    for k in ("trace_seconds", "limits"):
        assert k in c.traffic


def test_per_layer_keys():
    layers = {}
    for m in B["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert all(w in CELLS for w in m.get("workloads", CELLS))
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    for spelled in layers.values():
        assert len(spelled) == 1


def test_configs_used_and_files_under_paths():
    used = {w["config"] for w in B["workloads"]}
    files = [c["file"] for c in B["configs"]]
    assert used == {c["name"] for c in B["configs"]}
    assert len(files) == len(set(files))
    for f in files:
        assert any(f.startswith(p + "/") for p in B["paths"])
        assert (ROOT / f).exists()


def test_four_chip_share():
    fours = sum(w["chips"] == 4 for w in B["workloads"])
    assert fours <= max(1, len(B["workloads"]) // 4)


def test_check_budget():
    n = 24
    assert (2 + 14 * n) * (B["run_seconds"] + 60) + n * 180 + 1200 <= 43200
