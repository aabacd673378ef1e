"""The harness finds every cell, configuration, traffic, entry, metric and
limit named in BENCHMARK.json by file, refuses an unknown name, and the
file keeps to the benchmark's contract."""

import json
import re

import pytest

from _tiny import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [c["name"] for c in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_to_files(cell):
    from tuckerbench import harness

    spec = harness.load_spec(cell, ROOT)
    assert spec.config["name"] == spec.cell["config"]
    harness.entry_module(spec.traffic["entry"])
    for m in spec.per_layer:
        assert callable(harness.metric_module(m["name"]).read)
    names = {m["name"] for m in spec.e2e}
    assert {"decomp_s", "peak_gib", "setup_s"} <= names
    assert spec.per_layer, "every cell reports a per-layer metric"
    assert spec.limits["limits"], "every cell's check has limits"


def test_unknown_names_are_refused():
    from tuckerbench import harness

    with pytest.raises(harness.BenchError):
        harness.load_spec("no.such.cell", ROOT)
    with pytest.raises(harness.BenchError):
        harness.entry_module("no_such_entry")
    with pytest.raises(harness.BenchError):
        harness.metric_module("no.such_metric")


def test_names_units_and_bounds_keep_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for item in BENCH["configs"] + BENCH["workloads"] + metrics:
        assert NAME.match(item["name"]), item["name"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m["workloads"]) <= set(CELLS)
        # the end-to-end metric it moves is reported in each of its cells
        for cell in m["workloads"]:
            e2e = [e["name"] for e in BENCH["end_to_end"]
                   if cell in e.get("workloads", CELLS)]
            assert m["moves"] in e2e, (m["name"], cell)
    for item in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(item["why"]) <= 200 and "\n" not in item["why"]
    for c in BENCH["workloads"]:
        assert c["chips"] == 1
    for cfg in BENCH["configs"]:
        assert (ROOT / cfg["file"]).is_file()
        assert json.loads((ROOT / cfg["file"]).read_text())["reduced"] == \
            cfg["reduced"]


@pytest.mark.parametrize("setup, want", [({"plan_s": 97.25}, 97.25),
                                         ({}, None)])
def test_plan_reader_reports_the_set_up_plan_or_nothing(setup, want):
    from types import SimpleNamespace

    from tuckerbench import harness

    reader = harness.metric_module("plan.build_s")
    assert reader.read(SimpleNamespace(setup=setup)) == want
