"""The readers of the program's spans and counters (``repro_torch.tracing``):
a tiny traced run of each cell on the CPU reports every host-span metric of
the cell, the upload's megabytes to the byte, nothing from the device-time
readers, and stays correct; a program without the store reports nothing
and raises nothing.

The tiny traced runs leave out the two roofline readers: they read the
card's kernel records and fail a run that recorded none, which a CPU run
never does.
"""

import sys

import pytest
import torch

from _tiny import SEED, tiny_spec

CELLS = ["nell2.lite.p4", "nell2.hooi", "enron.hooi", "enron.lite.p4"]
NEW = {"entry.call_setup_s", "entry.upload_mb", "sweep.finalize_s",
       "sweep.norm2_s", "engine.zbuild_ms", "graphs.replay_ms",
       "graphs.cut_ms"}
DEVICE_TIME = {"engine.zbuild_ms", "graphs.replay_ms"}
NEEDS_KERNEL_RECORDS = {"kernels.zbuild_roofline", "kernels.oracle_roofline"}


def _traced(cell):
    import time

    from repro_torch import tracing
    from tuckerbench import harness

    spec = tiny_spec(cell)
    spec.per_layer = [m for m in spec.per_layer
                      if m["name"] not in NEEDS_KERNEL_RECORDS]
    tracing.clear()
    try:
        res = harness.run(spec, SEED, 0.5, True, time.perf_counter(),
                          device=torch.device("cpu"))
    finally:
        tracing.clear()
    return spec, res


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_tiny_run_reports_the_span_metrics(cell):
    from tuckerbench import harness

    spec, res = _traced(cell)
    assert res["correct"], res["checks"]
    mine = {m["name"] for m in spec.per_layer} & NEW
    assert mine, "every cell reads some of the program's spans"
    got = set(res["metrics"])
    assert mine - DEVICE_TIME <= got, (mine, got)
    assert not (DEVICE_TIME & got)  # no CUDA events on the CPU
    for name in mine - DEVICE_TIME:
        assert res["metrics"][name]["value"] >= 0.0
    if "entry.upload_mb" in mine:
        t = harness._make_tensor(spec.config, SEED, torch.device("cpu"))
        N = len(t.shape)
        assert res["metrics"]["entry.upload_mb"]["value"] == \
            t.nnz * (4 * N + 4) / 1e6


@pytest.mark.parametrize("name", sorted(NEW))
def test_a_program_without_the_store_reads_nothing(monkeypatch, name):
    import repro_torch
    from tuckerbench import harness

    monkeypatch.delattr(repro_torch, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    with pytest.raises(ImportError):
        from repro_torch import tracing  # noqa: F401
    assert harness.metric_module(name).read(None) is None
