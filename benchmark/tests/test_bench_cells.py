"""Every traffic mix, run tiny on the CPU through the port's plain route,
against the plain reference; and the last line's schema."""

from __future__ import annotations

import json
import math

import pytest

from conftest import cells

CELLS = cells()


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_matches_reference(tiny_run, cell):
    out = tiny_run(cell)
    assert out["correct"], out["checks"]
    # the float32 plain route is the reference's arithmetic: its gaps are a
    # small share of the bf16 yardstick's
    for name, rec in out["checks"].items():
        assert rec["value"] < 0.1, name
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("cell,trace", [("vanilla_train", False), ("vanilla_render", True)])
def test_result_schema(tiny_run, cell, trace):
    # a traced window outlasts the profiler's (5 s) so that the window's rest,
    # without it, gives the spans' and mfu's readings
    out = tiny_run(cell, trace=trace, seconds=6.0 if trace else 0.5)
    line = json.loads(json.dumps(out))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"]), name
    for rec in line["checks"].values():
        assert set(rec) == {"value", "limit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        bd = line["breakdown"]
        assert set(bd) == {"device_ops", "idle_gaps"}
        assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10
        assert "mfu.render" in line["metrics"]
    else:
        assert "setup_s" in line["metrics"]
