"""BENCHMARK.json keeps to the contract's shape: keys, names, units, the
metrics each cell reports, and every file it names."""

from __future__ import annotations

import json
import os
import re

from conftest import BENCH

ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_keys_names_units():
    spec = _spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= spec["run_seconds"] <= 51
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert json.load(open(os.path.join(ROOT, c["file"])))["name"] == c["name"]
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
        for rel in (f"traffic/{w['traffic']}.json", f"limits/{w['name']}.json",
                    f"flops/{w['config']}.py"):
            assert os.path.exists(os.path.join(BENCH, rel)), rel
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(BENCH, "metrics", m["name"] + ".py"))
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_every_cell_reports_enough():
    spec = _spec()
    e2e = spec["end_to_end"]
    for w in spec["workloads"]:
        mine = [m["name"] for m in e2e if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in mine and len(mine) >= 2, w["name"]
        layer = [m for m in spec["per_layer"] if w["name"] in m["workloads"]]
        assert layer and all(m["moves"] in mine for m in layer), w["name"]
        assert any(m["name"].startswith("mfu") for m in layer), w["name"]
