"""The FLOP counts reproduce chip_smoke's bounds at its shapes, and the
trace reduction's arithmetic on a hand-made trace."""

from __future__ import annotations

import json

import pytest

from common import PEAK_BF16_FLOPS, breakdown, kernel_seconds, load_module, reduce_trace


@pytest.mark.parametrize("config,rows,train,rays,want_ms", [
    ("vanilla_laptop", 193, False, 61440, 14.230), ("vanilla_laptop", 65, False, 61440, 4.792),
    ("vanilla_laptop", 193, True, 2048, 1.423), ("vanilla_laptop", 65, True, 2048, 0.479),
    ("autodec_laptop", 193, True, 2048, 1.661), ("autodec_laptop", 65, True, 2048, 0.559),
])
def test_bounds_match_chip_smoke(config, rows, train, rays, want_ms):
    fl = load_module("flops", config)
    assert round(1e3 * fl.level_flops(rays, rows, train) / PEAK_BF16_FLOPS, 3) == want_ms


def test_macs_per_row():
    assert load_module("flops", "vanilla_laptop").MACS_PER_ROW == 593408
    assert load_module("flops", "autodec_laptop").MACS_PER_ROW == 692480


def test_reduce_trace(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench/window", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "bench/dispatch", "ts": 0, "dur": 60},
        {"ph": "X", "cat": "user_annotation", "name": "bench/loader", "ts": 5, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "void sm90_train_fwd(sm90::FwdArgs)", "ts": 30, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "art_composite_kernel", "ts": 45, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 70, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "late", "ts": 95, "dur": 10},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    tr = reduce_trace(str(path))
    assert tr["window_s"] == pytest.approx(100e-6)
    # busy: [30, 55] + [70, 80] + [95, 100] (clipped to the window)
    assert tr["busy_s"] == pytest.approx(40e-6)
    # idle: [0, 30] (mid 15: loader inside dispatch), [55, 70] (mid 62.5: none), [80, 95]
    assert tr["idle_gaps"]["loader"] == pytest.approx(30e-6)
    assert tr["idle_gaps"]["other"] == pytest.approx(30e-6)
    assert kernel_seconds(tr, ["sm90_train_fwd", "composite_kernel"]) == pytest.approx(20e-6)
    assert kernel_seconds(tr, ["art_composite_kernel"]) == pytest.approx(10e-6)
    assert kernel_seconds(tr, ["nothing_here"]) is None
    bd = breakdown(tr)
    assert bd["device_ops"][0][0].startswith("void sm90_train_fwd")
