"""Shared pieces of the benchmark's tests: the benchmark's folder and the
checkout's root on the path, and tiny CPU runs of the cells on the port's
plain route (40x30 views, 8 + 16 samples, 64 rays a step)."""

from __future__ import annotations

import json
import os
import sys
import time

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)
if os.path.dirname(BENCH) not in sys.path:
    sys.path.append(os.path.dirname(BENCH))

TINY_SINGLE = {"name": "tiny_single", "scenes": [
    {"urdf": "laptop.urdf", "resolution": [40, 30], "qpos_deg": 55.0, "seed": 7,
     "splits": {"train": 4, "val": 2, "test": 2}}]}
TINY_MULTI = {"name": "tiny_multi", "scenes": [
    {"urdf": "laptop.urdf", "dir": "laptop_0", "resolution": [40, 30], "seed": 11,
     "splits": {"train": 3}, "joint_degrees": [0, 10, 20]},
    {"urdf": "laptop_b.urdf", "dir": "laptop_1", "resolution": [40, 30], "seed": 12,
     "splits": {"train": 3}, "joint_degrees": [0, 10, 20]}]}


def cells(kind: str = None) -> tuple:
    """The workloads of ``BENCHMARK.json`` whose traffic mix is of ``kind``
    (all where None): a cell added there is tested as it stands."""
    with open(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    out = []
    for w in bench["workloads"]:
        with open(os.path.join(BENCH, "traffic", f"{w['traffic']}.json")) as fh:
            if kind is None or json.load(fh)["kind"] == kind:
                out.append(w["name"])
    return tuple(out)


def tiny_overrides(cell: str, dtype: str = "float32") -> dict:
    ov = {"compute_dtype": dtype, "N_samples": 8, "N_importance": 16, "img_wh": [40, 30],
          "chunk": 512}
    if cell.startswith("vanilla"):
        ov.update(dataset=TINY_SINGLE, batch_size=64, microbatch_rays=64)
    else:
        ov.update(dataset=TINY_MULTI, ray_batch_size=64, microbatch_rays=32)
    return ov


@pytest.fixture(scope="session")
def data_root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("bench_data"))


@pytest.fixture
def tiny_run(data_root):
    """``tiny_run(cell, seed=5, trace=False, hooks=None, dtype="float32")``:
    one CPU run of a cell at the tiny size, its result dict."""
    import run as bench_run

    def go(cell, seed=5, trace=False, hooks=None, dtype="float32", seconds=0.5):
        return bench_run.run_cell(cell, seed, seconds, trace, device="cpu",
                                  overrides=tiny_overrides(cell, dtype), hooks=hooks,
                                  data_root=data_root, t_start=time.perf_counter())

    return go
