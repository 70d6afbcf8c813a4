"""Nothing a run loads is JAX or the JAX package, compared by whole
top-level names: ``aon_tpu_torch`` starts with ``aon_tpu`` and is allowed."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import types

from conftest import BENCH

import run as bench_run


def test_forbidden_names_are_whole():
    sys.modules["aon_tpu_torch_probe_x"] = types.ModuleType("aon_tpu_torch_probe_x")
    try:
        assert "aon_tpu" not in bench_run.forbidden_loaded()
        sys.modules["aon_tpu.probe_x"] = types.ModuleType("aon_tpu.probe_x")
        assert "aon_tpu" in bench_run.forbidden_loaded()
    finally:
        sys.modules.pop("aon_tpu_torch_probe_x", None)
        sys.modules.pop("aon_tpu.probe_x", None)


def test_a_run_of_each_mix_loads_no_jax(tmp_path):
    """In a fresh process, a tiny CPU run of each traffic mix, then every
    loaded module's top-level name against jax, jaxlib, flax and aon_tpu."""
    code = f"""
import json, sys, time
sys.path.insert(0, {os.path.join(BENCH, 'tests')!r})
from conftest import cells, tiny_overrides
import run
for cell in cells():
    run.run_cell(cell, 3, 0.2, cell == "vanilla_render", device="cpu",
                 overrides=tiny_overrides(cell), data_root={str(tmp_path)!r},
                 t_start=time.perf_counter())
print(json.dumps({{"bad": run.forbidden_loaded(),
                  "names": sorted({{m.split('.')[0] for m in sys.modules}})}}))
"""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    assert "aon_tpu_torch" in got["names"]
    assert not {"jax", "jaxlib", "flax", "aon_tpu"} & set(got["names"])


def test_harness_sources_import_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|aon_tpu)(\s|\.|$)", re.M)
    for dirpath, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    assert not pat.search(fh.read()), f
