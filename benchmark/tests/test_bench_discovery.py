"""Configurations, traffic mixes, metrics and limits are found by name:
adding a cell is adding files and entries, with no edit to a file the
benchmark has.  Shown in a temporary copy of the benchmark, which gains a
configuration, a mix, a FLOP count, a per-layer metric and a cell."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys

from conftest import BENCH

ROOT = os.path.dirname(BENCH)


def _digests(top):
    out = {}
    for dirpath, dirs, files in os.walk(top):
        dirs[:] = [d for d in dirs if d not in ("data", "__pycache__")]
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, top)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_new_cell_is_only_new_files(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("data", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    bench = root / "benchmark"
    before = _digests(bench)

    cfg = json.loads((bench / "configs" / "vanilla_laptop.json").read_text())
    cfg["name"] = "vanilla_laptop_b"
    (bench / "configs" / "vanilla_laptop_b.json").write_text(json.dumps(cfg))
    shutil.copy(bench / "flops" / "vanilla_laptop.py", bench / "flops" / "vanilla_laptop_b.py")
    mix = json.loads((bench / "traffic" / "train_loop.json").read_text())
    mix["warmup_dispatches"] = 1
    (bench / "traffic" / "train_loop_b.json").write_text(json.dumps(mix))
    (bench / "metrics" / "steps.train.py").write_text(
        '"""Steps in the window."""\n\n\ndef read(ctx):\n'
        '    return ctx["result"]["steps"] or None\n')
    shutil.copy(bench / "limits" / "vanilla_train.json", bench / "limits" / "vanilla_b_train.json")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(spec["configs"][0], name="vanilla_laptop_b",
                                file="benchmark/configs/vanilla_laptop_b.json"))
    spec["workloads"].append(dict(spec["workloads"][0], name="vanilla_b_train",
                                  config="vanilla_laptop_b", traffic="train_loop_b"))
    for m in spec["end_to_end"]:
        if "workloads" in m and "vanilla_train" in m["workloads"]:
            m["workloads"].append("vanilla_b_train")
    spec["per_layer"].append({"name": "steps.train", "unit": "count", "better": "higher",
                              "source": "host_clock", "layer": "trainer",
                              "moves": "train_rays_per_s", "workloads": ["vanilla_b_train"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    after = _digests(bench)
    assert all(after[k] == v for k, v in before.items()), "an existing file changed"

    code = f"""
import json, sys, time
sys.path.insert(0, {os.path.join(BENCH, 'tests')!r})
from conftest import tiny_overrides
sys.path.insert(0, {str(bench)!r})
import run
ov = tiny_overrides("vanilla_train")
out = run.run_cell("vanilla_b_train", 4, 0.3, True, device="cpu", overrides=ov,
                   data_root={str(tmp_path / 'data')!r}, t_start=time.perf_counter())
print(json.dumps(out))
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, env=env, cwd=str(root))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"]
    assert out["metrics"]["steps.train"]["value"] >= 1
    assert "level_roofline.train" not in out["metrics"]  # not listed for the new cell
