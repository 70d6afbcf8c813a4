"""Run one cell of the benchmark of ``aon_tpu_torch`` once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name from ``BENCHMARK.json`` at the checkout's root:
the cell (``workloads``), its configuration file
(``benchmark/configs/<config>.json``), its traffic mix
(``benchmark/traffic/<traffic>.json``, whose ``kind`` picks the driver
``benchmark/drivers/<kind>.py``), its limits
(``benchmark/limits/<workload>.json``), its FLOP counts
(``benchmark/flops/<config>.py``) and one reader a metric
(``benchmark/metrics/<metric>.py``, ``read(ctx) -> float | None``).

With ``--trace 0`` the result's metrics are the cell's end-to-end metrics;
with ``--trace 1`` its per-layer metrics, read from one profiler window and
the benchmark's spans.  The last line of standard output is the result; the
last lines of standard error are the numbers compared, each beside its
limit.  It exits non-zero and prints no result where there is no CUDA
device or fewer than the cell asks for, or where JAX or the JAX package is
loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402

# One thread for OpenMP and BLAS, set before numpy and torch load: one host
# thread paces the loop, and a pool's idle threads only take cores from it
# on a shared host.  A caller may set its own.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, BENCH)
sys.path.insert(1, os.path.dirname(BENCH))  # the checkout's root: the measured program

FORBIDDEN = ("jax", "jaxlib", "flax", "aon_tpu")


def forbidden_loaded() -> list:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (``aon_tpu_torch`` is not ``aon_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def cell_spec(name: str) -> dict:
    from common import ROOT, load_json

    bench = load_json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    return {"bench": bench, "workload": w,
            "config": load_json(BENCH, "configs", f"{w['config']}.json"),
            "traffic": load_json(BENCH, "traffic", f"{w['traffic']}.json"),
            "limits": load_json(BENCH, "limits", f"{name}.json")}


def applies(metric: dict, cell: str, moves_ok: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in moves_ok


@contextlib.contextmanager
def cell_run(name: str, seed: int, seconds: float = 0.0, trace: bool = False,
             overrides: dict = None, data_root: str = None, t_start: float = None):
    """The run's cell dict (its specs, the dataset rendered where it is
    missing, a scratch directory under ``TMPDIR`` removed afterwards), the
    program's settings that ``overrides`` changes, and the driver module."""
    import datagen
    from common import load_module

    spec = cell_spec(name)
    overrides = dict(overrides or {})
    dataset = overrides.pop("dataset", spec["config"]["dataset"])
    data_dir = datagen.ensure_dataset(dataset, data_root or os.path.join(BENCH, "data"))
    out_dir = tempfile.mkdtemp(prefix="aon_bench_")
    try:
        yield (dict(spec, name=name, seed=int(seed), seconds=float(seconds), trace=bool(trace),
                    data_dir=data_dir, out_dir=out_dir,
                    t_start=T_START if t_start is None else t_start),
               overrides, load_module("drivers", spec["traffic"]["kind"]))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device="cuda",
             overrides: dict = None, hooks=None, data_root: str = None,
             t_start: float = None) -> dict:
    """One run of cell ``name``: the result dict the entry prints."""
    import torch

    from common import Check, breakdown, load_module

    device = torch.device(device)
    with cell_run(name, seed, seconds, trace, overrides, data_root, t_start) as (spec, ov, drv):
        res = drv.run(spec, device, ov, hooks)

    check = Check()
    for k, limit in spec["limits"].items():  # the numbers this cell compares
        check.add(k, res["readings"][k], limit)
    bench = spec["bench"]
    e2e = [m for m in bench["end_to_end"] if applies(m, name, set())]
    ctx = {"result": res, "cell": spec["workload"], "config": spec["config"],
           "trace": res.get("trace"), "flops": load_module("flops", spec["workload"]["config"])}
    chosen = e2e
    if trace:
        moves = {m["name"] for m in e2e}
        chosen = [m for m in bench["per_layer"] if applies(m, name, moves)]
    metrics = {}
    for m in chosen:
        value = load_module("metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    if device.type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": int(spec["workload"]["chips"])}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1}
    dev["memory_peak_bytes"] = int(res["memory_peak_bytes"])
    attempted = int(res.get("steps", res.get("frames", 0)))
    out = {"correct": bool(check.correct and res["finite"]), "attempted": attempted,
           "failed": 0 if res["finite"] else attempted, "metrics": metrics, "device": dev}
    if res.get("trace"):
        dev["busy_s"] = float(res["trace"]["busy_s"])
        dev["window_s"] = float(res["trace"]["window_s"])
        out["breakdown"] = breakdown(res["trace"])
    out["checks"] = check.as_dict()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import program
    from common import ROOT, log

    program.cache_dirs(ROOT)
    import torch

    chips = int(cell_spec(args.workload)["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    import aon_tpu_torch  # the measured program: fail before any set-up

    if not os.path.abspath(aon_tpu_torch.__file__).startswith(os.path.join(ROOT, "")):
        log(f"aon_tpu_torch is not the checkout's: {aon_tpu_torch.__file__}")
        return 2

    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_loaded()
    if bad:
        log(f"modules of JAX or the JAX package loaded: {', '.join(bad)}")
        return 3
    for k, v in out["checks"].items():
        log(f"check {k} {v['value']:.6g} limit {v['limit']:.6g}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
