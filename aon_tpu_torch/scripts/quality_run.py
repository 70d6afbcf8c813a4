"""A quality run's val PSNR against a reference curve at equal steps.

    python -m aon_tpu_torch.scripts.quality_run PORT_METRICS_JSONL \\
        [--reference results/laptop_vanilla_refsched_occ16/metrics.jsonl]

prints one JSON line: ``[step, port val/psnr, reference val/psnr, port -
reference]`` at every step both curves have.

The run itself is the CLI's.  In segments, each resumed from the last
checkpoint, write a copy of the config with the segment's end as
``run_max_steps``, the whole run's LR horizon as ``lr_max_steps`` (else the
schedule decays over each segment), ``output_path`` and, for another run,
``seed``, then run it (a config's JSON keys win over the CLI's flags):

    python - <<'EOF'
    import json
    c = json.load(open("configs/quality_laptop_vanilla_refsched_occ16.json"))
    c.update(run_max_steps=25551, lr_max_steps=100000, output_path="build/quality", seed=0)
    json.dump(c, open("build/quality.json", "w"))
    EOF
    python -m aon_tpu_torch.run --config build/quality.json                        # first
    python -m aon_tpu_torch.run --config build/quality.json --ckpt_path last.ckpt  # later

``--run CONFIG --out DIR`` does that recipe and what follows it in one call:

    python -m aon_tpu_torch.scripts.quality_run --run configs/quality_laptop_autodec_24k_aabb24.json \
        --out build/quality_autodec [--set run_max_steps=12000] [--set seed=1] \
        [--reference results/laptop_autodec_24k_aabb24/metrics.jsonl] [--no_eval]

writes ``DIR/config.json`` (the config with ``--set KEY=JSON`` applied,
``output_path`` = ``DIR/results``, ``lr_max_steps`` pinned at the config's own
``run_max_steps`` unless set, ``root_dir`` made absolute), trains, resuming
from ``DIR/results/{exp_name}/last.ckpt`` where one exists, and then, unless
``--no_eval``: ``--run_eval`` (``render_name`` ``test``), for the
auto-decoder ``eval_per_instance`` and ``render_sweep``, and an extraction
over the dataset's bounds; their ``ckpts/`` land under ``DIR``.  It prints one
JSON line per part (``fit``, ``test``, ``test_split``, ``per_instance``,
``sweep``, ``geometry``, ``curve``, and ``gaps``: the mean gap over the
shared vals, over the last five and at the last, of val/psnr and, where both
files log them, val/psnr_obj and val/state_error_rad) and returns them.
``PORT_METRICS_JSONL --gaps`` prints those gaps alone.

``--sweep FILE ...`` prints the 19-frame sweeps' PSNR split into the
learned codes' (even) frames and the interpolated codes' (odd) frames, from
``results.json`` or ``per_instance.json`` files.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

REFERENCE = "results/laptop_vanilla_refsched_occ16/metrics.jsonl"


# the val metrics compare() reads: PSNR, the object's PSNR, and the
# auto-encoder's joint-state error
CURVE_KEYS = ("val/psnr", "val/psnr_obj", "val/state_error_rad")


def val_curve(metrics_jsonl, key: str = "val/psnr") -> dict:
    """{step: ``key``} of a metrics.jsonl, at the steps that log it."""
    curve = {}
    for line in Path(metrics_jsonl).read_text().splitlines():
        rec = json.loads(line)
        if key in rec:
            curve[int(rec["step"])] = float(rec[key])
    return curve


def compare(port_jsonl, reference_jsonl, key: str = "val/psnr") -> list:
    """[step, port ``key``, reference ``key``, port - reference] at every
    step both curves have."""
    port, ref = val_curve(port_jsonl, key), val_curve(reference_jsonl, key)
    return [[s, port[s], ref[s], port[s] - ref[s]] for s in sorted(port) if s in ref]


def curves(port_jsonl, reference_jsonl) -> dict:
    """compare() of each of CURVE_KEYS that both files log at a shared step."""
    out = {key: compare(port_jsonl, reference_jsonl, key) for key in CURVE_KEYS}
    return {key: rows for key, rows in out.items() if rows}


def gaps(rows) -> dict:
    """A compare() curve in a few numbers: the mean gap over its steps, over
    its last five, and its last step's values."""
    last = rows[-1]
    return {"steps": len(rows), "mean_gap": sum(r[3] for r in rows) / len(rows),
            "mean_gap_last5": sum(r[3] for r in rows[-5:]) / len(rows[-5:]),
            "last_step": last[0], "last_port": last[1], "last_reference": last[2],
            "last_gap": last[3]}


def sweep_split(path) -> dict:
    """The 19-frame sweep's PSNR split by code: the mean of its even frames
    (the learned articulation codes) and of its odd ones (the interpolated
    midpoints), from a ``results.json`` (``{"sweep": ...}``) or a
    ``per_instance.json`` (one entry per instance id)."""
    rec = json.loads(Path(path).read_text())

    def split(each):
        return {"learned": sum(each[::2]) / len(each[::2]),
                "interpolated": sum(each[1::2]) / len(each[1::2])}

    if "instances" in rec:
        return {r["id"]: split(r["each"]) for r in rec["instances"]}
    return {"sweep": split(rec["PSNR"]["each"])}


def run(config, out, overrides=(), reference=None, evals: bool = True,
        device="cuda") -> dict:
    """Train ``config`` (with ``overrides``, KEY=JSON strings) into ``out`` and
    evaluate it; see the module docstring.  Returns ``{part: record}``."""
    from aon_tpu_torch import run as cli
    from aon_tpu_torch.scripts import eval_per_instance, extract_geometry, render_sweep
    from aon_tpu_torch.utils.config import get_config

    out = Path(out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    c = json.loads(Path(config).read_text())
    c["lr_max_steps"] = c.get("lr_max_steps") or c["run_max_steps"]
    for item in overrides:
        key, value = item.split("=", 1)
        c[key] = json.loads(value)
    c["root_dir"] = os.path.abspath(c["root_dir"])
    c["output_path"] = str(out / "results")
    cfg_path = out / "config.json"
    cfg_path.write_text(json.dumps(c, indent=1))
    run_dir = out / "results" / c["exp_name"]
    metrics = run_dir / "metrics.jsonl"

    parts = {}

    def emit(name, rec):
        parts[name] = rec
        print(json.dumps({name: rec}), flush=True)

    cwd = os.getcwd()
    os.chdir(out)  # the evaluations write ckpts/ under the working directory
    try:
        resume = (run_dir / "last.ckpt").exists()
        t0 = time.perf_counter()
        argv = ["--config", str(cfg_path)] + (["--ckpt_path", "last.ckpt"] if resume else [])
        trainer = cli.main(get_config(argv), device=device)
        rates = [r["train/rays_per_sec"] for r in map(json.loads, metrics.read_text().splitlines())
                 if "train/rays_per_sec" in r]
        emit("fit", {"steps": trainer.global_step, "resumed": resume,
                     "seconds": time.perf_counter() - t0, "rays_per_sec_epochs": rates})
        if evals:
            test_cfg = get_config(["--config", str(cfg_path), "--run_eval",
                                   "--render_name", "test", "--ckpt_path", "last.ckpt"])
            cli.main(test_cfg, device=device)
            res = json.loads((out / "ckpts" / c["exp_name"] / "results.json").read_text())
            emit("test", {name: stat["mean"] for name, stat in res.items()})
            if c.get("exp_type") == "vanilla_autodecoder":  # its learned and midpoint codes
                emit("test_split", sweep_split(out / "ckpts" / c["exp_name"] / "results.json"))
                per = eval_per_instance.main(["--config", str(cfg_path), "--ckpt_path",
                                              "last.ckpt"], device=device)
                emit("per_instance", per)
                sweep = render_sweep.main(["--config", str(cfg_path)], device=device)
                emit("sweep", {"out_dir": sweep["out_dir"], "frames": len(sweep["frames"]),
                               "video": sweep["video"]})
            geo = extract_geometry.main(["--config", str(cfg_path)], device=device)
            emit("geometry", {k: geo[k] for k in ("occupied", "verts", "tris", "threshold")
                              if k in geo})
        if reference:
            emit("curve", compare(metrics, Path(cwd) / reference))
            emit("gaps", {key: gaps(rows)
                          for key, rows in curves(metrics, Path(cwd) / reference).items()})
    finally:
        os.chdir(cwd)
    return parts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("port", nargs="?", help="the run's metrics.jsonl")
    ap.add_argument("--reference", default=None, help="a metrics.jsonl to compare with "
                    f"(default {REFERENCE} without --run)")
    ap.add_argument("--run", default=None, help="a config to train and evaluate")
    ap.add_argument("--out", default=None, help="the run's directory (with --run)")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=JSON",
                    help="a config override (with --run)")
    ap.add_argument("--no_eval", action="store_true", help="train only (with --run)")
    ap.add_argument("--gaps", action="store_true",
                    help="print gaps() of each of CURVE_KEYS both files log, not the curve")
    ap.add_argument("--sweep", nargs="+", default=None, metavar="JSON",
                    help="results.json or per_instance.json files: print each sweep's "
                         "learned- and interpolated-code means")
    args = ap.parse_args(argv)
    if args.sweep:
        splits = {path: sweep_split(path) for path in args.sweep}
        print(json.dumps(splits), flush=True)
        return splits
    if args.run:
        if not args.out:
            ap.error("--run needs --out")
        return run(args.run, args.out, args.set, args.reference, evals=not args.no_eval)
    if not args.port:
        ap.error("give a metrics.jsonl or --run")
    reference = args.reference or REFERENCE
    if args.gaps:
        out = {key: gaps(rows) for key, rows in curves(args.port, reference).items()}
        print(json.dumps(out), flush=True)
        return out
    rows = compare(args.port, reference)
    print(json.dumps(rows), flush=True)
    return rows


if __name__ == "__main__":
    main()
