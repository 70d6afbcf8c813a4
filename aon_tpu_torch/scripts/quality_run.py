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
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

REFERENCE = "results/laptop_vanilla_refsched_occ16/metrics.jsonl"


def val_curve(metrics_jsonl) -> dict:
    """{step: val/psnr} of a metrics.jsonl."""
    curve = {}
    for line in Path(metrics_jsonl).read_text().splitlines():
        rec = json.loads(line)
        if "val/psnr" in rec:
            curve[int(rec["step"])] = float(rec["val/psnr"])
    return curve


def compare(port_jsonl, reference_jsonl) -> list:
    """[step, port val/psnr, reference val/psnr, port - reference] at every
    step both curves have."""
    port, ref = val_curve(port_jsonl), val_curve(reference_jsonl)
    return [[s, port[s], ref[s], port[s] - ref[s]] for s in sorted(port) if s in ref]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("port", help="the run's metrics.jsonl")
    ap.add_argument("--reference", default=REFERENCE, help="a metrics.jsonl to compare with")
    args = ap.parse_args(argv)
    rows = compare(args.port, args.reference)
    print(json.dumps(rows), flush=True)
    return rows


if __name__ == "__main__":
    main()
