"""Relaunch the port's CLI when its watchdog trips (port of
``scripts/train_resilient.py``).

``--watchdog_timeout N`` makes the trainer exit with code 17 when no
dispatch completes for N seconds; this wrapper then relaunches
``python -m aon_tpu_torch.run`` with ``--ckpt_path last.ckpt``, so the run
resumes from the last saved epoch:

    python -m aon_tpu_torch.scripts.train_resilient --config configs/quality_laptop_ae_aabb24.json \\
        --watchdog_timeout 900

Any other exit code (success, a real failure, Ctrl-C) is returned as it is;
a cap on the relaunches guards against a crash loop.
"""

from __future__ import annotations

import subprocess
import sys

from aon_tpu_torch.train.trainer import Trainer

WATCHDOG_EXIT_CODE = Trainer.WATCHDOG_EXIT_CODE
MAX_RELAUNCHES = 20


def main(argv=None, call=subprocess.call) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if "--watchdog_timeout" not in args:
        args += ["--watchdog_timeout", "900"]
    for attempt in range(MAX_RELAUNCHES + 1):
        cmd = [sys.executable, "-m", "aon_tpu_torch.run", *args]
        if attempt > 0 and "--ckpt_path" not in args:
            cmd += ["--ckpt_path", "last.ckpt"]
        print(f"[train_resilient] launching (attempt {attempt}): {' '.join(cmd)}", flush=True)
        rc = call(cmd)
        if rc != WATCHDOG_EXIT_CODE:
            return rc
        print(f"[train_resilient] watchdog tripped (exit {rc}); resuming", flush=True)
    print(f"[train_resilient] giving up after {MAX_RELAUNCHES} relaunches", flush=True)
    return 1


if __name__ == "__main__":
    sys.exit(main())
