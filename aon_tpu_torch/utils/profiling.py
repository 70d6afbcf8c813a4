"""Tracing and profiling hooks (port of ``aon_tpu/utils/profiling.py``).

The reference's only profiling is Lightning's ``profiler="simple"`` on one
GPU (run.py:108).  Here:

* ``trace(logdir)``: a ``torch.profiler`` context (host and, on a card, CUDA
  activity) that writes a Chrome / Perfetto trace, ``logdir/trace.json``
  (open it in ui.perfetto.dev or chrome://tracing);
* ``annotate(name)``: a named span in that trace
  (``torch.profiler.record_function``);
* the per-epoch ``train/rays_per_sec`` counter is logged by the Trainer.

NaN debugging (the reference runs Lightning's ``detect_anomaly=True``): the
Trainer raises on a NaN loss at every log interval; to find the operation
that made the first NaN set ``AON_DEBUG_NANS=1`` (or the config's
``debug_nans``), which turns on autograd's anomaly detection.

The JAX package's ``start_server`` (a live ``xprof`` capture server) has no
PyTorch counterpart and is not ported.
"""

from __future__ import annotations

import contextlib
import os

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the body and write ``logdir/trace.json`` when it ends."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def annotate(name: str):
    """A named span in the current trace."""
    return torch.profiler.record_function(name)


def maybe_enable_debug_nans(flag: bool = False) -> bool:
    """Turn on autograd's anomaly detection (the analogue of
    ``jax_debug_nans``) when ``flag`` is set or ``AON_DEBUG_NANS=1``;
    returns whether it is on."""
    if flag or os.environ.get("AON_DEBUG_NANS", "0") == "1":
        torch.autograd.set_detect_anomaly(True)
    return torch.is_anomaly_enabled()
