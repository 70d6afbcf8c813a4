"""What the traffic drivers, the metric readers and the entry share: finding
files by name, the weights drawn from the seed, the benchmark's spans, one
profiler window reduced to device busy time, kernel times and idle gaps,
and the comparison of readings with their limits."""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
PEAK_BF16_FLOPS = 989e12  # one H100 SXM, dense bf16 (NVIDIA's data sheet)


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(BENCH, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name}".replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------- weights


def make_weights(layout: Sequence[Tuple[str, tuple]], seed: int, device) -> Dict[str, torch.Tensor]:
    """Xavier-uniform weights and code tables and zero biases from ``seed``,
    in one draw of a generator on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    sizes = [math.prod(s) for _, s in layout]
    flat = torch.rand(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out, pos = {}, 0
    for (name, shape), n in zip(layout, sizes):
        chunk = flat[pos:pos + n].view(shape)
        pos += n
        if name.endswith(".bias"):
            out[name] = torch.zeros(shape, device=device)
        else:
            bound = math.sqrt(6.0 / (shape[0] + shape[-1]))
            out[name] = (chunk * 2.0 - 1.0) * bound
    return out


# ------------------------------------------------------------------ spans


class Spans:
    """Host-clocked spans of the benchmark's own calls into the program,
    each also a ``record_function`` range, so the profiler's trace can say
    which span the host was in."""

    def __init__(self):
        self.times: Dict[str, List[float]] = {}
        self.on = False

    def span(self, name: str):
        return _Span(self, name)


class _Span:
    def __init__(self, owner: Spans, name: str):
        self.owner, self.name = owner, name

    def __enter__(self):
        if self.owner.on:
            self.rf = torch.profiler.record_function(f"bench/{self.name}")
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        if self.owner.on:
            self.rf.__exit__(*exc)
        self.owner.times.setdefault(self.name, []).append(dt)
        return False


class SpanIter:
    """An iterator that times each ``next`` of the one it wraps."""

    def __init__(self, it, spans: Spans, name: str = "loader"):
        self.it, self.spans, self.name = it, spans, name

    def __iter__(self):
        return self

    def __next__(self):
        with self.spans.span(self.name):
            return next(self.it)


# ------------------------------------------------------------------ trace

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce_trace(path: str, window_name: str = "bench/window") -> dict:
    """A chrome trace of ``torch.profiler`` -> the ``window_name`` range's
    length, the device's busy time in it (the union of kernels, copies and
    sets), each kernel's time and launches by name, and the idle gaps
    labelled by the innermost benchmark span the host was in."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith("bench/")]
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    win = [e for e in spans if e["name"] == window_name]
    if not win:
        raise RuntimeError("the trace holds no benchmark window")
    w0, w1 = float(win[0]["ts"]), float(win[0]["ts"]) + float(win[0]["dur"])
    kernels: Dict[str, List[float]] = {}
    ivals = []
    for e in dev:
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        ivals.append((a, b))
        name = str(e["name"]) if e["cat"] == "kernel" else e["cat"]
        rec = kernels.setdefault(name, [0.0, 0])
        rec[0] += (b - a) * 1e-6
        rec[1] += 1
    busy = _union(ivals)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    by_name: Dict[str, List[Tuple[float, float]]] = {}
    for e in spans:
        if e["name"] != window_name:
            by_name.setdefault(e["name"][len("bench/"):], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    # spans of one name do not overlap: the last to start before a point is
    # the only one that can hold it
    table = {k: (np.array(sorted(v))[:, 0], np.array(sorted(v))[:, 1]) for k, v in by_name.items()}
    gaps: Dict[str, float] = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b - a <= 0:
            continue
        mid = 0.5 * (a + b)
        label, best = "other", None
        for name, (starts, ends) in table.items():
            i = int(np.searchsorted(starts, mid, side="right")) - 1
            if i >= 0 and ends[i] >= mid and (best is None or ends[i] - starts[i] < best):
                label, best = name, ends[i] - starts[i]
        gaps[label] = gaps.get(label, 0.0) + (b - a) * 1e-6
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_s,
            "kernels": {k: (v[0], v[1]) for k, v in kernels.items()},
            "idle_gaps": gaps}


def breakdown(tr: dict) -> dict:
    ops = sorted(tr["kernels"].items(), key=lambda kv: -kv[1][0])[:10]
    gaps = sorted(tr["idle_gaps"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v[0]] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}


def kernel_seconds(tr: dict, names: Sequence[str]) -> Optional[float]:
    """Device seconds of the kernels whose name holds one of ``names`` as a
    whole identifier; None where the trace has none of them."""
    import re

    pat = re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(map(re.escape, names)) + r")(?![A-Za-z0-9_])")
    total = [v[0] for k, v in tr["kernels"].items() if pat.search(k)]
    return sum(total) if total else None


# ------------------------------------------------------------- the checks


class Check:
    """Readings held against their limits: ``value <= limit`` for each."""

    def __init__(self):
        self.items: List[Tuple[str, float, float]] = []

    def add(self, name: str, value: float, limit: float) -> None:
        self.items.append((name, float(value), float(limit)))

    @property
    def correct(self) -> bool:
        return bool(self.items) and all(
            math.isfinite(v) and v <= lim for _, v, lim in self.items)

    def as_dict(self) -> dict:
        return {n: {"value": v, "limit": lim} for n, v, lim in self.items}


def quantile(values: Sequence[float], q: float) -> float:
    """The q-th quantile, linear between order statistics."""
    return float(np.quantile(np.asarray(values, np.float64), q))


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


class Tracer:
    """The traced run's profiler window (CPU and CUDA activity, the
    benchmark's spans as ``bench/`` ranges) over the first ``seconds`` of
    its window, from a sync to a sync: the device's busy time, its kernels
    by name and the idle gaps labelled by the span the host was in.  The
    profiler slows the host; the benchmark's spans count from the window's
    end on, without it.  A no-op where ``on`` is false."""

    def __init__(self, on: bool, spans: Spans, device, seconds: float):
        self.spans, self.cuda = spans, torch.device(device).type == "cuda"
        self.seconds, self.running, self.prof = seconds, on, None
        self.count = 0
        if on:
            self._sync()
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
            spans.on = True
            self.win = torch.profiler.record_function("bench/window")
            self.win.__enter__()

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def tick(self, now: float, count: int) -> None:
        """After each step or frame: ``now`` seconds into the run's window,
        ``count`` steps or frames done."""
        if self.running and now >= self.seconds:
            self._sync()
            self.win.__exit__(None, None, None)
            self.prof.stop()
            self.spans.on = self.running = False
            self.spans.times.clear()
            self.count = count
            self.t_end = time.perf_counter()

    def reduce(self, out_dir: str) -> Optional[dict]:
        """The trace reduced (``reduce_trace``); its file removed."""
        if self.prof is None or self.running:
            return None
        path = os.path.join(out_dir, "trace.json")
        self.prof.export_chrome_trace(path)
        self.prof = None
        try:
            return dict(reduce_trace(path), count=self.count, t_end=self.t_end)
        finally:
            os.remove(path)
