"""Device time of kernel table rows 2 and 14, apart from the host's.

    python -m aon_tpu_torch.scripts.kernel_times [--root DIR]

Rows 2 (the resample, ``ops/resample.py``) and 14 (the encoding check,
``fused_mlp_train.posenc_in_kernel``) are short kernels behind Python
wrappers, so a CUDA event pair around one call times the wrapper's host work
as much as the kernel.  At the shapes of the main paths this prints, for each
entry, three times:

  device_ms  the kernel's own duration under torch.profiler, summed by kernel
             name over REPS warm calls and divided by the launches the
             trace recorded (``stage_device_ms``: every kernel and copy the
             call launches).  The trace on the card drops a few records of
             100 (and at times most of them), so counts are taken relative
             to the kernel each call launches once;
  ms         the median of one event pair around each call, chip_smoke's
             ``time_ms``: what a caller pays;
  events_ms  one event, REPS calls back to back, one event, over the
             count.  It times the device only where the kernel outlasts the
             wrapper's host time; below that the device starves and this
             measures the host again;

the kernels and copies, by name, that one ``sample_pdf_fused`` call
launches with the eval quantiles and with randomized ones, and the host
milliseconds one ``unit_linspace`` call (the coarse samples' and the eval
quantiles' row) takes behind about 1 ms of queued device work: a call that
copies from pageable host memory synchronises the stream and waits it out.  ``--root``
imports ``aon_tpu_torch`` from another checkout (a parent tree, to compare in
one call).  Prints one JSON line with the card's name and power limit.  Needs
one CUDA device.  chip_smoke.py runs it in a process of its own for each
tree: after many profiler sessions in one process the card's trace can come
back empty.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

# (rays, coarse t-values, fine quantiles, shared eval row): the render chunk,
# a training microbatch, the bench's two contracts' microbatches and the occ8
# config's
RESAMPLE_SHAPES = ((61440, 65, 128, True), (2048, 65, 128, False),
                   (2048, 17, 32, False), (2048, 25, 48, False), (2048, 9, 16, False))
POSENC_ROWS = (256, 65536)  # row 14's check and one extraction block
REPS = 100  # warm calls per profiled and per back-to-back time
SEED = 0


def host_ms(torch, fn) -> float:
    """Median milliseconds of one event pair around each of 20 calls of
    ``fn``."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(20):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def events_ms(torch, fn) -> float:
    """Milliseconds per call of REPS calls between one pair of events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def profiled(torch, fn, reps: int) -> dict:
    """Device milliseconds and recorded launches of every kernel and copy
    ``fn`` launches, by name, over ``reps`` warm calls under torch.profiler.
    A trace that holds no device activity at all (seen on the card after many
    profiler sessions in one process) is taken again, up to three times."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = {e.key: {"ms": e.device_time_total / 1e3, "count": e.count}
                   for e in prof.key_averages()
                   if e.device_type.name == "CUDA" and e.device_time_total > 0}
        if kernels:
            return kernels
    return {}


def per_call(kernels: dict, match: str) -> dict:
    """A trace of calls that each launch the one kernel named like ``match``
    once: its ``device_ms`` per launch, and the call's device time and
    launches (every kernel and copy) per recorded launch of it."""
    own = [v for k, v in kernels.items() if match in k]
    if len(own) != 1:
        raise RuntimeError(f"not one kernel named like {match!r}: {sorted(kernels)}")
    calls = own[0]["count"]
    return {"device_ms": own[0]["ms"] / calls,
            "stage_device_ms": sum(v["ms"] for v in kernels.values()) / calls,
            "launches_per_call": sum(v["count"] for v in kernels.values()) / calls,
            "recorded_calls": calls}


def device_times(torch, fn, match: str) -> dict:
    """``device_ms`` of the kernel named like ``match`` that each call of
    ``fn`` launches once, the call's device time and launches, ``ms`` and
    ``events_ms``."""
    return dict(per_call(profiled(torch, fn, REPS), match), ms=host_ms(torch, fn),
                events_ms=events_ms(torch, fn))


def host_block_ms(torch, fn) -> dict:
    """Median host milliseconds of one call of ``fn``, of five, issued behind queued
    device work (``torch.cuda._sleep``), and the device milliseconds that
    work takes alone."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(2_000_000)
    end.record()
    end.synchronize()
    times = []
    for _ in range(5):
        torch.cuda._sleep(2_000_000)
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
    return {"call_ms": statistics.median(times), "queued_ms": start.elapsed_time(end)}


def resample_inputs(torch, n_rays: int, n_t: int, n_u: int, shared: bool, gen):
    """A coarse level's t-values (stratified in per-ray intervals), bins,
    weights (w^4, every 97th ray empty: the eps padding path) as the strided
    ``wgt[..., 1:-1]`` window the callers pass, and quantiles: the eval row
    expanded over the rays, or a sorted random row per ray."""
    from aon_tpu_torch.core.sampling import eval_quantiles
    from aon_tpu_torch.ops.resample import sorted_uniform

    dev = gen.device
    near = 2.0 + torch.rand(n_rays, 1, generator=gen, device=dev)
    far = near + 0.2 + 3.0 * torch.rand(n_rays, 1, generator=gen, device=dev)
    grid = (torch.arange(n_t, device=dev) + torch.rand(n_rays, n_t, generator=gen, device=dev))
    t_vals = (near + (far - near) * grid / n_t).contiguous()
    bins = (0.5 * (t_vals[:, 1:] + t_vals[:, :-1])).contiguous()
    wgt = torch.rand(n_rays, n_t, generator=gen, device=dev) ** 4
    wgt[::97] = 0.0
    if shared:
        u = eval_quantiles(n_u, device=dev).expand(n_rays, n_u)
    else:
        u = sorted_uniform(torch.rand(n_rays, n_u + 1, generator=gen, device=dev))
    return t_vals, bins, wgt[:, 1:-1], u


def measure() -> dict:
    """Rows 2 and 14's times at the main paths' shapes, and the launches of
    one ``sample_pdf_fused`` call, on seeded inputs."""
    import torch

    from aon_tpu_torch.core import prng
    from aon_tpu_torch.core.sampling import pdf_cdf, unit_linspace
    from aon_tpu_torch.ops.fused_mlp import ENCODERS, make_posenc_constants
    from aon_tpu_torch.ops.fused_mlp_train import posenc_in_kernel
    from aon_tpu_torch.ops.resample import fused_resample, resample_union, sample_pdf_fused

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = {"resample_union": [], "fused_resample": [], "sample_pdf_fused": [], "posenc": [],
           "unit_linspace_behind_queue": host_block_ms(torch, lambda: unit_linspace(17, dev))}
    for n_rays, n_t, n_u, shared in RESAMPLE_SHAPES:
        t_vals, bins, wgt, u = resample_inputs(torch, n_rays, n_t, n_u, shared, gen)
        cdf = pdf_cdf(wgt).contiguous()
        shape = {"shape": f"{n_rays}x{n_t}+{n_u}",
                 "quantiles": "one shared row" if shared else "a sorted random row per ray"}
        out["resample_union"].append(dict(shape, **device_times(
            torch, lambda: resample_union(t_vals, bins, cdf, u), "resample")))
        out["fused_resample"].append(dict(shape, **device_times(
            torch, lambda: fused_resample(t_vals, bins, wgt, u), "resample")))
        if n_t == 65:  # the stage as the render chunk and a training microbatch call it
            o = torch.randn(n_rays, 3, generator=gen, device=dev)
            d = torch.randn(n_rays, 3, generator=gen, device=dev)
            ids = torch.arange(n_rays, device=dev)
            kw = ({} if shared else
                  {"randomized": True, "key": prng.key(SEED + 1), "ray_ids": ids})
            kernels = profiled(torch, lambda: sample_pdf_fused(bins, wgt, o, d, t_vals, n_u, **kw),
                               reps=10)
            calls = per_call(kernels, "resample")
            out["sample_pdf_fused"].append(dict(
                shape, launches_per_call=calls["launches_per_call"],
                device_ms=calls["stage_device_ms"],
                kernels={k[:80]: v["count"] / calls["recorded_calls"]
                         for k, v in kernels.items()}))
        del t_vals, bins, wgt, u, cdf
    consts = make_posenc_constants(device=dev)
    for n in POSENC_ROWS:
        x = (torch.rand(n, 3, generator=gen, device=dev) * 12 - 6).contiguous()
        for encoder in ENCODERS:
            out["posenc"].append(dict({"shape": f"{n}x64", "encoder": encoder}, **device_times(
                torch, lambda: posenc_in_kernel(x, consts["s_pos"], consts["p_pos"], encoder),
                "posenc")))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None, help="import aon_tpu_torch from this checkout")
    args = ap.parse_args(argv)
    if args.root:
        sys.path.insert(0, args.root)
    import torch

    if not torch.cuda.is_available():
        print(json.dumps({"error": "needs a CUDA device"}))
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    rec = measure()
    import aon_tpu_torch

    rec.update(root=str(aon_tpu_torch.__file__).rsplit("/aon_tpu_torch/", 1)[0], card=smi)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
