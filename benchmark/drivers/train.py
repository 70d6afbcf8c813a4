"""Closed-loop training, as ``Trainer.fit`` runs it without validation:
dispatch after dispatch of ``steps_per_dispatch`` steps through
``Trainer._dispatch`` on the configuration's own loader.

Set-up builds one ``Trainer``, hands it the seed's weights and drives it
through ``Trainer._dispatch`` on the loader's first batches: a dispatch of
one step, then one of the window's own ``steps_per_dispatch`` steps.  The
checks read only the trainer's public state and metrics: the loss of the
first step, the optimizer's first moment after it (over ``1 - b1``: the
first gradient as Adam received it), the mean and the last loss of the
second dispatch, and the parameters it hands on.  Then the traffic's
warm-up dispatches run, and the window runs until ``--seconds`` have
passed, ended by a sync.

After the window the plain reference follows the same ``1 +
steps_per_dispatch`` steps from the same weights, on batches and draws it
works out again from the raw files and the seed, and ``readings``
compares.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

import program
from common import SpanIter, Spans, Tracer, log, make_weights
from reference import nerf as R
from reference import threefry as TF
from reference.data import multi_batches, single_batches

B1 = 0.9  # Adam's first-moment decay, the reference's (``R.adam_step``)
# The colour heads' biases (both levels): their gradient sums the loss's
# gradient over every sample through no rounded product, so it sees which
# rays went in and moves least under bf16.
HEAD = ".rgb.bias"


def _sorted(u: np.ndarray) -> np.ndarray:
    """(..., n + 1) uniforms -> (..., n) ascending order statistics, by the
    cumulative sum of their exponentials (as the program's resampling)."""
    s = np.cumsum(-np.log1p(-u.astype(np.float64)), -1)
    return (s[..., :-1] / s[..., -1:]).astype(np.float32)


class TrainCell:
    def __init__(self, cell: dict, device, overrides: Optional[dict] = None):
        self.cell, self.device = cell, torch.device(device)
        self.cfg_file, self.traffic = cell["config"], cell["traffic"]
        self.cfg = program.config(self.cfg_file, cell["data_dir"], cell["out_dir"], cell["seed"],
                                  overrides)
        self.tr = program.trainer(self.cfg, self.device)
        self.multi = self.cfg.dataset_name == "sapien_multi"
        self.model = self.cfg_file["model"]
        self.layout = R.layout(self.model, n_objs=self.cfg.N_max_objs,
                               code=self.cfg.N_obj_code_length)
        self.spd = int(self.traffic["steps_per_dispatch"])
        self.rays = self.cfg.ray_batch_size if self.multi else self.cfg.batch_size
        self.spans = Spans()
        if self.multi:
            self._warm_frames()

    def _warm_frames(self) -> None:
        """Decode every train frame into the loader's frame cache, as the
        first epochs of a run do: the window then sees the cached loader of
        a run's steady state."""
        ds = self.tr.train_dataset
        need = ("_degree_dirs", "_read_frame_cached", "_train_derived")
        if not all(hasattr(ds, n) for n in need):
            log("set-up: the loader decodes its frames on demand (no frame cache to fill)")
            return
        for inst in ds.ids:
            for deg in ds._degree_dirs(inst):
                n = len(os.listdir(os.path.join(ds.root_dir, inst, "train", deg, "rgb")))
                for image_id in range(n):
                    key, frame = ds._read_frame_cached(inst, deg, image_id)
                    ds._train_derived(key, frame[3], frame[4], frame[5])

    def reseed(self, seed: int) -> None:
        program.reseed(self.tr, seed)
        program.hand_weights(self.tr, make_weights(self.layout, seed, self.device))
        self.it = SpanIter(self.tr._train_iterator(), self.spans)

    def dispatch(self, n: int = 0) -> dict:
        n = n or self.spd
        state, metrics = self.tr._dispatch(self.it, n)
        self.tr.state = state
        self.tr.global_step += n
        return metrics

    def plan(self) -> List[tuple]:
        """The checked dispatches as (first step, steps): one step, then one
        of the window's own size."""
        return [(0, 1), (1, self.spd)]

    def prefix(self) -> dict:
        """The checked dispatches, read from the trainer's public state: the
        first step's loss and first gradient (Adam's first moment after it,
        over ``1 - b1``), the second dispatch's mean and last loss, and the
        parameters' change over both."""
        init = {k: v.detach().clone() for k, v in self.tr.state.params.items()}
        first = self.dispatch(1)
        grad1 = {k: (v.detach() / (1 - B1)).clone() for k, v in self.tr.state.mu.items()}
        loss1 = float(first["train/loss"])
        rest = self.dispatch(self.spd)
        return {"loss": [loss1, float(rest["train/loss"]), float(rest["train/loss_last"])],
                "grad1": {k: v.cpu() for k, v in grad1.items()},
                "change": {k: (self.tr.state.params[k].detach() - init[k]).cpu() for k in init}}

    # --------------------------------------------------------- reference

    def batches(self, seed: int, n: int) -> List[dict]:
        c = self.cfg
        if self.multi:
            return multi_batches(c.root_dir, c.img_wh, self.rays, seed, n, c.white_back)
        return single_batches(c.root_dir, c.img_wh, self.rays, seed, n)

    def draws(self, seed: int, step: int, fused: bool):
        """The step's (t_rand, u) as the program's route draws them: a
        dispatch of several steps gives step t of it the key ``fold_in(key,
        t)`` and every ray its own stream (``ray_ids``); a dispatch of one
        step takes its key whole and draws blocks, one a microbatch, each
        from its own split of the key where there are several."""
        start, n = next((a, b) for a, b in self.plan() if a <= step < a + b)
        key = TF.fold_in(TF.split(TF.key(seed))[0], start)
        per_ray = n > 1
        if per_ray:
            key = TF.fold_in(key, step - start)
        c = self.cfg
        if fused and per_ray:  # per ray, u as sorted order statistics
            k0, k2 = TF.split(key)
            ids = np.arange(self.rays)
            return (TF.per_ray_uniform(k0, ids, c.N_samples + 1),
                    _sorted(TF.per_ray_uniform(k2, ids, c.N_importance + 1)))
        m = min(c.microbatch_rays or self.rays, self.rays)
        k = self.rays // m
        keys = [key] * k if per_ray or k == 1 else TF.split(key, k)
        parts = []
        for mk in keys:
            if fused:
                k0, k2 = TF.split(mk)
                parts.append((TF.uniform(k0, (m, c.N_samples + 1)),
                              _sorted(TF.uniform(k2, (m, c.N_importance + 1)))))
            else:  # the plain modules: one block draw a microbatch
                sub = TF.split(mk, 4)
                parts.append((TF.uniform(sub[0], (m, c.N_samples + 1)),
                              TF.uniform(sub[2], (m, c.N_importance))))
        return (np.concatenate([t for t, _ in parts]), np.concatenate([u for _, u in parts]))

    def reference(self, seed: int, fused: bool, precision: str = "float32",
                  fault: Optional[str] = None, device=None) -> dict:
        """The reference's checked steps from the seed's weights: the
        losses, the first gradient and the change as ``prefix`` reads them."""
        device = torch.device(device or self.device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        c = self.cfg
        ref = R.Ref(self.model, c.white_back, num_coarse=c.N_samples, num_fine=c.N_importance,
                    precision=precision)
        params = make_weights(self.layout, seed, device)
        mu = {k: torch.zeros_like(v) for k, v in params.items()}
        nu = {k: torch.zeros_like(v) for k, v in params.items()}
        init = {k: v.clone() for k, v in params.items()}
        losses, grad1 = [], None
        for step, b in enumerate(self.batches(seed, sum(n for _, n in self.plan()))):
            t_rand, u = self.draws(seed, step, fused)
            batch = {k: (torch.as_tensor(v, device=device) if isinstance(v, np.ndarray) else v)
                     for k, v in b.items()}
            t_rand, u = torch.as_tensor(t_rand, device=device), torch.as_tensor(u, device=device)
            if fault == "half_batch":
                half = self.rays // 2
                batch = {k: (v[:half] if torch.is_tensor(v) else v) for k, v in batch.items()}
                t_rand, u = t_rand[:half], u[:half]
            loss, grads = ref.loss_and_grads(params, batch, t_rand, u)
            lr = R.nerf_lr(step, c.lr_init, c.lr_final, c.lr_delay_steps, c.lr_delay_mult,
                           c.lr_max_steps or c.run_max_steps)
            params, mu, nu = R.adam_step(params, grads, mu, nu, step, lr)
            losses.append(loss)
            if grad1 is None:
                grad1 = {k: g.detach().cpu() for k, g in grads.items()}
        return {"loss": [losses[0], float(np.mean(losses[1:])), losses[-1]], "grad1": grad1,
                "change": {k: (params[k] - init[k]).detach().cpu() for k in init}}


def _leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], keep,
               diff: bool = False) -> List[float]:
    """Each leaf's gap of norms (or, with ``diff``, the norm of the
    difference), over the reference's norm of that leaf or of the median
    leaf, whichever is larger."""
    rn = {k: float(torch.linalg.norm(ref[k].double())) for k in keep}
    med = float(np.median(list(rn.values())))
    if diff:
        num = {k: float(torch.linalg.norm(prog[k].double() - ref[k].double())) for k in keep}
    else:
        num = {k: abs(float(torch.linalg.norm(prog[k].double())) - rn[k]) for k in keep}
    return [num[k] / max(rn[k], med, 1e-30) for k in keep]


def _group_diff(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], keys) -> float:
    """The norm of the difference over the leaves ``keys`` together, over the
    reference's norm of them (NaN where there are none)."""
    if not keys:
        return float("nan")
    num = sum(float(torch.linalg.norm(prog[k].double() - ref[k].double())) ** 2 for k in keys)
    den = sum(float(torch.linalg.norm(ref[k].double())) ** 2 for k in keys)
    return (num / max(den, 1e-60)) ** 0.5


def gaps(got: dict, want: dict) -> dict:
    """``got`` (the program, a control or the yardstick) against the float32
    reference's ``want``: the worst of the checked losses' relative gaps;
    the worst and the median leaf's gap of first-gradient norms and of the
    first gradient's difference; the colour heads' biases' first-gradient
    difference (which sees which rays went in); the worst and the median
    leaf's gap of the change's norms, leaves whose reference gradient is
    under a thousandth of the median leaf's left out."""
    loss = max(abs(a - b) / abs(b) if np.isfinite(a) else float("inf")
               for a, b in zip(got["loss"], want["loss"]))
    gnorm = {k: float(torch.linalg.norm(v.double())) for k, v in want["grad1"].items()}
    med = float(np.median(list(gnorm.values())))
    moved = [k for k, n in gnorm.items() if n >= 1e-3 * med]
    names = list(gnorm)
    grad = _leaf_gaps(got["grad1"], want["grad1"], names)
    diff = _leaf_gaps(got["grad1"], want["grad1"], names, diff=True)
    change = _leaf_gaps(got["change"], want["change"], moved)
    return {"loss_gap": loss, "grad_gap": max(grad), "grad_gap_median": float(np.median(grad)),
            "grad_diff": max(diff), "grad_diff_median": float(np.median(diff)),
            "head_diff": _group_diff(got["grad1"], want["grad1"],
                                     [k for k in names if k.endswith(HEAD)]),
            "change_gap": max(change), "change_gap_median": float(np.median(change)),
            "worst_leaf": {"grad": names[int(np.argmax(grad))],
                           "grad_diff": names[int(np.argmax(diff))],
                           "change": moved[int(np.argmax(change))]}}


RATIOS = {"loss_ratio": "loss_gap", "grad_ratio": "grad_gap_median",
          "grad_diff_ratio": "grad_diff_median", "head_grad_ratio": "head_diff",
          "change_ratio": "change_gap_median",
          "grad_ratio_worst": "grad_gap", "change_ratio_worst": "change_gap"}


def readings(got: dict, want: dict, yard: dict) -> dict:
    """``gaps`` of ``got``, and the steady ones over the same gaps of the
    bf16 yardstick ``yard`` of the same seed (whose field sets how far any
    rounding moves the loss and the gradients)."""
    out, base = gaps(got, want), gaps(yard, want)
    out.update({r: out[g] / max(base[g], 1e-30) for r, g in RATIOS.items()})
    return out


def calibrate(cell: dict, device, seeds, overrides: Optional[dict] = None):
    """Per seed, the readings of the program, of the control (the reference
    in fp8) and of the half-batch fault (the reference on the first half of
    each batch), each against the float32 reference and over the bf16
    yardstick's gaps, and the yardstick's own gaps; no window."""
    tc = TrainCell(cell, device, overrides)
    for seed in seeds:
        tc.reseed(seed)
        got = tc.prefix()
        fused = program.fused_route(tc.tr)
        want = tc.reference(seed, fused)
        yard = tc.reference(seed, fused, precision="bfloat16")
        yield {"seed": seed, "program": readings(got, want, yard),
               "yardstick": gaps(yard, want),
               "control": readings(tc.reference(seed, fused, precision="fp8"), want, yard),
               "half_batch": readings(tc.reference(seed, fused, fault="half_batch"), want,
                                      yard)}


def run(cell: dict, device, overrides: Optional[dict] = None, hooks=None) -> dict:
    """One run of a training cell; ``hooks`` (tests only) may break the
    program under the run before its first step."""
    tc = TrainCell(cell, device, overrides)
    log(f"set-up: trainer {time.perf_counter() - cell['t_start']:.2f} s")
    if hooks:
        hooks(tc)
    seed = cell["seed"]
    tc.reseed(seed)
    got = tc.prefix()
    log(f"set-up: checked steps {time.perf_counter() - cell['t_start']:.2f} s")
    for _ in range(int(cell["traffic"]["warmup_dispatches"])):
        tc.dispatch()
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - cell["t_start"]
    log(f"set-up: warm {setup_s:.2f} s")

    t = cell["traffic"]
    tc.spans.times.clear()
    prof = Tracer(cell["trace"], tc.spans, device, float(t["trace_seconds"]))
    steps, metrics = 0, None
    t0 = time.perf_counter()
    while True:
        with tc.spans.span("dispatch"):
            metrics = tc.dispatch()
        steps += tc.spd
        now = time.perf_counter() - t0
        prof.tick(now, steps)
        if now >= cell["seconds"]:
            break
    prof.tick(float("inf"), steps)
    loss_last = float(metrics["train/loss"])  # the host read waits for the device
    if device.type == "cuda":
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    mem = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    spans = {k: list(v) for k, v in tc.spans.times.items()}
    d = np.array(spans.get("dispatch", [0.0])) * 1e3
    half = max(1, len(d) // 2)
    log(f"window: {steps} steps in {window_s:.3f} s; dispatch ms p10 {np.percentile(d, 10):.2f} "
        f"p50 {np.percentile(d, 50):.2f} p90 {np.percentile(d, 90):.2f} max {d.max():.2f}; "
        f"mean of the first / second half {d[:half].mean():.2f} / {d[half:].mean() if len(d) > 1 else 0:.2f}")
    fused = program.fused_route(tc.tr)
    program.free(tc.tr)

    t_ref = time.perf_counter()
    want = tc.reference(seed, fused)
    yard = tc.reference(seed, fused, precision="bfloat16")
    log(f"reference {time.perf_counter() - t_ref:.2f} s")
    trace = prof.reduce(cell["out_dir"])
    return {"setup_s": setup_s, "window_s": window_s, "steps": steps, "rays": tc.rays,
            "finite": bool(np.isfinite(loss_last)), "readings": readings(got, want, yard),
            "memory_peak_bytes": mem, "spans": spans, "trace": trace,
            "traced": trace["count"] if trace else 0,
            "untraced": {"count": steps - trace["count"], "seconds": t0 + window_s - trace["t_end"]}
            if trace else None}
