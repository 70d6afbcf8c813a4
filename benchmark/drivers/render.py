"""Frames rendered one after another through ``Trainer._render_full`` ->
``eval/render.py::render_frame`` -> ``system.render_chunk``, each ending in
host arrays, with the benchmark's seeded weights.

A mix's ``frames`` says what is cycled:

* ``"val_test"``: the one-scene dataset's val and test views, in an order
  drawn from the seed;
* ``"sweep"``: the 2N - 1 interpolated articulation codes (``is_test``)
  under one train camera of the 0-degree split, instance and image drawn
  from the seed, as ``scripts/render_sweep.py`` renders them.

Set-up prepares the frames' rays and renders ``warmup_frames`` frames.  The
window renders until ``--seconds`` have passed (and at least the frames it
checks).  Frames at positions drawn
from the seed among the window's first ``check_frames_within`` keep their
outputs; after the window the plain reference renders a seeded sample of
their rays and the checks compare comp_rgb, depth and acc.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

import program
from common import Spans, Tracer, log, make_weights
from reference import nerf as R
from reference.data import Scene, multi_frame


class RenderCell:
    def __init__(self, cell: dict, device, overrides: Optional[dict] = None):
        self.cell, self.device = cell, torch.device(device)
        self.cfg_file, self.traffic = cell["config"], cell["traffic"]
        over = dict(overrides or {}, run_eval=True)
        self.cfg = program.config(self.cfg_file, cell["data_dir"], cell["out_dir"], cell["seed"],
                                  over)
        self.tr = program.trainer(self.cfg, self.device)
        self.model = self.cfg_file["model"]
        self.layout = R.layout(self.model, n_objs=self.cfg.N_max_objs,
                               code=self.cfg.N_obj_code_length)
        self.spans = Spans()
        self.start = int(self.traffic["warmup_frames"])

    def reseed(self, seed: int) -> None:
        """The seed's weights, frames and checked frames and pixels."""
        self.seed = int(seed)
        self.g = np.random.default_rng(seed)
        self.frames = self._frames()
        program.hand_weights(self.tr, make_weights(self.layout, seed, self.device))
        t = self.traffic
        self.n_rays = int(self.frames[0][0]["rays_o"].shape[0])
        n_pix = min(int(t["check_pixels"]), self.n_rays)
        at = self.g.choice(int(t["check_frames_within"]), size=int(t["check_frames"]),
                           replace=False)
        self.plan = {int(a): np.sort(self.g.choice(self.n_rays, size=n_pix, replace=False))
                     for a in at}

    def keep(self, i: int, ret: dict):
        """(reference spec, pixels) and the program's outputs there, for the
        window's frame ``i`` where the plan checks it."""
        pix = self.plan[i]
        return ((self.frames[(self.start + i) % len(self.frames)][1], pix),
                {k: np.asarray(ret[k])[pix] for k in ("comp_rgb", "acc", "depth")})

    def _frames(self) -> List[dict]:
        """The frames to cycle: (frame dict, the reference's spec of it)."""
        kind, c = self.traffic["frames"], self.cfg
        keep = ("rays_o", "rays_d", "viewdirs")
        if kind == "val_test":
            from aon_tpu_torch.data import dataset_dict

            val = dataset_dict[c.dataset_name](
                root_dir=c.root_dir, split="val", img_wh=tuple(c.img_wh), white_back=c.white_back,
                eval_inference="render")
            out = []
            for split, ds in (("val", val), ("test", self.tr.test_dataset)):
                for i in range(len(ds.img_files)):
                    f = ds.full_frame(i)
                    out.append(({k: f[k] for k in keep}, (split, i)))
            order = self.g.permutation(len(out))
            return [out[i] for i in order]
        if kind == "sweep":
            ds = self.tr.test_dataset
            inst = int(self.g.integers(0, len(ds.ids)))
            image_id = int(self.g.integers(0, 59))
            rays_o, viewdirs, rays_d, img, seg, aabb = ds._read_frame(
                ds.ids[inst], "0_degree", image_id)
            frame = ds._to_sample(rays_o, viewdirs, rays_d, img, seg, aabb=aabb)
            frame = {k: frame[k] for k in keep}
            n_ids = 2 * len(ds._degree_dirs(ds.ids[inst])) - 1
            return [(dict(frame, instance_id=np.int32(inst), articulation_id=np.int32(a)),
                     ("sweep", inst, image_id, a)) for a in range(n_ids)]
        raise ValueError(f"unknown frames {kind!r}")

    def render(self, i: int) -> Dict[str, np.ndarray]:
        frame, _ = self.frames[i % len(self.frames)]
        with self.spans.span("render_frame"):
            return self.tr._render_full(self.tr.state.params, frame,
                                        is_test=self.traffic["frames"] == "sweep")

    # --------------------------------------------------------- reference

    def ref_rays(self, spec, pix: np.ndarray):
        """(rays_o, rays_d, codes args) of a frame's pixels from the raw files."""
        c = self.cfg
        if spec[0] in ("val", "test"):
            sc = Scene(f"{c.root_dir}/{spec[0]}", c.img_wh, sort_numeric=True)
            o, d = sc.frame_rays(spec[1], pix)
            return o, d, None
        _, inst, image_id, art = spec
        import os

        ids = sorted(e.name for e in os.scandir(c.root_dir) if e.is_dir())
        sc, f, _ = multi_frame(c.root_dir, c.img_wh, ids[inst], "0_degree", image_id,
                               c.white_back)
        o, d = sc.frame_rays(f, pix)
        return o, d, (inst, art)

    def reference(self, kept: List[tuple], precision: str = "float32", device=None) -> List[dict]:
        """The reference's comp_rgb, depth and acc at each kept frame's
        sampled pixels."""
        device = torch.device(device or self.device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        c = self.cfg
        ref = R.Ref(self.model, c.white_back, num_coarse=c.N_samples, num_fine=c.N_importance,
                    precision=precision)
        params = make_weights(self.layout, self.seed, device)
        block = int(self.traffic["reference_block"])
        out = []
        for spec, pix in kept:
            o, d, code = self.ref_rays(spec, pix)
            codes = None if code is None else ref.codes(params, code[0], code[1], is_test=True)
            parts = []
            with torch.no_grad():
                for s in range(0, len(pix), block):
                    _, (rgb, acc, depth) = ref.render_rays(
                        params, torch.as_tensor(o[s:s + block], device=device),
                        torch.as_tensor(d[s:s + block], device=device), codes)
                    parts.append((rgb.cpu().numpy(), acc.cpu().numpy(), depth.cpu().numpy()))
            out.append({"comp_rgb": np.concatenate([p[0] for p in parts]),
                        "acc": np.concatenate([p[1] for p in parts]),
                        "depth": np.concatenate([p[2] for p in parts])})
        return out


def gaps(got: List[dict], want: List[dict], far_near: float = 4.0) -> dict:
    """Mean absolute gaps over the sampled pixels of the kept frames: rgb
    (over channels), acc, and depth as a share of the far - near span."""
    cat = lambda xs, k: np.concatenate([np.asarray(x[k], np.float64).reshape(len(x[k]), -1)
                                        for x in xs])
    gap = {k: float(np.abs(cat(got, k) - cat(want, k)).mean()) for k in ("comp_rgb", "acc", "depth")}
    return {"rgb_mae": gap["comp_rgb"], "acc_mae": gap["acc"], "depth_mae": gap["depth"] / far_near}


RATIOS = {"rgb_ratio": "rgb_mae", "acc_ratio": "acc_mae", "depth_ratio": "depth_mae"}


def readings(got: List[dict], want: List[dict], yard: List[dict]) -> dict:
    """``gaps`` of ``got``, and the steady ones over the same gaps of the
    bf16 yardstick ``yard`` of the same seed (whose field sets how far any
    rounding moves a render)."""
    out, base = gaps(got, want), gaps(yard, want)
    out.update({r: out[g] / max(base[g], 1e-30) for r, g in RATIOS.items()})
    return out


def run(cell: dict, device, overrides: Optional[dict] = None, hooks=None) -> dict:
    """One run of a render cell; ``hooks`` (tests only) may break the
    program under the run before its first frame."""
    rc = RenderCell(cell, device, overrides)
    log(f"set-up: trainer {time.perf_counter() - cell['t_start']:.2f} s")
    if hooks:
        hooks(rc)
    rc.reseed(cell["seed"])
    log(f"set-up: frames and weights {time.perf_counter() - cell['t_start']:.2f} s")
    for i in range(rc.start):
        rc.render(i)
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - cell["t_start"]
    log(f"set-up: warm {setup_s:.2f} s")

    t = cell["traffic"]
    rc.spans.times.clear()
    prof = Tracer(cell["trace"], rc.spans, device, float(t["trace_seconds"]))
    times, kept, got, i = [], [], [], 0
    t0 = time.perf_counter()
    while True:
        tf = time.perf_counter()
        ret = rc.render(rc.start + i)
        times.append(time.perf_counter() - tf)
        if i in rc.plan:
            spec, out = rc.keep(i, ret)
            kept.append(spec)
            got.append(out)
        i += 1
        now = time.perf_counter() - t0
        prof.tick(now, i)
        if now >= cell["seconds"] and i > max(rc.plan):
            break
    prof.tick(float("inf"), i)
    window_s = time.perf_counter() - t0
    mem = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    spans = {k: list(v) for k, v in rc.spans.times.items()}
    f = np.array(times) * 1e3
    log(f"window: {i} frames in {window_s:.3f} s; frame ms p10 {np.percentile(f, 10):.2f} "
        f"p50 {np.percentile(f, 50):.2f} p90 {np.percentile(f, 90):.2f} max {f.max():.2f}")
    program.free(rc.tr)

    t_ref = time.perf_counter()
    want = rc.reference(kept)
    yard = rc.reference(kept, precision="bfloat16")
    log(f"reference {time.perf_counter() - t_ref:.2f} s")
    finite = all(np.isfinite(x[k]).all() for x in got for k in x)
    trace = prof.reduce(cell["out_dir"])
    return {"setup_s": setup_s, "window_s": window_s, "frames": i, "frame_times": times,
            "frame_rays": rc.n_rays, "finite": finite, "readings": readings(got, want, yard),
            "n_checked": len(got), "memory_peak_bytes": mem, "spans": spans, "trace": trace,
            "traced": trace["count"] if trace else 0,
            "untraced": {"count": i - trace["count"], "seconds": t0 + window_s - trace["t_end"]}
            if trace else None}


def calibrate(cell: dict, device, seeds, overrides: Optional[dict] = None):
    """Per seed, the readings of the program's checked frames (rendered as
    the window renders them, without the frames between) and of the control
    (the reference in fp8), each against the float32 reference and over the
    bf16 yardstick's gaps."""
    rc = RenderCell(cell, device, overrides)
    for seed in seeds:
        rc.reseed(seed)
        for i in range(rc.start):
            rc.render(i)
        kept, got = [], []
        for i in sorted(rc.plan):
            spec, out = rc.keep(i, rc.render(rc.start + i))
            kept.append(spec)
            got.append(out)
        want = rc.reference(kept)
        yard = rc.reference(kept, precision="bfloat16")
        yield {"seed": seed, "program": readings(got, want, yard), "yardstick": gaps(yard, want),
               "control": readings(rc.reference(kept, precision="fp8"), want, yard)}
