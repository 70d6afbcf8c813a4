"""Extract explicit geometry (density grid, point cloud, surface mesh) from a
trained checkpoint (port of ``scripts/extract_geometry.py``).

Queries the fine-level density field on a regular grid over the scene bounds
and writes, under ``ckpts/{exp_name}/{out}/`` of the working directory,

* ``density_grid.npz`` -- raw float sigma grid + bounds (for downstream tools),
* ``points.ply``       -- occupied-voxel point cloud, colored by the radiance
                          field at a fixed viewdir,
* ``mesh.obj``         -- closed boundary-face surface mesh (the occupied /
                          empty interface; no marching-cubes dependency).

Vanilla queries the fine MLP through ``ops.fused_nerf_mlp_xyz`` (kernel
table row 8), the auto-decoder the fine articulated MLP through
``ops.fused_art_mlp_eval`` (row 10) at any instance / articulation id,
including the odd interpolated ids of the 2N-1 midpoint table, and the
auto-encoder the same MLP under the encoding of train frame ``--image_id`` of
instance ``--instance`` at articulation ``--articulation`` (its degree
directory, whose angle also picks the degree table's row).  On the card
both launch their CUDA kernels; with ``device="cpu"`` the same code runs the
kernels' plain twins.

The system is built from the config and the state restored from
``{output_path}/{exp_name}/{--ckpt}`` (``train.checkpoint``).  The bounds are
``--bounds`` where given, else the dataset's AABB, as the JAX script takes
them: the padded box of the train split's depth maps at the config's
``img_wh`` (``data/aabb.py::scene_aabb``, pad ``aabb_pad`` where the config
tightens intervals, else 0.05; every ``{instance}/train/{degree}`` directory
of an articulated dataset).

Occupancy threshold: ``--threshold auto`` marks a voxel occupied when a ray
crossing a 4-voxel span of it would reach alpha > 0.5, i.e.
``sigma > ln(2) / (4 * voxel_size)``.

Usage:
  python -m aon_tpu_torch.scripts.extract_geometry --config configs/quality_laptop_autodec.json \\
      [--bounds -1.5 -1.5 -1.5 1.5 1.5 1.5] [--ckpt last.ckpt] [--resolution 160] \\
      [--instance 0] [--articulation 4] [--interpolated] [--threshold auto] [--out geometry]
"""

from __future__ import annotations

import argparse
import os
import time
import types
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from aon_tpu_torch.core import prng
from aon_tpu_torch.data.aabb import scene_aabb
from aon_tpu_torch.data.sapien_multi import SapienDatasetMulti
from aon_tpu_torch.ops.fused_art import (
    POS_DIM,
    VIEW_DIM,
    art_mlp_fwd_plain,
    fold_latents,
    fused_art_mlp_eval,
)
from aon_tpu_torch.ops.fused_mlp import (
    POS_PAD,
    VIEW_PAD,
    fused_nerf_mlp_xyz,
    fused_nerf_mlp_xyz_plain,
    launch_blobs,
    make_posenc_constants,
    pack_vanilla_mlp_params,
)
from aon_tpu_torch.ops.render_fused import mlp_params
from aon_tpu_torch.train.checkpoint import CheckpointManager
from aon_tpu_torch.train.systems import build_system
from aon_tpu_torch.utils.config import get_config
from aon_tpu_torch.utils.device import DeviceLike, resolve_device

# points per (B, S, 3) block the MLPs are queried with
POINTS_PER_RAY = 128
# near / far of the SAPIEN datasets; the density query reads neither
NEAR, FAR = 2.0, 6.0


def encoding_constants(cfg, device) -> dict:
    """The kernels' posenc constants at the config's encoding degrees
    (``N_emb_xyz``, ``N_emb_dir``), as the render and step paths build them
    (``ops/render_fused.py``).  The vanilla kernels take any degrees whose
    encodings fit their padded input widths (``POS_PAD``, ``VIEW_PAD``); the
    articulated kernels' weights are laid out for (10, 4) alone.  Other
    degrees raise ``ValueError``."""
    deg_xyz, deg_dir = cfg.N_emb_xyz, cfg.N_emb_dir
    width_xyz, width_dir = 3 * (2 * deg_xyz + 1), 3 * (2 * deg_dir + 1)
    if cfg.exp_type == "vanilla":
        fits = width_xyz <= POS_PAD and width_dir <= VIEW_PAD
        takes = f"at most {POS_PAD} / {VIEW_PAD}"
    else:
        fits = (width_xyz, width_dir) == (POS_DIM, VIEW_DIM)
        takes = f"{POS_DIM} / {VIEW_DIM}"
    if not fits:
        raise ValueError(f"N_emb_xyz={deg_xyz} / N_emb_dir={deg_dir} encode {width_xyz} / "
                         f"{width_dir} channels; the {cfg.exp_type} kernels take {takes}")
    return make_posenc_constants(deg_xyz, deg_dir, device=device)


def density_color_fn(trainer, args, plain: bool = False):
    """A (points (N, 3)) -> (sigma (N,), rgb (N, 3)) closure on the trained
    system's device (fine level only: it is the one supervised at the final
    sample density).  ``trainer`` holds ``cfg``, ``state.params`` and
    ``system``.  With ``plain`` the kernels' plain twins run in place of the
    kernels: the reference a run on the card is held against."""
    cfg = trainer.cfg
    params = trainer.state.params
    system = trainer.system
    device = system.device
    viewdir = np.array(args.viewdir, dtype=np.float32)
    viewdir /= max(np.linalg.norm(viewdir), 1e-8)
    viewdir = torch.from_numpy(viewdir).to(device)
    enc_consts = encoding_constants(cfg, device)

    def blocks(pts):
        n = pts.shape[0]
        pos = pts.reshape(n // POINTS_PER_RAY, POINTS_PER_RAY, 3)
        return n, pos, viewdir.expand(n // POINTS_PER_RAY, 3).contiguous()

    if cfg.exp_type == "vanilla":
        # packed once: every block reads the same blobs
        packed = pack_vanilla_mlp_params(mlp_params(params, "fine_mlp"))
        blobs = None if plain or device.type != "cuda" else launch_blobs(packed)

        @torch.no_grad()
        def query(pts):
            n, pos, vdir = blocks(pts)
            if plain:
                raw_rgb, raw_sigma = fused_nerf_mlp_xyz_plain(packed, enc_consts, pos, vdir)
            else:
                raw_rgb, raw_sigma = fused_nerf_mlp_xyz(packed, enc_consts, pos, vdir, blobs=blobs)
            return torch.relu(raw_sigma.reshape(n)), torch.sigmoid(raw_rgb.reshape(n, 3))

        return query

    model = system.model
    mlp = mlp_params(params, "model.fine_mlp")
    if cfg.exp_type == "vanilla_autodecoder":
        with torch.no_grad():
            latents = torch.func.functional_call(
                system.code_library, mlp_params(params, "code_library"),
                (args.instance, args.articulation), dict(is_test=args.interpolated))
    elif cfg.exp_type == "vanilla_ae_art":
        with torch.no_grad():
            latents, _ = system._encode(params, *ae_source(cfg, args))
    else:
        raise SystemExit(f"unsupported exp_type {cfg.exp_type!r}")
    packed = fold_latents(mlp, latents) if plain else None

    @torch.no_grad()
    def query(pts):
        n, pos, vdir = blocks(pts)
        if plain:
            raw_rgb, raw_sigma = art_mlp_fwd_plain(packed, enc_consts, pos, vdir)
        else:
            raw_rgb, raw_sigma = fused_art_mlp_eval(mlp, latents, pos, vdir, enc_consts)
        sigma, rgb = _art_activations(raw_sigma, raw_rgb, model.sigma_activation,
                                      model.density_bias, model.rgb_padding)
        return sigma.reshape(n), rgb.reshape(n, 3)

    return query


def ae_source(cfg, args):
    """``(src_imgs (1, 3, H, W), deg)``: the auto-encoder's input for train
    frame ``args.image_id`` of instance ``args.instance`` at articulation
    ``args.articulation`` (each wrapped to what the dataset holds); train
    degrees are the directory names, reference sapien_multi.py:11-14."""
    ds = SapienDatasetMulti(cfg.root_dir, "test_val", tuple(cfg.img_wh),
                            white_back=cfg.white_back, need_src_imgs=False)
    instance_dir = ds.ids[args.instance % len(ds.ids)]
    deg_dirs = ds._degree_dirs(instance_dir)
    deg_dir = deg_dirs[args.articulation % len(deg_dirs)]
    img = ds._read_frame(instance_dir, deg_dir, args.image_id)[3]
    src = ((np.asarray(img, np.float32) / 255.0 - 0.5) / 0.5).transpose(2, 0, 1)
    return src[None], np.float32(np.deg2rad(float(deg_dir.split("_")[0])))


def _art_activations(raw_sigma, raw_rgb, sigma_act, density_bias, rgb_padding):
    if sigma_act == "softplus_bias":
        sigma = F.softplus(raw_sigma + density_bias)
    else:
        sigma = torch.relu(raw_sigma)
    rgb = torch.sigmoid(raw_rgb)
    if rgb_padding > 0:
        rgb = torch.clip(rgb * (1 + 2 * rgb_padding) - rgb_padding, 0.0, 1.0)
    return sigma, rgb


def write_ply(path, pts, colors):
    with open(path, "w") as fh:
        fh.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(pts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n"
        )
        c = (np.clip(colors, 0, 1) * 255).astype(np.uint8)
        for p, q in zip(pts, c):
            fh.write(f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f} {q[0]} {q[1]} {q[2]}\n")


def boundary_mesh(occ, lo, voxel):
    """Boundary-face surface mesh of a bool grid: one quad per occupied-voxel
    face whose neighbor is empty.  Vertices deduplicated on the corner
    lattice; quads split into triangles.  Returns (verts (V,3), tris (T,3))."""
    corner_id = {}
    verts = []
    tris = []

    def vid(i, j, k):
        key = (i, j, k)
        n = corner_id.get(key)
        if n is None:
            n = len(verts)
            corner_id[key] = n
            verts.append(lo + voxel * np.array([i, j, k], dtype=np.float64))
        return n

    # face corner offsets per (axis, direction): CCW as seen from outside
    FACES = {
        (0, 1): [(1, 0, 0), (1, 1, 0), (1, 1, 1), (1, 0, 1)],
        (0, 0): [(0, 0, 0), (0, 0, 1), (0, 1, 1), (0, 1, 0)],
        (1, 1): [(0, 1, 0), (0, 1, 1), (1, 1, 1), (1, 1, 0)],
        (1, 0): [(0, 0, 0), (1, 0, 0), (1, 0, 1), (0, 0, 1)],
        (2, 1): [(0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)],
        (2, 0): [(0, 0, 0), (0, 1, 0), (1, 1, 0), (1, 0, 0)],
    }
    padded = np.zeros(tuple(s + 2 for s in occ.shape), dtype=bool)
    padded[1:-1, 1:-1, 1:-1] = occ
    for (axis, sign), corners in FACES.items():
        shift = np.roll(np.array([1 if sign else -1, 0, 0]), axis)
        nb = np.roll(padded, -shift, axis=(0, 1, 2))[1:-1, 1:-1, 1:-1]
        ii, jj, kk = np.nonzero(occ & ~nb)
        for i, j, k in zip(ii, jj, kk):
            q = [vid(i + c[0], j + c[1], k + c[2]) for c in corners]
            tris.append((q[0], q[1], q[2]))
            tris.append((q[0], q[2], q[3]))
    return np.asarray(verts), np.asarray(tris, dtype=np.int64)


def voxel_centers(lo, voxel, R):
    """(R, R, R, 3) centers of the grid's voxels from the corner ``lo``."""
    axes = [np.linspace(lo[d] + 0.5 * voxel, lo[d] + (R - 0.5) * voxel, R) for d in range(3)]
    return np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)


def threshold_of(threshold: str, voxel: float) -> float:
    """``auto`` (= ln 2 / (4 voxel)) or a float sigma."""
    return np.log(2.0) / (4.0 * voxel) if threshold == "auto" else float(threshold)


def write_obj(path, verts, tris):
    with open(path, "w") as fh:
        for v in verts:
            fh.write(f"v {v[0]:.5f} {v[1]:.5f} {v[2]:.5f}\n")
        for t in tris:
            fh.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n")


def dataset_bounds(cfg) -> np.ndarray:
    """(2, 3) [min, max] of the dataset's scene AABB from its train depth maps,
    as the JAX script's dataset fallback computes it."""
    if cfg.dataset_name == "sapien_multi":
        dirs = [f.path for inst in sorted(os.scandir(cfg.root_dir), key=lambda e: e.name)
                if inst.is_dir()
                for f in os.scandir(os.path.join(inst.path, "train")) if f.is_dir()]
    else:
        dirs = [os.path.join(cfg.root_dir, "train")]
    pad = cfg.aabb_pad if (cfg.use_aabb or cfg.use_occgrid) else 0.05
    bounds = scene_aabb(dirs, tuple(cfg.img_wh), pad=pad)
    if bounds is None:
        raise SystemExit(f"no depth data under {cfg.root_dir} for the AABB; pass --bounds")
    return np.asarray(bounds, dtype=np.float64)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="geometry from a trained checkpoint")
    ap.add_argument("--config", default=None, help="required unless --from_grid")
    ap.add_argument("--ckpt", default="last.ckpt")
    ap.add_argument("--resolution", type=int, default=160)
    ap.add_argument("--threshold", default="auto", help='"auto" (= ln2/(4*voxel)) or a float sigma')
    ap.add_argument("--instance", type=int, default=0)
    ap.add_argument("--articulation", type=int, default=0)
    ap.add_argument("--interpolated", action="store_true",
                    help="index the interpolated 2N-1 latent table (odd ids = midpoints)")
    ap.add_argument("--image_id", type=int, default=0, help="source frame for the AE encoder")
    ap.add_argument("--viewdir", type=float, nargs=3, default=(0.0, 0.0, -1.0))
    ap.add_argument("--chunk", type=int, default=65536)
    ap.add_argument("--bounds", type=float, nargs=6, default=None,
                    help="xmin ymin zmin xmax ymax zmax (overrides the dataset AABB)")
    ap.add_argument("--out", default="geometry")
    ap.add_argument("--from_grid", default=None,
                    help="re-threshold a saved density_grid.npz (no model query; "
                         "colors fall back to density-shaded gray)")
    return ap


def _from_grid(args) -> dict:
    z = np.load(args.from_grid)
    sig_grid, bounds, voxel = z["sigma"], z["bounds"], float(z["voxel"])
    R = sig_grid.shape[0]
    lo = bounds[0]
    thr = threshold_of(args.threshold, voxel)
    occ = sig_grid > thr
    out_dir = os.path.dirname(os.path.abspath(args.from_grid))
    grid = voxel_centers(lo, voxel, R)
    shade = np.clip(sig_grid[occ] / max(float(sig_grid.max()), 1e-6), 0.2, 1.0)
    write_ply(os.path.join(out_dir, "points.ply"), grid[occ], np.repeat(shade[:, None], 3, axis=1))
    verts, tris = boundary_mesh(occ, lo, voxel)
    write_obj(os.path.join(out_dir, "mesh.obj"), verts, tris)
    print(
        f"occupied {int(occ.sum())}/{R ** 3} voxels (sigma>{thr:.2f}); "
        f"mesh {len(verts)} verts / {len(tris)} tris -> {out_dir}",
        flush=True,
    )
    return {"out_dir": out_dir, "occupied": int(occ.sum()), "verts": len(verts),
            "tris": len(tris), "threshold": thr}


def main(argv=None, device: DeviceLike = "cuda") -> dict:
    """Run the extraction; returns what it wrote and how long its parts took
    (``seconds``: restore, query, mesh, write)."""
    args = build_parser().parse_args(argv)
    if args.from_grid:
        return _from_grid(args)
    if args.config is None:
        raise SystemExit("--config is required unless --from_grid is given")
    if args.chunk % POINTS_PER_RAY:
        raise SystemExit("--chunk must be a multiple of 128 (points are blocked (B,128,3))")
    device = resolve_device(device)
    seconds = {}

    t0 = time.perf_counter()
    cfg = get_config(["--config", args.config])
    if args.bounds is not None:
        bounds = np.asarray(args.bounds, dtype=np.float64).reshape(2, 3)
    else:
        bounds = dataset_bounds(cfg)
    system = build_system(cfg, NEAR, FAR, cfg.white_back, device=device)
    # the Trainer's init key: a template that the checkpoint overwrites
    state = system.init_state(prng.split(prng.key(cfg.seed))[1])
    ckpt = CheckpointManager(str(Path(cfg.output_path) / cfg.exp_name), save_top_k=cfg.save_top_k)
    state = ckpt.restore(state, args.ckpt)
    trainer = types.SimpleNamespace(cfg=cfg, state=state, system=system)
    seconds["restore"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    R = args.resolution
    lo, hi = bounds[0], bounds[1]
    voxel = float(np.max(hi - lo) / R)
    grid = voxel_centers(lo, voxel, R).reshape(-1, 3)

    query = density_color_fn(trainer, args)
    n = grid.shape[0]
    sigma = np.empty(n, dtype=np.float32)
    rgb = np.empty((n, 3), dtype=np.float32)
    pad_to = ((n + args.chunk - 1) // args.chunk) * args.chunk
    pts_padded = np.zeros((pad_to, 3), dtype=np.float32)
    pts_padded[:n] = grid
    for s in range(0, pad_to, args.chunk):
        sg, cg = query(torch.from_numpy(pts_padded[s: s + args.chunk]).to(device))
        e = min(s + args.chunk, n)
        sigma[s:e] = sg[: e - s].cpu().numpy()
        rgb[s:e] = cg[: e - s].cpu().numpy()
        print(f"queried {e}/{n} grid points", flush=True)
    seconds["query"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    thr = threshold_of(args.threshold, voxel)
    sig_grid = sigma.reshape(R, R, R)
    occ = sig_grid > thr
    verts, tris = boundary_mesh(occ, lo, voxel)
    seconds["mesh"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    out_dir = os.path.join("ckpts", cfg.exp_name, args.out)
    os.makedirs(out_dir, exist_ok=True)
    np.savez_compressed(
        os.path.join(out_dir, "density_grid.npz"),
        sigma=sig_grid, bounds=bounds, voxel=voxel, threshold=thr,
    )
    centers = grid.reshape(R, R, R, 3)[occ]
    write_ply(os.path.join(out_dir, "points.ply"), centers, rgb.reshape(R, R, R, 3)[occ])
    write_obj(os.path.join(out_dir, "mesh.obj"), verts, tris)
    seconds["write"] = time.perf_counter() - t0
    print(
        f"occupied {int(occ.sum())}/{R ** 3} voxels (sigma>{thr:.2f}); "
        f"mesh {len(verts)} verts / {len(tris)} tris -> {out_dir}",
        flush=True,
    )
    return {"out_dir": out_dir, "occupied": int(occ.sum()), "verts": len(verts),
            "tris": len(tris), "threshold": thr, "points": n, "queries": pad_to // args.chunk,
            "seconds": seconds}


if __name__ == "__main__":
    main()
