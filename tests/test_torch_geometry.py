"""Port parity, geometry extraction and checkpoints:
``aon_tpu_torch.scripts.extract_geometry`` and ``aon_tpu_torch.train.checkpoint``
against the JAX package's ``scripts/extract_geometry.py`` and
``aon_tpu/train/checkpoint.py``.

* The numpy host code (``write_ply``, ``boundary_mesh``, the ``--from_grid``
  re-threshold) gives byte-identical files and identical arrays.
* The two checkpoint managers, fed the same save sequence, leave identical
  ``index.json`` files and the same checkpoint directories; the port's
  ``restore`` round-trips a ``TrainState`` bit for bit.
* ``extract_geometry.main(device="cpu")`` (the kernels' plain twins, bf16
  weights) writes a sigma grid that agrees with the JAX ``density_color_fn``
  on its CPU branch (the flax modules, float32) from the same converted
  params.  Tolerance, relative to the grid's largest sigma: 1e-2 at the
  largest error and 2e-3 on average for the vanilla MLP (seen 2.3e-3 and
  5.1e-4); 8e-2 and 1e-2 for the auto-decoder (seen 3.6e-2 and 2.9e-3), whose
  deformation output is amplified by up to 2^9 inside the encoding
  (ROADMAP.md Queue 3).  Both are bf16's own rounding of a dozen layers
  against float32 (2^-9 per layer); a layout or indexing fault moves the
  grid by O(1).
"""

import importlib.util
import json
import os
import sys
import types
from pathlib import Path

import jax  # noqa: F401  (conftest keeps it on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aon_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from aon_tpu.train.systems import AutoDecoderSystem as JaxAutoDecoderSystem
from aon_tpu.train.systems import VanillaSystem as JaxVanillaSystem
from aon_tpu.utils.config import Config as JaxConfig
from aon_tpu_torch.core import prng
from aon_tpu_torch.models.convert import tree_to_flax
from aon_tpu_torch.ops import fused_art
from aon_tpu_torch.ops import fused_mlp as tfm
from aon_tpu_torch.scripts import extract_geometry as geo
from aon_tpu_torch.train.checkpoint import (
    CheckpointManager,
    extract_model_params,
    load_latent_codes,
)
from aon_tpu_torch.train.systems import TrainState, build_system
from aon_tpu_torch.utils.config import Config, get_config

REPO = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "jax_extract_geometry", REPO / "scripts" / "extract_geometry.py")
jgeo = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jgeo)

BOUNDS = ["-1.5", "-1.5", "-1.5", "1.5", "1.5", "1.5"]
RES, CHUNK = 16, 1024
TOL_SIGMA = {"vanilla": (1e-2, 2e-3), "vanilla_autodecoder": (8e-2, 1e-2)}


def _occupancy(seed=0, r=12):
    g = np.random.default_rng(seed)
    occ = g.uniform(size=(r, r, r)) < 0.3
    occ[0] = occ[:, -1] = False
    return occ


def test_boundary_mesh_and_write_ply_match_the_jax_script(tmp_path):
    occ = _occupancy()
    lo, voxel = np.array([-1.5, -1.0, -0.5]), 0.25
    verts, tris = geo.boundary_mesh(occ, lo, voxel)
    want_verts, want_tris = jgeo.boundary_mesh(occ, lo, voxel)
    assert len(tris) > 1000
    np.testing.assert_array_equal(verts, want_verts)
    np.testing.assert_array_equal(tris, want_tris)
    assert tris.dtype == want_tris.dtype == np.int64
    g = np.random.default_rng(1)
    pts, colors = g.normal(size=(500, 3)), g.uniform(-0.2, 1.2, size=(500, 3))
    geo.write_ply(tmp_path / "port.ply", pts, colors)
    jgeo.write_ply(tmp_path / "jax.ply", pts, colors)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()


def test_from_grid_writes_the_jax_scripts_files(tmp_path, monkeypatch):
    g = np.random.default_rng(2)
    R, voxel = 10, 0.3
    sigma = (g.exponential(size=(R, R, R)) * 2.0).astype(np.float32)
    bounds = np.array([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]])
    for side in ("port", "jax"):
        (tmp_path / side).mkdir()
        np.savez_compressed(tmp_path / side / "density_grid.npz", sigma=sigma, bounds=bounds,
                            voxel=voxel, threshold=0.0)
    out = geo.main(["--from_grid", str(tmp_path / "port" / "density_grid.npz")])
    monkeypatch.setattr(sys, "argv", ["extract_geometry.py", "--from_grid",
                                      str(tmp_path / "jax" / "density_grid.npz")])
    jgeo.main()
    for name in ("points.ply", "mesh.obj"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    assert out["occupied"] == int((sigma > np.log(2.0) / (4.0 * voxel)).sum()) > 0


def _jax_state(step):
    return types.SimpleNamespace(params={"w": jnp.arange(3.0)}, opt_state={"mu": jnp.ones(3)},
                                 step=jnp.asarray(step))


def _port_state(step, value=0.0):
    params = {"w": torch.arange(3.0) + value}
    return TrainState(step=step, params=params, mu={"w": torch.ones(3)},
                      nu={"w": torch.full((3,), 2.0)}, tx=None)


def test_checkpoint_manager_matches_the_jax_one(tmp_path):
    # (call, epoch, val_psnr): top-2 pruning, a re-saved name, last overwritten
    sequence = [("last", 0, None), ("ranked", 0, 20.0), ("ranked", 1, 25.0),
                ("ranked", 2, 22.0), ("ranked", 3, 21.0), ("last", 3, None),
                ("ranked", 1, 26.5), ("ranked", 4, 23.0)]
    managers = {"jax": JaxCheckpointManager(str(tmp_path / "jax"), save_top_k=2),
                "port": CheckpointManager(str(tmp_path / "port"), save_top_k=2)}
    states = {"jax": _jax_state, "port": _port_state}
    for i, (call, epoch, psnr) in enumerate(sequence):
        for side, m in managers.items():
            state = states[side](10 * i)
            if call == "last":
                m.save_last(state, epoch)
            else:
                m.save_ranked(state, epoch, psnr)
    index = {side: (tmp_path / side / "index.json").read_text() for side in managers}
    assert index["port"] == index["jax"]
    assert json.loads(index["port"])["ranked"][0]["name"] == "epoch=1.ckpt"
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    assert managers["port"].best() == managers["jax"].best()
    # a reopened manager reads the index back
    assert CheckpointManager(str(tmp_path / "port"), save_top_k=2).best() == managers["port"].best()


def test_restore_round_trips_a_train_state(tmp_path):
    system = build_system(Config(), 2.0, 6.0, True, device="cpu")
    state = system.init_state(prng.key(0))
    state = TrainState(step=17, params=state.params,
                       mu={k: torch.randn_like(v) for k, v in state.mu.items()},
                       nu={k: torch.rand_like(v) for k, v in state.nu.items()}, tx=state.tx)
    m = CheckpointManager(str(tmp_path / "run"))
    m.save_last(state, epoch=3)
    fresh = system.init_state(prng.key(1))
    for name in (None, "last.ckpt", str(tmp_path / "run" / "last.ckpt")):
        back = m.restore(fresh, name)
        assert back.step == 17 and back.tx is fresh.tx
        for part in ("params", "mu", "nu"):
            got, want = getattr(back, part), getattr(state, part)
            assert set(got) == set(want)
            assert all(torch.equal(got[k], want[k]) for k in want), part
    with pytest.raises(FileNotFoundError):
        m.restore(fresh, "epoch=9.ckpt")
    with pytest.raises(ValueError, match="names differ"):
        m.restore(_port_state(0), "last.ckpt")
    assert set(extract_model_params(state.params, "fine_mlp")) == {
        k[len("fine_mlp."):] for k in state.params if k.startswith("fine_mlp.")}
    assert extract_model_params(state.params, "model") == state.params  # no such prefix


def test_load_latent_codes_returns_the_code_tables(tmp_path):
    system = build_system(Config(exp_type="vanilla_autodecoder", N_max_objs=3), 2.0, 6.0,
                          False, device="cpu")
    state = system.init_state(prng.key(0))
    CheckpointManager(str(tmp_path)).save_last(state, epoch=0)
    codes = load_latent_codes(str(tmp_path))
    want = {k[len("code_library."):]: v for k, v in state.params.items()
            if k.startswith("code_library.")}
    assert set(codes) == set(want) and len(want) == 3
    for k, v in want.items():
        assert isinstance(codes[k], np.ndarray)
        np.testing.assert_array_equal(codes[k], v.numpy())
    vanilla = build_system(Config(), 2.0, 6.0, True, device="cpu")
    CheckpointManager(str(tmp_path / "v")).save_last(
        vanilla.init_state(prng.key(0)), epoch=0)
    with pytest.raises(KeyError, match="code_library"):
        load_latent_codes(str(tmp_path / "v"))


def _config(tmp_path, exp_type, **extra):
    cfg = dict(exp_type=exp_type, exp_name=f"geo_{exp_type}",
               output_path=str(tmp_path / "results"), N_max_objs=4, **extra)
    path = tmp_path / f"{exp_type}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _saved_state(config, seed):
    cfg = get_config(["--config", config])
    system = build_system(cfg, 2.0, 6.0, cfg.white_back, device="cpu")
    state = system.init_state(prng.key(seed))
    # partly opaque: a density bias that puts sigma around the auto threshold
    # (the auto-decoder's sigma is softplus(raw - 1))
    bias, shift = (("fine_mlp.density.bias", 1.0) if cfg.exp_type == "vanilla"
                   else ("model.fine_mlp.density.bias", 1.5))
    params = dict(state.params, **{bias: state.params[bias] + shift})
    state = TrainState(step=5, params=params, mu=state.mu, nu=state.nu, tx=state.tx)
    CheckpointManager(str(Path(cfg.output_path) / cfg.exp_name)).save_last(state, epoch=0)
    return state


def _jax_grid(exp_type, params, args):
    """The JAX script's density_color_fn on its CPU branch (flax, float32)
    over the port's voxel centers."""
    cfg = JaxConfig(exp_type=exp_type, N_max_objs=4, compute_dtype="float32")
    system_cls = JaxVanillaSystem if exp_type == "vanilla" else JaxAutoDecoderSystem
    system = system_cls(cfg, 2.0, 6.0, exp_type == "vanilla")
    tree = tree_to_flax(params)
    if exp_type == "vanilla":
        # the JAX script reads the vanilla fine MLP at params["model"], a level
        # the VanillaSystem's own state does not have (ROADMAP.md Queue 3)
        with pytest.raises(KeyError):
            jgeo.density_color_fn(types.SimpleNamespace(
                cfg=cfg, state=types.SimpleNamespace(params=tree), system=system), args)
        tree = {"model": tree}
    query = jgeo.density_color_fn(types.SimpleNamespace(
        cfg=cfg, state=types.SimpleNamespace(params=tree), system=system), args)
    voxel = 3.0 / RES
    pts = geo.voxel_centers(np.full(3, -1.5), voxel, RES).reshape(-1, 3).astype(np.float32)
    return np.concatenate([np.asarray(query(jnp.asarray(pts[i:i + CHUNK]))[0])
                           for i in range(0, len(pts), CHUNK)]).reshape(RES, RES, RES)


@pytest.mark.parametrize("exp_type,ids", [
    ("vanilla", []),
    ("vanilla_autodecoder", ["--instance", "2", "--articulation", "3"]),
    ("vanilla_autodecoder", ["--instance", "1", "--articulation", "5", "--interpolated"]),
], ids=["vanilla", "autodecoder", "autodecoder-midpoint"])
def test_extract_geometry_on_the_cpu_matches_the_jax_script(tmp_path, monkeypatch, exp_type, ids):
    config = _config(tmp_path, exp_type)
    state = _saved_state(config, seed=3)
    monkeypatch.chdir(tmp_path)
    counters = (tfm.fused_nerf_mlp_xyz, fused_art.art_mlp_fwd)
    before = [c.launches for c in counters]
    out = geo.main(["--config", config, "--resolution", str(RES), "--chunk", str(CHUNK),
                    "--bounds", *BOUNDS, *ids], device="cpu")
    assert [c.launches for c in counters] == before  # CPU tensors: the twins
    out_dir = tmp_path / "ckpts" / f"geo_{exp_type}" / "geometry"
    assert Path(out["out_dir"]).resolve() == out_dir
    assert out["queries"] == RES ** 3 // CHUNK and set(out["seconds"]) == {
        "restore", "query", "mesh", "write"}
    grid = np.load(out_dir / "density_grid.npz")
    sigma = grid["sigma"]
    assert sigma.shape == (RES,) * 3 and np.isfinite(sigma).all()
    np.testing.assert_allclose(grid["bounds"], np.asarray(BOUNDS, float).reshape(2, 3))
    assert float(grid["threshold"]) == pytest.approx(np.log(2.0) / (4.0 * 3.0 / RES))
    assert 0 < out["occupied"] < RES ** 3  # the threshold cuts through the field
    lines = (out_dir / "points.ply").read_text().splitlines()
    assert f"element vertex {out['occupied']}" in lines
    assert len(lines) == lines.index("end_header") + 1 + out["occupied"]
    obj = (out_dir / "mesh.obj").read_text().splitlines()
    assert sum(ln.startswith("f ") for ln in obj) == out["tris"] > 0

    args = types.SimpleNamespace(viewdir=(0.0, 0.0, -1.0), instance=0, articulation=0,
                                 interpolated=False)
    for flag, value in zip(ids[::2], ids[1::2]):
        setattr(args, flag[2:], int(value))
    args.interpolated = "--interpolated" in ids
    want = _jax_grid(exp_type, state.params, args)
    err = np.abs(sigma - want)
    tol_max, tol_mean = TOL_SIGMA[exp_type]
    scale = float(np.abs(want).max())
    assert err.max() <= tol_max * scale and err.mean() <= tol_mean * scale, (
        err.max() / scale, err.mean() / scale)


def test_main_needs_bounds_and_a_config(tmp_path):
    with pytest.raises(SystemExit, match="bounds"):
        geo.main(["--config", _config(tmp_path, "vanilla")], device="cpu")
    with pytest.raises(SystemExit, match="config"):
        geo.main(["--bounds", *BOUNDS], device="cpu")
    with pytest.raises(SystemExit, match="multiple of 128"):
        geo.main(["--config", _config(tmp_path, "vanilla"), "--bounds", *BOUNDS, "--chunk", "100"],
                 device="cpu")
    # the auto-encoder builds its system and asks for the checkpoint it extracts from
    with pytest.raises(FileNotFoundError):
        geo.main(["--config", _config(tmp_path, "vanilla_ae_art"), "--bounds", *BOUNDS],
                 device="cpu")


def test_extraction_takes_the_configs_encoding_degrees(tmp_path, monkeypatch):
    """A vanilla config with other encoding degrees than (10, 4) extracts the
    grid of the plain float32 model (``NeRFMLP`` on ``pos_enc`` at the config's
    degrees), within the bf16 tolerance of ``TOL_SIGMA``; degrees the kernels'
    widths cannot hold, and any but (10, 4) for the auto-decoder, are refused."""
    from aon_tpu_torch.core.sampling import pos_enc

    config = _config(tmp_path, "vanilla", N_emb_xyz=8, N_emb_dir=3)
    state = _saved_state(config, seed=4)
    monkeypatch.chdir(tmp_path)
    geo.main(["--config", config, "--resolution", str(RES), "--chunk", str(CHUNK),
              "--bounds", *BOUNDS], device="cpu")
    sigma = np.load(tmp_path / "ckpts" / "geo_vanilla" / "geometry" / "density_grid.npz")["sigma"]

    cfg = get_config(["--config", config])
    system = build_system(cfg, 2.0, 6.0, cfg.white_back, device="cpu")
    mlp = system.model.fine_mlp.float()
    mlp.load_state_dict({k[len("fine_mlp."):]: v for k, v in state.params.items()
                         if k.startswith("fine_mlp.")})
    pts = torch.from_numpy(geo.voxel_centers(np.full(3, -1.5), 3.0 / RES, RES)
                           .reshape(-1, geo.POINTS_PER_RAY, 3).astype(np.float32))
    view = torch.tensor([[0.0, 0.0, -1.0]]).expand(pts.shape[0], 3)
    with torch.no_grad():
        _, raw_sigma = mlp(pos_enc(pts, 0, 8), pos_enc(view, 0, 3))
    want = torch.relu(raw_sigma).reshape(RES, RES, RES).numpy()
    err, scale = np.abs(sigma - want), float(np.abs(want).max())
    tol_max, tol_mean = TOL_SIGMA["vanilla"]
    assert err.max() <= tol_max * scale and err.mean() <= tol_mean * scale, (
        err.max() / scale, err.mean() / scale)

    for exp_type, degrees in (("vanilla", dict(N_emb_xyz=11)), ("vanilla", dict(N_emb_dir=5)),
                              ("vanilla_autodecoder", dict(N_emb_xyz=8))):
        with pytest.raises(ValueError, match="N_emb_xyz"):
            geo.encoding_constants(Config(exp_type=exp_type, **degrees), "cpu")
    assert geo.encoding_constants(Config(exp_type="vanilla_autodecoder"), "cpu")["s_pos"].shape \
        == (4, tfm.POS_PAD)
