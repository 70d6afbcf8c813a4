"""Package rules of aon_tpu_torch: no JAX and nothing of aon_tpu at run time,
entry points that default to CUDA and raise without it, kernel wrappers that
never fall back, and the nvcc build orchestration (with a stand-in compiler)."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from aon_tpu_torch.eval.render import render_frame
from aon_tpu_torch.ops import _build
from aon_tpu_torch.ops.fused_mlp import make_posenc_constants, pack_vanilla_mlp_params
from aon_tpu_torch.ops.fused_mlp_train import fused_nerf_mlp_xyz_eval
from aon_tpu_torch.ops.render_fused import mlp_params
from aon_tpu_torch.ops.resample import resample_union
from aon_tpu_torch.train.systems import VanillaSystem, build_system
from aon_tpu_torch.utils.config import Config

ROOT = Path(__file__).resolve().parents[1]
_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "aon_tpu")


def test_import_leaves_no_jax_and_no_aon_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import aon_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(aon_tpu_torch.__path__, 'aon_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in {_FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_sources_import_no_jax_and_no_aon_tpu():
    pattern = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|flax|optax|orbax|aon_tpu)\b(?!_torch)")
    files = sorted((ROOT / "aon_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [f"{f}:{i + 1}" for f in files
                 for i, line in enumerate(f.read_text().splitlines()) if pattern.match(line)]
    assert not offenders


def _frame(n=16):
    d = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (n, 1))
    return {"rays_o": -4 * d, "rays_d": d, "viewdirs": d}


def test_default_device_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("the host has CUDA: the defaults run there")
    cfg = Config()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_system(cfg, 2.0, 6.0, True)
    with pytest.raises(RuntimeError, match="CUDA"):
        VanillaSystem(cfg, 2.0, 6.0, True)
    with pytest.raises(RuntimeError, match="CUDA"):
        render_frame(lambda rays: rays, _frame(), chunk=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_posenc_constants()


def test_other_exp_types_name_their_roadmap_item():
    # the auto-decoder is ported; the auto-encoder names the slice it waits for
    system = build_system(Config(exp_type="vanilla_autodecoder", N_max_objs=4), 2.0, 6.0, False,
                          device="cpu")
    assert type(system).__name__ == "AutoDecoderSystem"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_system(Config(exp_type="vanilla_ae_art"), 2.0, 6.0, True, device="cpu")
    with pytest.raises(ValueError):
        build_system(Config(exp_type="nope"), 2.0, 6.0, True, device="cpu")


def test_cpu_system_runs_plain_module_and_fused_needs_cuda():
    system = build_system(Config(use_pallas=True), 2.0, 6.0, True, device="cpu")
    assert system._fused is None  # use_pallas picks the kernels only on CUDA
    params = system.init_params(torch.Generator().manual_seed(0))
    again = system.init_params(torch.Generator().manual_seed(0))
    assert all(torch.equal(params[k], again[k]) for k in params)
    out = system.render_chunk(params, _frame(8))
    assert out["comp_rgb"].shape == (8, 3) and torch.isfinite(out["comp_rgb"]).all()


def test_kernel_wrappers_raise_on_other_devices():
    system = build_system(Config(), 2.0, 6.0, True, device="cpu")
    params = system.init_params(torch.Generator().manual_seed(0))
    packed = pack_vanilla_mlp_params(mlp_params(params, "coarse_mlp"))
    consts = make_posenc_constants(device="cpu")
    meta = torch.empty(2, 5, 3, device="meta")
    launches = (fused_nerf_mlp_xyz_eval.launches, resample_union.launches)
    with pytest.raises(ValueError, match="no kernel"):
        fused_nerf_mlp_xyz_eval(packed, consts, meta, torch.empty(2, 3, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        resample_union(torch.empty(2, 5, device="meta"), torch.empty(2, 4, device="meta"),
                       torch.empty(2, 4, device="meta"), torch.empty(2, 8, device="meta"))
    assert (fused_nerf_mlp_xyz_eval.launches, resample_union.launches) == launches


def test_nvcc_flags_target_sm90a_without_fast_math():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    assert {p.stem for p in _build.CSRC.glob("*.cu")} == set(_build.KERNEL_SOURCES)


def _fake_nvcc(tmp_path, body):
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\nimport sys\nargs = sys.argv[1:]\n{body}\n")
    nvcc.chmod(0o755)
    return home


def test_build_runs_nvcc_per_source_into_build_dir(tmp_path, monkeypatch):
    home = _fake_nvcc(tmp_path, "open(args[args.index('-o') + 1], 'w').write('lib')\n"
                                "print('ptxas info : Used 90 registers')")
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    logs = _build.build()
    assert set(logs) == set(_build.KERNEL_SOURCES)
    assert all("Used 90 registers" in log for log in logs.values())
    for name in _build.KERNEL_SOURCES:
        assert _build.library_path(name).exists()
    assert _build.build() == {}  # built once, then reused


def test_build_failure_raises_with_the_compiler_log(tmp_path, monkeypatch):
    home = _fake_nvcc(tmp_path, "print('error: no such instruction'); sys.exit(2)")
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no such instruction"):
        _build.build(["resample"])
    assert not list((tmp_path / "build").glob("*.so"))


def test_launcher_error_codes_raise():
    _build.check(0, "ok")
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        _build.check(9, "launch")


def test_chip_smoke_refuses_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("the host has CUDA")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
