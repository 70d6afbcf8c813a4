"""Build and load the port's CUDA kernels.

Each ``ops/csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with
a plain C interface (``extern "C"`` launchers that take the CUDA stream and
return ``cudaGetLastError()``), loaded with ``ctypes``.  No PyTorch headers
are compiled, so a build takes seconds.  Libraries land in
``build/aon_tpu_torch/`` at the repository root, named by a hash of their
source, the headers beside it and the flags, and are built at first use.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "aon_tpu_torch"
KERNEL_SOURCES = ("fused_mlp_eval", "resample", "level_train", "art")

# No --use_fast_math: the positional encoding needs the accurate sinf and
# IEEE division (ops/csrc/fused_mlp_eval.cu).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_VOID_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_INT = ctypes.c_int
_FLOAT = ctypes.c_float
# argtypes of every launcher: each pointer and the stream as c_void_p, or
# ctypes would pass them as 32-bit ints.
_SIGNATURES = {
    "fused_mlp_eval": {
        "aon_mlp_eval_launch": [_VOID_P] * 10 + [_LL, _INT, _INT, _VOID_P],
        "aon_mlp_xyz_per_ray_launch": [_VOID_P] * 10 + [_LL, _INT, _INT, _VOID_P],
        "aon_mlp_enc_launch": [_VOID_P] * 6 + [_LL, _INT, _VOID_P],
        "aon_mlp_enc_per_ray_launch": [_VOID_P] * 6 + [_LL, _INT, _INT, _VOID_P],
        "aon_mlp_body_launch": [_VOID_P] * 6 + [_LL, _INT, _INT, _VOID_P],
        "aon_mlp_xyz_body_launch": [_VOID_P] * 10 + [_LL, _INT, _INT, _VOID_P],
        "aon_posenc_launch": [_VOID_P] * 3 + [_INT, _LL, _INT, _VOID_P, _VOID_P],
    },
    "resample": {
        "aon_resample_launch": [_VOID_P] * 4 + [_LL, _VOID_P, _LL, _INT, _INT, _INT, _VOID_P],
    },
    "level_train": {
        "aon_level_train_launch": [_VOID_P] * 21 + [_INT] * 5 + [_VOID_P],
        "aon_mlp_bwd_launch": [_VOID_P] * 16 + [_INT, _LL, _INT, _INT, _VOID_P],
        "aon_mlp_bwd_enc_launch": [_VOID_P] * 12 + [_INT, _LL, _INT, _VOID_P],
        "aon_wgrad_run": [_VOID_P] * 4 + [_INT, _VOID_P],
    },
    "art": {
        "aon_art_fwd_launch": [_VOID_P] * 10 + [_LL, _INT, _INT, _VOID_P],
        "aon_art_bwd_launch": [_VOID_P] * 17 + [_INT, _LL, _INT, _INT, _VOID_P],
        "aon_art_level_launch": ([_VOID_P] * 25 + [_INT, _INT, _INT, _INT]
                                 + [_FLOAT, _FLOAT, _FLOAT, _INT, _INT, _VOID_P]),
    },
}


def nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # every source may include them
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, str]:
    """Compile every named source that is not built yet, all nvcc processes
    started together.  Returns ``{name: compiler log}`` (``-Xptxas -v``: each
    kernel's registers, shared memory and spills) for the ones it built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), tmp, out)
    logs, failures = {}, []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(log)
    if failures:
        raise RuntimeError("\n".join(failures))
    return logs


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    build([name])
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, argtypes in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
