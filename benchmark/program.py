"""The benchmark's hold on the measured program, ``aon_tpu_torch``: its
configuration built from a configuration file, its ``Trainer``, and the
weights the benchmark hands it.  Nothing here imports the program at
import time."""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import torch

from common import log


def config(cfg_file: dict, data_dir: str, out_dir: str, seed: int, overrides: Optional[dict] = None):
    """The port's ``Config`` of a configuration file, run from ``data_dir``."""
    from aon_tpu_torch.utils.config import Config

    fields = dict(cfg_file["program"], **(overrides or {}))
    cfg = Config()
    for k, v in fields.items():
        if not hasattr(cfg, k):
            raise KeyError(f"the program has no setting {k!r}")
        setattr(cfg, k, v)
    cfg.root_dir, cfg.output_path, cfg.seed = data_dir, out_dir, int(seed)
    cfg.watchdog_timeout = 0.0
    return cfg


def trainer(cfg, device):
    from aon_tpu_torch.train.trainer import Trainer

    return Trainer(cfg, device=device)


def hand_weights(tr, params: Dict[str, torch.Tensor]) -> None:
    """Put the benchmark's weights into the trainer's state, with fresh
    optimizer moments at step 0, after checking that the program's
    parameters are exactly these names and shapes."""
    have = {k: tuple(v.shape) for k, v in tr.state.params.items()}
    want = {k: tuple(v.shape) for k, v in params.items()}
    if have != want:
        diff = sorted(set(have.items()) ^ set(want.items()))
        raise ValueError(f"the program's parameters differ from the reference's: {diff[:6]}")
    params = {k: params[k].detach().clone() for k in tr.state.params}
    mu, nu = tr.system.tx.init(params)
    tr.state = dataclasses.replace(tr.state, step=0, params=params, mu=mu, nu=nu)
    tr.global_step = 0


def reseed(tr, seed: int) -> None:
    """A trainer's seed-dependent state as a fresh ``Trainer`` of ``seed``
    holds it: the draws' base key and step 0 (the weights: ``hand_weights``)."""
    from aon_tpu_torch.core import prng

    tr.cfg.seed = int(seed)
    tr.base_key, _ = prng.split(prng.key(int(seed)))
    tr.global_step = 0


def fused_route(tr) -> bool:
    """Whether the system trains and renders through the CUDA kernels (else
    the plain modules): the configuration's ``use_pallas`` on a CUDA device."""
    return bool(tr.cfg.use_pallas) and tr.device.type == "cuda"


def free(tr) -> None:
    tr.state = None
    tr.system = None
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def cache_dirs(root: str) -> None:
    """The program's and the compilers' caches at fixed paths inside the
    checkout (the port builds its kernels into ``build/aon_tpu_torch``)."""
    base = os.path.join(root, "build", "benchmark")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(base, sub)
    log(f"caches under {base}")
