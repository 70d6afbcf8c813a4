"""Checkpointing: val/psnr-ranked top-k retention + last (port of
``aon_tpu/train/checkpoint.py``).

Replaces the reference's Lightning ``ModelCheckpoint`` (``run.py:62-71``:
monitor val/psnr mode max, save_top_k=5, save_last, every_n_epochs=10).  The
directory layout, the ``index.json`` schema (``{"ranked": [...], "last":
{...}}``), the top-k pruning and the name resolution are the JAX package's.
The storage is not: each ``*.ckpt`` directory holds one ``torch.save`` file,
``state.pt``, of ``{"params", "opt_state": {"mu", "nu"}, "step"}``.  The JAX
package writes orbax checkpoints, which need orbax and tensorstore; neither
is on the card's machine, and this module cannot read them.  Carry a JAX
checkpoint over through ``models.convert.params_from_flax`` instead.

The state dict holds the auto-decoder's code tables (``code_library.*``), so
they are checkpointed with the rest (cf. the reference's manual
``load_latent_codes`` surgery, utils/__init__.py:117-147).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

STATE_FILE = "state.pt"


class CheckpointManager:
    def __init__(self, directory: str, save_top_k: int = 5):
        self.directory = os.path.abspath(directory)
        self.save_top_k = save_top_k
        os.makedirs(self.directory, exist_ok=True)
        self._index_path = os.path.join(self.directory, "index.json")
        self._index = {"ranked": [], "last": None}
        if os.path.exists(self._index_path):
            with open(self._index_path) as fh:
                self._index = json.load(fh)

    def _write_index(self):
        with open(self._index_path, "w") as fh:
            json.dump(self._index, fh, indent=2)

    def _save_tree(self, name: str, state: Any) -> str:
        path = os.path.join(self.directory, name)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.makedirs(path)
        tree = {"params": dict(state.params),
                "opt_state": {"mu": dict(state.mu), "nu": dict(state.nu)},
                "step": int(state.step)}
        torch.save(tree, os.path.join(path, STATE_FILE))
        return path

    def save_last(self, state: Any, epoch: int) -> None:
        self._save_tree("last.ckpt", state)
        self._index["last"] = {"name": "last.ckpt", "epoch": epoch, "step": int(state.step)}
        self._write_index()

    def save_ranked(self, state: Any, epoch: int, val_psnr: float) -> None:
        name = f"epoch={epoch}.ckpt"
        self._save_tree(name, state)
        ranked = [r for r in self._index["ranked"] if r["name"] != name]
        ranked.append({"name": name, "epoch": epoch, "psnr": float(val_psnr)})
        ranked.sort(key=lambda r: -r["psnr"])
        for stale in ranked[self.save_top_k:]:
            p = os.path.join(self.directory, stale["name"])
            if os.path.exists(p):
                shutil.rmtree(p)
        self._index["ranked"] = ranked[: self.save_top_k]
        self._write_index()

    def _path(self, name: Optional[str]) -> str:
        name = name or "last.ckpt"
        # --ckpt_path may be a full path to any checkpoint dir (reference
        # run.py:156-163); bare names resolve inside this run's directory
        path = os.path.abspath(name) if os.path.isdir(name) else os.path.join(self.directory, name)
        if not os.path.isdir(path):
            raise FileNotFoundError(path)
        return path

    def restore(self, state: Any, name: Optional[str] = None) -> Any:
        """Restore into the structure of ``state`` (a fresh ``TrainState``),
        onto the device of its parameters; returns the restored ``TrainState``."""
        path = self._path(name)
        device = next(iter(state.params.values())).device
        tree = torch.load(os.path.join(path, STATE_FILE), map_location=device, weights_only=True)
        parts = {"params": (tree["params"], state.params),
                 "mu": (tree["opt_state"]["mu"], state.mu),
                 "nu": (tree["opt_state"]["nu"], state.nu)}
        for part, (got, want) in parts.items():
            _check_like(got, want, f"{path}: {part}")
        return dataclasses.replace(state, params=tree["params"], mu=tree["opt_state"]["mu"],
                                   nu=tree["opt_state"]["nu"], step=int(tree["step"]))

    def best(self) -> Optional[dict]:
        return self._index["ranked"][0] if self._index["ranked"] else None


def _check_like(got: Mapping[str, torch.Tensor], want: Mapping[str, torch.Tensor],
                what: str) -> None:
    """Raise unless ``got`` has the names, shapes and dtypes of ``want``."""
    if set(got) != set(want):
        raise ValueError(f"{what}: the checkpoint's names differ from the state's "
                         f"({sorted(set(got) ^ set(want))[:4]} ...)")
    for k, v in want.items():
        if got[k].shape != v.shape or got[k].dtype != v.dtype:
            raise ValueError(f"{what}: {k} is {tuple(got[k].shape)} {got[k].dtype}, "
                             f"the state's {tuple(v.shape)} {v.dtype}")


def extract_model_params(tree: Mapping[str, Any], prefix: str = "model") -> Dict[str, Any]:
    """One params subtree of a checkpointed state dict: the entries under
    ``prefix.`` with the prefix taken off, or the state dict itself where no
    entry has it (the analogue of the reference's ``extract_model_state_dict``
    prefix surgery, utils/__init__.py:117-131)."""
    head = prefix + "."
    sub = {k[len(head):]: v for k, v in tree.items() if k.startswith(head)}
    return sub if sub else dict(tree)


def load_latent_codes(directory: str, name: str = "last.ckpt") -> Dict[str, np.ndarray]:
    """Restore only the auto-decoder latent tables from a checkpoint
    (reference ``load_latent_codes``, utils/__init__.py:140-147).

    Returns the ``code_library`` entries (``embedding_instance_shape.weight``
    ...) as host numpy arrays.
    """
    path = os.path.join(directory, name)
    tree = torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)
    params = tree["params"] if "params" in tree else tree
    if not any(k.startswith("code_library.") for k in params):
        raise KeyError(f"no code_library entries in checkpoint {path}")
    return {k: v.numpy() for k, v in extract_model_params(params, "code_library").items()}
