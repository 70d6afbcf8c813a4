"""Carry-over of weights and train state from the JAX package's flax trees.

A flax ``Dense`` stores ``kernel`` as (in, out); ``nn.Linear`` stores
``weight`` as (out, in), so ``weight = kernel.T``.  Param paths map one to
one: ``coarse_mlp/pts_0/kernel`` -> ``coarse_mlp.pts_0.weight``.  A flax
``Embed`` stores ``embedding`` as (rows, features), as ``nn.Embedding.weight``
does, so the code tables of the auto-decoder carry over untransposed:
``code_library/embedding_instance_shape/embedding`` ->
``code_library.embedding_instance_shape.weight``, as does the auto-encoder's
degree table (``deg_embedding/deg_embedding/embedding``).  A flax ``Conv``
stores ``kernel`` as (kh, kw, in, out), ``nn.Conv2d`` its ``weight`` as (out,
in, kh, kw): ``weight = kernel.transpose(3, 2, 0, 1)``.  The auto-decoder's
tree ``{"model": {"coarse_mlp", "fine_mlp"}, "code_library": {...}}`` becomes
the flat ``model.*`` / ``code_library.*`` state dict of ``AutoDecoderSystem``;
the auto-encoder's adds ``encoder.*``, ``joint_state.*`` and
``deg_embedding.*``.

Going back, ``tree_to_flax`` tells the leaves apart by what they were in
flax: a 4-D ``weight`` is a conv ``kernel``, and the ``weight`` of a module
that is a flax ``nn.Embed`` in the JAX package (``FLAX_EMBEDS``) an
``embedding``; every other ``weight`` is a dense ``kernel``.

The transpose that carries a kernel carries its gradient and its Adam moments
too, so ``params_from_flax`` and ``tree_to_flax`` serve any tree of the
params' structure (params, gradients, ``mu``, ``nu``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_LEAF = {"kernel": "weight", "bias": "bias", "embedding": "weight"}
# the modules that are flax ``nn.Embed``s: the code library's three tables
# (``aon_tpu/models/code_library.py``) and the auto-encoder's degree table
# (``aon_tpu/train/system_ae.py::DegEmbedding``)
FLAX_EMBEDS = frozenset({"embedding_instance_shape", "embedding_instance_appearance",
                         "embedding_instance_articulation", "deg_embedding"})
# flax conv kernel (kh, kw, in, out) <-> torch conv weight (out, in, kh, kw)
_CONV_TO_TORCH, _CONV_TO_FLAX = (3, 2, 0, 1), (2, 3, 1, 0)


def params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Nested dicts of numpy arrays in the flax layout (params, or gradients
    or Adam moments of the same structure) -> a torch state dict."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], prefix: str) -> None:
        for name, value in node.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{name}.")
                continue
            if name not in _LEAF:
                raise KeyError(f"unexpected flax leaf {prefix}{name}")
            arr = np.asarray(value, dtype=np.float32)
            if name == "kernel":
                arr = arr.transpose(_CONV_TO_TORCH) if arr.ndim == 4 else arr.T
            out[prefix + _LEAF[name]] = torch.from_numpy(np.array(arr, order="C"))

    walk(tree, "")
    return out


def load_npz(path: str) -> Dict[str, torch.Tensor]:
    """A flax params tree saved flat with ``/``-joined keys -> a torch state dict."""
    tree: Dict[str, Any] = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return params_from_flax(tree)


def tree_to_flax(flat: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of ``params_from_flax``: a ``{name: tensor}`` tree (params,
    gradients, moments) -> nested dicts of numpy arrays in the flax layout."""
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        *parents, leaf = key.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        arr = value.detach().cpu().numpy()
        if leaf == "weight" and parents and parents[-1] in FLAX_EMBEDS:
            node["embedding"] = np.array(arr, order="C")
        elif leaf == "weight":
            kernel = arr.transpose(_CONV_TO_FLAX) if arr.ndim == 4 else arr.T
            node["kernel"] = np.array(kernel, order="C")
        else:
            node[leaf] = np.array(arr, order="C")
    return tree
