"""The fused kernels' public entry points (port of ``aon_tpu/ops/__init__.py``).

Importing the package builds nothing: each kernel is compiled at its first
launch (``ops/_build.py``).
"""

from aon_tpu_torch.ops.fused_art import fused_art_mlp_eval, fused_art_mlp_train
from aon_tpu_torch.ops.fused_mlp import (
    fused_nerf_mlp,
    fused_nerf_mlp_per_ray,
    fused_nerf_mlp_xyz,
    make_posenc_constants,
    pack_vanilla_mlp_params,
    pack_vanilla_mlp_params_f32,
)
from aon_tpu_torch.ops.fused_mlp_train import fused_mlp_train_xyz, fused_nerf_mlp_xyz_eval
from aon_tpu_torch.ops.train_fused_level import fused_level_train_grads
from aon_tpu_torch.ops.train_fused_level_art import fused_level_train_art_grads

# The JAX package also re-exports the function ``fused_mlp_train`` here, which
# shadows its module of the same name.  This package does not: the name
# ``aon_tpu_torch.ops.fused_mlp_train`` stays the module, and the function is
# ``aon_tpu_torch.ops.fused_mlp_train.fused_mlp_train``.
__all__ = [
    "fused_level_train_grads",
    "fused_level_train_art_grads",
    "fused_nerf_mlp",
    "fused_nerf_mlp_per_ray",
    "fused_nerf_mlp_xyz",
    "fused_nerf_mlp_xyz_eval",
    "fused_mlp_train_xyz",
    "fused_art_mlp_train",
    "fused_art_mlp_eval",
    "make_posenc_constants",
    "pack_vanilla_mlp_params",
    "pack_vanilla_mlp_params_f32",
]
