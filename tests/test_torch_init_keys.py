"""Port parity, the init: each system's ``init_state(key)`` against the JAX
system's ``init_state(key)`` from the same threefry key, at the smoke
configs' widths (CPU, float32), in the port's layout (``params_from_flax``).

Tolerances, and why:
  * the uniform-drawn tensors (the NeRF MLPs' xavier-uniform kernels, the
    code library's tables) and the zero biases: bit for bit;
  * the normal-drawn ones (the ResNet-34 encoder's and the joint-state
    head's ``lecun_normal`` kernels, a truncated normal; the degree table's
    normal): within INIT_RTOL of each tensor's largest magnitude (seen
    6.8e-7; ``torch.erfinv`` against XLA's float32 polynomial on the same
    uniforms, tests/test_torch_prng.py's NORMAL_RTOL).
"""

import numpy as np
import pytest
import torch

import jax
from aon_tpu.train.system_ae import AutoEncoderSystem as JaxAutoEncoderSystem
from aon_tpu.train.systems import AutoDecoderSystem as JaxAutoDecoderSystem
from aon_tpu.train.systems import VanillaSystem as JaxVanillaSystem
from aon_tpu.utils.config import Config as JaxConfig
from aon_tpu_torch.core import prng
from aon_tpu_torch.models.convert import params_from_flax
from aon_tpu_torch.train.systems import build_system
from aon_tpu_torch.utils.config import Config

INIT_RTOL = 2e-5
SMALL = dict(N_samples=8, N_importance=8, compute_dtype="float32", use_pallas=False)
SYSTEMS = {
    "vanilla": (JaxVanillaSystem, dict(SMALL), True),
    "vanilla_autodecoder": (JaxAutoDecoderSystem,
                            dict(SMALL, exp_type="vanilla_autodecoder"), False),
    # 64x48: the smallest frame whose layer4 maps are wider than one pixel
    "vanilla_ae_art": (JaxAutoEncoderSystem,
                       dict(SMALL, exp_type="vanilla_ae_art", img_wh=[64, 48]), False),
}
NORMAL_DRAWN = ("encoder.", "joint_state.", "deg_embedding.")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("exp_type", list(SYSTEMS))
def test_init_state_is_the_jax_systems_from_the_same_key(exp_type, monkeypatch):
    monkeypatch.delenv("AON_RESNET_WEIGHTS", raising=False)
    jcls, kw, white = SYSTEMS[exp_type]
    seed = 5
    jsys = jcls(JaxConfig(**kw), 2.0, 6.0, white)
    # jitted: the same draws, in seconds where flax's op-by-op init takes ~10
    jparams = jax.jit(lambda k: jsys.init_state(k).params)(jax.random.PRNGKey(seed))
    want = params_from_flax(jax.tree.map(np.asarray, jparams))
    system = build_system(Config(**kw), 2.0, 6.0, white, device="cpu")
    state = system.init_state(prng.key(seed))
    assert state.step == 0 and set(state.params) == set(want)
    for name, w in want.items():
        got = state.params[name].numpy()
        assert got.shape == tuple(w.shape), name
        if name.startswith(NORMAL_DRAWN) and name.endswith("weight"):
            w = w.numpy()
            assert np.abs(got - w).max() <= INIT_RTOL * np.abs(w).max(), name
        else:
            np.testing.assert_array_equal(got, w.numpy(), err_msg=name)
        assert all(torch.count_nonzero(m) == 0 for m in (state.mu[name], state.nu[name]))
