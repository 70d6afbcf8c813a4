"""Port parity, the auto-encoder's models: ``models/resnet.py``,
``models/joint_state.py`` and the degree table of ``train/system_ae.py``
against the flax modules on converted weights, ``aggregate_views``,
``params_from_npz`` on a converted backbone, and ``params_from_flax`` /
``tree_to_flax`` on the auto-encoder's whole tree.

Tolerances, and why:
  * the encoder in float32 against flax on the same weights: 2e-4 of each
    head's largest magnitude (float32 convolutions summed in another order,
    through 36 instance norms that rescale each map to unit variance); in
    bf16 against flax in bf16: 5e-2 (two bf16 roundings of every layer's
    output apart, with the same float32 statistics);
  * a conv kernel with kh != kw and a square kernel with no spatial symmetry
    against ``flax.linen.Conv``: 1e-5 (one float32 convolution), while the
    kernel carried with the dense rule (``kernel.T``) misses by more than 1e-1;
  * the joint-state head: 1e-6 (three float32 dense layers);
  * the degree table's row index, ties at x.5 degrees and angles outside
    0..90 included: exact; the rows: bit for bit;
  * ``_encode`` as a whole against the JAX system's: latents 2e-4 of their
    scale as the encoder, ``pred_state`` 1e-5;
  * ``aggregate_views``: max exact, mean 1e-6 (another summation order);
    ``params_from_npz`` and the tree round trip: exact.
"""

import functools
import sys
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aon_tpu.models.joint_state import JointStateDecoder as FlaxJointState
from aon_tpu.models.resnet import ImgEncoderMultiHeadArt as FlaxEncoder
from aon_tpu.train.system_ae import AutoEncoderSystem as JaxAutoEncoderSystem
from aon_tpu.utils.config import Config as JaxConfig
from aon_tpu_torch.core import prng
from aon_tpu_torch.models.convert import params_from_flax, tree_to_flax
from aon_tpu_torch.models.joint_state import JointStateDecoder
from aon_tpu_torch.models.resnet import RESNET34_STAGES, ImgEncoderMultiHeadArt
from aon_tpu_torch.ops.render_fused import mlp_params
from aon_tpu_torch.train.system_ae import N_DEG_EMBEDDINGS, AutoEncoderSystem, deg_index
from aon_tpu_torch.train.systems import build_system
from aon_tpu_torch.utils.config import Config

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))
WH = (64, 48)  # the smallest frame whose layer4 maps are wider than one pixel
SMALL = dict(exp_type="vanilla_ae_art", N_samples=8, N_importance=8, img_wh=list(WH),
             compute_dtype="float32", use_pallas=False)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch: the suite runs these files beside
    others in parallel workers, where OpenMP threads of every worker
    oversubscribe the cores, and these small shapes gain nothing from them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_system():
    system = build_system(Config(**SMALL), 2.0, 6.0, False, device="cpu")
    return system, system.init_params(prng.key(0))


@pytest.fixture(scope="module")
def src():
    return np.random.default_rng(1).normal(size=(2, 3, WH[1], WH[0])).astype(np.float32)


def _head_close(got, want, tol):
    for k in ("color", "density", "articulation"):
        w = np.asarray(want[k], np.float32)
        err = np.abs(got[k].float().numpy() - w).max() / np.abs(w).max()
        assert err <= tol, (k, err)


def test_encoder_matches_flax_on_converted_weights(port_system, src):
    system, params = port_system
    enc = mlp_params(params, "encoder")
    tree = tree_to_flax(enc)
    assert set(jax.tree.map(np.shape, tree).keys()) >= {"conv1", "layer1", "layer3",
                                                         "color_layer4", "articulation_fc"}
    want = _jax_encode(params, src)[0]
    got = torch.func.functional_call(system.encoder, enc, (torch.from_numpy(src),))
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        "color": (2, 128), "density": (2, 128), "articulation": (2, 32)}
    assert all(v.dtype == torch.float32 for v in got.values())
    _head_close(got, want, 2e-4)
    # the NHWC layout the JAX module also takes gives the same encoding
    nhwc = torch.func.functional_call(system.encoder, enc,
                                      (torch.from_numpy(src).permute(0, 2, 3, 1),))
    for k in got:
        torch.testing.assert_close(nhwc[k], got[k], rtol=0, atol=0)


@functools.lru_cache(maxsize=None)
def _jax_system():
    return JaxAutoEncoderSystem(JaxConfig(**SMALL), 2.0, 6.0, False)


_ENCODED = {}


def _jax_encode(params, src):
    """The JAX system's ``_encode`` (jitted once) on ``src`` at 40 degrees,
    from ``params`` carried over: (latents, pred_state) as numpy."""
    if "out" not in _ENCODED:
        fn = jax.jit(_jax_system()._encode)
        lat, state = fn(jax.tree.map(jnp.asarray, tree_to_flax(params)), jnp.asarray(src),
                        jnp.asarray(np.float32(np.deg2rad(40.0))))
        _ENCODED["out"] = ({k: np.asarray(v) for k, v in lat.items()}, np.asarray(state))
    return _ENCODED["out"]


def test_encoder_in_bf16_matches_flax_in_bf16(port_system, src):
    """bf16 rounding alone moves a random-init ResNet-34's heads by about a
    tenth of their scale (the 2x2 layer4 maps' instance norms magnify it), and
    the two packages' bf16 convolutions round differently: the port's bf16
    encoding is held to the float32 one within twice the distance the JAX
    module's own bf16 encoding lies from it."""
    system, params = port_system
    enc = mlp_params(params, "encoder")
    tree = tree_to_flax(enc)
    want32 = _jax_encode(params, src)[0]
    want16 = jax.jit(FlaxEncoder(dtype=jnp.bfloat16).apply)({"params": tree}, jnp.asarray(src))
    port = ImgEncoderMultiHeadArt(dtype=torch.bfloat16)
    got = torch.func.functional_call(port, enc, (torch.from_numpy(src),))
    got32 = torch.func.functional_call(system.encoder, enc, (torch.from_numpy(src),))
    assert all(v.dtype == torch.float32 for v in got.values())  # the heads run in float32
    for k in got:
        scale = np.abs(np.asarray(want32[k])).max()
        port_err = np.abs(got[k].numpy() - np.asarray(want32[k])).max() / scale
        jax_err = np.abs(np.asarray(want16[k], np.float32) - np.asarray(want32[k])).max() / scale
        assert 1e-3 < port_err <= 2.0 * jax_err, (k, port_err, jax_err)  # bf16 is live
        assert not torch.equal(got[k], got32[k])


@pytest.mark.parametrize("kernel_size", [(3, 2), (3, 3)], ids=["3x2", "3x3"])
def test_conv_kernels_carry_their_spatial_axes(rng, kernel_size):
    conv = fnn.Conv(5, kernel_size, padding="VALID", use_bias=False)
    x = rng.normal(size=(2, 9, 7, 4)).astype(np.float32)  # NHWC
    kernel = rng.normal(size=(*kernel_size, 4, 5)).astype(np.float32)  # no spatial symmetry
    want = np.asarray(conv.apply({"params": {"kernel": jnp.asarray(kernel)}}, jnp.asarray(x)))
    weight = params_from_flax({"c": {"kernel": kernel}})["c.weight"]
    assert tuple(weight.shape) == (5, 4, *kernel_size)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = torch.nn.functional.conv2d(xt, weight).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_array_equal(tree_to_flax({"c.weight": weight})["c"]["kernel"], kernel)
    if kernel_size[0] == kernel_size[1]:  # the dense rule fits the shape, not the values
        dense = torch.from_numpy(np.ascontiguousarray(kernel.T))
        wrong = torch.nn.functional.conv2d(xt, dense).permute(0, 2, 3, 1).numpy()
        assert np.abs(wrong - want).max() > 1e-1


def test_joint_state_head_matches_flax(rng):
    x = rng.normal(size=(4, 32)).astype(np.float32)
    jmod = FlaxJointState()
    jparams = jmod.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"]
    want = np.asarray(jmod.apply({"params": jparams}, jnp.asarray(x)))
    head = JointStateDecoder()
    sd = params_from_flax(jax.tree.map(np.asarray, jparams))
    assert set(sd) == set(head.state_dict())
    got = torch.func.functional_call(head, sd, (torch.from_numpy(x),))
    assert got.shape == (4, 1)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6)


def _deg_inputs():
    """Joint angles in radians: float32 values whose float32 ``rad2deg`` is
    exactly x.5 degrees (the ties ``round`` breaks to even), whole degrees,
    and angles below 0 and above 90 degrees."""
    scale = np.float32(180.0 / np.pi)
    out = []
    for deg in (0.5, 1.5, 2.5, 40.5, 41.5, 89.5, 90.5):
        x = np.float32(np.deg2rad(deg))
        for _ in range(64):
            if np.float32(x * scale) == np.float32(deg):
                break
            x = np.nextafter(x, np.float32(np.inf) if x * scale < deg else np.float32(-np.inf),
                             dtype=np.float32)
        assert np.float32(x * scale) == np.float32(deg), deg
        out.append(x)
    out += [np.float32(np.deg2rad(d)) for d in (0.0, 10.0, 45.0, 90.0, 95.0, 180.0, -5.0)]
    return np.asarray(out, np.float32)


def test_degree_rows_match_the_jax_system(port_system, monkeypatch):
    system, params = port_system
    deg = _deg_inputs()
    want_idx = np.asarray(jnp.clip(jnp.round(jnp.rad2deg(jnp.asarray(deg))).astype(jnp.int32),
                                   0, N_DEG_EMBEDDINGS - 1))
    got_idx = deg_index(torch.from_numpy(deg)).numpy()
    np.testing.assert_array_equal(got_idx, want_idx)
    # ties go to the even neighbour: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, 40.5 -> 40, 41.5 -> 42
    assert got_idx[:7].tolist() == [0, 2, 2, 40, 42, 90, 90]
    assert got_idx[-3:].tolist() == [90, 90, 0]
    # the rows the JAX DegEmbedding returns for them, on the converted table
    jsys = _jax_system()
    table = tree_to_flax(mlp_params(params, "deg_embedding"))
    rows = np.asarray(jsys.deg_embedding.apply({"params": table}, jnp.asarray(want_idx)))
    got = torch.func.functional_call(system.deg_embedding, mlp_params(params, "deg_embedding"),
                                     (torch.from_numpy(got_idx),))
    np.testing.assert_array_equal(got.detach().numpy(), rows)


def test_encode_matches_the_jax_systems(port_system, src):
    system, params = port_system
    want_lat, want_state = _jax_encode(params, src)
    got_lat, got_state = system._encode(params, torch.from_numpy(src),
                                        torch.tensor(np.float32(np.deg2rad(40.0))))
    assert set(got_lat) == set(want_lat) == {"color", "density", "articulation",
                                             "articulation_deg"}
    _head_close(got_lat, want_lat, 2e-4)
    np.testing.assert_array_equal(got_lat["articulation_deg"].detach().numpy(),
                                  want_lat["articulation_deg"])
    assert got_state.shape == (2, 1)
    np.testing.assert_allclose(got_state.detach().numpy(), want_state, atol=1e-5)


@pytest.mark.parametrize("how", ["mean", "max"])
def test_aggregate_views_matches_flax(rng, how):
    outs = [{"color": rng.normal(size=(1, 4)).astype(np.float32),
             "articulation": rng.normal(size=(1, 2)).astype(np.float32)} for _ in range(3)]
    want = FlaxEncoder.aggregate_views([{k: jnp.asarray(v) for k, v in o.items()}
                                        for o in outs], how)
    got = ImgEncoderMultiHeadArt.aggregate_views(
        [{k: torch.from_numpy(v) for k, v in o.items()} for o in outs], how)
    for k in want:  # the mean sums in another order
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7)
    with pytest.raises(NotImplementedError):
        ImgEncoderMultiHeadArt.aggregate_views(outs, "median")


def _torchvision_state_dict(rng):
    """Random conv weights under torchvision resnet34's keys (OIHW)."""
    sd = {"conv1.weight": rng.normal(size=(64, 3, 7, 7))}
    cin = 64
    for layer, (n_blocks, ch) in enumerate(RESNET34_STAGES, start=1):
        for b in range(n_blocks):
            c_in = cin if b == 0 else ch
            sd[f"layer{layer}.{b}.conv1.weight"] = rng.normal(size=(ch, c_in, 3, 3))
            sd[f"layer{layer}.{b}.conv2.weight"] = rng.normal(size=(ch, ch, 3, 3))
            if b == 0 and layer > 1:
                sd[f"layer{layer}.{b}.downsample.0.weight"] = rng.normal(size=(ch, c_in, 1, 1))
        cin = ch
    return {k: v.astype(np.float32) for k, v in sd.items()}


def test_params_from_npz_matches_the_jax_loader(port_system, tmp_path, rng, monkeypatch):
    from convert_resnet_weights import convert_state_dict

    system, params = port_system
    npz = tmp_path / "resnet34.npz"
    np.savez(npz, **convert_state_dict(_torchvision_state_dict(rng)))
    enc = mlp_params(params, "encoder")
    got = ImgEncoderMultiHeadArt.params_from_npz(enc, str(npz))
    want = FlaxEncoder.params_from_npz(jax.tree.map(jnp.asarray, tree_to_flax(enc)), str(npz))
    want = params_from_flax(jax.tree.map(np.asarray, want))
    assert set(got) == set(want) == set(enc)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    # the trunk and every head's layer4 took the converted kernels; the fc layers did not
    for k in ("conv1.weight", "layer3.block5.conv2.weight", "color_layer4.block0.conv1.weight",
              "articulation_layer4.block2.conv2.weight"):
        assert not torch.equal(got[k], enc[k]), k
    assert torch.equal(got["color_layer4.block1.conv1.weight"],
                       got["density_layer4.block1.conv1.weight"])
    assert torch.equal(got["color_fc.weight"], enc["color_fc.weight"])
    # the system overlays it at init where AON_RESNET_WEIGHTS names it
    monkeypatch.setenv("AON_RESNET_WEIGHTS", str(npz))
    fresh = system.init_params(prng.key(4))
    assert torch.equal(fresh["encoder.layer2.block0.downsample.weight"],
                       got["layer2.block0.downsample.weight"])


def test_params_from_npz_rejects_bad_files(port_system, tmp_path):
    _, params = port_system
    enc = mlp_params(params, "encoder")
    np.savez(tmp_path / "bad.npz", **{"conv1/kernel": np.zeros((3, 3, 3, 64), np.float32)})
    with pytest.raises(ValueError, match="shape mismatch"):
        ImgEncoderMultiHeadArt.params_from_npz(enc, str(tmp_path / "bad.npz"))
    np.savez(tmp_path / "missing.npz", **{"layerX/kernel": np.zeros((1,), np.float32)})
    with pytest.raises(KeyError):
        ImgEncoderMultiHeadArt.params_from_npz(enc, str(tmp_path / "missing.npz"))


def test_tree_round_trip_is_bit_exact(port_system):
    """The AE's flax tree (the port's init params carried over) back and forth:
    every leaf bit for bit, conv kernels and the degree table included, and
    the JAX system's own tree has the same paths and shapes."""
    _, params = port_system
    tree = tree_to_flax(params)
    assert set(tree) == {"model", "encoder", "joint_state", "deg_embedding"}
    assert tree["deg_embedding"]["deg_embedding"]["embedding"].shape == (N_DEG_EMBEDDINGS, 32)
    assert tree["encoder"]["conv1"]["kernel"].shape == (7, 7, 3, 64)
    back = params_from_flax(tree)
    assert set(back) == set(params)
    for k in params:
        assert torch.equal(back[k], params[k]), k
    again = tree_to_flax(back)
    flat_a, flat_b = (jax.tree_util.tree_flatten_with_path(t)[0] for t in (tree, again))
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(flat_a, flat_b))
    jsys = _jax_system()
    shapes = jax.eval_shape(lambda k: jsys.init_state(k).params, jax.random.PRNGKey(0))
    assert jax.tree.map(lambda s: tuple(s.shape), shapes) == jax.tree.map(np.shape, tree)


def test_system_widths_are_the_published_configs():
    system = AutoEncoderSystem(Config(exp_type="vanilla_ae_art"), 2.0, 6.0, False, device="cpu")
    shapes = {k: tuple(v.shape) for k, v in system.init_params(prng.key(0)).items()}
    assert shapes["model.coarse_mlp.deform_0.weight"] == (128, 3 + 128 + 32)
    assert shapes["deg_embedding.deg_embedding.weight"] == (91, 32)
    assert shapes["encoder.color_fc.weight"] == (128, 512)
    assert shapes["encoder.articulation_fc.weight"] == (32, 512)
    assert shapes["joint_state.fc_joint_state.weight"] == (1, 32)
    assert not any(k.startswith("encoder.layer4") for k in shapes)
    assert system.sigma_act == "relu" and system.density_bias == 0.0
    soft = AutoEncoderSystem(Config(exp_type="vanilla_ae_art",
                                    ae_sigma_activation="softplus_bias"), 2.0, 6.0, False,
                             device="cpu")
    assert soft.sigma_act == "softplus_bias" and soft.density_bias == -1.0
    assert soft.model.sigma_activation == "softplus_bias" and soft.model.rgb_padding == 0.0
