"""Port parity, the benchmark entry points: the kernel bench's variants
(kernel table rows 12 and 13, and row 14's test wrapper) against the JAX
bench's kernels run in interpret mode on the CPU or against the JAX pieces
their kernel bodies call; the bench's batch, its superbatch layout and the
per-ray-interval training it measures against the JAX systems; and both
scripts' ``main`` on the CPU.

Tolerances, and why:
  * row 12 (``_make_fwd``), each body, raw outputs against the JAX kernel in
    interpret mode with the same bf16 weights: 5e-3 absolute, as row 5's twin
    (tests/test_torch_ops_api.py): each layer rounds to bf16 and the sums run
    in another order, so a value on a rounding boundary lands on the other
    side and carries that step on (seen 1.3e-3 for base and 2s; 6e-8 for
    bf16acc, whose every product XLA also rounds from a float32 sum); and
    1e-4 on the mean error, the card's TWIN_TOL_MEAN (seen 7.8e-6 and
    1.3e-9).  The mean tells the roundings apart where the largest error does
    not: the base twin is 5.9e-3 / 1.1e-3 (max / mean) from the bf16acc
    kernel, so it would pass the first limit and fails the second;
  * row 13 (``bench_xyz_body``), the encodings against the JAX encoders in
    float32: 2e-4 for the elementwise and MXU encoders, the in-kernel
    encoding's bound (tests/test_torch_kernels.py: XLA contracts the range
    reduction into an FMA in some compilations); 1e-3 for the doubling
    encoder (seen 6.4e-4), whose nine doublings carry those differences up by
    2^9; the padding columns exact.  Raw outputs through ``_mlp_compute``:
    5e-3, as row 1's;
  * row 14's wrapper (``tests_tpu/test_kernel_parity.py``), the twin of each
    encoder against the exact sine in float64 on the TPU test's inputs: 2e-3,
    that test's bound;
  * the bench's batch: bit-identical (the same numpy draws);
  * the per-ray interval ladder ``near * (1 - t) + far * t``: bit-identical
    to JAX run op by op; within 1 ulp of t (4.8e-7 below 8) of JAX under
    ``jit``, which contracts ``far * t`` into a fused multiply-add on ~11-18%
    of the entries; the jittered samples within 2 ulps (1e-6);
  * one ``train_step`` with per-ray intervals at the bench's sample counts
    against the JAX systems (plain float32 routes): the measures of
    tests/test_torch_train_step.py and tests/test_torch_art_step.py: loss
    1e-5 (vanilla) and 1e-4 (auto-decoder) relative, coarse gradients 1e-2 /
    2e-3 (vanilla) and 5e-2 / 1e-2 (auto-decoder) of each tensor's largest
    and mean magnitude; fine gradients by direction (cosine >= 0.9) and size
    (norm ratio 0.8..1.25): the fine samples move with the coarse weights'
    last bits, more so on the short intervals of the occupancy contract.
"""

import json
import os
import sys
from pathlib import Path

os.environ.setdefault("AON_PALLAS_INTERPRET", "1")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from aon_tpu.core import sampling as jax_sampling  # noqa: E402
from aon_tpu.models.mlp import NeRFMLP as FlaxMLP  # noqa: E402
from aon_tpu.ops import fused_mlp as jfm  # noqa: E402
from aon_tpu.parallel import get_mesh  # noqa: E402
from aon_tpu.parallel import stack_step_batches as jax_stack_step_batches  # noqa: E402
from aon_tpu.train.systems import AutoDecoderSystem as JaxAutoDecoderSystem  # noqa: E402
from aon_tpu.train.systems import VanillaSystem as JaxVanillaSystem  # noqa: E402
from aon_tpu.utils.config import Config as JaxConfig  # noqa: E402
from aon_tpu_torch.core import sampling  # noqa: E402
from aon_tpu_torch.models.convert import params_from_flax  # noqa: E402
from aon_tpu_torch.ops import bench_variants as bv  # noqa: E402
from aon_tpu_torch.ops.fused_mlp import make_posenc_constants, pack_vanilla_mlp_params  # noqa: E402
from aon_tpu_torch.scripts import bench as port_bench  # noqa: E402
from aon_tpu_torch.scripts import bench_kernels as port_bench_kernels  # noqa: E402
from aon_tpu_torch.train.microbatch import accumulated_grads, stack_step_batches  # noqa: E402
from aon_tpu_torch.train.systems import build_system  # noqa: E402
from aon_tpu_torch.utils.config import Config  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
sys.path.insert(0, str(ROOT))
import bench as jax_bench  # noqa: E402
import bench_kernels as jax_bench_kernels  # noqa: E402

TOL_BF16 = 5e-3
TOL_BF16_MEAN = 1e-4
TOL_ENC = {"elementwise": 2e-4, "mxu": 2e-4, "doubling": 1e-3}
JAX_ENCODERS = {"elementwise": jfm._encode_in_kernel, "mxu": jax_bench_kernels._encode_mxu,
                "doubling": jax_bench_kernels._encode_doubling}
JAX_BODIES = {"base": jfm._mlp_body, "2s": jax_bench_kernels._mlp_body_2s,
              "bf16acc": jax_bench_kernels._mlp_body_bf16acc}
ULP_T = 2.0 ** -21  # an ulp of float32 in [4, 8)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_bench_main_prints_the_jax_schema(capsys):
    with pytest.raises(RuntimeError, match="CUDA"):
        if not torch.cuda.is_available():
            port_bench.main(["--headline_only"])
        else:
            raise RuntimeError("CUDA present: the default runs there")
    res = port_bench.main(["--batch", "256", "--headline_only"], device="cpu")
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert len(lines) == 1 and set(lines[0]) == {"metric", "value", "unit", "vs_baseline"}
    assert lines[0]["metric"] == "train_rays_per_sec" and lines[0]["unit"] == "rays/s"
    assert lines[0]["vs_baseline"] == round(lines[0]["value"] / 25000.0, 3)
    r = res["vanilla"]
    assert r["samples"] == [16, 32] and r["tight"] == "occ" and r["final_step"] == 48
    assert all(np.isfinite(r["dispatch_losses"]))
    assert r["dispatch_losses"][-1] < r["dispatch_losses"][0]  # the same batch repeats


def test_bench_kernels_runs_every_variant():
    # every variant's twins on the CPU at a small shape (no time is given
    # there); main picks variants by the JAX bench's names
    lines = [port_bench_kernels.run_variant(name, torch.device("cpu"), rows=128, calls=1)
             for name in port_bench_kernels.VARIANTS]
    # the eval kernel's variants and the training kernels' both run 128-row tiles
    eval_only = {n for n, (kind, _, opts) in port_bench_kernels.VARIANTS.items()
                 if kind in ("fwd", "xyz") or opts.get("part") == "fwd"}
    assert eval_only == {"fwdxyz512", "fwdxyz1024", "body_base512", "body_2s512", "body_2s1024",
                         "body_bf16acc512", "xyzbody_base512", "xyzbody_mxu512",
                         "xyzbody_doubling512"}
    assert all(ln["tile"] == 128 and "tflops" not in ln for ln in lines)
    assert port_bench_kernels.JAX_BENCH_MACS_PER_SAMPLE == jax_bench_kernels.MACS_PER_SAMPLE
    assert {n: v[1] for n, v in port_bench_kernels.VARIANTS.items() if not n.startswith("xyz")} \
        == {"fwdxyz512": 512, "fwdxyz1024": 1024, "bwd512f32": 512, "bwd512bf16": 512,
            "bwd640bf16": 640, "bwd768bf16": 768, "step512f32": 512, "body_base512": 512,
            "body_2s512": 512, "body_2s1024": 1024, "body_bf16acc512": 512, "train512": 512}
    with pytest.raises(SystemExit, match="unknown variants"):
        port_bench_kernels.main(["body_3s512"], device="cpu")


@pytest.fixture(scope="module")
def packed():
    """The bench's bf16 packing (``_params``) of one flax MLP, in both packages."""
    variables = FlaxMLP().init(jax.random.PRNGKey(0), jnp.zeros((2, 4, 63)), jnp.zeros((2, 27)))
    packed_j = jfm.pack_vanilla_mlp_params(variables["params"], dtype=jnp.bfloat16)
    packed_j = {k: (v.reshape(1, -1) if v.ndim == 1 else v) for k, v in packed_j.items()}
    packed_t = pack_vanilla_mlp_params(params_from_flax(jax.tree.map(np.asarray,
                                                                     variables["params"])))
    for k, v in packed_j.items():  # the same values on both sides
        np.testing.assert_array_equal(np.asarray(v.astype(jnp.float32)).reshape(-1),
                                      packed_t[k].float().numpy().reshape(-1))
    return packed_j, packed_t


@pytest.mark.parametrize("body", bv.BODIES)
def test_mlp_body_twin_matches_the_jax_bench_kernel(packed, body):
    packed_j, packed_t = packed
    g = np.random.default_rng(0)
    enc = g.normal(size=(256, 64)).astype(np.float32)
    venc = g.normal(size=(256, 32)).astype(np.float32)
    want = np.asarray(jax_bench_kernels._make_fwd(JAX_BODIES[body], 64)(
        packed_j, jnp.asarray(enc), jnp.asarray(venc)))
    before = bv.MLP_BODY[body].launches
    rgb, sigma = bv.MLP_BODY[body](packed_t, _t(enc), _t(venc))  # CPU tensors: the twin
    assert bv.MLP_BODY[body].launches == before
    got = torch.cat([rgb, sigma], -1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_BF16)
    assert np.abs(got - want).mean() <= TOL_BF16_MEAN
    # the check tells the roundings apart: the twin of the other rounding
    # (base for bf16acc, bf16acc for the others) misses this kernel's output
    other = "base" if body == "bf16acc" else "bf16acc"
    wrong = torch.cat(bv.mlp_body_plain(_t(enc), _t(venc), packed_t, other), -1).numpy()
    assert np.abs(wrong - want).mean() > 5 * TOL_BF16_MEAN


@pytest.mark.parametrize("encoder", bv.ENCODERS)
def test_xyz_body_twin_matches_the_jax_bench_pieces(packed, encoder):
    packed_j, packed_t = packed
    g = np.random.default_rng(0)
    n = 256
    xyz4 = np.pad(g.normal(size=(n, 3)), ((0, 0), (0, 1))).astype(np.float32)
    vdir4 = np.pad(g.normal(size=(n, 3)), ((0, 0), (0, 1))).astype(np.float32)
    consts_j, consts_t = jfm.make_posenc_constants(), make_posenc_constants(device="cpu")
    encode = JAX_ENCODERS[encoder]
    for x4, s, p, n_real in ((xyz4, "s_pos", "p_pos", 63), (vdir4, "s_view", "p_view", 27)):
        want = np.asarray(encode(jnp.asarray(x4), consts_j[s], consts_j[p], jnp.float32))
        got = bv.encode_plain(_t(x4[:, :3]), consts_t[s], consts_t[p], encoder).numpy()
        np.testing.assert_allclose(got[:, :n_real], want[:, :n_real], rtol=0,
                                   atol=TOL_ENC[encoder])
        np.testing.assert_array_equal(got[:, n_real:], want[:, n_real:])  # the padding
    enc = encode(jnp.asarray(xyz4), consts_j["s_pos"], consts_j["p_pos"], jnp.bfloat16)
    venc = encode(jnp.asarray(vdir4), consts_j["s_view"], consts_j["p_view"], jnp.bfloat16)
    want = np.asarray(jfm._mlp_compute(enc, venc, packed_j))
    rgb, sigma = bv.XYZ_BODY[encoder](packed_t, consts_t, _t(xyz4[:, :3]), _t(vdir4[:, :3]))
    np.testing.assert_allclose(torch.cat([rgb, sigma], -1).numpy(), want, rtol=0, atol=TOL_BF16)


@pytest.mark.parametrize("encoder", bv.ENCODERS)
def test_row14_posenc_twin_against_the_exact_sine(encoder):
    # tests_tpu/test_kernel_parity.py::test_in_kernel_posenc_range_reduction's
    # inputs and bound; on the CPU the wrapper runs the encoder's twin
    from aon_tpu_torch.ops.fused_mlp_train import posenc_in_kernel

    x = np.random.default_rng(1).uniform(-6, 6, (256, 3)).astype(np.float32)
    consts = make_posenc_constants(device="cpu")
    for s, p, n_real in (("s_pos", "p_pos", 63), ("s_view", "p_view", 27)):
        before = posenc_in_kernel.launches
        got = posenc_in_kernel(_t(x), consts[s], consts[p], encoder).numpy()
        assert posenc_in_kernel.launches == before
        pre = x.astype(np.float64) @ consts[s].double().numpy()[:3] + consts[p].double().numpy()
        exact = np.where(np.arange(pre.shape[1]) < 3, pre, np.sin(pre))
        assert np.abs(got[:, :n_real] - exact[:, :n_real]).max() <= 2e-3
        pad = x[:, (np.arange(n_real, pre.shape[1]) - 3) % 3] if encoder == "doubling" else 0.0
        np.testing.assert_array_equal(got[:, n_real:], np.broadcast_to(pad, got[:, n_real:].shape))


@pytest.mark.parametrize("tight,seed", [("occ", 0), ("aabb", 1), (False, 0)])
def test_synthetic_batch_is_the_jax_bench_batch(tight, seed):
    want = jax_bench._synthetic_batch(512, tight, seed=seed)
    got = port_bench._synthetic_batch(512, tight, seed=seed)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_stack_step_batches_gives_the_jax_layout():
    host = jax_bench._synthetic_batch(64, "aabb", seed=1)
    host["instance_id"] = np.int32(0)
    host["articulation_id"] = np.int32(1)
    batches = [host, dict(host, target=host["target"] + 1.0)]
    want = jax_stack_step_batches(batches, get_mesh(1), microbatch=16)
    got = stack_step_batches(batches, microbatch=16, device="cpu")
    assert set(got) == set(want)
    assert got["rays_o"].shape == (2, 4, 16, 3) and got["t_near"].shape == (2, 4, 16)
    assert got["instance_id"].shape == (2,)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    with pytest.raises(ValueError, match="divisible"):
        stack_step_batches(batches, microbatch=24, device="cpu")


@pytest.mark.parametrize("tight,n_samples", [("occ", 16), ("occ", 48), ("aabb", 24),
                                             ("aabb", 72)])
def test_per_ray_interval_ladder_matches_xla(tight, n_samples):
    # the stratified ladder of the bench's contracts: 17 and 49 samples a ray
    # (vanilla, occupancy intervals), 25 and 73 (auto-decoder, AABB)
    b = jax_bench._synthetic_batch(1024, tight, seed=2)
    o, d = jnp.asarray(b["rays_o"]), jnp.asarray(b["rays_d"])
    near, far = jnp.asarray(b["t_near"]), jnp.asarray(b["t_far"])
    key = jax.random.PRNGKey(3)
    t_rand = np.asarray(jax.random.uniform(key, (1024, n_samples + 1), dtype=jnp.float32))
    got, _ = sampling.sample_along_rays(_t(b["rays_o"]), _t(b["rays_d"]), n_samples,
                                        _t(b["t_near"]), _t(b["t_far"]))
    eager, _ = jax_sampling.sample_along_rays(key, o, d, n_samples, near, far, randomized=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(eager))
    for r, tol in ((False, ULP_T), (True, 2 * ULP_T)):
        want = np.asarray(jax.jit(lambda o, d, r=r: jax_sampling.sample_along_rays(
            key, o, d, n_samples, near, far, randomized=r)[0])(o, d))
        got, _ = sampling.sample_along_rays(_t(b["rays_o"]), _t(b["rays_d"]), n_samples,
                                            _t(b["t_near"]), _t(b["t_far"]), randomized=r,
                                            t_rand=_t(t_rand))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


def _fine_direction(got, want, prefix):
    for k in want:
        if k.startswith(prefix):
            a, b = got[k].reshape(-1), want[k].reshape(-1)
            assert (a @ b / (a.norm() * b.norm())).item() >= 0.9, k
            assert 0.8 <= (a.norm() / b.norm()).item() <= 1.25, k


def _errors(got, want, prefix):
    names = [k for k in want if k.startswith(prefix)]
    max_rel = max(((got[k] - want[k]).abs().max() / want[k].abs().max().clamp_min(1e-30)).item()
                  for k in names)
    mean_rel = max(((got[k] - want[k]).abs().mean() / want[k].abs().mean().clamp_min(1e-30)).item()
                   for k in names)
    return max_rel, mean_rel


@pytest.mark.parametrize("system", ["vanilla", "autodecoder"])
def test_train_step_with_per_ray_intervals_matches_jax(system):
    # the bench's contracts at 64 rays: vanilla 16 + 32 samples on occupancy
    # intervals, the auto-decoder 24 + 48 on AABB intervals
    B = 64
    if system == "vanilla":
        kw = dict(N_samples=16, N_importance=32, use_pallas=False, compute_dtype="float32")
        jsys = JaxVanillaSystem(JaxConfig(**kw), 2.0, 6.0, True)
        batch = jax_bench._synthetic_batch(B, "occ", seed=4)
        tols, loss_rtol, coarse = (1e-2, 2e-3), 1e-5, "coarse_mlp."
    else:
        kw = dict(exp_type="vanilla_autodecoder", N_samples=24, N_importance=48, N_max_objs=4,
                  white_back=False, use_pallas=False, compute_dtype="float32")
        jsys = JaxAutoDecoderSystem(JaxConfig(**kw), 2.0, 6.0, False)
        batch = jax_bench._synthetic_batch(B, "aabb", seed=5)
        batch.update(instance_id=np.int32(1), articulation_id=np.int32(2))
        tols, loss_rtol, coarse = (5e-2, 1e-2), 1e-4, "model.coarse_mlp."
    key = jax.random.PRNGKey(11)
    keys = jax.random.split(key, 4)  # one key per level and purpose
    draws = {"t_rand": _t(jax.random.uniform(keys[0], (B, kw["N_samples"] + 1),
                                             dtype=jnp.float32)),
             "u": _t(jax.random.uniform(keys[2], (B, kw["N_importance"]), dtype=jnp.float32))}
    jstate = jsys.init_state(jax.random.PRNGKey(0))
    params = params_from_flax(jax.tree.map(np.asarray, jstate.params))
    jstate, jmetrics = jsys.train_step(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    # after the first step mu = (1 - b1) * g: the step's own gradients
    want = {k: 10.0 * v for k, v in params_from_flax(
        jax.tree.map(np.asarray, jstate.opt_state[0].mu)).items()}

    port = build_system(Config(**kw), 2.0, 6.0, system == "vanilla", device="cpu")
    loss, _, grads = accumulated_grads(port.loss_fn, params, {k: _t(v) for k, v in batch.items()},
                                       None, draws)
    np.testing.assert_allclose(loss.item(), float(jmetrics["train/loss"]), rtol=loss_rtol)
    assert set(grads) == set(want)
    max_rel, mean_rel = _errors(grads, want, coarse)
    assert max_rel <= tols[0] and mean_rel <= tols[1], (max_rel, mean_rel)
    _fine_direction(grads, want, coarse.replace("coarse", "fine"))
