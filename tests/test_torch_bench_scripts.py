"""Port parity of the benchmark and profiling scripts: ``bench_eval``,
``bench_art``, ``profile_ae_host`` and ``roofline_ae`` of
``aon_tpu_torch/scripts`` against the JAX scripts of ``scripts/`` (CPU).

Tolerances, and why:
  * ``bench_eval``: the reference frame's rays and their edge-padded chunks
    as the JAX script hands them to ``render_chunk`` (captured), atol 0 (the
    same numpy); a 1,024-ray chunk of them through the contract's system in
    float32 from one set of weights against the JAX system's render run op by
    op, comp_rgb and acc 1e-4, depth 1e-3 (tests/test_torch_render.py's
    system tolerances; seen 4e-6, 7e-6, 3e-5).  XLA's compiled render fuses
    the sample points' ``o + t d`` into fused multiply-adds and lies 1.0e-4
    from its own op-by-op render in comp_rgb (1.7e-4 in acc), as far as from
    the port; the bf16 route is held to the float32 one on the card by
    chip_smoke.  The production mode's ``hit_frac``, chunk, frame length and
    keys on a 64x48 ``use_aabb`` fixture, exact;
  * ``bench_art``: the host batch and the ``Config`` as the JAX script builds
    them (captured at ``stack_step_batches``), exact; a run of the port at 16
    rays (the plain route; 64 rays at 64 + 128 samples take ~2 s a step on one
    CPU thread) prints one finite line with the JAX line's keys;
  * ``profile_ae_host``: on a ``--multi`` fixture with a smoke AE config cut
    to 64 rays and one step a dispatch, the report's keys a superset of the
    JAX script's (read from its source) and every rate above 0;
  * ``roofline_ae``: the encoder's forward FLOPs at a 64x48 input.  The
    counter's are exactly two a multiply-add of every convolution's whole
    window and every matmul (684.8M); XLA's ``cost_analysis`` of the JAX
    encoder (through the JAX script's ``_flops_of``) counts only the taps
    that land inside the unpadded input, plus the elementwise work (433.6M):
    at 64x48 the padding is a third of layer4's 2x2 maps, so the two differ
    by 37%.  The test counts both kinds of taps of the convolutions the port
    runs and holds the counter to the whole windows exactly and XLA to the
    valid taps within 2% (the norms, relus, pools and adds); and a run at
    tiny sizes whose report holds the JAX script's keys.
"""

import dataclasses
import importlib.util
import io
import json
import math
import re
import shutil
import sys
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import aon_tpu.parallel as jparallel
import aon_tpu.train.systems as jsystems
from aon_tpu.models.joint_state import JointStateDecoder as JaxJointState
from aon_tpu.models.resnet import ImgEncoderMultiHeadArt as JaxEncoder
from aon_tpu.utils.config import Config as JaxConfig
from aon_tpu_torch.models.convert import tree_to_flax
from aon_tpu_torch.models.joint_state import JointStateDecoder
from aon_tpu_torch.models.resnet import ImgEncoderMultiHeadArt
from aon_tpu_torch.scripts import (
    bench_art,
    bench_eval,
    make_fixture_dataset,
    profile_ae_host,
    roofline_ae,
)
from aon_tpu_torch.train.systems import VanillaSystem
from aon_tpu_torch.utils.config import Config

REPO = Path(__file__).resolve().parent.parent


def jax_script(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def report_keys(name: str) -> set:
    """The keys of the JAX script's report, from its source."""
    src = (REPO / "scripts" / f"{name}.py").read_text()
    head = re.search(r"report = \{(.*?)\}", src, re.S).group(1)
    return set(re.findall(r'"(\w+)":', head)) | set(re.findall(r'report\["(\w+)"\] =', src))


class _Captured(Exception):
    pass


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------- bench_eval


def test_bench_eval_reference_rays_match_the_jax_script(monkeypatch, capsys):
    chunk = 100_000  # four chunks, the last edge-padded
    pieces = []

    class Recorder:
        def __init__(self, *args, **kwargs):
            pass

        def init_state(self, key):
            return type("State", (), {"params": None})()

        def render_chunk(self, params, piece):
            pieces.append({k: np.asarray(v) for k, v in piece.items()})
            return {"comp_rgb": jnp.zeros((piece["rays_o"].shape[0], 3))}

    mod = jax_script("bench_eval")
    monkeypatch.setattr(mod, "VanillaSystem", Recorder)
    mod.bench_reference_contract(chunks=(chunk,))
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert set(line) == {"chunk", "frame_ms", "frames_per_sec"}
    rays = {k: torch.from_numpy(v) for k, v in bench_eval.reference_frame().items()}
    got = bench_eval.chunk_pieces(rays, chunk)
    assert len(pieces) == 4 * len(got) == 16  # a warm frame and three timed ones
    for want, mine in zip(pieces[:4], got):
        assert set(mine) == set(want)
        for k in want:
            np.testing.assert_array_equal(mine[k].numpy(), want[k], err_msg=k)


def test_bench_eval_contract_chunk_matches_jax_render():
    cfg = Config(compute_dtype="float32")
    tsys = VanillaSystem(cfg, near=2.0, far=6.0, white_bkgd=True, device="cpu")
    params = tsys.init_state(torch.Generator().manual_seed(0)).params
    rays = {k: v[:1024] for k, v in bench_eval.reference_frame().items()}
    got = tsys.render_chunk(params, rays)
    jsys = jsystems.VanillaSystem(JaxConfig(compute_dtype="float32"), near=2.0, far=6.0,
                                  white_bkgd=True)
    jparams = jax.tree.map(jnp.asarray, tree_to_flax(params))
    with jax.disable_jit():  # the port's arithmetic: XLA's compiled render fuses o + t d
        want = jsys.render_chunk(jparams, {k: jnp.asarray(v) for k, v in rays.items()})
    for k, atol in (("comp_rgb", 1e-4), ("acc", 1e-4), ("depth", 1e-3)):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=atol,
                                   err_msg=k)


@pytest.fixture(scope="module")
def single_fixture(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench_single") / "data"
    make_fixture_dataset.main([str(root), "--n", "3", "--wh", "64", "48", "--seed", "2"])
    return root


def test_bench_eval_production_matches_the_jax_script(single_fixture, tmp_path, capsys):
    kw = dict(dataset_name="sapien", img_wh=[64, 48], white_back=True, use_aabb=True,
              N_samples=4, N_importance=4, compute_dtype="float32", chunk=512,
              config="configs/fixture.json")
    lines = {}
    for side, cls, bench in (("jax", JaxConfig, jax_script("bench_eval").bench_production),
                             ("port", Config, None)):
        root = tmp_path / side / "data"
        shutil.copytree(single_fixture, root)  # each package caches under the same names
        cfg = cls(root_dir=str(root), **kw)
        if bench is None:
            rec = bench_eval.bench_production(cfg, device="cpu")
        else:
            bench(cfg)
        lines[side] = json.loads(capsys.readouterr().out.splitlines()[-1])
    got, want = lines["port"], lines["jax"]
    assert set(got) == set(want)
    for k in ("mode", "config", "img_wh", "samples", "use_aabb", "hit_frac", "chunk"):
        assert got[k] == want[k], k
    assert rec["n_rays"] == 64 * 48 and rec["comp_rgb"].shape == (64 * 48, 3)
    assert 0 < rec["hit_frac"] < 1 and math.isfinite(got["frame_ms"])


def test_bench_eval_refuses_articulated_datasets(tmp_path):
    root = tmp_path / "multi"
    make_fixture_dataset.main([str(root), "--multi", "--n", "2", "--wh", "64", "48"])
    cfg = Config(dataset_name="sapien_multi", root_dir=str(root), img_wh=[64, 48])
    with pytest.raises(SystemExit, match="single-scene"):
        bench_eval.bench_production(cfg, device="cpu")


# ---------------------------------------------------------------- bench_art


def test_bench_art_batch_and_config_match_the_jax_script(monkeypatch):
    seen = {}

    class Recorder:
        def __init__(self, cfg, **kwargs):
            seen["cfg"] = cfg

        def init_state(self, key):
            return None

    def capture(batches, mesh, microbatch=None):
        seen.update(batches=batches, microbatch=microbatch)
        raise _Captured

    monkeypatch.setattr(jsystems, "AutoDecoderSystem", Recorder)
    monkeypatch.setattr(jparallel, "stack_step_batches", capture)
    argv = ["--batch", "64", "--fused", "v2", "--steps_per_dispatch", "3"]
    monkeypatch.setattr(sys, "argv", ["bench_art.py", *argv])
    with pytest.raises(_Captured):
        jax_script("bench_art").main()
    args = bench_art.build_parser().parse_args(argv)
    cfg = bench_art.bench_config(args.batch, args.fused)
    want_cfg = dataclasses.asdict(seen["cfg"])
    mine = dataclasses.asdict(cfg)
    assert {k: mine[k] for k in want_cfg if k in mine} == \
        {k: v for k, v in want_cfg.items() if k in mine}
    assert seen["microbatch"] == cfg.microbatch_rays
    assert len(seen["batches"]) == args.steps_per_dispatch
    batch = bench_art.host_batch(args.batch)
    for want in seen["batches"]:
        assert set(want) == set(batch)
        for k, v in want.items():
            assert np.asarray(batch[k]).dtype == np.asarray(v).dtype, k
            np.testing.assert_array_equal(batch[k], v, err_msg=k)


def test_bench_art_prints_one_finite_line_with_the_jax_keys():
    out = io.StringIO()
    with redirect_stdout(out):
        rec = bench_art.main(["--batch", "16", "--steps_per_dispatch", "2"], device="cpu")
    lines = [json.loads(ln) for ln in out.getvalue().splitlines()]
    assert lines[0] == {"card": "cpu"}
    assert set(lines[-1]) == {"metric", "value", "unit", "fused"}
    assert lines[-1]["metric"] == "art_train_rays_per_sec" and lines[-1]["fused"] == "v3"
    assert math.isfinite(lines[-1]["value"]) and lines[-1]["value"] > 0
    assert all(math.isfinite(v) for v in rec["losses"])


# ---------------------------------------------------------- profile_ae_host


def test_profile_ae_host_report_holds_the_jax_keys(tmp_path, monkeypatch):
    root = tmp_path / "data"
    make_fixture_dataset.main([str(root), "--multi", "--n", "2", "--wh", "64", "48"])
    cfg = json.loads((REPO / "configs" / "smoke_ae_art.json").read_text())
    cfg.update(root_dir=str(root), output_path=str(tmp_path / "results"), ray_batch_size=64,
               steps_per_dispatch=1, N_samples=4, N_importance=4)
    path = tmp_path / "smoke_ae.json"
    path.write_text(json.dumps(cfg))
    monkeypatch.chdir(tmp_path)
    report = profile_ae_host.main(["--config", str(path), "--dispatches", "1"], device="cpu")
    assert report_keys("profile_ae_host") <= set(report)
    for k in report:
        if k.endswith("_rays_per_sec"):
            assert report[k] > 0, k
    assert 0 < report["host_share_if_serial"] < 1
    assert report["card"] == "cpu" and report["dispatch_device_idle_share"] is None


# -------------------------------------------------------------- roofline_ae


def test_roofline_ae_encoder_flops_match_xla_cost_analysis():
    src = np.random.default_rng(0).normal(size=(1, 3, 48, 64)).astype(np.float32)
    enc, js = JaxEncoder(), JaxJointState()
    enc_params = jax.jit(enc.init)(jax.random.PRNGKey(0), src)["params"]
    lat = enc.apply({"params": enc_params}, src)
    js_params = jax.jit(js.init)(jax.random.PRNGKey(1), lat["articulation"])["params"]

    @jax.jit
    def fwd(p, x):
        lat = enc.apply({"params": p["encoder"]}, x)
        ps = js.apply({"params": p["joint_state"]}, lat["articulation"])
        return sum(jnp.sum(v) for v in lat.values()) + jnp.sum(ps)

    want = jax_script("roofline_ae")._flops_of(
        fwd, {"encoder": enc_params, "joint_state": js_params}, src)
    t_enc, t_js = ImgEncoderMultiHeadArt(), JointStateDecoder()
    x = torch.from_numpy(src)

    def port_fwd():
        with torch.no_grad():
            lat = t_enc(x)
            return sum(v.sum() for v in lat.values()) + t_js(lat["articulation"]).sum()

    got = roofline_ae._flops(port_fwd)
    taps = _Taps()
    with taps:
        port_fwd()
    assert want is not None and taps.whole > taps.valid > 0
    assert got == 2 * taps.whole, (got, taps.whole)
    assert abs(want - 2 * taps.valid) / want <= 0.02, (want, taps.valid)


class _Taps(TorchDispatchMode):
    """The multiply-adds of every convolution and matmul that runs: over whole
    windows (``whole``) and over the taps inside the unpadded input only
    (``valid``)."""

    def __init__(self):
        super().__init__()
        self.whole = self.valid = 0

    @staticmethod
    def _inside(n_in, n_out, k, stride, pad):
        return sum(1 for o in range(n_out) for t in range(k) if 0 <= o * stride - pad + t < n_in)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.ops.aten.convolution.default:
            x, w, _, stride, pad = args[:5]
            c_out, c_in, kh, kw = w.shape
            self.whole += out.shape[2] * out.shape[3] * c_out * c_in * kh * kw
            self.valid += c_out * c_in * (self._inside(x.shape[2], out.shape[2], kh, stride[0], pad[0])
                                          * self._inside(x.shape[3], out.shape[3], kw, stride[1],
                                                         pad[1]))
        elif func in (torch.ops.aten.addmm.default, torch.ops.aten.mm.default):
            a, b = args[-2:]
            self.whole += a.shape[0] * a.shape[1] * b.shape[1]
            self.valid += a.shape[0] * a.shape[1] * b.shape[1]
        return out


def test_roofline_ae_report_at_tiny_sizes(tmp_path):
    out = tmp_path / "roofline.json"
    args = roofline_ae.build_parser().parse_args(
        ["--N_samples", "4", "--N_importance", "4", "--dispatches", "1", "--out", str(out)])
    report = roofline_ae.measure(args, device="cpu", batch=64, steps_per_dispatch=1,
                                 img_wh=(64, 48))
    assert report_keys("roofline_ae") <= set(report)
    assert json.loads(out.read_text()) == json.loads(json.dumps(report))
    for k in ("ae_full_ms_per_dispatch", "enc_fwd_ms_per_dispatch",
              "enc_fwd_bwd_ms_per_dispatch", "autodec_body_ms_per_dispatch"):
        assert math.isfinite(report[k]) and report[k] > 0, k
    assert report["enc_fwd_bwd_flops_per_dispatch"] > 2 * report["enc_fwd_flops_per_dispatch"] > 0
    assert report["nerf_levels_flops_per_dispatch"] == roofline_ae.nerf_level_flops(64, 1, 4, 4)
    assert roofline_ae.ART_MACS_PER_SAMPLE == 692480
