"""aon_tpu_torch: the PyTorch + CUDA port of ``aon_tpu`` for one NVIDIA H100.

The JAX package ``aon_tpu`` stays the reference; this package mirrors its
module layout and imports nothing from it (nor JAX).  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; on the CPU every kernel
wrapper runs its plain PyTorch twin.

Ported so far: the vanilla two-level NeRF.  Rendering
(``train.systems.VanillaSystem.render_chunk`` -> ``ops.render_fused`` ->
the CUDA kernels in ``ops/csrc``), ``eval.render.render_frame`` and
``eval.metrics``; training (``VanillaSystem.init_state`` / ``train_step`` /
``train_many`` -> ``ops.train_fused_level`` or ``ops.train_pallas`` -> the
training kernels in ``ops/csrc/level_train.cu``, Adam with the log-lerp
schedule), trained on a single-scene SAPIEN dataset through the CLI
(``python -m aon_tpu_torch.run`` -> ``train.trainer.Trainer`` on
``data.sapien.SapienDataset``); the auto-decoder's system and kernels,
trained through the same CLI on the multi-instance articulated dataset
(``data.sapien_multi.SapienDatasetMulti``) and evaluated on its 19-frame
sweep (``scripts.render_sweep``, ``scripts.eval_per_instance``); the
auto-encoder on the same dataset (``train.system_ae``); LPIPS
(``eval.lpips``), the optimizer and scheduler factories (``train.optim``),
the profiling hooks (``utils.profiling``) and multi-process data-parallel
training and evaluation, one process per GPU (``parallel``,
``python -m torch.distributed.run``).  ROADMAP.md lists what is still to come.
"""
