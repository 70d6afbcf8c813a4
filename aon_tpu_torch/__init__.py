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
schedule).  ROADMAP.md lists what is still to come.
"""
