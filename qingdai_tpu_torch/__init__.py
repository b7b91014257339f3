"""PyTorch / CUDA port of the Qingdai climate engine.

The JAX package ``qingdai_tpu`` is the reference; this package keeps its
module and function names so each counterpart can be found by name. It
imports ``torch`` and never ``jax``. The JAX-free modules of the reference
(``qingdai_tpu.config``, ``qingdai_tpu.constants``, ``qingdai_tpu.topography``)
are reused as they are.

Dispatch is by device: a CUDA tensor goes to the hand-written kernel in
``kernels/`` (sources in ``csrc/``), a CPU tensor to the plain PyTorch version
beside it. Entry point: :func:`qingdai_tpu_torch.entry.build_world`.
"""
