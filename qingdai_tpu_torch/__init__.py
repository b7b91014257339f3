"""PyTorch / CUDA port of the Qingdai climate engine.

The JAX package ``qingdai_tpu`` is the reference; this package keeps its
module and function names so each counterpart can be found by name. It
imports ``torch`` and never ``jax``, and nothing of the JAX package: the
JAX-free modules it needs (``constants``, ``config``, ``topography``,
``ecology/genes``, ``ecology/types``) are copies of its own, held equal to
the originals by the tests.

Dispatch is by device: a CUDA tensor goes to the hand-written kernel in
``kernels/`` (sources in ``csrc/``), a CPU tensor to the plain PyTorch version
beside it. Entry point: :func:`qingdai_tpu_torch.entry.build_world`, which
runs on the card unless the caller passes ``device="cpu"``.
"""
