"""Python wrappers of the hand-written CUDA kernels (sources in ``csrc/``):
five kernels, K1 the median of positives (``median_pos``), K2 the
semi-Lagrangian gather (``advect_bilinear``), K3 the ∇⁴ hyperdiffusion
(``hyper4``), K4 the ocean substeps (``ocean_substeps``) and K5 the
chlorophyll transport (``phyto_transport``).

Each wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, raises on anything else, allocates its outputs and scratch with
``torch.empty``, launches on PyTorch's current stream and raises if the
launcher returns a CUDA error. There is no fallback to the plain version;
the dispatch to the plain version for CPU tensors lives in ``ops/``.

Every wrapper carries a plain integer ``launches`` that it increments once
per call that launched its kernel, so a run can show that the main path went
through the kernels.
"""

from __future__ import annotations

import math

import torch

from .build import load_library

FLOAT_TYPES = {torch.float32: "_f32", torch.float64: "_f64"}


def use_kernel(t: torch.Tensor) -> bool:
    """Dispatch by device: True for a CUDA tensor (launch the kernel), False
    for a CPU tensor (run the plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got device {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def member_stride(t: torch.Tensor, name: str, dtype: torch.dtype, shape, n_members: int) -> int:
    """A batched form's input: an [n_members, *shape] tensor, each member's
    own, whose members' blocks are each contiguous at the tensor's member
    stride (a contiguous stack, or a slice of a larger one, read in place),
    or a [*shape] tensor shared by every member (stride 0, read without a
    copy). Each member's block is checked as ``check_tensor`` does."""
    if n_members < 1:
        raise ValueError(f"n_members must be >= 1, got {n_members}")
    shape = tuple(shape)
    if isinstance(t, torch.Tensor) and t.dim() == len(shape) + 1:
        if t.shape[0] != n_members:
            raise ValueError(f"{name}: expected {n_members} members, got shape {tuple(t.shape)}")
        check_tensor(t[0], name, dtype, shape)
        return t.stride(0) if n_members > 1 else math.prod(shape)
    check_tensor(t, name, dtype, shape)
    return 0


def launch(name: str, dtype: torch.dtype, device: torch.device, *args) -> None:
    """Call launcher ``name`` for ``dtype`` on ``device``'s current stream."""
    if dtype not in FLOAT_TYPES:
        raise TypeError(f"{name}: unsupported dtype {dtype}")
    fn = getattr(load_library(), name + FLOAT_TYPES[dtype])
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}{FLOAT_TYPES[dtype]}: CUDA error {rc}")


def wrappers() -> dict:
    """The kernel wrappers by kernel name: the five single forms, their
    batched forms (one launch for an ensemble's members) and the sharded
    forms of K2 and K4 (a rank of the longitude mesh; K4's launches two
    kernels a substep, each counted), each counted apart."""
    from .advect_bilinear import (advect_bilinear_batched_cuda, advect_bilinear_cuda,
                                  advect_bilinear_sharded_cuda)
    from .hyper4 import hyperdiffuse_batched_cuda, hyperdiffuse_cuda
    from .median_pos import median_pos_batched_cuda, median_pos_cuda
    from .ocean_substeps import (ocean_substep_sharded_cuda, ocean_substeps_batched_cuda,
                                 ocean_substeps_cuda)
    from .phyto_transport import phyto_transport_batched_cuda, phyto_transport_cuda
    return {"median_pos": median_pos_cuda, "advect_bilinear": advect_bilinear_cuda,
            "hyper4": hyperdiffuse_cuda, "ocean_substeps": ocean_substeps_cuda,
            "median_pos_batched": median_pos_batched_cuda,
            "advect_bilinear_batched": advect_bilinear_batched_cuda,
            "hyper4_batched": hyperdiffuse_batched_cuda,
            "ocean_substeps_batched": ocean_substeps_batched_cuda,
            "phyto_transport": phyto_transport_cuda,
            "phyto_transport_batched": phyto_transport_batched_cuda,
            "advect_bilinear_sharded": advect_bilinear_sharded_cuda,
            "ocean_substeps_sharded": ocean_substep_sharded_cuda}


def launch_counts() -> dict:
    return {name: w.launches for name, w in wrappers().items()}


def reset_launch_counts() -> None:
    for w in wrappers().values():
        w.launches = 0
