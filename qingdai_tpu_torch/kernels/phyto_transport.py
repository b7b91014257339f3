"""Wrappers of kernel K5 (``csrc/phyto_transport.cu``): the chlorophyll
transport after the gather (blend, ∇² diffusion, ocean mask and clamp, the
polar ring means) in one launch; the batched form takes every member of an
ensemble in the same launch.

Replaces no TPU kernel: the JAX package leaves this chain to XLA's fusion.
Plain version ``ecology.phyto.phyto_transport_plain``.
"""

from __future__ import annotations

import torch

from . import launch, member_stride


def phyto_transport_cuda(C_phyto: torch.Tensor, C_adv: torch.Tensor, ocean: torch.Tensor,
                         coslat: torch.Tensor, alpha: float, K_h: float, dt: float,
                         dlat: float, dlon: float, a: float) -> torch.Tensor:
    """The transported chlorophyll [S, H, W] from C_phyto and the advected
    C_adv [S, H, W], the ocean mask (bool) and the capped cos map [H, W]."""
    if not isinstance(C_phyto, torch.Tensor) or C_phyto.dim() != 3:
        raise ValueError("C_phyto: expected an [S, H, W] CUDA tensor")
    out = _run(C_phyto, C_adv, ocean, coslat, alpha, K_h, dt, dlat, dlon, a, 1)[0]
    phyto_transport_cuda.launches += 1
    return out


phyto_transport_cuda.launches = 0


def phyto_transport_batched_cuda(C_phyto: torch.Tensor, C_adv: torch.Tensor,
                                 ocean: torch.Tensor, coslat: torch.Tensor, alpha: float,
                                 K_h: float, dt: float, dlat: float, dlon: float, a: float,
                                 n_members: int) -> torch.Tensor:
    """``phyto_transport_cuda`` for ``n_members`` members in one launch:
    C_phyto and C_adv [n_members, S, H, W], the mask and the cos map
    [n_members, H, W]; any of them may instead be one tensor without the
    member axis, shared by every member (read without a copy). Returns
    [n_members, S, H, W]; member b's result is ``phyto_transport_cuda`` of
    member b's inputs bit for bit."""
    if not isinstance(C_phyto, torch.Tensor) or C_phyto.dim() not in (3, 4):
        raise ValueError("C_phyto: expected an [n_members, S, H, W] or [S, H, W] CUDA tensor")
    out = _run(C_phyto, C_adv, ocean, coslat, alpha, K_h, dt, dlat, dlon, a, int(n_members))
    phyto_transport_batched_cuda.launches += 1
    return out


phyto_transport_batched_cuda.launches = 0


def _run(C_phyto, C_adv, ocean, coslat, alpha, K_h, dt, dlat, dlon, a, n_members):
    """The launch for ``n_members`` members (each input with or without the
    member axis): [n_members, S, H, W]. The Python numbers are formed as the
    plain version forms them (1 − α, α, dt·K_h in double); the kernel rounds
    them to the stack's type."""
    S, H, W = C_phyto.shape[-3:]
    if S == 0 or H < 3 or W < 3:
        raise ValueError(f"C_phyto: expected S >= 1 and H, W >= 3, got {tuple(C_phyto.shape)}")
    if W > 2048:
        raise ValueError(f"C_phyto: {W} columns exceed the kernel's 2048 (512 threads of 4)")
    T = C_phyto.dtype
    strides = [member_stride(t, name, dtype, shape, n_members)
               for t, name, dtype, shape in ((C_phyto, "C_phyto", T, (S, H, W)),
                                             (C_adv, "C_adv", T, (S, H, W)),
                                             (ocean, "ocean", torch.bool, (H, W)),
                                             (coslat, "coslat", T, (H, W)))]
    if any(t.device != C_phyto.device for t in (C_adv, ocean, coslat)):
        raise ValueError("C_phyto, C_adv, ocean and coslat must be on one device")
    out = torch.empty((n_members, S, H, W), dtype=T, device=C_phyto.device)
    launch("qd_phyto_transport", T, C_phyto.device, C_phyto.data_ptr(), C_adv.data_ptr(),
           ocean.data_ptr(), coslat.data_ptr(), out.data_ptr(), n_members, *strides, S, H, W,
           int(K_h > 0.0), float(1.0 - alpha), float(alpha), float(dt * K_h), float(dlat),
           float(dlon), float(a))
    return out
