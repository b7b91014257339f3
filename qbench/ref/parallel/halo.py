"""The single-rank forms of the port's mesh collectives: with no mesh every
collective is the local operation (the reference runs one planet whole)."""

from __future__ import annotations

import torch


def single(mesh) -> bool:
    if mesh is not None:
        raise ValueError("the reference runs no longitude mesh")
    return True


def seam_pad(x: torch.Tensor, k: int, side: str, mode: str) -> torch.Tensor:
    """The k columns beyond ``x``'s left or right edge under the seam's
    ``mode``: wrap (the other edge's), reflect (scipy's: the edge columns
    mirrored, edge included) or nearest (the edge column repeated)."""
    W = x.shape[-1]
    if mode == "wrap":
        return x[..., W - k:] if side == "left" else x[..., :k]
    if mode == "reflect":
        return torch.flip(x[..., :k] if side == "left" else x[..., W - k:], (-1,))
    if mode == "nearest":
        edge = x[..., :1] if side == "left" else x[..., W - 1:]
        return edge.repeat_interleave(k, dim=-1)
    raise ValueError(f"unknown seam mode {mode}")


def pad_lon(x: torch.Tensor, k: int, seam_mode: str, mesh) -> torch.Tensor:
    """[..., w] → [..., k + w + k] with ``seam_pad`` on both sides."""
    single(mesh)
    if k == 0:
        return x
    if k > x.shape[-1]:
        raise ValueError(f"a halo of {k} columns exceeds the {x.shape[-1]} columns")
    return torch.cat([seam_pad(x, k, "left", seam_mode), x,
                      seam_pad(x, k, "right", seam_mode)], dim=-1)


def all_gather_lon(x: torch.Tensor, mesh) -> torch.Tensor:
    single(mesh)
    return x


def all_reduce_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    single(mesh)
    return x


def gsum(x: torch.Tensor, mesh, dim=None) -> torch.Tensor:
    single(mesh)
    return torch.sum(x) if dim is None else torch.sum(x, dim=dim)


def gsums(parts, mesh) -> list:
    single(mesh)
    return list(parts)


def gmax(x: torch.Tensor, mesh) -> torch.Tensor:
    single(mesh)
    return torch.amax(x)


def gmin(x: torch.Tensor, mesh) -> torch.Tensor:
    single(mesh)
    return torch.amin(x)


def gany(x: torch.Tensor, mesh) -> torch.Tensor:
    single(mesh)
    return torch.any(x)


def lon_neighbours(x: torch.Tensor, mesh):
    """(x at column i + 1, x at column i − 1) around the ring."""
    single(mesh)
    return torch.roll(x, -1, -1), torch.roll(x, 1, -1)
