"""The collectives of the longitude mesh: halo columns, the whole field,
and sums across ranks (port of ``_halo_pad_lon``,
``qingdai_tpu/ops/stencil.py``, and of the ppermute of
``_windowed_accumulate_spmd``, ``qingdai_tpu/ops/advect.py``).

Every function takes the rank's ``Mesh`` (``parallel.mesh``) or None. With
None or one rank no collective is called: ``torch.distributed`` refuses a
send to its own rank, and a one-rank pad wraps locally. Under gloo a card's
tensor is copied to host memory for the collective and back
(``Mesh.stage``); NCCL takes it where it is.

The longitude seam. Most stencils wrap in longitude, but the Gaussian
filter's default lon mode is ``reflect`` and ``np.gradient`` takes
one-sided edges. A seam's mode applies only at global columns 0 and W−1:
only the rank that holds a seam column applies it, and every other edge
takes its neighbour's columns.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# tags of the two directions of a halo exchange (gloo matches by tag; NCCL
# matches a pair's messages in order, which the posting order below keeps)
_LEFTWARD, _RIGHTWARD = 1, 2


def single(mesh) -> bool:
    """Whether ``mesh`` calls no collective: None or one rank."""
    return mesh is None or mesh.n == 1


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


def _out(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` as the collective takes it (host memory under staging)."""
    return t.cpu() if mesh.stage else t.contiguous()


def pad_lon(x: torch.Tensor, k: int, seam_mode: str, mesh) -> torch.Tensor:
    """[..., w] → [..., k + w + k]: k columns from each neighbour rank
    (``dist.batch_isend_irecv``), ``seam_pad`` at the global seam unless
    ``seam_mode`` is wrap."""
    if k == 0:
        return x
    w = x.shape[-1]
    if k > w:
        raise ValueError(f"a halo of {k} columns exceeds the rank's {w} columns")
    if single(mesh):
        return torch.cat([seam_pad(x, k, "left", seam_mode), x,
                          seam_pad(x, k, "right", seam_mode)], dim=-1)
    r, n = mesh.rank, mesh.n
    wrap = seam_mode == "wrap"
    left_nbr, right_nbr = (r - 1) % n, (r + 1) % n
    need_left = wrap or r != 0          # the left halo comes from a rank
    need_right = wrap or r != n - 1
    send_left = wrap or r != 0          # the left neighbour needs our first columns
    send_right = wrap or r != n - 1
    lo = _out(x[..., :k], mesh)
    hi = _out(x[..., w - k:], mesh)
    left = torch.empty_like(lo) if need_left else None
    right = torch.empty_like(hi) if need_right else None
    ops = []
    # sends first, leftward then rightward; receives from the right
    # neighbour (its leftward message) before the left one's: with two
    # ranks both messages of a pair go to one peer and match in this order
    if send_left:
        ops.append(dist.P2POp(dist.isend, lo, left_nbr, mesh.group, _LEFTWARD))
    if send_right:
        ops.append(dist.P2POp(dist.isend, hi, right_nbr, mesh.group, _RIGHTWARD))
    if need_right:
        ops.append(dist.P2POp(dist.irecv, right, right_nbr, mesh.group, _LEFTWARD))
    if need_left:
        ops.append(dist.P2POp(dist.irecv, left, left_nbr, mesh.group, _RIGHTWARD))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    got = [t for t in (left, right) if t is not None]
    mesh.stats["collectives"] += 1
    mesh.stats["halo_bytes"] += sum(t.numel() * t.element_size() for t in got)
    left = left.to(x.device) if need_left else seam_pad(x, k, "left", seam_mode)
    right = right.to(x.device) if need_right else seam_pad(x, k, "right", seam_mode)
    return torch.cat([left, x, right], dim=-1)


def _all_gather(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (bool
    tensors travel as bytes)."""
    flag = x.dtype == torch.bool
    xc = _out(x.to(torch.uint8) if flag else x, mesh)
    parts = [torch.empty_like(xc) for _ in range(mesh.n)]
    dist.all_gather(parts, xc, group=mesh.group)
    mesh.stats["collectives"] += 1
    mesh.stats["gather_bytes"] += (mesh.n - 1) * xc.numel() * xc.element_size()
    out = torch.cat(parts, dim=dim).to(x.device)
    return out.bool() if flag else out


def all_gather_lon(x: torch.Tensor, mesh) -> torch.Tensor:
    """[..., w] on each rank → the whole field [..., n·w] on every rank."""
    return x if single(mesh) else _all_gather(x, mesh, -1)


def all_gather_members(x: torch.Tensor, mesh) -> torch.Tensor:
    """[b, ...] on each rank → [n·b, ...] on every rank, rank order."""
    return x if single(mesh) else _all_gather(x, mesh, 0)


def _all_reduce(x: torch.Tensor, mesh, op) -> torch.Tensor:
    xc = x.cpu() if mesh.stage else x.clone()
    dist.all_reduce(xc, op=op, group=mesh.group)
    mesh.stats["collectives"] += 1
    mesh.stats["reduce_bytes"] += xc.numel() * xc.element_size()
    return xc.to(x.device)


def all_reduce_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over ranks of ``x``, taken in float64 and returned in
    ``x``'s dtype (exact for one nonzero contribution, as an owner's value
    among zeros)."""
    if single(mesh):
        return x
    if not x.is_floating_point():
        return _all_reduce(x, mesh, dist.ReduceOp.SUM)
    return _all_reduce(x.to(torch.float64), mesh, dist.ReduceOp.SUM).to(x.dtype)


def gsum(x: torch.Tensor, mesh, dim=None) -> torch.Tensor:
    """``torch.sum(x)`` (or over ``dim``) of the whole field from the
    ranks' columns: the local sum, then ``all_reduce_sum``."""
    local = torch.sum(x) if dim is None else torch.sum(x, dim=dim)
    return all_reduce_sum(local, mesh)


def gsums(parts, mesh) -> list:
    """Local sums (tensors of any shapes and dtypes) summed over the ranks
    with one collective, in float64, each returned in its own shape and
    dtype; on one rank ``parts`` itself."""
    if single(mesh):
        return list(parts)
    flat = torch.cat([p.reshape(-1).to(torch.float64) for p in parts])
    total = _all_reduce(flat, mesh, dist.ReduceOp.SUM)
    out, i = [], 0
    for p in parts:
        out.append(total[i:i + p.numel()].reshape(p.shape).to(p.dtype))
        i += p.numel()
    return out


def gmax(x: torch.Tensor, mesh) -> torch.Tensor:
    """``torch.amax(x)`` over the whole field."""
    local = torch.amax(x)
    return local if single(mesh) else _all_reduce(local, mesh, dist.ReduceOp.MAX)


def gmin(x: torch.Tensor, mesh) -> torch.Tensor:
    """``torch.amin(x)`` over the whole field."""
    local = torch.amin(x)
    return local if single(mesh) else _all_reduce(local, mesh, dist.ReduceOp.MIN)


def gany(x: torch.Tensor, mesh) -> torch.Tensor:
    """``torch.any(x)`` over the whole field."""
    local = torch.any(x)
    if single(mesh):
        return local
    return _all_reduce(local.to(torch.int32), mesh, dist.ReduceOp.MAX) > 0


def lon_neighbours(x: torch.Tensor, mesh):
    """(x at column i + 1, x at column i − 1) around the whole ring:
    ``torch.roll`` by −1 and +1 on one rank, a one-column halo on a mesh."""
    if single(mesh):
        return torch.roll(x, -1, -1), torch.roll(x, 1, -1)
    xp = pad_lon(x, 1, "wrap", mesh)
    return xp[..., 2:], xp[..., :-2]
