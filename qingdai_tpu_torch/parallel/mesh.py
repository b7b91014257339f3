"""Longitude and member meshes over ``torch.distributed`` ranks (port of
``qingdai_tpu/parallel/mesh.py``).

The longitude mesh splits every field's columns over the n ranks, rows
whole: rank r owns the global columns ``[lon0, lon0 + W/n)``, ``lon0 = r·W/n``
(W divisible by n). Latitude stays whole, so the pole rows' special cases
(the polar ring means, the freeze fix, the rolls that wrap across the poles)
stay local to every rank, as in the JAX package. Each rank is one process;
the same ``model.make_step_fn`` runs on a shard whose ``Grid`` carries the
mesh, and the ops reach across ranks through ``parallel.halo``.

``shard_state`` and ``shard_model_statics`` cut the columns of every tensor
whose trailing axis is the longitude axis (two or more dimensions, the last
of length n_lon) and replicate every other tensor, the rule of the JAX
package's ``_spec_for_leaf``. Three groups differ, each for its module's
reason: the grid's 1-D ``lon`` is cut too (the ocean's polar fill reads it
per column), the individual pool stays replicated with the owner of each of
its sampled cells recorded (``ecology.individuals.shard_indiv_static``), and
the routing network's flat arrays stay whole because the event runs on the
whole field (``routing.routing_step``).

The backend and the device are the caller's choice. NCCL needs one card a
rank; with more ranks than cards ``make_mesh`` raises and names
``backend="gloo"``, which stages the card's tensors through host memory and
lets several ranks share one card. Nothing switches backend on an error.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from ..grid import Grid, resolve_device

# the counters a mesh keeps of its collectives (parallel.halo)
STAT_KEYS = ("collectives", "halo_bytes", "gather_bytes", "reduce_bytes")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's view of the mesh: its process group (None with one
    rank), rank, rank count n, device and backend. ``stats`` counts the
    collectives this rank has called and the bytes it has received."""
    group: Optional[object]
    rank: int
    n: int
    device: torch.device
    backend: str
    stats: dict = dataclasses.field(default_factory=lambda: dict.fromkeys(STAT_KEYS, 0))

    @property
    def stage(self) -> bool:
        """Whether a collective copies a card's tensors through host memory
        (gloo's collectives take CPU tensors)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def cols(self, n_lon: int) -> tuple[int, int]:
        """(lon0, width): the first global column this rank owns and how many."""
        if n_lon % self.n:
            raise ValueError(f"n_lon {n_lon} does not divide over {self.n} ranks")
        width = n_lon // self.n
        return self.rank * width, width

    def reset_stats(self) -> None:
        for k in STAT_KEYS:
            self.stats[k] = 0


def make_mesh(backend: str = "nccl", device="cuda", *, rank: int = 0, world_size: int = 1,
              init_method: Optional[str] = None) -> Mesh:
    """This process's mesh. With ``world_size`` > 1 and no process group
    yet, joins one at ``init_method`` (``tcp://localhost:<port>`` or
    ``file://<path>``) as ``rank``; with ``world_size`` 1 and none, a mesh of
    one rank that calls no collective. ``device`` "cuda" without an index
    takes card ``rank`` under NCCL and card ``rank`` mod the card count under
    gloo."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    dev = resolve_device(device)
    initialized = dist.is_available() and dist.is_initialized()
    if initialized:
        rank, world_size = dist.get_rank(), dist.get_world_size()
    if dev.type == "cuda" and dev.index is None:
        cards = torch.cuda.device_count()
        if backend == "nccl" and world_size > cards:
            raise RuntimeError(f"backend='nccl' needs one card a rank: {world_size} ranks, "
                               f"{cards} card(s); pass backend='gloo' to share a card")
        dev = torch.device("cuda", rank % cards)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("backend='nccl' runs on cards; pass backend='gloo' for the CPU")
    if world_size > 1 and not initialized:
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size)
        initialized = True
    if initialized and dist.get_backend() != backend:
        raise RuntimeError(f"the process group's backend is {dist.get_backend()!r}, "
                           f"not {backend!r}")
    group = dist.group.WORLD if world_size > 1 else None
    return Mesh(group=group, rank=rank, n=world_size, device=dev, backend=backend)


def _cut(t, n_lon: int, lon0: int, width: int, one_d: bool = False):
    """``t``'s columns [lon0, lon0 + width), wrapped, if its trailing axis
    is the longitude axis, else ``t`` (``_spec_for_leaf``)."""
    if (isinstance(t, torch.Tensor) and t.shape and t.shape[-1] == n_lon
            and (t.dim() >= 2 or one_d)):
        if 0 <= lon0 and lon0 + width <= n_lon:
            return t[..., lon0:lon0 + width].contiguous()
        idx = torch.remainder(torch.arange(lon0, lon0 + width, device=t.device), n_lon)
        return t.index_select(-1, idx)
    return t


def _map(obj, fn):
    """``obj`` with ``fn`` applied to every tensor of its (nested)
    dataclass fields; other values unchanged."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: _map(getattr(obj, f.name), fn)
                                           for f in dataclasses.fields(obj) if f.init})
    return obj


def static_pad(cfg) -> int:
    """The columns a shard's grid holds beyond its own on each side
    (``Grid.padded``) for a ``SimConfig``: as many as the padded stencils
    with static operands read, K3's 2 a ∇⁴ substep and K4's halo."""
    from ..kernels.ocean_substeps import halo
    return max(2 * max(1, int(cfg.dynamics.k4_nsub)),
               halo(max(1, int(cfg.ocean.k4_nsub)))[1])


def shard_grid(grid: Grid, mesh: Mesh, pad: int = 0) -> Grid:
    """The rank's grid: its columns of every map and of ``lon``, the global
    ``n_lon`` and ``dlon_rad``, ``lon0`` and the mesh; with ``pad`` and
    more than one rank, also its maps over ``pad`` more columns on each side
    (``Grid.padded``)."""
    lon0, width = mesh.cols(grid.n_lon)

    def cut(lo, w):
        return dataclasses.replace(_map(grid, lambda t: _cut(t, grid.n_lon, lo, w, one_d=True)),
                                   lat=grid.lat, lon0=lo, width=w)

    # one rank pads by wrapping its own columns (``halo.pad_lon``)
    padded = cut(lon0 - pad, width + 2 * pad) if pad and mesh.n > 1 else None
    return dataclasses.replace(cut(lon0, width), mesh=mesh, padded=padded)


def shard_state(state, mesh: Mesh, n_lon: int):
    """The rank's shard of a ``WorldState``: the columns of every field,
    every other leaf replicated; the individual pool whole."""
    lon0, width = mesh.cols(n_lon)
    cut = lambda t: _cut(t, n_lon, lon0, width)
    return dataclasses.replace(
        state, **{f.name: _map(getattr(state, f.name), cut)
                  for f in dataclasses.fields(state) if f.name != "indiv"})


def gather_state(state, mesh: Mesh, n_lon: int):
    """The whole ``WorldState`` on every rank from the ranks' shards, the
    inverse of ``shard_state``."""
    from .halo import all_gather_lon
    _, width = mesh.cols(n_lon)
    if mesh.n == 1:
        return state
    n_lat = state.atmos.T_s.shape[0]

    def gather(t):
        # a field's shard ends in [n_lat, width]; a replicated table such as
        # the species' bands may end in width alone
        if t.dim() >= 2 and tuple(t.shape[-2:]) == (n_lat, width):
            return all_gather_lon(t, mesh)
        return t

    return dataclasses.replace(
        state, **{f.name: _map(getattr(state, f.name), gather)
                  for f in dataclasses.fields(state) if f.name != "indiv"})


def shard_model_statics(model, mesh: Mesh):
    """The model on the rank's shard: the sharded grid (which carries the
    mesh, and its maps padded by ``static_pad``), the columns of every
    static map and initial state, the individual pool's owners, and the
    routing network's accumulation maps (its flat arrays whole)."""
    from ..ecology.individuals import shard_indiv_static
    n_lon = model.grid.n_lon
    lon0, width = mesh.cols(n_lon)
    cut = lambda obj: _map(obj, lambda t: _cut(t, n_lon, lon0, width))
    rs = model.routing_static
    if rs is not None:
        rs = dataclasses.replace(cut(rs), grid_shape=(model.grid.n_lat, width))
    ist = model.indiv_static
    return dataclasses.replace(
        model, grid=shard_grid(model.grid, mesh, static_pad(model.cfg)),
        static=cut(model.static),
        eco_static=cut(model.eco_static), phyto_static=cut(model.phyto_static),
        indiv_static=None if ist is None else shard_indiv_static(ist, mesh, model.grid.n_lat,
                                                                n_lon),
        routing_static=rs, eco_state0=cut(model.eco_state0),
        phyto_state0=cut(model.phyto_state0))


def _rank_main(rank: int, fn, nproc: int, backend: str, device, workdir: str, threads, args):
    if threads:
        torch.set_num_threads(threads)
    mesh = make_mesh(backend, device, rank=rank, world_size=nproc,
                     init_method=f"file://{workdir}/pg")
    try:
        result = fn(mesh, *args)
        torch.save(result, f"{workdir}/rank{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, nproc: int, backend: str = "nccl", device="cuda", args=(),
                threads: Optional[int] = None, timeout: float = 3600.0) -> list:
    """Run ``fn(mesh, *args)`` in ``nproc`` new processes, one rank each
    (``torch.multiprocessing``'s spawn, which starts them fresh: a parent
    that holds a CUDA context cannot fork), joined through a file in a
    temporary directory; returns each rank's result in rank order (``fn`` is
    a module-level function and its result is saved with ``torch.save``).
    ``threads`` sets each rank's ``torch.set_num_threads``. A rank that
    raises makes this raise; ranks still running after ``timeout`` seconds
    are killed and this raises ``TimeoutError``. Every process has ended on
    return."""
    import tempfile
    import time

    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as workdir:
        ctx = mp.start_processes(_rank_main, nprocs=nproc, join=False, start_method="spawn",
                                 args=(fn, nproc, backend, device, workdir, threads, args))
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{nproc} ranks of {fn.__name__} still running after "
                                       f"{timeout:g} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(f"{workdir}/rank{r}.pt", map_location="cpu", weights_only=False)
                for r in range(nproc)]
