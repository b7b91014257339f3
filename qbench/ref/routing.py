"""River routing over the offline D8 network (port of ``qingdai_tpu/routing.py``).

Runoff mass accumulates on land every step; every ``QD_HYDRO_DT_HOURS`` an
event routes it downstream. The reference routes along a topological
``flow_order`` one cell at a time (reference routing.py:261-298); the event
here passes over topological *levels* of the effective graph instead: every
cell of level ℓ has received all its upstream mass once levels < ℓ are done,
so a whole level forwards its mass at once. The build is host NumPy, copied
from the JAX package (lake redirects folded into an effective downstream,
the reference's stranding edges from ``flow_order`` positions, levels of the
effective DAG, a level-sorted compaction with static level bounds), and its
result goes to the model's device once.

Three things differ from the JAX package, none in the values beyond rounding:
- **A fixed order of additions.** ``index_add_`` on a CUDA tensor adds with
  atomics, so two contributions to one target land in any order. The build
  splits each level's forwarding edges into rounds whose targets are unique
  (``ops.scatter.unique_rounds``: round k holds the k-th upstream neighbour
  of each target, in the level-sorted order; D8 gives a cell at most 8
  upstream neighbours, lake redirects more), and the event adds one round
  at a time. Each target then
  receives its contributions in the order the JAX package's sequential
  scatter adds them, and two events from the same buffer give the same bits.
  Endorheic storage goes to the lakes the same way.
- **Host clock.** ``t_accum`` is a host float rounded to the model dtype
  after each add, as the clock's day accumulators are, so the event is a
  Python ``if`` with no host sync and fires on the step the JAX package's
  ``lax.cond`` fires on.
- **Sums.** The JAX package's float-float sums become float64 accumulation
  cast back to the state's dtype, and the closure error is taken in its
  reduced form ``store_out − lake_delta`` (the reference's
  ``input − (ocean + lakeΔ + residual)`` with the residual written out).

Routing does not feed back into the physics: only its state and six diags
read it. Mass conventions match the reference: buffers in kg, fluxes in
kg m⁻² s⁻¹, flow_accum in kg/s over the event window.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import HydrologyConfig
from .grid import Grid
from .ops.scatter import unique_rounds
from .parallel.halo import all_gather_lon
from .state import round_to

# effective-downstream sentinel codes
OCEAN = -1   # mass leaves to the ocean
STORE = -2   # endorheic lake storage (no outlet)


@dataclasses.dataclass(frozen=True)
class RoutingStatic:
    """The folded network on the model's device. Cells of the level-sorted
    compaction are addressed by their position in ``order``; level ℓ holds
    positions ``level_starts[ℓ]`` to ``level_starts[ℓ + 1]``. Bounds of
    rounds are host ints, so the event never syncs."""
    n_levels: int
    n_lakes: int
    level_starts: tuple
    grid_shape: tuple
    # (first, last) row of each level's rounds in ``rounds``; each round is
    # (first, last) of its rows in ``fwd_src``/``fwd_tgt``
    level_rounds: tuple
    rounds: tuple
    store_rounds: tuple          # rounds of ``store_src``/``store_slot``
    land: torch.Tensor           # bool (H, W)
    cell_area: torch.Tensor      # m² (H, W)
    land_flat: torch.Tensor      # bool (n_cells,)
    lake_mask_flat: torch.Tensor  # bool (n_cells,)
    cell_area_flat: torch.Tensor  # m² (n_cells,)
    lake_area_frac: torch.Tensor  # (n_lakes,) area share of each lake, or (1,)
    order: torch.Tensor          # int64 cell indices sorted by level (n_land,)
    to_ocean_ordered: torch.Tensor  # bool along ``order``
    to_store_ordered: torch.Tensor  # bool along ``order``
    fwd_src: torch.Tensor        # int64 positions that forward, by level, then round
    fwd_tgt: torch.Tensor        # int64 position each of them forwards to
    store_src: torch.Tensor      # int64 positions that store into a lake, by round
    store_slot: torch.Tensor     # int64 lake slot (lake id − 1) of each


@dataclasses.dataclass(frozen=True)
class RoutingState:
    """Routing state, with the decomposition of the last event's closure
    error (reference routing.py:320-331):
    ``mass_error = store_out − lake_delta`` (exactly: it is taken in that
    form from the stored values) and
    ``routed_mass = ocean_out + store_out + stranded``. ``stranded_kg`` is
    the mass the reference's own loop parks on cells whose turn in
    ``flow_order`` has passed (a lake outlet upstream of its lake): it never
    moves again and is dropped when the buffer resets. It is the
    reference's artifact, quantified, not a loss of this port."""
    buffer_kg: torch.Tensor       # (H, W) accumulated land runoff mass
    t_accum: float                # seconds since the last event (host, model dtype)
    flow_accum_kgps: torch.Tensor  # (n_cells,) last event's throughput
    ocean_inflow_kgps: torch.Tensor
    mass_error_kg: torch.Tensor
    lake_volume_kg: torch.Tensor   # (n_lakes,) or (1,) without lakes
    stranded_kg: torch.Tensor
    routed_mass_kg: torch.Tensor
    store_out_kg: torch.Tensor
    lake_delta_kg: torch.Tensor


def fold_network(net: dict, cell_area: np.ndarray) -> dict:
    """The JAX package's ``build_routing_static`` on the host, as it is:
    the effective downstream with lake redirects, the lakes' area shares,
    the stranding edges, the levels of the effective DAG and the
    level-sorted compaction. Returns NumPy arrays by the JAX field names."""
    land = net["land_mask"].ravel().astype(bool)
    n_cells = land.size
    flow_to = np.asarray(net["flow_to_index"]).ravel().astype(np.int64)
    # net["flow_level"] (raw-D8 levels) is deliberately NOT used: the event
    # needs levels of the effective graph, computed below
    lake_id = np.asarray(net["lake_id"]).ravel().astype(np.int32)
    lake_mask = np.asarray(net["lake_mask"]).ravel().astype(bool)
    n_lakes = int(net.get("n_lakes", 0))
    outlets = np.asarray(net.get("lake_outlet_index", np.zeros((0,), np.int32)))

    eff = np.full(n_cells, OCEAN, np.int64)
    for c in np.nonzero(land)[0]:
        if lake_mask[c] and lake_id[c] > 0 and n_lakes > 0:
            lid = int(lake_id[c])
            if lid <= outlets.shape[0]:
                o = int(outlets[lid - 1])
                if o < 0:
                    eff[c] = OCEAN
                elif 0 <= o < n_cells and land[o]:
                    eff[c] = o
                else:
                    eff[c] = OCEAN
            else:
                eff[c] = STORE
        else:
            dn = int(flow_to[c])
            eff[c] = dn if (dn >= 0 and land[dn]) else OCEAN

    # lake area fractions for P−E distribution (reference routing.py:305-318)
    cell_area = np.asarray(cell_area).ravel()
    if n_lakes > 0:
        total_lake_area = cell_area[lake_mask].sum()
        frac = np.zeros(n_lakes)
        for k in range(1, n_lakes + 1):
            frac[k - 1] = cell_area[lake_id == k].sum() / max(total_lake_area, 1e-30)
    else:
        frac = np.zeros(1)

    # Stranding edges per the reference's own flow_order positions: a cell
    # whose effective downstream sits EARLIER in flow_order adds its mass to
    # an already-processed cell in the reference's sequential loop, so the
    # mass never moves again. Determined on the full grid first: the level
    # structure below must be built without them (lake→outlet edges are not
    # DAG edges).
    from .hydro_network import topo_levels
    fo = net.get("flow_order")
    if fo is None:
        # synthetic dicts without a flow_order: a level-sorted order of the
        # raw D8 DAG is a valid topological order for the non-lake edges
        raw_level, _ = topo_levels(flow_to, land.astype(np.uint8))
        li = np.nonzero(land)[0]
        fo = li[np.argsort(raw_level[li], kind="stable")]
    fo = np.asarray(fo).astype(np.int64).ravel()
    order_pos = np.full(n_cells, -1, np.int64)
    order_pos[fo] = np.arange(fo.size)
    cell_idx = np.arange(n_cells)
    is_cell_edge_full = land & (eff >= 0)
    backward_full = is_cell_edge_full & (
        order_pos[np.clip(eff, 0, n_cells - 1)] < order_pos[cell_idx])

    # Levels of the EFFECTIVE propagating graph (lake redirects included,
    # stranding edges excluded: what remains is forward in flow_order and
    # therefore acyclic). Raw-D8 levels are not enough: a lake→outlet edge
    # forward in a Kahn flow_order can land on an equal-or-lower raw level.
    eff_dag = np.where(backward_full, OCEAN, eff)
    level, n_levels = topo_levels(eff_dag, land.astype(np.uint8))
    level = level.astype(np.int64)

    # level-sorted compaction: cells grouped by level with static boundaries
    land_idx = np.nonzero(land)[0]
    lvl_land = level[land_idx]
    sort = np.argsort(lvl_land, kind="stable")
    order = land_idx[sort].astype(np.int64)
    lvl_sorted = lvl_land[sort]
    starts = tuple(int(x) for x in np.searchsorted(lvl_sorted, np.arange(n_levels + 1)))
    dn_ordered = eff[order]
    to_ocean_ordered = dn_ordered == OCEAN
    to_store_ordered = dn_ordered == STORE
    lake_slot_ordered = np.clip(lake_id[order] - 1, 0, max(n_lakes, 1) - 1)
    # position of the downstream cell inside `order`; ocean/store rows point
    # at 0 and forward no mass
    inv_pos = np.zeros(n_cells, np.int64)
    inv_pos[order] = np.arange(order.size)
    dn_pos_ordered = inv_pos[np.clip(dn_ordered, 0, n_cells - 1)]
    dn_pos_ordered[to_ocean_ordered | to_store_ordered] = 0
    backward_ordered = backward_full[order]
    dn_pos_ordered[backward_ordered] = 0
    return dict(n_levels=n_levels, n_lakes=max(n_lakes, 0), level_starts=starts,
                land=land, lake_mask=lake_mask, lake_area_frac=frac, order=order,
                to_ocean_ordered=to_ocean_ordered, to_store_ordered=to_store_ordered,
                lake_slot_ordered=lake_slot_ordered,
                dn_pos_ordered=dn_pos_ordered, backward_ordered=backward_ordered)


def build_routing_static(net: dict, grid: Grid, dtype=None) -> RoutingStatic:
    """Fold the offline network dict (``hydro_network.build_network`` or
    ``load_network_netcdf``) on the host, split each level's forwarding
    edges into rounds of unique targets, and put the result on the grid's
    device in ``dtype`` (the grid's by default)."""
    dtype = dtype or grid.cell_area.dtype
    device = grid.cell_area.device
    # the areas in the grid's dtype, as the JAX package sums them
    f = fold_network(net, grid.cell_area.detach().cpu().numpy())
    starts = f["level_starts"]
    fwd = ~(f["to_ocean_ordered"] | f["to_store_ordered"] | f["backward_ordered"])
    src, tgt, rounds, level_rounds = [], [], [], []
    for lvl in range(f["n_levels"]):
        s, e = starts[lvl], starts[lvl + 1]
        pos = s + np.nonzero(fwd[s:e])[0]
        perm, bounds = unique_rounds(f["dn_pos_ordered"][pos])
        base = sum(len(p) for p in src)
        src.append(pos[perm])
        tgt.append(f["dn_pos_ordered"][pos][perm])
        level_rounds.append((len(rounds), len(rounds) + len(bounds)))
        rounds.extend((base + a, base + b) for a, b in bounds)
    store_pos = np.nonzero(f["to_store_ordered"])[0] if f["n_lakes"] > 0 else np.zeros(0, int)
    sperm, store_rounds = unique_rounds(f["lake_slot_ordered"][store_pos])

    def idx(a):
        return torch.as_tensor(np.asarray(a, np.int64)).to(device)

    def cat(parts):
        return idx(np.concatenate(parts) if parts else np.zeros(0, np.int64))

    shape = tuple(net["land_mask"].shape)
    land = torch.as_tensor(f["land"]).to(device)
    area = grid.cell_area.to(dtype)
    return RoutingStatic(
        n_levels=f["n_levels"], n_lakes=f["n_lakes"], level_starts=starts,
        grid_shape=shape, level_rounds=tuple(level_rounds), rounds=tuple(rounds),
        store_rounds=tuple(store_rounds),
        land=land.reshape(shape), cell_area=area, land_flat=land,
        lake_mask_flat=torch.as_tensor(f["lake_mask"]).to(device),
        cell_area_flat=area.reshape(-1),
        lake_area_frac=torch.as_tensor(f["lake_area_frac"]).to(device=device, dtype=dtype),
        order=idx(f["order"]),
        to_ocean_ordered=torch.as_tensor(f["to_ocean_ordered"]).to(device),
        to_store_ordered=torch.as_tensor(f["to_store_ordered"]).to(device),
        fwd_src=cat(src), fwd_tgt=cat(tgt),
        store_src=idx(store_pos[sperm]),
        store_slot=idx(f["lake_slot_ordered"][store_pos][sperm]))


def init_routing_state(static: RoutingStatic, dtype=None) -> RoutingState:
    dtype = dtype or static.cell_area.dtype
    device = static.cell_area.device

    def zero(shape=()):
        return torch.zeros(shape, dtype=dtype, device=device)

    return RoutingState(
        buffer_kg=zero(static.grid_shape), t_accum=0.0,
        flow_accum_kgps=zero((static.land_flat.shape[0],)), ocean_inflow_kgps=zero(),
        mass_error_kg=zero(), lake_volume_kg=zero((max(static.n_lakes, 1),)),
        stranded_kg=zero(), routed_mass_kg=zero(), store_out_kg=zero(), lake_delta_kg=zero())


def _sum64(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x, dtype=torch.float64)


def route_event(rs: RoutingStatic, acc: torch.Tensor, lake_volume: torch.Tensor):
    """Route the flat accumulated mass ``acc`` level by level over the
    level-sorted land cells: one gather in, per level one gather of its
    forwarding rows and one ``index_add_`` per round, one scatter out, and
    the terminal sums at the end. Every downstream position sits at a
    strictly higher level, so a level's rows are final once it is done and
    the finished carry is the per-cell throughput. Returns (flow_accum_kg,
    float64 sums (input, ocean_out, store_out), lake_volume')."""
    route_event.events += 1
    carry = acc.index_select(0, rs.order)
    mass_in = _sum64(carry)
    for first, last in rs.level_rounds:
        if first == last:
            continue
        base = rs.rounds[first][0]
        end = rs.rounds[last - 1][1]
        # this level's forwarding rows, read before any of its rounds adds:
        # their targets sit at higher levels
        moved = carry.index_select(0, rs.fwd_src[base:end])
        for a, b in rs.rounds[first:last]:
            carry.index_add_(0, rs.fwd_tgt[a:b], moved[a - base:b - base])
    ocean_out = _sum64(torch.where(rs.to_ocean_ordered, carry, 0.0))
    store_out = _sum64(torch.where(rs.to_store_ordered, carry, 0.0))
    if rs.store_rounds:
        stored = carry.index_select(0, rs.store_src)
        lake_volume = lake_volume.clone()
        for a, b in rs.store_rounds:
            lake_volume.index_add_(0, rs.store_slot[a:b], stored[a:b])
    # out of place: functorch batches index_copy, not index_copy_
    flow_accum = torch.zeros_like(acc).index_copy(0, rs.order, carry)
    return flow_accum, (mass_in, ocean_out, store_out), lake_volume


route_event.events = 0


def routing_step(rs: RoutingStatic, state: RoutingState, cfg: HydrologyConfig, R_land_flux,
                 dt: float, precip_flux, evap_flux, mesh=None) -> RoutingState:
    """Accumulate runoff mass; once Σdt reaches dt_hydro, route it
    (reference routing.py:211-335). The firing test is on host numbers.

    On a rank of the longitude mesh (``mesh``) the accumulation stays in the
    rank's columns; rivers form one graph across ranks, so the event gathers
    the runoff buffer (and P − E for the lakes) whole on every rank and runs
    unchanged on the whole field, and each rank keeps its own columns of the
    buffer (the JAX package's routing.py:306-309)."""
    dtype = state.buffer_kg.dtype
    dt_hydro = cfg.dt_hydro_hours * 3600.0
    buffer_kg = state.buffer_kg + torch.where(rs.land, R_land_flux * rs.cell_area * dt, 0.0)
    t_accum = round_to(state.t_accum + round_to(dt, dtype), dtype)
    if not round_to(t_accum + round_to(1e-9, dtype), dtype) >= round_to(dt_hydro, dtype):
        return dataclasses.replace(state, buffer_kg=buffer_kg, t_accum=t_accum)

    event_dt = max(t_accum, 1e-9)
    flow_accum, (mass_in, ocean_out, store_out), lake_vol = route_event(
        rs, all_gather_lon(buffer_kg, mesh).reshape(-1), state.lake_volume_kg)
    # lake P−E volume update over the event window (reference routing.py:305-318)
    lake_delta = torch.zeros((), dtype=torch.float64, device=buffer_kg.device)
    if rs.n_lakes > 0 and cfg.treat_lake_as_water:
        pe = all_gather_lon(torch.stack([precip_flux, evap_flux]), mesh)
        net = (pe[0].reshape(-1) - pe[1].reshape(-1)) * rs.cell_area_flat * t_accum
        lake_delta = _sum64(torch.where(rs.lake_mask_flat, net, 0.0))
        lake_vol = lake_vol + rs.lake_area_frac * lake_delta.to(dtype)
    # the reference's closure_err = input − (ocean + lakeΔ + residual), with
    # the residual (stranded) the input that reached neither the ocean nor a
    # lake, is store_out − lakeΔ; it is taken in that form from the stored
    # values, so RoutingState's identity holds exactly in the state's dtype
    stranded = mass_in - ocean_out - store_out
    store_out, lake_delta = store_out.to(dtype), lake_delta.to(dtype)
    return RoutingState(
        buffer_kg=torch.zeros_like(buffer_kg), t_accum=0.0,
        flow_accum_kgps=flow_accum / event_dt,
        ocean_inflow_kgps=ocean_out.to(dtype) / event_dt,
        mass_error_kg=store_out - lake_delta, lake_volume_kg=lake_vol,
        stranded_kg=stranded.to(dtype), routed_mass_kg=mass_in.to(dtype),
        store_out_kg=store_out, lake_delta_kg=lake_delta)
