"""Wind-driven barotropic slab ocean (port of ``qingdai_tpu/ocean.py``).

The substep count is the static conservative bound of the JAX package.
With the default structure (Shapiro off, ∇⁴ every step) the substep loop is
one call of ``ocean_substeps``: kernel K4 (``kernels/ocean_substeps.py``,
the port of ``ocean_substeps_pallas``) on a CUDA tensor, its plain version
``ocean_substeps_plain`` on a CPU tensor. It takes the SST and any tracers
(the phytoplankton chlorophyll stack) as one stack advected by a single
gather. With Shapiro on or another ∇⁴ cadence the same loop runs unfused,
reaching kernels K2 (advection) and K3 (∇⁴) through ``ops``, as the JAX
package keeps its scan for those structures.

On a rank of the longitude mesh (``grid.mesh``) the fused loop runs K4's
sharded form (``ocean_substeps_sharded``): each substep exchanges the halo
of ``mom``, gathers ``st`` whole, and launches the tile pass and the finish
around the cross-rank η sums; ``forc`` and the land and ice masks are
exchanged once a step, and ``geo``'s maps come from the shard grid's padded
maps.
The unfused loop reaches K2, K3 and Shapiro through their mesh forms, and
the plain version of either is ``_substeps`` with the mesh. The polar ring
means add their masked sums and counts across ranks; rows are whole, so
the rolls that wrap across the poles stay local.
"""

from __future__ import annotations

import math

import torch

from . import constants as const
from .config import OceanConfig
from .grid import Grid
from .kernels import use_kernel
from .kernels.ocean_substeps import halo
from .ops import safegrad
from .ops.members import plain_vjp, refuse_grad, to_front
from .ops.advect import advect_semilag_multi, bilinear_wrap_gather_multi, departure_indices
from .ops.reductions import area_mean
from .ops.stencil import (hyperdiffuse_multi, hyperdiffuse_multi_ref, laplacian_sphere,
                          shapiro_filter_multi)
from .parallel.halo import (all_gather_lon, all_reduce_sum, gmax, gmin, gsum, gsums,
                            lon_neighbours, pad_lon, single)
from .physics.energy import pow4
from .state import OceanState

# planes of the static geometry stack ``geo`` (the order of the GEO_*
# indices of qingdai_tpu/ops/pallas_ocean.py)
GEO_F = 0          # Coriolis parameter
GEO_COS05 = 1      # max(cosφ, 0.5), the ocean metric cap
GEO_COS = 2        # raw cosφ (divergence φ-term)
GEO_COS_TINY = 3   # max(cosφ, 1e-6) (divergence divisor)
GEO_R_EXTRA = 4    # polar sponge extra drag profile
GEO_LAND = 5       # land mask as float (1 on land)
GEO_OPEN = 6       # open-ocean mask (ocean and not ice)
GEO_UNDER = 7      # under-ice ocean mask
GEO_W_OCEAN = 8    # area weights × ocean mask (η mean removal)
GEO_K4_U = 9
GEO_K4_V = 10
GEO_K4_ETA = 11
N_GEO = 12


def static_substeps(grid: Grid, cfg: OceanConfig, dt: float) -> int:
    """Conservative static substep count from the gravity-wave speed and the
    wind and current caps (replaces the reference's per-call CFL loop)."""
    if cfg.n_substeps > 0:
        return int(cfg.n_substeps)
    a = const.PLANET_RADIUS
    dx_lat = a * grid.dlat_rad
    dx_lon_min = a * grid.dlon_rad * max(1e-3, 0.5)
    dx_min = min(dx_lat, dx_lon_min)
    c = math.sqrt(9.81 * cfg.H_m)
    u_bound = max(c, cfg.max_u_cap, cfg.vcap)
    target = max(1e-3, cfg.cfl_target)
    n = int(math.ceil(u_bound * (dt / max(1e-12, dx_min)) / target))
    return max(1, min(500, n))


# ---------------- polar ring corrections ----------------

def _pole_rows(F: torch.Tensor):
    rows = torch.arange(F.shape[0], device=F.device)[:, None]
    return rows == 0, rows == F.shape[0] - 1


def polar_scalar_average_fill(F, ocean_mask, mesh=None):
    """Replace both pole rows by their ocean ring means (on a mesh, the
    rows' sums and counts over every rank in one collective)."""
    top, bot = _pole_rows(F)
    rows = (0, -1)
    sums = gsums([x for r in rows for x in (torch.sum(torch.where(ocean_mask[r], F[r], 0.0)),
                                            torch.sum(ocean_mask[r]))], mesh)
    fills = []
    for k, r in enumerate(rows):
        m, s, n = ocean_mask[r], sums[2 * k], sums[2 * k + 1]
        fills.append(torch.where(m & (n > 0), s / torch.clamp(n, min=1), F[r]))
    return torch.where(top, fills[0][None], torch.where(bot, fills[1][None], F))


def polar_vector_average_fill(u, v, ocean_mask, lons_rad, mesh=None):
    """Both pole rows of (u, v) refilled from their ring-mean vectors,
    averaged in each pole's tangent plane (on a mesh, the rows' sums and
    counts over every rank in one collective)."""
    top, bot = _pole_rows(u)
    sin_l, cos_l = torch.sin(lons_rad), torch.cos(lons_rad)
    rows, parts, bases = (0, -1), [], []
    for r, north in zip(rows, (False, True)):
        # east basis (-sinλ, cosλ, 0); north basis at ±90°
        enx, eny = (-cos_l, -sin_l) if north else (cos_l, sin_l)
        m = ocean_mask[r]
        v3x = (-sin_l) * u[r] + enx * v[r]
        v3y = cos_l * u[r] + eny * v[r]
        parts += [torch.sum(m), torch.sum(torch.where(m, v3x, 0.0)),
                  torch.sum(torch.where(m, v3y, 0.0))]
        bases.append((enx, eny))
    sums = gsums(parts, mesh)
    fills = []
    for k, r in enumerate(rows):
        m, (enx, eny) = ocean_mask[r], bases[k]
        n, sx, sy = sums[3 * k:3 * k + 3]
        cnt = torch.clamp(n, min=1)
        mx, my = sx / cnt, sy / cnt
        fill = m & (n > 0)
        fills.append((torch.where(fill, (-sin_l) * mx + cos_l * my, u[r]),
                      torch.where(fill, enx * mx + eny * my, v[r])))
    (u0, v0), (u1, v1) = fills
    u = torch.where(top, u0[None], torch.where(bot, u1[None], u))
    v = torch.where(top, v0[None], torch.where(bot, v1[None], v))
    return u, v


# ---------------- the substep loop ----------------

def _substeps(mom, st, forc, geo, *, n_sub, k4_nsub, sub_dt, H_m, r_bot, g, a, dlat, dlon,
              K_h, adv_alpha, use_qnet, ice_qfac, cap, mean4, eta_cap,
              diffuse=True, shapiro_n=0, plain=True, mesh=None):
    """The substep loop over stacks (see :func:`ocean_substeps_plain`).

    ``diffuse`` and ``shapiro_n`` give the unfused structures; ``plain``
    picks the plain gather and ∇⁴ (False: the ``ops`` functions, which
    launch K2 and K3 on a card). On a rank of ``mesh`` the stacks are the
    rank's columns and every lon neighbour, gather and sum reaches across
    ranks."""
    f, cos05, cos_raw, cos_tiny = geo[GEO_F], geo[GEO_COS05], geo[GEO_COS], geo[GEO_COS_TINY]
    r_extra, w_ocean = geo[GEO_R_EXTRA], geo[GEO_W_OCEAN]
    on_land, open_m, under_m = geo[GEO_LAND] > 0.5, geo[GEO_OPEN] > 0.5, geo[GEO_UNDER] > 0.5
    k4s = geo[GEO_K4_U:GEO_K4_ETA + 1]
    ax, ay, heat = forc[0], forc[1], forc[2]
    H = st.shape[1]
    interior = (torch.arange(H, device=st.device)[:, None] > 0) & (
        torch.arange(H, device=st.device)[:, None] < H - 1)

    uo, vo, eta = mom[0], mom[1], mom[2]
    for _ in range(n_sub):
        # pressure gradient; the latitude roll wraps across the poles
        east, west = lon_neighbours(eta, mesh)
        deta_dlam = (east - west) / (2.0 * dlon)
        deta_dphi = (torch.roll(eta, -1, 0) - torch.roll(eta, 1, 0)) / (2.0 * dlat)
        gx = deta_dlam / (a * cos05)
        gy = deta_dphi / a
        du = f * vo - g * gx + ax - r_bot * uo
        dv = -f * uo - g * gy + ay - r_bot * vo
        uo = torch.where(on_land, 0.0, uo + sub_dt * du)
        vo = torch.where(on_land, 0.0, vo + sub_dt * dv)
        # polar sponge
        uo = uo - sub_dt * r_extra * uo
        vo = vo - sub_dt * r_extra * vo

        if diffuse:
            S = torch.stack([uo, vo, eta])
            hyper = hyperdiffuse_multi_ref if plain else hyperdiffuse_multi
            S = hyper(S, k4s, sub_dt, k4_nsub, dlat, dlon, cos05, a, mesh)
            uo, vo, eta = S[0], S[1], S[2]
        if shapiro_n:
            S = shapiro_filter_multi(torch.stack([uo, vo, eta]), shapiro_n, mesh=mesh)
            uo, vo, eta = S[0], S[1], S[2]

        # continuity (the divergence's latitude term is zero on the pole
        # rows), then removal of the ocean-mean η
        east, west = lon_neighbours(uo, mesh)
        du_dlon = (east - west) / (2.0 * dlon)
        v_cos = vo * cos_raw
        dv_dlat = (torch.roll(v_cos, -1, 0) - torch.roll(v_cos, 1, 0)) / (2.0 * dlat)
        div = (du_dlon + torch.where(interior, dv_dlat, 0.0)) / (a * cos_tiny)
        eta = eta - sub_dt * H_m * div
        eta = torch.where(on_land, 0.0, eta)
        eta = eta - gsum(eta * w_ocean, mesh) / (gsum(w_ocean, mesh) + 1e-15)

        # SST and tracers share one departure-point gather; the blend is the
        # SST's only, the tracers take the advected value
        if plain:
            lon0 = 0 if single(mesh) else mesh.rank * st.shape[-1]
            adv = bilinear_wrap_gather_multi(all_gather_lon(st, mesh), *departure_indices(
                st.shape[1:], uo, vo, sub_dt, a, dlat, dlon, cos05, st.dtype, lon0))
        else:
            adv = advect_semilag_multi(st, uo, vo, sub_dt, a, dlat, dlon, cos05, mesh)
        sst = (1.0 - adv_alpha) * st[0] + adv_alpha * adv[0]
        if K_h > 0.0:
            sst = sst + sub_dt * K_h * laplacian_sphere(sst, dlat, dlon, cos05, a, mesh)

        # Q_net heating, reduced under ice
        if use_qnet:
            sst = torch.where(open_m, sst + sub_dt * heat, sst)
            if ice_qfac > 0.0:
                sst = torch.where(under_m, sst + sub_dt * ice_qfac * heat, sst)

        # outlier handling
        uo = torch.nan_to_num(uo)
        vo = torch.nan_to_num(vo)
        speed = safegrad.speed(uo, vo)
        if mean4:
            u_e, u_w = lon_neighbours(uo, mesh)
            v_e, v_w = lon_neighbours(vo, mesh)
            u_m4 = 0.25 * (torch.roll(uo, -1, 0) + torch.roll(uo, 1, 0) + u_e + u_w)
            v_m4 = 0.25 * (torch.roll(vo, -1, 0) + torch.roll(vo, 1, 0) + v_e + v_w)
            fast = speed > cap
            uo = torch.where(fast, u_m4, uo)
            vo = torch.where(fast, v_m4, vo)
            speed = safegrad.speed(uo, vo)
        scl = torch.where(speed > cap, cap / (speed + 1e-12), 1.0)
        uo = uo * scl
        vo = vo * scl

        eta = torch.clamp(torch.nan_to_num(eta), -eta_cap, eta_cap)
        st = torch.cat([torch.nan_to_num(sst)[None], adv[1:]])
    return torch.stack([uo, vo, eta]), st


def ocean_substeps_plain(mom, st, forc, geo, **params):
    """Plain version of kernel K4: ``n_sub`` ocean substeps over stacks.

    ``mom`` = [uo, vo, η], ``st`` = [SST] + tracers, ``forc`` =
    [τx/(ρ_w H), τy/(ρ_w H), Q_net/(ρ_w c_p H)], ``geo`` = the ``N_GEO``
    static planes (``GEO_*``). Keyword parameters: ``n_sub, k4_nsub,
    sub_dt, H_m, r_bot, g, a, dlat, dlon, K_h, adv_alpha, use_qnet,
    ice_qfac, cap, mean4, eta_cap``. Returns (mom', st'). This is what
    ``_ocean_kernel`` (qingdai_tpu/ops/pallas_ocean.py) computes, with the
    port's full bilinear gather in place of the TPU's shift window."""
    return _substeps(mom, st, forc, geo, **params)


class OceanSubsteps(torch.autograd.Function):
    """K4 on a CUDA tensor; its gradient with respect to the four stacks
    the plain version's VJP (all ``n_sub`` substeps recomputed in the plain
    ops); under ``torch.func.vmap`` the batched form, one cooperative launch
    for every member (``ops.members``). ``params`` is the dict of keyword
    parameters."""

    @staticmethod
    def forward(mom, st, forc, geo, params):
        from .kernels.ocean_substeps import ocean_substeps_cuda
        return ocean_substeps_cuda(mom, st, forc, geo, **params)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:4])
        ctx.params = inputs[4]

    @staticmethod
    def backward(ctx, g_mom, g_st):
        return plain_vjp(lambda *ops: ocean_substeps_plain(*ops[:4], **ops[4]),
                         (*ctx.saved_tensors, ctx.params), (g_mom, g_st), ctx.needs_input_grad)

    @staticmethod
    def vmap(info, in_dims, mom, st, forc, geo, params):
        from .kernels.ocean_substeps import ocean_substeps_batched_cuda
        refuse_grad("ocean_substeps", mom, st, forc, geo)
        ops = [to_front(t, d) for t, d in zip((mom, st, forc, geo), in_dims)]
        return ocean_substeps_batched_cuda(*ops, info.batch_size, **params), (0, 0)


def ocean_substeps(mom, st, forc, geo, **params):
    """K4 on a CUDA tensor, its plain version on a CPU tensor."""
    if not use_kernel(st):
        return ocean_substeps_plain(mom, st, forc, geo, **params)
    return OceanSubsteps.apply(mom, st, forc, geo, params)


def ocean_substeps_sharded(mom, st, forc, geo, mesh, **params):
    """``ocean_substeps`` on a rank of ``mesh``: the rank's columns of
    ``mom`` and ``st`` in and out, ``forc`` and ``geo`` padded by at least
    ``halo(k4_nsub)`` columns on each side (``substep_operands``' pad). On a
    CUDA tensor K4's sharded form, a substep at a time: the halo of ``mom``
    exchanged, ``st`` gathered whole, the tile pass, the η sums added across
    ranks, the finish. On a CPU tensor its plain version, ``_substeps`` with
    the mesh on the rank's columns. Every owned cell equals the whole grid's
    call but for the η mean's order of summation."""
    w = st.shape[-1]
    pad = (forc.shape[-1] - w) // 2
    if pad < halo(params["k4_nsub"])[1] or geo.shape[-1] != forc.shape[-1]:
        raise ValueError(f"forc and geo of {forc.shape[-1]} and {geo.shape[-1]} columns are not "
                         f"the rank's {w} padded by at least {halo(params['k4_nsub'])[1]}")
    if not use_kernel(st):
        own = lambda x: x[..., pad:pad + w]
        return _substeps(mom, st, own(forc), own(geo), **params, mesh=mesh)
    from .kernels.ocean_substeps import ocean_substep_sharded_cuda
    lon0 = mesh.rank * w
    one = dict(params, n_sub=1)
    for _ in range(params["n_sub"]):
        mom, st = ocean_substep_sharded_cuda(
            pad_lon(mom, pad, "wrap", mesh), all_gather_lon(st, mesh), forc, geo, pad=pad,
            lon0=lon0, reduce_sums=lambda v: all_reduce_sum(v, mesh), **one)
    return mom, st


def fused_structure(cfg: OceanConfig) -> bool:
    """Whether the substeps run as one ``ocean_substeps`` call: the numerical
    conditions of the JAX package's gate (Shapiro off, ∇⁴ every step)."""
    return not (cfg.shapiro_n > 0 and cfg.shapiro_every > 0) and cfg.diff_every == 1


# ---------------- main step ----------------

def geo_stack(grid: Grid, cfg: OceanConfig, land_mask, ice_mask, sub_dt: float, dtype):
    """The geometry planes ``geo`` (``GEO_*``) on ``grid``'s columns: the
    grid's maps, the land and ice masks, the latitude-adaptive K4 maps."""
    a = const.PLANET_RADIUS
    coslat = grid.coslat_cap_05
    on_land = land_mask == 1
    ocean_mask = ~on_land

    # polar sponge profile
    lat_deg = torch.abs(torch.rad2deg(grid.lat_rad))
    s = torch.clamp((lat_deg - cfg.polar_lat0) / max(1e-6, 90.0 - cfg.polar_lat0), 0.0, 1.0)
    r_extra = cfg.polar_gain * (s ** 2)

    # latitude-adaptive K4 maps (the reference divides by sub_dt)
    dx_min_map = torch.clamp(a * grid.dlon_rad * coslat, max=a * grid.dlat_rad)
    k4_map = cfg.sigma4 * pow4(dx_min_map) / max(1e-12, sub_dt)
    k4_u = k4_map if cfg.k4_u is None else torch.full_like(k4_map, cfg.k4_u)
    k4_v = k4_map if cfg.k4_v is None else torch.full_like(k4_map, cfg.k4_v)
    k4_eta = 0.5 * k4_map if cfg.k4_eta is None else torch.full_like(k4_map, cfg.k4_eta)

    planes = [grid.f, coslat, grid.coslat, grid.coslat_cap_tiny, r_extra, on_land,
              ocean_mask & ~ice_mask, ocean_mask & ice_mask, grid.area_w * ocean_mask,
              k4_u, k4_v, k4_eta]
    return torch.stack([x.to(dtype) for x in planes])


def sharded_pad(cfg: OceanConfig) -> int:
    """The columns of each neighbour's that K4's sharded form reads around a
    rank's (``kernels.ocean_substeps.halo``)."""
    return halo(max(1, int(cfg.k4_nsub)))[1]


def substep_operands(grid: Grid, cfg: OceanConfig, land_mask, ocn: OceanState, u_atm, v_atm,
                     Q_net, ice_mask, dt: float, n_sub: int, tracers=None, pad: int = 0):
    """(mom, st, forc, geo, params): the stacks and keyword parameters of
    :func:`ocean_substeps` for one outer step (``ocean.py:172-189`` of the
    JAX package). With ``pad`` (a rank of the longitude mesh whose grid
    holds padded maps), ``forc`` and ``geo`` also hold ``pad`` columns of
    each neighbour's: the step's fields (the forcing, the land and ice
    masks) in one exchange, the grid's maps from ``Grid.padded`` in none."""
    dtype = ocn.sst.dtype

    # wind stress from the relative wind, constant within the substeps
    u_rel = u_atm - ocn.uo
    v_rel = v_atm - ocn.vo
    Va_eff = torch.clamp(safegrad.speed(u_rel, v_rel), max=cfg.vcap)
    tau_x = cfg.tau_scale * (cfg.rho_a * cfg.CD * Va_eff * u_rel)
    tau_y = cfg.tau_scale * (cfg.rho_a * cfg.CD * Va_eff * v_rel)
    forc = torch.stack([tau_x / (cfg.rho_w * cfg.H_m), tau_y / (cfg.rho_w * cfg.H_m),
                        Q_net / (cfg.rho_w * cfg.cp_w * cfg.H_m)])
    sub_dt = dt / n_sub
    geo_grid = grid
    if pad:
        fp = pad_lon(torch.cat([forc, land_mask[None].to(dtype), ice_mask[None].to(dtype)]),
                     pad, "wrap", grid.mesh)
        forc, land_mask, ice_mask = fp[:3], fp[3], fp[4] > 0.5
        geo_grid = grid.padded_by(pad)
    geo = geo_stack(geo_grid, cfg, land_mask, ice_mask, sub_dt, dtype)
    mom = torch.stack([ocn.uo, ocn.vo, ocn.eta])
    st = ocn.sst[None] if tracers is None else torch.cat([ocn.sst[None], tracers])
    params = dict(n_sub=n_sub, k4_nsub=max(1, int(cfg.k4_nsub)), sub_dt=sub_dt, H_m=cfg.H_m,
                  r_bot=cfg.r_bot, g=9.81, a=const.PLANET_RADIUS, dlat=grid.dlat_rad,
                  dlon=grid.dlon_rad, K_h=cfg.K_h, adv_alpha=cfg.adv_alpha,
                  use_qnet=cfg.use_qnet, ice_qfac=cfg.ice_qfac, cap=cfg.max_u_cap,
                  mean4=cfg.outlier_method == "mean4", eta_cap=cfg.eta_cap)
    return mom, st, forc, geo, params


def ocean_step(grid: Grid, cfg: OceanConfig, land_mask, ocn: OceanState, u_atm, v_atm,
               Q_net, ice_mask, step_idx: int, dt: float, n_sub: int, tracers=None):
    """Advance the slab ocean one outer step with ``n_sub`` static substeps.

    ``tracers`` ([T, H, W], optional, ``n_sub == 1`` only) are advected by
    the same departure-point gather as the SST (the model passes the
    phytoplankton chlorophyll stack). Returns (OceanState, advected tracers
    or None)."""
    if tracers is not None and n_sub != 1:
        raise ValueError("shared-gather tracers require n_sub == 1")
    mesh = grid.mesh
    sharded = fused_structure(cfg) and not single(mesh)
    mom, st, forc, geo, params = substep_operands(grid, cfg, land_mask, ocn, u_atm, v_atm,
                                                  Q_net, ice_mask, dt, n_sub, tracers,
                                                  sharded_pad(cfg) if sharded else 0)
    if sharded:
        mom, st = ocean_substeps_sharded(mom, st, forc, geo, mesh, **params)
    elif fused_structure(cfg):
        mom, st = ocean_substeps(mom, st, forc, geo, **params)
    else:
        # the reference increments its counter at the start of a step
        apply_diff = cfg.diff_every > 0 and (step_idx + 1) % max(1, cfg.diff_every) == 0
        apply_shap = (cfg.shapiro_n > 0 and cfg.shapiro_every > 0
                      and (step_idx + 1) % max(1, cfg.shapiro_every) == 0)
        mom, st = _substeps(mom, st, forc, geo, **params, diffuse=apply_diff,
                            shapiro_n=cfg.shapiro_n if apply_shap else 0, plain=False,
                            mesh=mesh)

    uo, vo, eta, sst = mom[0], mom[1], mom[2], st[0]
    ocean_mask = land_mask != 1
    if cfg.polar_fix:
        lons_rad = torch.deg2rad(grid.lon)
        sst = polar_scalar_average_fill(sst, ocean_mask, mesh)
        uo, vo = polar_vector_average_fill(uo, vo, ocean_mask, lons_rad, mesh)

    sst = torch.clamp(sst, cfg.ts_min, cfg.ts_max)
    return OceanState(uo=uo, vo=vo, eta=eta, sst=sst), (st[1:] if tracers is not None else None)


def ocean_diagnostics(grid: Grid, cfg: OceanConfig, ocn: OceanState):
    """KE, max |u|, η range and CFL scalars."""
    KE = 0.5 * (ocn.uo ** 2 + ocn.vo ** 2)
    speed = safegrad.speed(ocn.uo, ocn.vo)
    a = const.PLANET_RADIUS
    dx_min = min(a * grid.dlat_rad, a * grid.dlon_rad * 0.5)
    c = math.sqrt(9.81 * cfg.H_m)
    mesh = grid.mesh
    return {
        "KE_mean": area_mean(KE, grid.area_w, mesh=mesh),
        "U_max": gmax(speed, mesh),
        "eta_min": gmin(ocn.eta, mesh),
        "eta_max": gmax(ocn.eta, mesh),
        "cfl_per_s": torch.full((), c / max(1e-12, dx_min), dtype=KE.dtype, device=KE.device),
    }
