"""Ocean phytoplankton and ocean color (port of ``qingdai_tpu/ecology/phyto.py``).

S-species mixed-layer chlorophyll with spectral light limitation, a Q10
temperature factor, Michaelis-Menten single-nutrient competition, band
optics → water reflectance, and per-physics-step semi-Lagrangian transport
by the ocean currents. The build is NumPy with the JAX package's draws; the
daily step is torch over [S, NB, H, W] broadcasts.

The transport after the gather (blend, ∇² diffusion, mask and clamp, the
polar ring means) runs kernel K5 (``kernels/phyto_transport.py``) on a CUDA
tensor, through ``PhytoTransport`` (an ensemble's members in one launch),
and ``phyto_transport_plain`` on a CPU tensor and on a rank of the longitude
mesh, whose ring sums add across ranks. The JAX package leaves this chain to
XLA's fusion; eager PyTorch would launch some 75 kernels for it a step.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import constants as const
from ..config import EcologyConfig, PhytoConfig
from ..grid import Grid
from ..kernels import use_kernel
from ..ops import safegrad
from ..ops.advect import advect_semilag_multi
from ..ops.members import members_first, plain_vjp, refuse_grad
from ..ops.reductions import sum_fixed
from ..ops.stencil import laplacian_sphere
from ..parallel.halo import gsums, single
from . import spectral as spec


@dataclasses.dataclass(frozen=True)
class PhytoStatic:
    S: int
    NB: int
    idx_490: int
    H_mld: float
    ocean: torch.Tensor         # bool [H,W]
    Kd0_b: torch.Tensor         # [NB]
    kchl_b: torch.Tensor        # [NB]
    Apure_b: torch.Tensor       # [NB]
    shape_sb: torch.Tensor      # [S,NB] normalized Gaussian shapes
    c_reflect_s: torch.Tensor   # [S]
    p_reflect_s: torch.Tensor   # [S]
    mu_max_s: torch.Tensor      # [S]
    m0_s: torch.Tensor          # [S]
    KN_s: torch.Tensor          # [S]
    Y_s: torch.Tensor           # [S]
    w_b: torch.Tensor           # [NB]
    dlam_b: torch.Tensor        # [NB] band widths Δλ (nm)
    specA: torch.Tensor         # [NB]
    specB: torch.Tensor
    T_ray: torch.Tensor


@dataclasses.dataclass(frozen=True)
class PhytoState:
    C_phyto: torch.Tensor       # [S,H,W] chlorophyll mg/m^3
    N: torch.Tensor             # [H,W] nutrient mmol/m^3
    alpha_bands: torch.Tensor   # [NB,H,W]
    alpha_scalar: torch.Tensor  # [H,W]
    Kd_490: torch.Tensor        # [H,W]


def _fill(vals, default, n):
    out = np.full((n,), float(default))
    if vals is not None:
        for i, v in enumerate(vals[:n]):
            out[i] = float(v)
    return out


def build_phyto(grid_shape, land_mask, cfg: PhytoConfig, eco_cfg: EcologyConfig,
                H_mld_m: float, device, dtype=torch.float32, seed=None):
    """(PhytoStatic, PhytoState, bands) from the config and the land mask,
    with the same NumPy draws as the JAX package's ``build_phyto``."""
    H, W = grid_shape
    bands = spec.make_bands(eco_cfg)
    NB = bands.nbands
    S = cfg.n_species
    lam = bands.lambda_centers

    Kd0 = _fill(cfg.kd0, cfg.kd0_default, NB)
    kchl = _fill(cfg.kd_chl, cfg.kd_chl_default, NB)
    Apure = _fill(cfg.apure, cfg.apure_default, NB)

    mu_defaults = (np.linspace(460.0, 680.0, S) if S > 1
                   else np.array([cfg.shape_mu_nm]))
    shape_sb = np.zeros((S, NB))
    c_ref = np.zeros(S)
    p_ref = np.zeros(S)
    for s in range(S):
        mu_s = cfg.spec_mu_nm[s] if (cfg.spec_mu_nm and s < len(cfg.spec_mu_nm)) \
            else float(mu_defaults[min(s, len(mu_defaults) - 1)])
        sig_s = cfg.spec_sigma_nm[s] if (cfg.spec_sigma_nm and s < len(cfg.spec_sigma_nm)) \
            else cfg.shape_sigma_nm
        g = np.exp(-((lam - mu_s) ** 2) / (2.0 * sig_s ** 2))
        shape_sb[s] = g / (g.sum() + 1e-12)
        c_ref[s] = (cfg.spec_c_reflect[s] if (cfg.spec_c_reflect and s < len(cfg.spec_c_reflect))
                    else cfg.reflect_c)
        p_ref[s] = (cfg.spec_p_reflect[s] if (cfg.spec_p_reflect and s < len(cfg.spec_p_reflect))
                    else cfg.reflect_p)

    mu_max_s = _fill(cfg.spec_mu_max, cfg.mu_max, S)
    m0_s = _fill(cfg.spec_m0, cfg.m0, S)
    KN_s = _fill(cfg.KN, 0.5, S)
    Y_s = _fill(cfg.yield_s, 1.0, S)

    if cfg.init_frac is not None and len(cfg.init_frac) >= S:
        frac = np.clip(np.asarray(cfg.init_frac[:S], float), 0.0, None)
        frac = frac / frac.sum() if frac.sum() > 0 else np.full(S, 1.0 / S)
    else:
        frac = np.full(S, 1.0 / S)

    ocean = np.asarray(land_mask) == 0
    C0 = np.where(ocean[None], frac[:, None, None] * cfg.chl0, 0.0)
    if cfg.init_random:
        # QD_PHYTO_INIT_RANDOM=1: ±30% multiplicative noise over ocean
        rng = np.random.default_rng(seed)
        noise = (rng.random((S, H, W)) * 2.0 - 1.0) * 0.3
        C0 = np.clip(C0 * (1.0 + noise), 0.0, np.inf)
    N0 = np.where(ocean, cfg.N_init, 0.0)

    w_b = spec.band_weights(bands, eco_cfg)
    specA, specB, T_ray = spec.star_band_spectra(bands, eco_cfg)

    def t(x, dt_=dtype):
        return torch.as_tensor(np.asarray(x)).to(device=device, dtype=dt_)

    static = PhytoStatic(
        S=S, NB=NB, idx_490=int(np.argmin(np.abs(lam - 490.0))),
        H_mld=float(max(0.1, H_mld_m)),
        ocean=t(ocean, torch.bool),
        Kd0_b=t(Kd0), kchl_b=t(kchl), Apure_b=t(Apure), shape_sb=t(shape_sb),
        c_reflect_s=t(c_ref), p_reflect_s=t(p_ref), mu_max_s=t(mu_max_s), m0_s=t(m0_s),
        KN_s=t(KN_s), Y_s=t(Y_s), w_b=t(w_b), dlam_b=t(bands.delta_lambda),
        specA=t(specA), specB=t(specB), T_ray=t(T_ray),
    )
    Apure_t = t(Apure)
    state = PhytoState(
        C_phyto=t(C0), N=t(N0),
        alpha_bands=Apure_t[:, None, None].expand(NB, H, W).clone(),
        alpha_scalar=torch.full((H, W), float(np.sum(Apure * w_b)), dtype=dtype, device=device),
        Kd_490=torch.zeros((H, W), dtype=dtype, device=device),
    )
    return static, state, bands


def _alpha_bands_from_species(ps: PhytoStatic, cfg: PhytoConfig, C_phyto):
    """A_b = A_pure_b + Σ_s c_s·Shape_s[b]·Chl_s^p_s (phyto.py:314-335)."""
    chl = torch.clamp(C_phyto, min=0.0)
    term = safegrad.pow_safe(chl, ps.p_reflect_s[:, None, None])          # [S,H,W]
    contrib = torch.einsum("sb,shw->bhw", ps.shape_sb * ps.c_reflect_s[:, None], term)
    A = ps.Apure_b[:, None, None] + contrib
    return torch.clamp(A, cfg.alpha_min, cfg.alpha_max)


def phyto_step_daily(ps: PhytoStatic, st: PhytoState, cfg: PhytoConfig,
                     insA, insB, T_w, dt_days: float = 1.0) -> PhytoState:
    """Daily growth/loss/nutrient/optics update (phyto.py:339-435)."""
    I_b_surf = spec.dual_star_insolation_to_bands(insA, insB, ps.specA, ps.specB, ps.T_ray)

    C_tot = torch.sum(st.C_phyto, dim=0)
    chl_pow = safegrad.pow_safe(torch.clamp(C_tot, min=0.0), cfg.kd_exp_m)
    Kd_b = torch.clamp(ps.Kd0_b[:, None, None] + ps.kchl_b[:, None, None] * chl_pow[None],
                       min=1e-6)
    x = Kd_b * ps.H_mld
    factor = torch.where(x < 1e-6, 1.0 - 0.5 * x + x * x / 6.0,
                         (1.0 - torch.exp(-x)) / torch.clamp(x, min=1e-12))
    Ibar_b = torch.clamp(I_b_surf * factor, min=0.0)

    # species light proxy E_s = Σ_b Ī_b Shape_s[b] Δλ_b (phyto.py:358-367)
    E_s = torch.einsum("sb,bhw->shw", ps.shape_sb, Ibar_b * ps.dlam_b[:, None, None])

    mu_max = ps.mu_max_s[:, None, None]
    muL_s = torch.tanh(cfg.alpha_P * E_s / torch.clamp(mu_max, min=1e-6))
    fT = torch.pow(cfg.Q10, (T_w - cfg.T_ref) / 10.0)

    sink = (cfg.lambda_sink / max(1e-6, ps.H_mld)) if cfg.lambda_sink > 0 else 0.0
    if cfg.enable_N:
        KN = torch.clamp(ps.KN_s[:, None, None], min=1e-12)
        fN = torch.clamp(st.N[None] / (KN + st.N[None]), 0.0, 1.0)
        mu_grow = mu_max * muL_s * fT[None] * fN
    else:
        mu_grow = mu_max * muL_s * fT[None]
    mu = mu_grow - (ps.m0_s[:, None, None] + sink)

    C_new = torch.clamp(st.C_phyto + mu * st.C_phyto * dt_days, min=0.0)
    C_new = torch.where(ps.ocean[None], C_new, 0.0)

    N_new = st.N
    if cfg.enable_N:
        uptake = torch.sum(mu_grow * C_new / torch.clamp(ps.Y_s[:, None, None], min=1e-12),
                           dim=0)
        N_new = torch.clamp(st.N + (-uptake + cfg.remin) * dt_days, min=0.0)
        N_new = torch.where(ps.ocean, N_new, 0.0)

    alpha_b = _alpha_bands_from_species(ps, cfg, C_new)
    alpha_scalar = torch.clamp(torch.sum(alpha_b * ps.w_b[:, None, None], dim=0),
                               cfg.alpha_min, cfg.alpha_max)
    return PhytoState(C_phyto=C_new, N=N_new, alpha_bands=alpha_b,
                      alpha_scalar=alpha_scalar, Kd_490=Kd_b[ps.idx_490])


def phyto_transport_plain(C_phyto: torch.Tensor, C_adv: torch.Tensor, ocean: torch.Tensor,
                          coslat: torch.Tensor, alpha: float, K_h: float, dt: float,
                          dlat: float, dlon: float, a: float, mesh=None) -> torch.Tensor:
    """Plain version of kernel K5: blend, lateral diffusion, masking and the
    polar ring means of the chlorophyll [S, H, W] given the advected stack
    ``C_adv``, the ocean mask and the capped cos map."""
    C = (1.0 - alpha) * C_phyto + alpha * C_adv
    if K_h > 0.0:
        C = torch.nan_to_num(C)
        C = C + dt * K_h * laplacian_sphere(C, dlat, dlon, coslat, a, mesh)
    C = torch.where(ocean[None], torch.clamp(C, min=0.0), 0.0)

    # polar ring averaging (phyto.py:531-547), both rows in one pass (on a
    # mesh, their sums and counts over every rank in one collective); the
    # ring sums add in one order, so a batched member's equal a single call's
    rows = (0, -1)
    sums = gsums([x for r in rows for x in (torch.sum(ocean[r]), sum_fixed(
        torch.where(ocean[r][None], C[:, r], 0.0), 1))], mesh)
    news = []
    for k, row in enumerate(rows):
        m, n = ocean[row], sums[2 * k]
        mean_row = sums[2 * k + 1] / torch.clamp(n, min=1)
        news.append(torch.where(m[None] & (n > 0), mean_row[:, None], C[:, row]))
    rows = torch.arange(C.shape[1], device=C.device)[None, :, None]
    return torch.where(rows == 0, news[0][:, None, :],
                       torch.where(rows == C.shape[1] - 1, news[1][:, None, :], C))


class PhytoTransport(torch.autograd.Function):
    """K5 on a CUDA tensor; its gradient the plain version's VJP; under
    ``torch.func.vmap`` the batched form, one launch for every member
    (``ops.members``)."""

    @staticmethod
    def forward(C_phyto, C_adv, ocean, coslat, alpha, K_h, dt, dlat, dlon, a):
        from ..kernels.phyto_transport import phyto_transport_cuda
        return phyto_transport_cuda(C_phyto.contiguous(), C_adv.contiguous(), ocean.contiguous(),
                                    coslat.contiguous(), alpha, K_h, dt, dlat, dlon, a)

    @staticmethod
    def setup_context(ctx, inputs, output):
        C_phyto, C_adv, ocean, coslat, *scalars = inputs
        ctx.save_for_backward(C_phyto, C_adv, ocean, coslat)
        ctx.scalars = scalars

    @staticmethod
    def backward(ctx, g):
        return plain_vjp(phyto_transport_plain, (*ctx.saved_tensors, *ctx.scalars), (g,),
                         ctx.needs_input_grad)

    @staticmethod
    def vmap(info, in_dims, C_phyto, C_adv, ocean, coslat, alpha, K_h, dt, dlat, dlon, a):
        from ..kernels.phyto_transport import phyto_transport_batched_cuda
        refuse_grad("phyto_transport", C_phyto, C_adv, coslat)
        stacks = [members_first(t, d) for t, d in zip((C_phyto, C_adv, ocean, coslat), in_dims)]
        return phyto_transport_batched_cuda(*stacks, alpha, K_h, dt, dlat, dlon, a,
                                            info.batch_size), 0


def phyto_apply_transport(ps: PhytoStatic, st: PhytoState, cfg: PhytoConfig,
                          grid: Grid, C_adv, dt: float) -> PhytoState:
    """Blend, lateral diffusion and masking given the advected chlorophyll
    (the gather may have ridden the ocean's SST advection, kernel K4): K5
    on a CUDA tensor, the plain version on a CPU tensor or a mesh rank."""
    args = (st.C_phyto, C_adv, ps.ocean, grid.coslat_cap_05, cfg.adv_alpha, cfg.K_h, dt,
            grid.dlat_rad, grid.dlon_rad, const.PLANET_RADIUS)
    if single(grid.mesh) and use_kernel(st.C_phyto):
        C = PhytoTransport.apply(*args)
    else:
        C = phyto_transport_plain(*args, grid.mesh)
    return dataclasses.replace(st, C_phyto=C)


def phyto_advect_diffuse(ps: PhytoStatic, st: PhytoState, cfg: PhytoConfig,
                         grid: Grid, uo, vo, dt: float) -> PhytoState:
    """Per-physics-step transport of every species (phyto.py:496-547): one
    departure-point gather shared by the species (kernel K2 on a card)."""
    C_adv = advect_semilag_multi(st.C_phyto, uo, vo, dt, const.PLANET_RADIUS,
                                 grid.dlat_rad, grid.dlon_rad, grid.coslat_cap_05, grid.mesh)
    return phyto_apply_transport(ps, st, cfg, grid, C_adv, dt)
