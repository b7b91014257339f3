"""Ensemble data assimilation: the LETKF over the member-batched ensemble
(port of ``qingdai_tpu/assim.py``).

The Local Ensemble Transform Kalman Filter (Hunt, Kostelich and Szunyogh
2007) combines the ensemble of ``ensemble.py`` with observations into an
analysis ensemble. Every grid cell solves its own k×k ensemble-space
problem (k members); batched over the cells the analysis is a few matmuls
and einsums plus a batched inverse square root, plain PyTorch
(``torch.matmul``, ``torch.einsum``, ``torch.linalg``) on the card as on the
CPU. The JAX package reaches no Pallas kernel here, and the port adds none.

Math (per cell c; background members x_i, mean x̄, deviations X' [k
columns]; obs deviations Y' = H(X) − mean, innovations d = y − H(x̄), obs
error R, Gaspari–Cohn weights ρ_c):

    C_c   = Y'^T (ρ_c ∘ R^{-1}) Y'                 (k×k)
    A_c   = (k−1)I/α + C_c                          (α = inflation)
    w̄_c  = A_c^{-1} Y'^T (ρ_c ∘ R^{-1}) d          (mean weights)
    W_c   = [(k−1) A_c^{-1}]^{1/2}                  (symmetric sqrt)
    x_i^a = x̄ + X' (w̄_c + W_c e_i)

The symmetric square root keeps the analysis deviations zero-mean, so the
analysis mean is x̄ + X'w̄. The inverse square root is a coupled
Newton–Schulz iteration (batched matmuls, no eigendecomposition), with an
``eigh`` path beside it. Localization is in observation space: each cell
scales each observation's precision by a Gaspari–Cohn weight of the
great-circle distance, so observations beyond twice the radius weigh
exactly 0 and the analysis stays one dense computation of static shape.
Observing T_s updates SST, h, q and the winds through the ensemble's
cross-covariances.

Augmented-state parameter estimation appends scalar physics parameters to
the state: each member's forecast runs with its own parameter value
(``make_param_ensemble_chunk_fn``, the adjoint's ``inject_path`` inside the
ensemble's ``torch.func.vmap``), and a global (unlocalized) update moves the
parameters through their cross-covariances with the observed fields
(``letkf_param_analysis``).

Random numbers (the observing network, the observation noise) come from an
explicit ``torch.Generator``; the JAX package's ``jax.random`` streams cannot
be reproduced, so the two packages agree on given draws. The OSSE driver is
``qingdai_tpu_torch.assimilate``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import constants as const
from . import ensemble as E
from . import model as M
from .adjoint import PARAM_ALIASES, inject_path
from .state import WorldState


# ---------------------------------------------------------------------------
# assimilated-field registry: name -> (get, set, guard)
# ---------------------------------------------------------------------------

def _get_atmos(name):
    return lambda s: getattr(s.atmos, name)


def _set_atmos(name):
    def set_(s, v):
        return dataclasses.replace(s, atmos=dataclasses.replace(s.atmos, **{name: v}))
    return set_


def _get_ocean(name):
    return lambda s: getattr(s.ocean, name)


def _set_ocean(name):
    def set_(s, v):
        return dataclasses.replace(s, ocean=dataclasses.replace(s.ocean, **{name: v}))
    return set_


# guards keep the analysis physical: the update is unconstrained linear
# algebra, so bounded or positive fields are projected back into their
# admissible range (the clamps the model itself applies)
_FIELDS = {
    "T_s": (_get_atmos("T_s"), _set_atmos("T_s"), lambda v: torch.clamp(v, 150.0, 400.0)),
    "sst": (_get_ocean("sst"), _set_ocean("sst"), lambda v: torch.clamp(v, 150.0, 340.0)),
    "h": (_get_atmos("h"), _set_atmos("h"), None),
    "q": (_get_atmos("q"), _set_atmos("q"), lambda v: torch.clamp(v, min=0.0)),
    "u": (_get_atmos("u"), _set_atmos("u"), None),
    "v": (_get_atmos("v"), _set_atmos("v"), None),
    "cloud_cover": (_get_atmos("cloud_cover"), _set_atmos("cloud_cover"),
                    lambda v: torch.clamp(v, 0.0, 1.0)),
}

# ocean-only fields: the update is masked back to the background over land,
# where the value is a placeholder the model never reads
_OCEAN_ONLY = ("sst",)


@dataclasses.dataclass(frozen=True)
class AssimConfig:
    """LETKF configuration (command-line arguments, not ``QD_*``)."""
    fields: tuple = ("T_s", "sst", "h", "q")
    obs_field: str = "T_s"
    obs_err: float = 1.0           # observation error std dev (field units)
    loc_radius_km: float = 2000.0  # Gaspari–Cohn radius c (support 2c); 0: global ETKF
    inflation: float = 1.04        # multiplicative prior-covariance inflation
    rtps: float = 0.6              # relaxation to prior spread (Whitaker & Hamill 2012); 0: off
    solver: str = "ns"             # "ns" (Newton–Schulz) | "eigh"
    ns_iters: int = 25


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def gaspari_cohn(r: torch.Tensor) -> torch.Tensor:
    """Gaspari & Cohn (1999) 5th-order compact correlation, eq. 4.10, of
    ``r`` = distance / c: 1 at r = 0, exactly 0 for r >= 2, C² everywhere."""
    r = torch.abs(r)
    r2, r3, r4, r5 = r * r, r ** 3, r ** 4, r ** 5
    near = -0.25 * r5 + 0.5 * r4 + 0.625 * r3 - (5.0 / 3.0) * r2 + 1.0
    far = (r5 / 12.0 - 0.5 * r4 + 0.625 * r3 + (5.0 / 3.0) * r2
           - 5.0 * r + 4.0 - (2.0 / 3.0) / torch.clamp(r, min=1e-12))
    zero = torch.zeros_like(r)
    return torch.where(r <= 1.0, near, torch.where(r < 2.0, torch.clamp(far, min=0.0), zero))


def great_circle_km(lat1, lon1, lat2, lon2, radius_m: float) -> torch.Tensor:
    """Haversine great-circle distance (km); arguments in degrees,
    broadcastable."""
    p1, p2 = torch.deg2rad(lat1), torch.deg2rad(lat2)
    dphi = p2 - p1
    dlmb = torch.deg2rad(lon2 - lon1)
    a = torch.sin(dphi / 2.0) ** 2 + torch.cos(p1) * torch.cos(p2) * torch.sin(dlmb / 2.0) ** 2
    return (2.0 * radius_m / 1e3) * torch.arcsin(torch.sqrt(torch.clamp(a, 0.0, 1.0)))


def inv_and_inv_sqrt_psd(A: torch.Tensor, iters: int = 25):
    """Batched (A^{-1}, A^{-1/2}) of SPD matrices [..., k, k] by the coupled
    Newton–Schulz iteration: with Y₀ = A/c, Z₀ = I and T = (3I − ZY)/2,
    Y ← YT and Z ← TZ, so Y → (A/c)^{1/2} and Z → (A/c)^{-1/2}. The ∞-norm c
    bounds λmax, so every eigenvalue of A/c lies in (0, 1]; 25 iterations
    cover condition numbers to ~1e8 at float32 roundoff."""
    k = A.shape[-1]
    eye = torch.eye(k, dtype=A.dtype, device=A.device)
    c = torch.amax(torch.sum(torch.abs(A), dim=-1), dim=-1)   # ∞-norm ≥ λmax
    c = torch.clamp(c, min=1e-30)[..., None, None]
    Y = A / c
    Z = eye.expand(A.shape)
    for _ in range(iters):
        T = 0.5 * (3.0 * eye - Z @ Y)
        Y, Z = Y @ T, T @ Z
    return (Z @ Z) / c, Z / torch.sqrt(c)


# cuSOLVER's batched eigh (cusolverDnXsyevBatched) refuses batches of 2**15
# matrices and more, so the cells go to it in slices of this many
EIGH_SLICE = 1 << 14


def _inv_and_inv_sqrt_eigh(A: torch.Tensor):
    """The reference path: batched (A^{-1}, A^{-1/2}) from ``eigh``."""
    k = A.shape[-1]
    parts = [torch.linalg.eigh(a) for a in A.reshape(-1, k, k).split(EIGH_SLICE)]
    w = torch.cat([p[0] for p in parts]).reshape(A.shape[:-1])
    V = torch.cat([p[1] for p in parts]).reshape(A.shape)
    w = torch.clamp(w, min=1e-30)
    inv = torch.einsum("...ij,...j,...kj->...ik", V, 1.0 / w, V)
    inv_sqrt = torch.einsum("...ij,...j,...kj->...ik", V, 1.0 / torch.sqrt(w), V)
    return inv, inv_sqrt


def _inv_pair(A: torch.Tensor, solver: str, ns_iters: int):
    if solver == "eigh":
        return _inv_and_inv_sqrt_eigh(A)
    if solver == "ns":
        return inv_and_inv_sqrt_psd(A, iters=ns_iters)
    raise ValueError(f"solver {solver!r}: expected 'ns' or 'eigh'")


def _precision(obs_err, p: int, like: torch.Tensor) -> torch.Tensor:
    """R^{-1} [p] of a scalar or [p] observation error std dev."""
    err = torch.as_tensor(obs_err, dtype=like.dtype, device=like.device)
    return 1.0 / torch.broadcast_to(err, (p,)) ** 2


# ---------------------------------------------------------------------------
# the analysis
# ---------------------------------------------------------------------------

def obs_background(X: torch.Tensor, y: torch.Tensor, obs_cell, obs_field_idx):
    """(x̄ [F, C], X' [k, F, C], Y' [k, p], d [p]) of a flat ensemble X
    [k, F, C]: H is a pointwise gather of field ``obs_field_idx`` at cell
    ``obs_cell``."""
    k, F, C = X.shape
    xbar = torch.mean(X, dim=0)
    Xp = X - xbar[None]
    fidx = torch.as_tensor(obs_field_idx, device=X.device).long()
    gidx = fidx * C + torch.as_tensor(obs_cell, device=X.device).long()
    Yp = Xp.reshape(k, F * C)[:, gidx]
    d = y.to(X.dtype) - xbar.reshape(F * C)[gidx]
    return xbar, Xp, Yp, d


def _letkf_update(xbar, Xp, Yp, d, obs_cell, cell_lat, cell_lon, obs_err, loc_radius_km,
                  inflation, rtps, planet_radius_m, solver, ns_iters):
    """The analysis ensemble [k, F, C] from ``obs_background``'s pieces."""
    k, F, C = Xp.shape
    p = d.shape[0]
    dtype, dev = Xp.dtype, Xp.device
    rinv = _precision(obs_err, p, Xp)
    if loc_radius_km and loc_radius_km > 0:
        oc = torch.as_tensor(obs_cell, device=dev).long()
        dist = great_circle_km(cell_lat[:, None], cell_lon[:, None], cell_lat[oc][None, :],
                               cell_lon[oc][None, :], planet_radius_m)      # [C, p]
        rho = gaspari_cohn(dist / loc_radius_km).to(dtype)
    else:
        rho = torch.ones((C, p), dtype=dtype, device=dev)
    w_obs = rho * rinv[None, :]                                            # [C, p]

    # C_c = Y' diag(w_c) Y'^T: one [C, p] × [p, k²] product
    YY = (Yp[:, None, :] * Yp[None, :, :]).reshape(k * k, p)
    Cmat = (w_obs @ YY.T).reshape(C, k, k)
    A = Cmat + (k - 1) / inflation * torch.eye(k, dtype=dtype, device=dev)[None]
    Ainv, Ainv_sqrt = _inv_pair(A, solver, ns_iters)

    # mean weights w̄_c = A^{-1} Y'(w_c ∘ d)
    g = w_obs @ (Yp * d[None, :]).T                                        # [C, k]
    wbar = torch.einsum("cij,cj->ci", Ainv, g)
    W = float(np.sqrt(k - 1)) * Ainv_sqrt

    incr_mean = torch.einsum("nfc,cn->fc", Xp, wbar)
    pert = torch.einsum("nfc,cni->ifc", Xp, W)
    if rtps and rtps > 0.0:
        # W is the symmetric root, so pert is zero-mean: std == rms
        sig_b = torch.sqrt(torch.mean(Xp * Xp, dim=0))
        sig_a = torch.sqrt(torch.mean(pert * pert, dim=0))
        scale = (rtps * sig_b + (1.0 - rtps) * sig_a) / torch.clamp(sig_a, min=1e-12)
        pert = pert * scale[None]
    return xbar[None] + incr_mean[None] + pert


def letkf_analysis(X, y, obs_cell, obs_field_idx, cell_lat, cell_lon, obs_err=1.0,
                   loc_radius_km=2000.0, inflation=1.04, rtps=0.0, planet_radius_m=6.371e6,
                   solver="ns", ns_iters=25) -> torch.Tensor:
    """LETKF analysis of a flat ensemble; static shapes throughout.

    X: background ensemble [k, F, C]; y: observations [p]; obs_cell: flat
    cell index of each observation [p]; obs_field_idx: the F index each
    observation measures [p]; cell_lat, cell_lon: per-cell degrees [C];
    obs_err: error std dev (scalar or [p]); loc_radius_km: Gaspari–Cohn
    radius (0: every cell uses every observation at full weight, the global
    ETKF); inflation α, applied as (k−1)/α in ensemble space; rtps: per
    cell and field the analysis deviations scaled by (α·σ_b + (1−α)·σ_a)/σ_a
    (0: off; the analysis mean is untouched either way); solver "ns"
    (Newton–Schulz) or "eigh". Returns the analysis ensemble [k, F, C]."""
    xbar, Xp, Yp, d = obs_background(X, y, obs_cell, obs_field_idx)
    return _letkf_update(xbar, Xp, Yp, d, obs_cell, cell_lat, cell_lon, obs_err,
                         loc_radius_km, inflation, rtps, planet_radius_m, solver, ns_iters)


def gather_fields(ens_state: WorldState, fields) -> torch.Tensor:
    """The assimilated fields stacked as [k, F, H, W]."""
    return torch.stack([_FIELDS[f][0](ens_state) for f in fields], dim=1)


def scatter_fields(ens_state: WorldState, fields, Xa: torch.Tensor, land_mask) -> WorldState:
    """A new ensemble state with the analysis ``Xa`` [k, F, H, W] written
    back through each field's guard, the background kept over land for
    ocean-only fields. ``ens_state`` is not written to: the caller may keep
    the background (and a free control that shares its tensors)."""
    out = ens_state
    for i, f in enumerate(fields):
        get, set_, guard = _FIELDS[f]
        v = Xa[:, i]
        if guard is not None:
            v = guard(v)
        if f in _OCEAN_ONLY:
            v = torch.where(land_mask[None] == 0, v, get(ens_state))
        out = set_(out, v.to(get(ens_state).dtype))
    return out


def _cell_coords(model: M.Model):
    return model.grid.lat_mesh.reshape(-1), model.grid.lon_mesh.reshape(-1)


def _check_fields(cfg: AssimConfig):
    for f in cfg.fields:
        if f not in _FIELDS:
            raise ValueError(f"assimilated field {f!r}: expected one of {sorted(_FIELDS)}")
    if cfg.obs_field not in cfg.fields:
        raise ValueError(f"observed field {cfg.obs_field!r} not in assimilated fields "
                         f"{tuple(cfg.fields)}")


def make_analysis_fn(model: M.Model, cfg: AssimConfig, n_obs: int):
    """``analysis(ens_state, y, obs_cell) -> ens_state``: the LETKF of
    ``n_obs`` observations of ``cfg.obs_field``, whose locations and values
    may change from call to call."""
    _check_fields(cfg)
    fields = tuple(cfg.fields)
    fidx = torch.full((n_obs,), fields.index(cfg.obs_field), dtype=torch.long,
                      device=model.device)
    lat, lon = _cell_coords(model)
    land = model.static.land_mask

    def analysis(ens_state: WorldState, y: torch.Tensor, obs_cell: torch.Tensor):
        Xf = gather_fields(ens_state, fields)
        k, F, H, W = Xf.shape
        Xa = letkf_analysis(Xf.reshape(k, F, H * W), y, obs_cell, fidx, lat, lon,
                            obs_err=cfg.obs_err, loc_radius_km=cfg.loc_radius_km,
                            inflation=cfg.inflation, rtps=cfg.rtps,
                            planet_radius_m=const.PLANET_RADIUS, solver=cfg.solver,
                            ns_iters=cfg.ns_iters)
        return scatter_fields(ens_state, fields, Xa.reshape(k, F, H, W), land)

    return analysis


def make_multivar_analysis_fn(model: M.Model, cfg: AssimConfig, obs_spec):
    """The analysis of a multivariate observing network. ``obs_spec`` is a
    tuple of ``(field, n_obs, obs_err)`` blocks, e.g. ``(("T_s", 250, 0.5),
    ("sst", 150, 0.3), ("q", 100, 5e-4))``; every observed field must be one
    of ``cfg.fields``. Returns ``analysis(ens_state, y, obs_cell) ->
    ens_state`` where ``y`` and ``obs_cell`` are the blocks' concatenations
    in spec order (``draw_multivar_obs``)."""
    fields = tuple(cfg.fields)
    for f, _, _ in obs_spec:
        if f not in fields:
            raise ValueError(f"observed field {f!r} not in assimilated fields {fields}")
    fidx = torch.as_tensor(np.concatenate([np.full(n, fields.index(f), np.int64)
                                           for f, n, _ in obs_spec]), device=model.device)
    # the errors pass through float32, as the JAX package's do
    errs = np.concatenate([np.full(n, e, np.float32) for f, n, e in obs_spec])
    errs = torch.as_tensor(errs).to(device=model.device, dtype=model.dtype)
    lat, lon = _cell_coords(model)
    land = model.static.land_mask

    def analysis(ens_state: WorldState, y: torch.Tensor, obs_cell: torch.Tensor):
        Xf = gather_fields(ens_state, fields)
        k, F, H, W = Xf.shape
        Xa = letkf_analysis(Xf.reshape(k, F, H * W), y, obs_cell, fidx, lat, lon,
                            obs_err=errs.to(Xf.dtype), loc_radius_km=cfg.loc_radius_km,
                            inflation=cfg.inflation, rtps=cfg.rtps,
                            planet_radius_m=const.PLANET_RADIUS, solver=cfg.solver,
                            ns_iters=cfg.ns_iters)
        return scatter_fields(ens_state, fields, Xa.reshape(k, F, H, W), land)

    return analysis


def _network_probs(model: M.Model, ocean_only: bool = False) -> torch.Tensor:
    """Area-weighted cell probabilities (float64), zero over land for an
    ocean-only network."""
    w = model.grid.area_w.reshape(-1).to(torch.float64)
    if ocean_only:
        w = torch.where(model.static.land_mask.reshape(-1) == 1, torch.zeros_like(w), w)
    return w / torch.sum(w)


def draw_multivar_obs(generator: torch.Generator, model: M.Model, truth_state: WorldState,
                      obs_spec):
    """One observing network and its synthetic observations per block of
    ``obs_spec``, drawn from ``generator``: (y, obs_cell), concatenated in
    spec order. An ocean-only field draws from ocean cells only (an SST
    instrument cannot sit on land)."""
    ys, cells = [], []
    for f, n, err in obs_spec:
        probs = _network_probs(model, ocean_only=f in _OCEAN_ONLY)
        cell = torch.multinomial(probs, n, replacement=False, generator=generator)
        ys.append(synthetic_obs(generator, truth_state, cell, f, err))
        cells.append(cell)
    return torch.cat(ys), torch.cat(cells)


# ---------------------------------------------------------------------------
# state-augmented parameter estimation
# ---------------------------------------------------------------------------

def make_param_ensemble_chunk_fn(model: M.Model, param_names, chunk_steps: Optional[int] = None,
                                 diag_every: Optional[int] = None):
    """``chunk(ens, theta, generators=None) -> (ens, diags)``: ``theta`` is
    [k, n_params], and member i's forecast runs with theta[i] injected
    (``adjoint.PARAM_ALIASES``, e.g. 'gh_factor' -> cfg.energy.gh_factor).

    Each step is one ``torch.func.vmap`` over the members, as
    ``ensemble.make_ensemble_chunk_fn``'s, with the shared clock unbatched;
    inside the vmapped body the step is built from the model with the
    member's parameters injected, so each member's configuration holds a
    batched 0-d tensor where the model holds a float. Diags and
    ``generators`` as in ``make_ensemble_chunk_fn``."""
    paths = tuple(PARAM_ALIASES.get(p, p) for p in param_names)
    n = chunk_steps or model.cfg.run.chunk_steps
    de = M.diag_stride(model, n, diag_every)

    def member_step(with_diags):
        def step(state, draws, theta_row):
            mdl = model
            for j, path in enumerate(paths):
                mdl = inject_path(mdl, path, theta_row[j])
            return M.make_step_fn(mdl, with_diags=with_diags)(state, draws)
        return step

    step, step_nd = member_step(True), member_step(False)

    def chunk(ens: WorldState, theta: torch.Tensor, generators=None):
        if tuple(theta.shape) != (E.n_members(ens), len(paths)):
            raise ValueError(f"theta: expected [{E.n_members(ens)}, {len(paths)}], got "
                             f"{tuple(theta.shape)}")
        theta = theta.to(device=model.device, dtype=model.dtype)
        return E.run_steps(model, ens, n, de, step, step_nd, generators, (theta,))

    return chunk


def letkf_param_analysis(theta, Yp, d, obs_err, inflation=1.0, rtps=0.0, solver="ns",
                         ns_iters=25) -> torch.Tensor:
    """Global ensemble-space parameter update.

    theta: per-member parameters [k] or [k, n_params]; Yp: the state
    ensemble's obs-space deviations [k, p] (the parameters are not observed:
    they move through these cross-covariances); d: innovations [p];
    obs_err: scalar or [p]; inflation: (k−1)/α in ensemble space, for this
    update only; rtps: relaxation to prior spread of the parameter
    deviations (a parameter has no dynamics to regenerate its spread).
    Returns theta^a of theta's shape and dtype."""
    squeeze = theta.dim() == 1
    th = theta[:, None] if squeeze else theta
    k = th.shape[0]
    dtype = Yp.dtype
    th = th.to(dtype)
    rinv = _precision(obs_err, d.shape[0], Yp)
    C = (Yp * rinv[None, :]) @ Yp.T                                        # [k, k]
    A = C + (k - 1) / inflation * torch.eye(k, dtype=dtype, device=Yp.device)
    Ainv, Ainv_sqrt = (x[0] for x in _inv_pair(A[None], solver, ns_iters))
    wbar = Ainv @ torch.sum(Yp * (rinv * d)[None, :], dim=-1)              # [k]
    W = float(np.sqrt(k - 1)) * Ainv_sqrt
    thbar = torch.mean(th, dim=0)
    Tp = th - thbar[None]
    incr = Tp.T @ wbar
    pert = torch.einsum("ki,kn->in", W, Tp)
    if rtps and rtps > 0.0:
        sig_b = torch.sqrt(torch.mean(Tp * Tp, dim=0))
        sig_a = torch.sqrt(torch.mean(pert * pert, dim=0))
        scale = (rtps * sig_b + (1.0 - rtps) * sig_a) / torch.clamp(sig_a, min=1e-20)
        pert = pert * scale[None]
    out = ((thbar + incr)[None] + pert).to(theta.dtype)
    return out[:, 0] if squeeze else out


def make_augmented_analysis_fn(model: M.Model, cfg: AssimConfig, n_obs: int,
                               param_rtps: Optional[float] = None):
    """``analysis(ens_state, theta, y, obs_cell) -> (ens_state, theta)``: the
    localized state LETKF of ``make_analysis_fn`` and the global parameter
    update, from one obs-space background."""
    _check_fields(cfg)
    fields = tuple(cfg.fields)
    fidx = torch.full((n_obs,), fields.index(cfg.obs_field), dtype=torch.long,
                      device=model.device)
    lat, lon = _cell_coords(model)
    land = model.static.land_mask
    prtps = cfg.rtps if param_rtps is None else param_rtps

    def analysis(ens_state: WorldState, theta: torch.Tensor, y: torch.Tensor,
                 obs_cell: torch.Tensor):
        Xf = gather_fields(ens_state, fields)
        k, F, H, W = Xf.shape
        xbar, Xp, Yp, d = obs_background(Xf.reshape(k, F, H * W), y, obs_cell, fidx)
        Xa = _letkf_update(xbar, Xp, Yp, d, obs_cell, lat, lon, cfg.obs_err,
                           cfg.loc_radius_km, cfg.inflation, cfg.rtps, const.PLANET_RADIUS,
                           cfg.solver, cfg.ns_iters)
        th_a = letkf_param_analysis(theta, Yp, d, cfg.obs_err, inflation=cfg.inflation,
                                    rtps=prtps, solver=cfg.solver, ns_iters=cfg.ns_iters)
        return scatter_fields(ens_state, fields, Xa.reshape(k, F, H, W), land), th_a

    return analysis


# ---------------------------------------------------------------------------
# OSSE helpers (a synthetic observing network over a truth state)
# ---------------------------------------------------------------------------

def draw_obs_network(generator: torch.Generator, model: M.Model, n_obs: int) -> torch.Tensor:
    """``n_obs`` distinct cells, area-weighted so that the network samples
    the sphere uniformly (a draw uniform in latitude and longitude would
    oversample the poles ~57× at 181×360)."""
    return torch.multinomial(_network_probs(model), n_obs, replacement=False,
                             generator=generator)


def synthetic_obs(generator: torch.Generator, truth_state: WorldState, obs_cell, obs_field: str,
                  obs_err: float) -> torch.Tensor:
    """The truth's ``obs_field`` at ``obs_cell`` with N(0, obs_err²) noise."""
    y = _FIELDS[obs_field][0](truth_state).reshape(-1)[obs_cell]
    noise = torch.randn(tuple(y.shape), generator=generator, dtype=y.dtype, device=y.device)
    return y + obs_err * noise


def rmse_to_truth(ens_state: WorldState, truth_state: WorldState, field: str,
                  area_w: torch.Tensor) -> torch.Tensor:
    """Area-weighted RMSE of the ensemble mean against the truth."""
    mean = torch.mean(_FIELDS[field][0](ens_state), dim=0)
    tru = _FIELDS[field][0](truth_state)
    w = area_w / torch.sum(area_w)
    return torch.sqrt(torch.sum(w * (mean - tru) ** 2))


def ensemble_spread(ens_state: WorldState, field: str, area_w: torch.Tensor) -> torch.Tensor:
    """Area-weighted mean ensemble std dev of ``field``."""
    v = _FIELDS[field][0](ens_state)
    w = area_w / torch.sum(area_w)
    return torch.sqrt(torch.sum(w * torch.var(v, dim=0, correction=0)))
