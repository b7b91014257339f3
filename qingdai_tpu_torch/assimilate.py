"""OSSE data-assimilation cycling: the LETKF over the member-batched
ensemble, on the card unless ``--device`` asks for the CPU (the port's
counterpart of ``scripts/assimilate.py``).

An Observing-System Simulation Experiment on the full coupled planet: a
"truth" run gives synthetic point observations each cycle; the ensemble is
advanced by the member-batched chunk (``ensemble.py``) and corrected by the
LETKF analysis (``assim.py``) at every cycle boundary. A free-running
ensemble (the same members, no assimilation) is the control: the
assimilated ensemble mean should track the truth closer than the free one.

Two truth designs (--truth-mode):
  chaos (default): the truth is the same model started from an initial
    state perturbed at the members' amplitude; a burn-in (--burnin-cycles)
    lets the coupled dynamics decorrelate truth and ensemble before the
    cycling starts, so the assimilated-against-free gap measures the
    filter's skill.
  displace: the truth carries a smooth +3 K zonal anomaly the ensemble does
    not know about; the anomaly relaxes toward the attractor within days,
    so the free control converges too (a large-increment smoke test).

Every member is perturbed, each from its own ``torch.Generator`` seeded from
(--seed + 1, i); the truth's perturbation from --seed + 777, the observing
network and its noise from --seed and the parameter prior from --seed + 99.
The JAX package's ``jax.random`` streams cannot be reproduced, so the
numbers differ from ``scripts/assimilate.py``'s run for run. With mutation
on (``QD_ECO_MUT_RATE``), the free control draws from copies of the
members' generators taken when it forks, so it draws as the assimilated
ensemble does.

Usage:
  python -m qingdai_tpu_torch.assimilate --members 8 --cycles 8 --json      # the card
  python -m qingdai_tpu_torch.assimilate --device cpu --nlat 19 --nlon 36 \\
      --cycle-steps 6 --members 4 --cycles 2 --burnin-cycles 1 --json     # the CPU

Prints one JSON line: per-cycle background and analysis RMSE of the
ensemble mean against the truth, the ensemble spread and the free
control's RMSE, as the JAX CLI does, plus the device and the wall ms of a
cycle's parts (truth, forecast, free control, analysis). ``--out`` also
writes it to a file under ``output/``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch


def _parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--members", type=int, default=8)
    p.add_argument("--cycles", type=int, default=8)
    p.add_argument("--cycle-steps", type=int, default=0,
                   help="steps per assimilation cycle (0 = one planetary day)")
    p.add_argument("--nlat", type=int, default=181)
    p.add_argument("--nlon", type=int, default=360)
    p.add_argument("--obs-count", type=int, default=500)
    p.add_argument("--obs-sigma", type=float, default=0.5,
                   help="observation error std dev (K)")
    p.add_argument("--radius-km", type=float, default=2000.0,
                   help="Gaspari-Cohn localization radius (0 = global ETKF)")
    p.add_argument("--inflation", type=float, default=1.04)
    p.add_argument("--rtps", type=float, default=0.6,
                   help="relaxation-to-prior-spread coefficient (0 = off)")
    p.add_argument("--fields", default="T_s,sst,h,q,u,v",
                   help="comma-separated assimilated fields")
    p.add_argument("--perturb-k", type=float, default=1.0,
                   help="ensemble initial displacement amplitude (K)")
    p.add_argument("--perturb-h-m", type=float, default=0.0,
                   help="chaos mode: correlated geopotential-height noise amplitude (m) for "
                        "truth and members; a T_s-only perturbation decays under the "
                        "geostrophic relaxation, height noise carries flow differences "
                        "that grow")
    p.add_argument("--truth-mode", default="chaos", choices=["chaos", "displace"])
    p.add_argument("--warmup-days", type=int, default=0,
                   help="advance the base state this many days before the experiment (out "
                        "of the damped cold-start transient)")
    p.add_argument("--burnin-cycles", type=int, default=5,
                   help="chaos mode: cycles of free decorrelation before assimilation starts")
    p.add_argument("--displace-k", type=float, default=3.0,
                   help="displace mode: truth anomaly amplitude (K)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--solver", default="ns", choices=["ns", "eigh"])
    p.add_argument("--est-param", default=None,
                   help="augmented-state parameter estimation: estimate this scalar physics "
                        "parameter (alias per adjoint.PARAM_ALIASES, e.g. gh_factor) from the "
                        "observations; the truth runs with --param-truth, the ensemble starts "
                        "from N(--param-prior-mean, --param-prior-std) and is never told the "
                        "truth")
    p.add_argument("--param-truth", type=float, default=0.46)
    p.add_argument("--param-prior-mean", type=float, default=0.34)
    p.add_argument("--param-prior-std", type=float, default=0.04)
    p.add_argument("--param-rtps", type=float, default=0.5,
                   help="relaxation-to-prior-spread for the parameter deviations")
    p.add_argument("--no-param-update", action="store_true",
                   help="with --est-param: inject --param-truth into the truth only and keep "
                        "the ensemble's (biased) default: the imperfect-model OSSE")
    p.add_argument("--obs-mix", default=None,
                   help="multivariate observing network: comma-separated field:count[:err] "
                        "blocks, e.g. 'T_s:250:0.5,sst:150:0.3,q:100:5e-4' (err defaults to "
                        "--obs-sigma). Replaces the single --obs-count T_s network; every "
                        "observed field must be in --fields; SST networks draw over ocean "
                        "cells only. Not with a parameter update (use --no-param-update).")
    p.add_argument("--no-free-baseline", action="store_true",
                   help="skip the free-running control ensemble")
    p.add_argument("--out", default=None,
                   help="also write the JSON summary to output/<OUT>")
    p.add_argument("--json", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda; cpu runs the plain versions "
                        "of the kernels)")
    return p


def _obs_spec(args):
    if not args.obs_mix:
        return None
    blocks = []
    for blk in args.obs_mix.split(","):
        parts = blk.split(":")
        blocks.append((parts[0], int(parts[1]),
                       float(parts[2]) if len(parts) > 2 else args.obs_sigma))
    return tuple(blocks)


def _copy_generators(generators):
    """Generators in the states of ``generators``, to draw as they will."""
    out = []
    for g in generators:
        c = torch.Generator(device=g.device)
        c.set_state(g.get_state())
        out.append(c)
    return out


class _Clock:
    """Wall ms by part, the card synchronised around each part."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.ms = {}

    def run(self, part, fn, *args):
        if self.cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        if self.cuda:
            torch.cuda.synchronize()
        self.ms.setdefault(part, []).append((time.perf_counter() - t0) * 1e3)
        return out


def main(argv=None):
    args = _parser().parse_args(argv)
    from . import assim as A
    from . import ensemble as E
    from . import entry
    from . import model as M
    from .adjoint import PARAM_ALIASES, inject_path
    from .physics.orbital import T_PLANET

    obs_spec = _obs_spec(args)
    est_on = bool(args.est_param) and not args.no_param_update
    if obs_spec and est_on:
        raise SystemExit("--obs-mix is not supported with an augmented-state parameter "
                         "update; add --no-param-update")
    # the QD_* environment applies, as in the JAX CLI: users drive it
    mdl, base = entry.build_world(args.nlat, args.nlon, device=args.device, hermetic=False)
    dev = mdl.device
    spd = int(round(mdl.day_seconds / mdl.dt))
    cyc = args.cycle_steps or spd
    cfg = A.AssimConfig(fields=tuple(args.fields.split(",")), obs_field="T_s",
                        obs_err=args.obs_sigma, loc_radius_km=args.radius_km,
                        inflation=args.inflation, rtps=args.rtps, solver=args.solver)

    def seeded(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    # the warm-up runs the ensemble's (prior) model; the truth may carry
    # another parameter value (--est-param)
    chunk = M.make_chunk_fn(mdl, cyc)
    chunk_truth = chunk
    if args.est_param:
        mdl_truth = inject_path(mdl, PARAM_ALIASES.get(args.est_param, args.est_param),
                                torch.full((), args.param_truth, dtype=torch.float32,
                                           device=dev))
        chunk_truth = M.make_chunk_fn(mdl_truth, cyc)
    for _ in range(args.warmup_days * spd // cyc):
        base, _ = chunk(base)

    land = mdl.static.land_mask
    if args.truth_mode == "displace":
        anom = (args.displace_k * torch.cos(torch.deg2rad(mdl.grid.lat_mesh))).to(
            base.atmos.T_s.dtype)
        truth = dataclasses.replace(
            base, atmos=dataclasses.replace(base.atmos, T_s=base.atmos.T_s + anom),
            ocean=dataclasses.replace(base.ocean, sst=torch.where(
                land == 0, base.ocean.sst + anom, base.ocean.sst)))
    else:
        truth = E.perturb_member(base, seeded(args.seed + 777), args.perturb_k, land,
                                 args.perturb_h_m)

    # every member perturbed, each from its own generator (no member may
    # equal the truth); the generators then feed the members' mutation draws
    gens = [seeded(E.member_seed(args.seed + 1, i)) for i in range(args.members)]
    ens = E.stack_members([E.perturb_member(base, g, args.perturb_k, land, args.perturb_h_m)
                           for g in gens])

    theta = None
    if est_on:
        theta = (args.param_prior_mean + args.param_prior_std * torch.randn(
            (args.members, 1), generator=seeded(args.seed + 99), dtype=torch.float32,
            device=dev))
        echunk = A.make_param_ensemble_chunk_fn(mdl, (args.est_param,), cyc)
        analysis = A.make_augmented_analysis_fn(mdl, cfg, args.obs_count,
                                                param_rtps=args.param_rtps)
    else:
        echunk = E.make_ensemble_chunk_fn(mdl, cyc)
        analysis = (A.make_multivar_analysis_fn(mdl, cfg, obs_spec) if obs_spec
                    else A.make_analysis_fn(mdl, cfg, args.obs_count))
    w = mdl.grid.area_w
    g_obs = seeded(args.seed)

    def advance(ens_state, th, generators):
        if est_on:
            return echunk(ens_state, th, generators)[0]
        return echunk(ens_state, generators)[0]

    burnin = args.burnin_cycles if args.truth_mode == "chaos" else 0
    for _ in range(burnin):
        truth, _ = chunk_truth(truth)
        ens = advance(ens, theta, gens)
    free = None if args.no_free_baseline else ens
    theta_free, gens_free = theta, _copy_generators(gens)

    clock = _Clock(dev)
    t0 = time.time()
    series = []
    for c in range(args.cycles):
        truth, _ = clock.run("truth", chunk_truth, truth)
        ens = clock.run("forecast", advance, ens, theta, gens)
        if free is not None:
            free = clock.run("free", advance, free, theta_free, gens_free)
        if obs_spec is not None:
            y, obs_cell = A.draw_multivar_obs(g_obs, mdl, truth, obs_spec)
        else:
            obs_cell = A.draw_obs_network(g_obs, mdl, args.obs_count)
            y = A.synthetic_obs(g_obs, truth, obs_cell, cfg.obs_field, cfg.obs_err)
        rmse_b = float(A.rmse_to_truth(ens, truth, "T_s", w))
        spread_b = float(A.ensemble_spread(ens, "T_s", w))
        if est_on:
            ens, theta = clock.run("analysis", analysis, ens, theta, y, obs_cell)
        else:
            ens = clock.run("analysis", analysis, ens, y, obs_cell)
        rmse_a = float(A.rmse_to_truth(ens, truth, "T_s", w))
        spread_a = float(A.ensemble_spread(ens, "T_s", w))
        row = {"cycle": c, "rmse_b_K": round(rmse_b, 4), "rmse_a_K": round(rmse_a, 4),
               "spread_K": round(spread_b, 4),
               # spread-skill consistency: a calibrated filter keeps the
               # background spread near the background error (ratio ≈ 1)
               "spread_a_K": round(spread_a, 4),
               "spread_skill_ratio": round(spread_b / max(rmse_b, 1e-12), 3)}
        if free is not None:
            row["rmse_free_K"] = round(float(A.rmse_to_truth(free, truth, "T_s", w)), 4)
        if est_on:
            th = theta.detach().cpu().numpy()
            row["param_mean"] = round(float(th.mean()), 6)
            row["param_std"] = round(float(th.std()), 6)
        series.append(row)
        if not args.json:
            print(f"[Assim] {row}", flush=True)
    wall = time.time() - t0

    # the last cycle's RMSE of every assimilated field (and of the free
    # control): the T_s series understates what a multivariate network buys
    final_rmse = {}
    for f in cfg.fields:
        final_rmse[f] = round(float(A.rmse_to_truth(ens, truth, f, w)), 6)
        if free is not None:
            final_rmse[f + "_free"] = round(float(A.rmse_to_truth(free, truth, f, w)), 6)

    cycle_ms = {k: float(np.mean(v)) for k, v in clock.ms.items()}
    forecast_s_step = cycle_ms["forecast"] / 1e3 / cyc
    summary = {
        "metric": "letkf_osse",
        "grid": f"{args.nlat}x{args.nlon}",
        "members": args.members,
        "cycles": args.cycles,
        "cycle_steps": cyc,
        "obs_count": args.obs_count,
        "obs_mix": args.obs_mix,
        "obs_sigma_K": args.obs_sigma,
        "radius_km": args.radius_km,
        "inflation": args.inflation,
        "rtps": args.rtps,
        "truth_mode": args.truth_mode,
        "warmup_days": args.warmup_days,
        "burnin_cycles": burnin,
        "solver": args.solver,
        "rmse_a_final_K": series[-1]["rmse_a_K"],
        "rmse_free_final_K": series[-1].get("rmse_free_K"),
        "final_rmse_by_field": final_rmse,
        "series": series,
        "wall_s": round(wall, 1),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "cycle_ms": cycle_ms,
        "forecast_member_sim_years_per_hour":
            args.members * 3600.0 / forecast_s_step * mdl.dt / T_PLANET,
    }
    if args.est_param:
        summary["no_param_update"] = bool(args.no_param_update)
        summary.update({
            "est_param": args.est_param,
            "param_truth": args.param_truth,
            "param_prior_mean": args.param_prior_mean,
            "param_prior_std": args.param_prior_std,
            "param_final_mean": series[-1].get("param_mean"),
            "param_final_std": series[-1].get("param_std"),
        })
    print(json.dumps(summary))
    if args.out:
        os.makedirs("output", exist_ok=True)
        with open(os.path.join("output", os.path.basename(args.out)), "w") as f:
            json.dump(summary, f, indent=1)
    return summary


if __name__ == "__main__":
    main()
