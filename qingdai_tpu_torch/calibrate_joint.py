"""Joint multi-parameter adjoint calibration through the coupled model (the
port's counterpart of ``scripts/calibrate_joint.py``), on the card unless
``--device`` asks for the CPU.

Recovers several scalar physics parameters at once from a synthetic truth
trajectory by Adam descent on the gradient of a multi-series mismatch
objective (``adjoint.calibrate_joint``). The truth runs the same window
with withheld parameter values; the optimizer starts from biased priors and
is never told them. One forward+backward sweep per iteration through the
full coupled physics.

Usage:
  python -m qingdai_tpu_torch.calibrate_joint --json
  python -m qingdai_tpu_torch.calibrate_joint --params gh_factor,c_e,tau_cond \\
      --truths 0.43,1.6e-3,2200 --days 1 --iters 40 --x64
  python -m qingdai_tpu_torch.calibrate_joint --nlat 19 --nlon 36 --steps 20 \\
      --params gh_factor,c_e --truths 0.43,1.6e-3 --iters 25 --device cpu

The JSON record (the schema of ``CALIB.json``, with the device it ran on)
goes to ``output/calib_torch.json`` unless ``--out`` names another file.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

DEFAULT_OUT = os.path.join("output", "calib_torch.json")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--params", default="gh_factor,c_e",
                   help="comma-separated aliases (adjoint.PARAM_ALIASES)")
    p.add_argument("--truths", default="0.43,1.6e-3",
                   help="withheld truth values, same order as --params")
    p.add_argument("--priors", default=None,
                   help="starting values (default: the engine's config "
                        "defaults — the honest biased prior)")
    p.add_argument("--nlat", type=int, default=181)
    p.add_argument("--nlon", type=int, default=360)
    p.add_argument("--days", type=float, default=1.0,
                   help="calibration window length (planetary days)")
    p.add_argument("--steps", type=int, default=None,
                   help="window steps (overrides --days)")
    p.add_argument("--warmup-days", type=int, default=2,
                   help="advance the state out of the cold-start transient "
                        "before the window")
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--lr", type=float, default=0.08)
    p.add_argument("--obs-keys", default="Ts_mean,OLR_mean,E_mean",
                   help="diag series whose trajectories the objective "
                        "matches — distinct parameters imprint on distinct "
                        "series, which is what makes the joint problem "
                        "identifiable")
    p.add_argument("--x64", action="store_true",
                   help="float64 build (float32 otherwise)")
    p.add_argument("--out", default=DEFAULT_OUT,
                   help=f"write the CALIB-style JSON record here (default {DEFAULT_OUT})")
    p.add_argument("--json", action="store_true",
                   help="print only the JSON record, not the iterations")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda; cpu runs the plain versions "
                        "of the kernels)")
    args = p.parse_args(argv)

    from . import adjoint as adj
    from . import entry
    from . import model as M

    names = [s.strip() for s in args.params.split(",")]
    truths = [float(s) for s in args.truths.split(",")]
    if len(names) != len(truths):
        raise SystemExit("--truths must match --params")

    dtype = torch.float64 if args.x64 else torch.float32
    # the QD_* environment reaches the build, as in the JAX script
    mdl, state = entry.build_world(args.nlat, args.nlon, device=args.device, dtype=dtype,
                                   hermetic=False)
    spd = int(round(mdl.day_seconds / mdl.dt))
    n_steps = args.steps or int(round(args.days * spd))

    if args.priors:
        priors = {n: float(v)
                  for n, v in zip(names, args.priors.split(","))}
    else:
        # default prior = the engine default for each alias (dotted lookup)
        def _default(alias):
            obj = mdl
            for part in adj.PARAM_ALIASES.get(alias, alias).split("."):
                obj = getattr(obj, part)
            return float(obj)
        priors = {n: _default(n) for n in names}
    truth = dict(zip(names, truths))

    # warm-up out of the damped cold-start transient (plain forward chunks)
    if args.warmup_days:
        chunk = M.make_chunk_fn(mdl, spd)
        with torch.no_grad():
            for _ in range(args.warmup_days):
                state, _ = chunk(state)

    t0 = time.time()
    recovered, history = adj.calibrate_joint(
        mdl, state, priors, truth, n_steps=n_steps,
        obs_keys=tuple(args.obs_keys.split(",")),
        iters=args.iters, lr=args.lr, verbose=not args.json)
    wall = time.time() - t0

    summary = {
        "metric": "joint_calibration",
        "grid": f"{args.nlat}x{args.nlon}",
        "window_steps": n_steps,
        "warmup_days": args.warmup_days,
        "obs_keys": args.obs_keys,
        "iters": args.iters,
        "lr": args.lr,
        "x64": bool(args.x64),
        "params": names,
        "truth": truth,
        "prior": priors,
        "recovered": recovered,
        "rel_err": {n: abs(recovered[n] - truth[n]) / abs(truth[n])
                    for n in names},
        "prior_rel_err": {n: abs(priors[n] - truth[n]) / abs(truth[n])
                          for n in names},
        "J_trajectory": [round(J, 8) for _, _, J in history],
        "param_trajectory": [
            {k: round(v, 8) for k, v in vals.items()}
            for _, vals, _ in history],
        "wall_s": round(wall, 1),
        "device": (torch.cuda.get_device_name(mdl.device) if mdl.device.type == "cuda"
                   else "cpu"),
    }
    print(json.dumps(summary))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    return summary


if __name__ == "__main__":
    main()
