"""Adjoint sensitivity / calibration CLI over the full coupled model (the
port's counterpart of ``scripts/sensitivity.py``), on the card unless
``--device`` asks for the CPU.

Three modes, all building the world through ``world.QingdaiWorld`` (the
``QD_*`` environment, topography files, restart priority of
``run_simulation``):

  # scalar sensitivity: dJ/d(gh_factor) over a 1-day window
  python -m qingdai_tpu_torch.sensitivity --param gh_factor --days 1 --json

  # adjoint sensitivity map: dJ/d(friction[y,x]) for every cell in one
  # backward sweep
  python -m qingdai_tpu_torch.sensitivity --map friction --days 1 --out sens.npz

  # Newton-calibrate the greenhouse factor to hit a target window-mean Ts
  python -m qingdai_tpu_torch.sensitivity --calibrate 289.0 --param gh_factor --days 1

Objective J = mean of a per-step diagnostic scalar (--objective, default
Ts_mean) over the window, or over its last --trailing steps. QD_DTYPE picks
float32 (default) or float64; --fd EPS adds a central-difference check of
the scalar mode.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--param", default="gh_factor",
                   help="alias or dotted path (see adjoint.PARAM_ALIASES)")
    p.add_argument("--value", type=float, default=None,
                   help="parameter value to linearize at (default: the "
                        "configured value for aliased cfg scalars)")
    p.add_argument("--map", dest="map_name", default=None,
                   help="field alias/path for a sensitivity map (e.g. "
                        "friction, state.ocean.sst)")
    p.add_argument("--calibrate", type=float, default=None,
                   help="target objective value; Newton-tunes --param")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--days", type=float, default=None,
                   help="window length in planetary days (overrides --steps)")
    p.add_argument("--objective", default="Ts_mean")
    p.add_argument("--trailing", type=int, default=None,
                   help="average the objective over only the last K steps")
    p.add_argument("--segment", type=int, default=None,
                   help="checkpoint segment length (default ~sqrt(steps))")
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--fd", type=float, default=None,
                   help="central-difference step for a scalar-mode check")
    p.add_argument("--out", default=None, help="NPZ path for --map output")
    p.add_argument("--json", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda; cpu runs the plain versions "
                        "of the kernels)")
    args = p.parse_args(argv)

    from . import adjoint as A
    from .world import QingdaiWorld

    w = QingdaiWorld(verbose=not args.json, device=args.device)
    mdl, state = w.model, w.state
    spd = int(round(mdl.day_seconds / mdl.dt))
    n_steps = (int(round(args.days * spd)) if args.days is not None
               else (args.steps or spd))
    seg = args.segment or A.default_segment(n_steps)

    def report(obj):
        print(json.dumps(obj) if args.json else
              "\n".join(f"{k}: {v}" for k, v in obj.items()))

    t0 = time.time()
    if args.calibrate is not None:
        x0 = args.value if args.value is not None else _default_value(mdl, args.param)
        x, hist = A.calibrate(mdl, state, args.param, x0, n_steps=n_steps,
                              target=args.calibrate, objective=args.objective,
                              trailing_steps=args.trailing, iters=args.iters,
                              verbose=not args.json)
        report({"mode": "calibrate", "param": args.param, "x": x,
                "target": args.calibrate, "iters": len(hist),
                "history": [[float(v) for v in h] for h in hist],
                "steps": n_steps, "wall_s": round(time.time() - t0, 2)})
        return 0

    if args.map_name:
        path = A.PARAM_ALIASES.get(args.map_name, args.map_name)
        field = (_leaf(state, path[len("state."):]) if
                 path.startswith("state.") else _leaf(mdl, path))
        vg = A.make_value_and_grad(mdl, n_steps, objective=args.objective,
                                   trailing_steps=args.trailing, segment=seg)
        (J, _), grads = vg({args.map_name: field}, state)
        gmap = grads[args.map_name].cpu().numpy()
        out = args.out or f"sensitivity_{args.map_name.replace('.', '_')}.npz"
        np.savez(out, grad=gmap, lat=w.lat, lon=w.lon,
                 objective=args.objective, steps=n_steps,
                 J=float(J), field=field.cpu().numpy())
        report({"mode": "map", "field": args.map_name, "J": float(J),
                "steps": n_steps, "grad_min": float(gmap.min()),
                "grad_max": float(gmap.max()),
                "grad_absmean": float(np.abs(gmap).mean()),
                "out": out, "wall_s": round(time.time() - t0, 2)})
        return 0

    x0 = args.value if args.value is not None else _default_value(mdl, args.param)
    vg = A.make_value_and_grad(mdl, n_steps, objective=args.objective,
                               trailing_steps=args.trailing, segment=seg)
    (J, _), grads = vg({args.param: x0}, state)
    res = {"mode": "scalar", "param": args.param, "x": float(x0),
           "objective": args.objective, "J": float(J),
           "dJ_dx": float(grads[args.param]), "steps": n_steps,
           "segment": seg, "wall_s": round(time.time() - t0, 2)}
    if args.fd:
        val = A.make_value(mdl, n_steps, objective=args.objective,
                           trailing_steps=args.trailing, segment=seg)
        Jp, _ = val({args.param: x0 + args.fd}, state)
        Jm, _ = val({args.param: x0 - args.fd}, state)
        res["fd"] = (float(Jp) - float(Jm)) / (2 * args.fd)
    report(res)
    return 0


def _default_value(mdl, name):
    from . import adjoint as A
    path = A.PARAM_ALIASES.get(name, name)
    if path.startswith("cfg."):
        return float(_leaf(mdl, path))
    raise SystemExit(f"--value required for param {name!r} (no cfg default)")


def _leaf(obj, path):
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj.detach() if isinstance(obj, torch.Tensor) else obj


if __name__ == "__main__":
    sys.exit(main())
