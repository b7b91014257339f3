"""The port's ensemble CLI, the counterpart of ``scripts/ensemble.py``: N
perturbed flagship planets advanced together, each step one member-batched
step (``ensemble.make_ensemble_chunk_fn``), on the card unless ``--device``
asks for the CPU.

Usage:
  python -m qingdai_tpu_torch.run_ensemble --members 8 --days 2 [--json]
  python -m qingdai_tpu_torch.run_ensemble --members 2 --days 0.05 --chunk-days 0.05 \\
      --nlat 19 --nlon 36 --device cpu

It builds the flagship planet (``entry.build_world``: every default on,
independent of the ambient ``QD_*`` settings), runs one warm chunk, then
``--days`` days in chunks of ``--chunk-days``, and prints the time a step of
all members, the time a member-step, the aggregate member·sim-years/hour and
the members' spread of the scalar diagnostics at the last step
(``ensemble.spread_diagnostics``). ``scripts/ensemble.py``'s
``--member-chunk``, ``--donate`` and ``--profile`` are working-set and trace
experiments of the JAX compiler and are not ported.
"""

from __future__ import annotations

import argparse
import json
import time

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--members", type=int, default=8)
    ap.add_argument("--days", type=float, default=2,
                    help="simulated days to time after the warm chunk")
    ap.add_argument("--nlat", type=int, default=181)
    ap.add_argument("--nlon", type=int, default=360)
    ap.add_argument("--perturb-k", type=float, default=0.01,
                    help="members' T_s/SST perturbation amplitude (kelvin)")
    ap.add_argument("--chunk-days", type=float, default=1,
                    help="days a chunk (a fraction runs part of a day)")
    ap.add_argument("--json", action="store_true", help="print only the one-line JSON summary")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda; cpu runs the plain versions "
                         "of the kernels)")
    args = ap.parse_args(argv)

    from . import ensemble as E
    from . import entry
    from .physics.orbital import T_PLANET

    mdl, _ = entry.build_world(args.nlat, args.nlon, device=args.device)
    on_card = mdl.device.type == "cuda"
    steps = max(1, int(round(args.chunk_days * mdl.day_seconds / mdl.dt)))
    chunk = E.make_ensemble_chunk_fn(mdl, steps)
    ens, generators = E.init_ensemble(mdl, args.members, perturb_k=args.perturb_k)

    def run(ens):
        out = chunk(ens, generators)
        if on_card:
            torch.cuda.synchronize(mdl.device)
        return out

    t0 = time.perf_counter()
    ens, diags = run(ens)                    # the warm chunk
    warm_s = time.perf_counter() - t0
    n_chunks = max(1, int(round(args.days / args.chunk_days)))
    t0 = time.perf_counter()
    for _ in range(n_chunks):
        ens, diags = run(ens)
    ms_step = (time.perf_counter() - t0) * 1e3 / (n_chunks * steps)
    sim_years_per_hour = 3600.0 / (ms_step / 1e3) * mdl.dt / T_PLANET
    spread = E.spread_diagnostics(diags)
    device = torch.cuda.get_device_name(mdl.device) if on_card else "cpu"
    summary = {
        "metric": "ensemble_member_sim_years_per_hour",
        "members": args.members,
        "grid": f"{args.nlat}x{args.nlon}",
        "device": device,
        "ms_per_step": ms_step,
        "ms_per_member_step": ms_step / args.members,
        "sim_years_per_hour": sim_years_per_hour,
        "value": args.members * sim_years_per_hour,
        "unit": "member-sim-years/hour",
        "warm_chunk_s": warm_s,
        "spread": spread,
    }
    if not args.json:
        print(f"[Ensemble] {args.members} members at {args.nlat}x{args.nlon} on {device}: "
              f"{ms_step:.3f} ms/step (all members), {ms_step / args.members:.3f} ms a "
              f"member-step, {sim_years_per_hour:.3f} sim-years/hour, aggregate "
              f"{args.members * sim_years_per_hour:.3f} member-sim-years/hour")
        print("[Ensemble] spread at the last step: "
              + ", ".join(f"{k} {v:.6g}" for k, v in sorted(spread.items())))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
