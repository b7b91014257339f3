"""The readings that the check's limits are set from, on the card at a
cell's own size: the measured package against the reference on a dozen
seeds or more (the lower readings), and the control, the reference in
bfloat16 put in the program's place, on three seeds or more (the upper
readings). One process builds both worlds once and runs every seed.

    python3 -m qbench.control --workload flagship-181.ens400 --seeds 1,2,3 --control-seeds 3

Each seed's run is the cell's own: its members, its warm-up and its steps
through the check plan's day end, with the same captures as a benchmark run
(no timed window). With ``--full n`` the seeds after the first ``n`` stop
after the warm-up and read ``start`` and ``warmup`` only. Prints one JSON
line a seed, with what parts after the warm-up on each member compared
(``check.warmup_detail``), and a summary line. With ``--witness`` it first
runs the warm-up of the first seed's compared members twice in the
reference, once from the initial state with every nonzero floating entry
nudged by one ulp, and prints what parts between the two: where a last-bit
difference of the start alone leads over the warm-up.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control-seeds", type=int, default=3,
                    help="how many of the seeds (the first) also run the control")
    ap.add_argument("--full", type=int, default=None,
                    help="how many of the seeds (the first) run every check; the rest stop "
                         "after the warm-up")
    ap.add_argument("--witness", action="store_true",
                    help="first the reference against itself nudged by one ulp")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", default=None, help="n_lat,n_lon: a rehearsal on the CPU")
    args = ap.parse_args(argv)

    from . import cell as cell_mod
    from . import check, plan, spec, states, world

    t0 = time.perf_counter()
    c = spec.cell(args.workload)
    config = dict(c.config)
    if args.size:
        config.update(zip(("n_lat", "n_lon"), map(int, args.size.split(","))))
    dtype = world.DTYPES[config["dtype"]]
    traffic = c.traffic
    import importlib
    E = importlib.import_module(cell_mod.PACKAGE + ".ensemble")
    S = importlib.import_module(cell_mod.PACKAGE + ".state")
    inputs = world.make_inputs(config)
    model = world.build(cell_mod.PACKAGE, inputs, args.device, dtype)
    ref = check.Reference(inputs, args.device, dtype)
    low = check.Reference(inputs, args.device, dtype, control=True)
    chunk = E.make_ensemble_chunk_fn(model, 1, int(traffic["diag_every"]))
    start = int(traffic["start_step"])
    n_warm = plan.warmup_steps(model, start)
    B = int(traffic["members"])
    lower, upper = {}, {}
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.witness:
        cplan = plan.check_plan(model, seeds[0], B, start + n_warm, traffic)
        for m in cplan.members:
            st, _ = ref.initial(m, seeds[0], traffic, start)
            nudged = ref.state({k: torch.where(v != 0, torch.nextafter(v, torch.full_like(
                v, float("inf"))), v) if isinstance(v, torch.Tensor) and v.is_floating_point()
                else v for k, v in states.leaves(st).items()})
            for _ in range(n_warm):
                st, _ = ref.step(st)
                nudged, _ = ref.step(nudged)
            a, b = states.leaves(nudged), states.leaves(st)
            print(json.dumps({"witness": seeds[0], "member": m,
                              "warmup": states.worst_share(a, b, check.PART),
                              **check.warmup_detail(a, b)}, default=str), flush=True)
    n_full = len(seeds) if args.full is None else args.full
    for i, seed in enumerate(seeds):
        ens, gens = E.init_ensemble(model, B, seed=seed, perturb_k=float(traffic["perturb_k"]),
                                    h_amp=float(traffic.get("h_amp", 0.0)))
        ens = plan.set_clock(ens, model, S, start)
        cplan = plan.check_plan(model, seed, B, start + n_warm, traffic)
        if i >= n_full:
            cplan = plan.CheckPlan(cplan.members, {})
        rec = check.Recorder(cplan, E.SHARED_LEAVES, ens)
        for _ in range(n_warm):
            ens, _ = chunk(ens, gens)
        rec.copy(ens, rec.window0)
        k = 0
        while not rec.done():
            rec.before(k, ens)
            ens, diags = chunk(ens, gens)
            rec.after(k, ens, diags)
            k += 1
        if args.device != "cpu":
            torch.cuda.synchronize()
        rec.finish()
        del ens
        read = set(check.CHECKS) if cplan.steps else {"start", "warmup"}
        detail = []
        got = check.compare(rec, inputs, args.device, dtype, seed, traffic, start, n_warm,
                            ref=ref, detail=detail)
        got = {k: v for k, v in got.items() if k in read}
        line = {"seed": seed, "members": list(cplan.members), "steps": cplan.steps,
                "program": got, "warmup_detail": detail}
        for name, (gap, _) in got.items():
            lower[name] = max(lower.get(name, 0.0), gap)
        if i < args.control_seeds:
            detail = []
            ctl = check.compare(rec, inputs, args.device, dtype, seed, traffic, start, n_warm,
                                control=True, ref=ref, low=low, detail=detail)
            ctl = {k: v for k, v in ctl.items() if k in read}
            line["control"], line["control_warmup_detail"] = ctl, detail
            for name, (gap, _) in ctl.items():
                upper[name] = min(upper.get(name, float("inf")), gap)
        print(json.dumps(line, default=str), flush=True)
        print(f"[control {time.perf_counter() - t0:8.1f} s] seed {seed} done", file=sys.stderr,
              flush=True)
    print(json.dumps({"workload": args.workload, "lower": lower, "upper": upper,
                      "device": torch.cuda.get_device_name(0) if args.device != "cpu" else "cpu"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
