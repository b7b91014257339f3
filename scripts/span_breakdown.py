"""Device and idle time of one traced benchmark run, by the port's own spans.

    python3 scripts/span_breakdown.py --workload flagship-181.ens400 --seed 7 \\
        --seconds 40 --out spans-181.json

From the root of a checkout on the card. Runs the cell once as
``python3 -m qbench.run --trace 1`` does and prints the same result line
last, then writes to ``--out``: device ms a step by innermost program span
(``qingdai_tpu_torch.telemetry``) and by layer, idle ms a step by the
program span open at the next operation's launch (``breakdown``'s rule),
the device ms a step of the program's ``dynamics``, ``ocean``, ``routing``
and ``ecology.*`` spans beside the harness's ``device_ms`` of the same
layers, and the device operations of the harness's step span (outside its
``qb.record`` copies) launched outside every program ``ensemble.step``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _ms(ns: float, n: int) -> float:
    return 1e-6 * ns / n


def breakdown(run) -> dict:
    """The numbers described above, from a traced run."""
    from qbench import spec, trace
    from qbench.metrics import _program

    tr = run.trace
    n = tr.n_steps
    placed = _program.placed(run)
    if placed is None:
        return {"error": "no program spans in the traced window"}
    path_of = {id(o): p for o, p in placed}
    leaf, layer, within = {}, {}, {}
    for o, p in placed:
        if p is None:
            continue
        d = o.end - o.start
        leaf[p[-1]] = leaf.get(p[-1], 0) + d
        layer[_program.layer(p[-1])] = layer.get(_program.layer(p[-1]), 0) + d
        for name in p:
            within[name] = within.get(name, 0) + d
    # idle gaps, each put down to the program span open at the launch of the
    # operation that ends it
    idle, cur = {}, tr.t0
    for o in sorted(tr.ops, key=lambda o: o.start):
        if o.start > cur:
            p = path_of.get(id(o))
            label = p[-1] if p else "outside the program's spans"
            idle[label] = idle.get(label, 0) + (o.start - cur)
        cur = max(cur, o.end)
    if tr.t1 > cur:
        idle["window end"] = idle.get("window end", 0) + (tr.t1 - cur)
    ecology = sum(o.end - o.start for o, p in placed
                  if p and any(k.startswith("ecology.") for k in p))
    harness = {name: spec.reader(name)(run) for name in
               ("device_ms.dynamics", "device_ms.ocean", "device_ms.routing",
                "device_ms.ecology")}
    step_ops = {id(o) for o in tr.inside([trace.STEP])}
    record_ops = {id(o) for o in tr.inside([trace.RECORD])}
    stray = [o.name for o in tr.ops if id(o) in step_ops and id(o) not in record_ops
             and "ensemble.step" not in (path_of.get(id(o)) or ())]
    all_ns = sum(o.end - o.start for o in tr.ops)
    return {
        "n_steps": n,
        "busy_ms_per_step": _ms(tr.busy_ns(), n),
        "device_ms_per_step_all_ops": _ms(all_ns, n),
        "window_ms_per_step": _ms(tr.t1 - tr.t0, n),
        "device_ms_by_leaf": {k: _ms(v, n) for k, v in sorted(leaf.items(), key=lambda kv: -kv[1])},
        "device_ms_by_layer": {k: _ms(v, n) for k, v in sorted(layer.items(),
                                                                 key=lambda kv: -kv[1])},
        "device_ms_outside_program_spans": _ms(
            sum(o.end - o.start for o, p in placed if p is None)
            + sum(o.end - o.start for o in tr.ops if o.launch < 0), n),
        "idle_ms_by_leaf": {k: _ms(v, n) for k, v in sorted(idle.items(), key=lambda kv: -kv[1])},
        "program_against_harness": {
            "dynamics": [_ms(within.get("dynamics", 0), n), harness["device_ms.dynamics"]],
            "ocean": [_ms(within.get("ocean", 0), n), harness["device_ms.ocean"]],
            "routing": [_ms(within.get("routing", 0), n), harness["device_ms.routing"]],
            "ecology": [_ms(ecology, n), harness["device_ms.ecology"]],
        },
        "step_ops_outside_ensemble_step": {"count": len(stray), "names": sorted(set(stray))[:20]},
        "step_ops_counted": len(step_ops - record_ops),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    import torch

    from qbench import cell as cell_mod
    from qbench import run as run_mod
    from qbench import spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("span_breakdown: needs a CUDA card", file=sys.stderr)
        return 3
    run, results = cell_mod.run(cell, args.seed, args.seconds, True, "cuda", T_START)
    if run.trace is None or not run.trace.ops:
        print("span_breakdown: the profile holds no device operation", file=sys.stderr)
        return 5
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": cell.chips, "memory_peak_bytes": int(run.peak_bytes),
                   "busy_s": run.trace.busy_ns() * 1e-9, "window_s": run.trace.window_s}
    line = run_mod.result_line(cell, run, results, True, device_info)
    out = breakdown(run)
    out.update(workload=args.workload, seed=args.seed,
               metrics={k: v["value"] for k, v in line["metrics"].items()},
               correct=line["correct"], device=device_info)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(line, allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
