"""Run one cell of the benchmark once and print its result line.

    python3 -m qbench.run --workload flagship-181.ens400 --seed 7 --seconds 20 --trace 0

From the root of a checkout on a machine with the cards the cell asks for.
With ``--trace 0`` the result's metrics are the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics, read from a ``torch.profiler``
trace of the window's first ``trace_steps`` steps. The last line of
standard output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, then
``kernel_build_s``, the seconds that building the kernel library took, which
``setup_s`` leaves out, and last ``checks``: each number the check
compared, with its limit); the same
numbers end standard error. Exits non-zero, printing no result, without
the cards, if JAX or the JAX package was loaded, or if the profile of a
traced run holds no device operation twice.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def _args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result_line(cell, run, results, traced: bool, device_info: dict) -> dict:
    """The result's JSON object."""
    from . import spec
    metrics = {}
    entries = cell.per_layer if traced else cell.end_to_end
    for m in entries:
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {name: {"value": gap, "limit": cell.limits["limits"][name], "worst": where}
              for name, (gap, where) in results.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    failed = sum(c["value"] > c["limit"] for c in checks.values())
    line = {"correct": correct, "attempted": len(checks), "failed": failed,
            "metrics": metrics, "device": device_info}
    if traced and run.trace is not None:
        from . import trace
        line["breakdown"] = trace.breakdown(run.trace)
    # the kernel library's build (a checkout's first run only), apart from setup_s
    line["kernel_build_s"] = run.kernel_build_s
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    args = _args(argv)
    # keep any library the program uses from loading JAX by itself
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    import torch

    from . import cell as cell_mod
    from . import guard, spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"qbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    run, results = cell_mod.run(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                                T_START)
    loaded = guard.forbidden_loaded()
    if loaded:
        print(f"qbench: forbidden modules loaded: {', '.join(loaded)}", file=sys.stderr)
        return 4
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": cell.chips, "memory_peak_bytes": int(run.peak_bytes)}
    if args.trace:
        if run.trace is None or not run.trace.ops:
            print("qbench: the profile holds no device operation", file=sys.stderr)
            return 5
        device_info["busy_s"] = run.trace.busy_ns() * 1e-9
        device_info["window_s"] = run.trace.window_s
    line = result_line(cell, run, results, bool(args.trace), device_info)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} ({c['worst']})",
              file=sys.stderr)
    print(json.dumps(line, allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
