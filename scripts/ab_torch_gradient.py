"""Compare the port's 24-step gradient in two checkouts on one card, in
turns: its time and whether identical calls repeat to the bit.

    python3 scripts/ab_torch_gradient.py PARENT_ROOT CHANGE_ROOT [--rounds 2]

Runs each checkout's ``qingdai_tpu_torch`` in its own process, in the order
parent, change, change, parent: the flagship planet at 181×360 float32
warmed for one planetary day, then ``adjoint.make_value_and_grad`` over 24
steps (segment 4) of dJ/d gh_factor, the friction map and the initial T_s
map, as ``chip_smoke.py`` phase 7 takes it: one untimed call, then
``--rounds`` timed calls (host clock between card syncs). Each run's line
holds the median ms per window-step and the largest |difference| of each
gradient between the timed calls and the first (0 where identical calls
repeat to the bit); the last line is a JSON summary with the card's name
and power limit. Imports no JAX.
"""

import argparse
import json
import subprocess
import sys

RUN = r"""
import json, statistics, sys, time
import torch
sys.path.insert(0, sys.argv[1])
from qingdai_tpu_torch import adjoint as A, entry, model as M
rounds = int(sys.argv[2])
mdl, st = entry.build_world(181, 360, device="cuda", dtype=torch.float32)
with torch.no_grad():
    st, _ = M.make_chunk_fn(mdl, 240)(st)
params = {"gh_factor": mdl.cfg.energy.gh_factor, "friction": mdl.static.friction,
          "state.atmos.T_s": st.atmos.T_s}
vg = A.make_value_and_grad(mdl, 24, segment=4)
(_, _), g0 = vg(params, st)
ms, diff = [], {k: 0.0 for k in g0}
for _ in range(rounds):
    torch.cuda.synchronize()
    t = time.perf_counter()
    (_, _), g = vg(params, st)
    torch.cuda.synchronize()
    ms.append((time.perf_counter() - t) * 1e3 / 24)
    for k in g0:
        diff[k] = max(diff[k], float((g[k] - g0[k]).abs().max()))
print(json.dumps({"ms_per_window_step": statistics.median(ms), "rounds_ms": ms,
                  "max_abs_diff": diff, "dJ_dgh": float(g0["gh_factor"])}))
"""


def card_label() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    label = card_label()
    runs = []
    for name, root in (("parent", args.parent), ("change", args.change),
                       ("change", args.change), ("parent", args.parent)):
        out = subprocess.run([sys.executable, "-c", RUN, root, str(args.rounds)],
                             capture_output=True, text=True, cwd=root)
        if out.returncode != 0:
            raise SystemExit(f"{name} ({root}) failed:\n{out.stderr[-3000:]}")
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        print(f"{name} {root}: {rec['ms_per_window_step']:.4f} ms per window-step "
              f"({rec['rounds_ms']}), dJ/d gh_factor {rec['dJ_dgh']:.9e}, largest |difference| "
              f"from the first call {rec['max_abs_diff']} (24-step gradient, 181x360 f32) "
              f"[{label}]", flush=True)
        runs.append(dict(rec, which=name))
    print(json.dumps({"card": label, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
