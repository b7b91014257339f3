"""Compare the step time of two checkouts of the port on one card, in turns.

    python3 scripts/ab_torch_step.py PARENT_ROOT CHANGE_ROOT [--path slice|main|planet]
                                     [--days 1]

Runs the chosen path of each checkout's ``qingdai_tpu_torch`` at 181×360
float32 in its own process, in the order parent, change, change, parent:
one warm-up planetary day, then ``--days`` timed days (CUDA events). Each
process imports only its own checkout (and builds its kernels there).
Prints one line per run and a JSON summary with the card's name and power
limit. The slice is the path without ecology, phytoplankton and routing
that every version of the port runs; ``main`` is the planet with routing
off, which needs a checkout that ports ecology; ``planet`` is the flagship
planet with every default on, routing included, which needs a checkout that
ports routing. Imports no JAX.
"""

import argparse
import json
import subprocess
import sys

PATHS = {"slice": {"QD_ECO_ENABLE": "0", "QD_PHYTO_ENABLE": "0", "QD_HYDRO_ENABLE": "0"},
         "main": {"QD_HYDRO_ENABLE": "0"},
         "planet": {}}

RUN = r"""
import json, sys, torch
sys.path.insert(0, sys.argv[1])
from qingdai_tpu_torch import entry, model as M
env, days = json.loads(sys.argv[2]), int(sys.argv[3])
mdl, st = entry.build_world(181, 360, extra_env=env, device="cuda", dtype=torch.float32)
chunk = M.make_chunk_fn(mdl, 240)
st, _ = chunk(st)
a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
a.record()
for _ in range(days):
    st, d = chunk(st)
b.record()
b.synchronize()
print(json.dumps({"ms_per_step": a.elapsed_time(b) / (240 * days),
                  "Ts_mean": float(d["Ts_mean"][-1])}))
"""


def card_label() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--path", choices=sorted(PATHS), default="slice")
    ap.add_argument("--days", type=int, default=1)
    args = ap.parse_args()
    label = card_label()
    runs = []
    for name, root in (("parent", args.parent), ("change", args.change),
                       ("change", args.change), ("parent", args.parent)):
        out = subprocess.run([sys.executable, "-c", RUN, root, json.dumps(PATHS[args.path]),
                              str(args.days)], capture_output=True, text=True, check=True)
        rec = dict(json.loads(out.stdout.strip().splitlines()[-1]), which=name)
        runs.append(rec)
        print(f"{name} {root}: {rec['ms_per_step']:.4f} ms/step ({args.path}, 181x360 f32), "
              f"Ts_mean {rec['Ts_mean']:.3f} K [{label}]")
    print(json.dumps({"card": label, "path": args.path, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
