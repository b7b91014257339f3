"""Compare the step time, or the kernels' call times, of two checkouts of the
port on one card, in turns.

    python3 scripts/ab_torch_step.py PARENT_ROOT CHANGE_ROOT
                                     [--path slice|main|planet|kernels] [--days 1] [--rounds 3]

Runs the chosen path of each checkout's ``qingdai_tpu_torch`` at 181×360
float32 in its own process, in the order parent, change, change, parent:
one warm-up planetary day, then ``--days`` timed days (CUDA events). Each
process imports only its own checkout (and builds its kernels there).
Prints one line per run and a JSON summary with the card's name and power
limit. The slice is the path without ecology, phytoplankton and routing
that every version of the port runs; ``main`` is the planet with routing
off, which needs a checkout that ports ecology; ``planet`` is the flagship
planet with every default on, routing included, which needs a checkout that
ports routing.

``kernels`` times the four kernels' single wrappers instead: a process builds
the inputs of ``chip_smoke.py``'s phase-3 timing at 181×360 float32 from one
seed (K1 a precipitation-like field, K2 two planes and winds, K3 five planes,
K4 the SST and 10 tracers, one substep) and times each wrapper with that
checkout's ``chip_smoke.device_ms`` (torch.profiler, 20 calls) ``--rounds``
times; its line holds the median of each kernel's rounds. Imports no JAX.
"""

import argparse
import json
import subprocess
import sys

PATHS = {"slice": {"QD_ECO_ENABLE": "0", "QD_PHYTO_ENABLE": "0", "QD_HYDRO_ENABLE": "0"},
         "main": {"QD_HYDRO_ENABLE": "0"},
         "planet": {},
         "kernels": None}

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

RUN_KERNELS = r"""
import json, statistics, sys
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
from qingdai_tpu_torch import constants as const
from qingdai_tpu_torch.grid import make_grid
from qingdai_tpu_torch.kernels.advect_bilinear import advect_bilinear_cuda
from qingdai_tpu_torch.kernels.hyper4 import hyperdiffuse_cuda
from qingdai_tpu_torch.kernels.median_pos import median_pos_cuda
from qingdai_tpu_torch.kernels.ocean_substeps import ocean_substeps_cuda
rounds = int(sys.argv[2])
dev, f32, H, W, A = torch.device("cuda"), torch.float32, 181, 360, const.PLANET_RADIUS
r = np.random.default_rng(0)
g = make_grid(H, W, device=dev, dtype=f32)
x = cs.on(dev, np.where(r.random((H, W)) < 0.6, 0.0, np.abs(r.standard_normal((H, W))) * 1e-5), f32)
F2 = cs.on(dev, 280.0 + 20.0 * r.standard_normal((2, H, W)), f32)
u = cs.on(dev, np.clip(60.0 * r.standard_normal((H, W)), -200, 200), f32)
v = cs.on(dev, np.clip(30.0 * r.standard_normal((H, W)), -200, 200), f32)
F5 = cs.on(dev, 30.0 * r.standard_normal((5, H, W)), f32)
k4 = (0.02 * g.k4_map_unit / 300.0)[None].expand(5, H, W).contiguous()
mom, st, forc, geo, params = cs.k4_operands(dev, f32, 10, 1, 1, 5.0e3)
calls = {
    "median_pos": lambda: median_pos_cuda(x, 1e-6),
    "advect_bilinear": lambda: advect_bilinear_cuda(F2, u, v, 300.0, A, g.dlat_rad, g.dlon_rad,
                                                    g.coslat_cap_tiny),
    "hyper4": lambda: hyperdiffuse_cuda(F5, k4, 300.0, 1, g.dlat_rad, g.dlon_rad,
                                        g.coslat_cap_02, A),
    "ocean_substeps": lambda: ocean_substeps_cuda(mom, st, forc, geo, **params),
}
out = {name: [cs.device_ms(fn, what=name) for _ in range(rounds)] for name, fn in calls.items()}
print(json.dumps({name: statistics.median(t) for name, t in out.items()}))
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
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    label = card_label()
    runs = []
    for name, root in (("parent", args.parent), ("change", args.change),
                       ("change", args.change), ("parent", args.parent)):
        argv = ([RUN_KERNELS, root, str(args.rounds)] if args.path == "kernels"
                else [RUN, root, json.dumps(PATHS[args.path]), str(args.days)])
        out = subprocess.run([sys.executable, "-c", *argv], capture_output=True, text=True,
                             cwd=root)
        if out.returncode != 0:
            raise SystemExit(f"{name} ({root}) failed:\n{out.stderr[-3000:]}")
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        if args.path == "kernels":
            print(f"{name} {root}: " + ", ".join(f"{k} {v:.5f}" for k, v in rec.items())
                  + f" device ms a call [{label}]", flush=True)
            rec = {"ms_per_call": rec}
        else:
            print(f"{name} {root}: {rec['ms_per_step']:.4f} ms/step ({args.path}, 181x360 f32), "
                  f"Ts_mean {rec['Ts_mean']:.3f} K [{label}]", flush=True)
        runs.append(dict(rec, which=name))
    print(json.dumps({"card": label, "path": args.path, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
