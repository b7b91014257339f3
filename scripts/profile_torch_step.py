"""Where the time of the PyTorch / CUDA port's step goes, on one NVIDIA card.

    python3 scripts/profile_torch_step.py [--paths planet,main,slice] [--steps 72]
                                          [--out output/profile_torch_step.json]

Builds each path of ``chip_smoke.py`` named in ``--paths``, in that order,
in this one process (``planet``: the flagship planet, every default on,
river routing included, the main path since routing was ported; ``main``:
the planet with routing off, the main path before; ``slice``: also without
ecology and phytoplankton) at 181×360 float32 on the card, runs one
planetary day to warm up, then measures:
  - wall ms/step over a second day (CUDA events), with diags every step and
    with diags only on the day's last step;
  - a ``torch.profiler`` window of ``--steps`` steps: device kernel launches
    per step, device time per step, the kernels and the PyTorch ops that take
    the most device time, and the device time of each of the port's four
    CUDA kernels per call. The default window is one routing period (72
    steps at dt 300 s); it starts three days in, so it holds one event;
  - with routing on, one routing event alone (``routing.route_event`` on the
    state's buffer) and one firing ``routing.routing_step``: device ms and
    device launches per event;
  - the device's idle share, 1 − device time per step / unprofiled wall
    time per step.
Prints one line per measurement and writes them all to ``--out`` as JSON.
Imports no JAX.
"""

import argparse
import collections
import json
import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from qingdai_tpu_torch import entry  # noqa: E402
from qingdai_tpu_torch import model as M  # noqa: E402

PATHS = {"planet": {},
         "main": {"QD_HYDRO_ENABLE": "0"},
         "slice": {"QD_ECO_ENABLE": "0", "QD_PHYTO_ENABLE": "0", "QD_HYDRO_ENABLE": "0"}}
DAY = 240
# device-side names of the port's kernels
PORT_KERNELS = {"median_pos": ("median_pos_kernel",),
                "advect_bilinear": ("advect_bilinear_kernel",),
                "hyper4": ("hyper4_tile_kernel",),
                "ocean_substeps": ("ocean_coop_kernel",)}


def card_label() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def wall_ms_per_step(chunk, st, steps):
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    st, _ = chunk(st)
    b.record()
    b.synchronize()
    return st, a.elapsed_time(b) / steps


def profile_window(step, st, steps, wrappers):
    """(kernels per step, device ms per step, top kernels, top ops, device ms
    per call of each port kernel)."""
    torch.cuda.synchronize()
    calls0 = {k: w.launches for k, w in wrappers.items()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(chip_smoke.PROFILE_WAIT_S)       # the profiler's start-up (chip_smoke.py)
        for _ in range(steps):
            st, _ = step(st)
        torch.cuda.synchronize()
    n_dev, dev_us = 0, 0.0
    by_kernel = collections.Counter()
    port_us = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            n_dev += 1
            dev_us += us
            by_kernel[e.name[:80]] += us
            for k, names in PORT_KERNELS.items():
                if any(n in e.name for n in names):
                    port_us[k] += us
    port = {k: port_us[k] / 1e3 / max(1, w.launches - calls0[k]) for k, w in wrappers.items()}
    ops = sorted(((a.key, a.device_time_total / steps / 1e3, a.count / steps)
                  for a in prof.key_averages() if a.key.startswith("aten::")),
                 key=lambda t: -t[1])[:12]
    kernels = [(k, us / steps / 1e3) for k, us in by_kernel.most_common(12)]
    return st, n_dev / steps, dev_us / steps / 1e3, kernels, ops, port


def routing_event(mdl, st):
    """Device ms and device launches of one routing event: the level pass
    alone, and the whole firing routing_step (buffer add, event, lake P−E,
    the state's scalars)."""
    import dataclasses
    from qingdai_tpu_torch import routing

    rs, rstate = mdl.routing_static, st.routing
    hcfg = mdl.cfg.hydrology
    firing = dataclasses.replace(rstate, t_accum=hcfg.dt_hydro_hours * 3600.0 - mdl.dt)
    zero = torch.zeros(rs.grid_shape, dtype=rstate.buffer_kg.dtype, device=mdl.device)
    ev_ms, ev_n = chip_smoke.device_profile(
        lambda: routing.route_event(rs, rstate.buffer_kg.reshape(-1), rstate.lake_volume_kg),
        what="route_event")
    st_ms, st_n = chip_smoke.device_profile(
        lambda: routing.routing_step(rs, firing, hcfg, zero, mdl.dt, zero, zero),
        what="a firing routing_step")
    return {"route_event_ms": ev_ms, "route_event_launches": ev_n, "routing_step_ms": st_ms,
            "routing_step_launches": st_n, "levels": rs.n_levels, "rounds": len(rs.rounds)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paths", default="planet,main,slice",
                    help="comma-separated paths, run in this order in one process")
    ap.add_argument("--steps", type=int, default=72)
    ap.add_argument("--out", default="output/profile_torch_step.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_step: no CUDA device", file=sys.stderr)
        return 2
    from qingdai_tpu_torch import kernels as port_kernels
    label = card_label()
    print(f"card: {label}")
    out = {"card": label, "steps_profiled": args.steps, "runs": []}
    for name in args.paths.split(","):
        mdl, st = entry.build_world(181, 360, extra_env=PATHS[name])
        chunk = M.make_chunk_fn(mdl, DAY)
        st, _ = chunk(st)                                       # warm-up day
        st, ms_diag = wall_ms_per_step(chunk, st, DAY)
        st, ms_nodiag = wall_ms_per_step(M.make_chunk_fn(mdl, DAY, diag_every=DAY), st, DAY)
        st, n_kern, dev_ms, kernels, ops, port = profile_window(
            M.make_step_fn(mdl), st, args.steps, port_kernels.wrappers())
        rec = {"path": name, "wall_ms_per_step": ms_diag,
               "wall_ms_per_step_diag_once_a_day": ms_nodiag,
               "device_launches_per_step": n_kern, "device_ms_per_step": dev_ms,
               "idle_share": 1.0 - dev_ms / ms_diag, "top_kernels_ms_per_step": kernels,
               "top_ops_device_ms_per_step": ops, "port_kernel_device_ms_per_call": port}
        if mdl.routing_static is not None:
            rec["routing_event"] = routing_event(mdl, st)
        out["runs"].append(rec)
        print(f"{name}: wall {ms_diag:.4f} ms/step with diags, {ms_nodiag:.4f} with diags once "
              f"a day; {n_kern:.1f} device launches/step, device {dev_ms:.4f} ms/step, idle "
              f"share {rec['idle_share']:.3f} [{label}]")
        print("  port kernels, device ms per call: "
              + ", ".join(f"{k} {ms:.4f}" for k, ms in port.items()))
        if "routing_event" in rec:
            ev = rec["routing_event"]
            print(f"  routing event: route_event {ev['route_event_ms']:.5f} device ms, "
                  f"{ev['route_event_launches']:g} device launches; firing routing_step "
                  f"{ev['routing_step_ms']:.5f} ms, {ev['routing_step_launches']:g} launches "
                  f"({ev['levels']} levels, {ev['rounds']} rounds) [{label}]")
        for k, ms in kernels:
            print(f"  kernel {ms:.4f} ms/step  {k}")
        for k, ms, cnt in ops:
            print(f"  op {ms:.4f} ms/step  {cnt:.1f} calls/step  {k}")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"card": label, "wall_ms_per_step": [
        (r["path"], r["wall_ms_per_step"]) for r in out["runs"]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
