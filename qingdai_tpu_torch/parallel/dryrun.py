"""The sharded dry run: the flagship planet's full coupled step sharded over
longitude, compared leaf by leaf against the same chunks unsharded (port of
``__graft_entry__.dryrun_multichip``, with the same measure).

Each rank is one process (``parallel.mesh.spawn_ranks``); every rank runs
the unsharded reference too, so each can reshard it. The comparison is in
float64 at dt 7200 s: one 20-h planetary day is 10 steps and the 6-h
routing event fires every 3 steps, so ``n_segs`` half-day segments cross
daily boundaries (the ecology, individual-pool and phytoplankton daily
blocks, the mutation) and routing events. Between segments the sharded run
is resynced from the unsharded one. Each segment measures its own chaos
envelope: the unsharded chunk again from the segment start with the height
field bumped by ±1e-13 relative (two controls), and the sharded difference
must satisfy ``d < min(0.2, max(1e-3, 300·d_ctrl))``. Routing residuals
(stranded, mass error, store out, lake delta) are held relative to the
event's routed mass. All three runs of a segment draw the mutation from the
same generator state.

Run it as ``python -m qingdai_tpu_torch.parallel.dryrun --nproc N --backend
{nccl,gloo} [--device cpu]``: on the card by default (NCCL needs a card a
rank; gloo lets ranks share one, staging through host memory), the record
in ``output/``. ``n_lon`` is rounded as the JAX function rounds it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from .. import convert, entry
from .. import model as M
from ..grid import resolve_device
from .mesh import gather_state, shard_model_statics, shard_state, spawn_ranks

# routing residuals: differences of ~1e16-kg sums, held relative to the
# routed mass
ROUTED_SCALED = ("stranded_kg", "mass_error_kg", "store_out_kg", "lake_delta_kg")


def compare(ref, new) -> tuple[float, str]:
    """(the largest relative leaf difference of two ``WorldState``s, its
    leaf): each float leaf's max |a − b| over max(1, max |a|), NaN
    sentinels required in the same cells, routing residuals over the
    routed mass."""
    a_all, b_all = convert.world_to_numpy(ref), convert.world_to_numpy(new)
    routed = max(1.0, abs(float(a_all["routing.routed_mass_kg"])))
    worst, name = 0.0, ""
    for k, a in a_all.items():
        a, b = np.asarray(a), np.asarray(b_all[k])
        if a.size == 0 or a.dtype.kind != "f":
            continue
        a, b = a.astype(np.float64), b.astype(np.float64)
        fin = np.isfinite(a)
        if not np.array_equal(fin, np.isfinite(b)):
            raise AssertionError(f"{k}: the sharded run changed the non-finite cells")
        if not fin.any():
            continue
        scale = routed if k.split(".")[-1] in ROUTED_SCALED else max(1.0, np.abs(a[fin]).max())
        d = float(np.abs(a[fin] - b[fin]).max()) / scale
        if d > worst:
            worst, name = d, k
    return worst, name


def _perturbed(state, eps: float):
    a = state.atmos
    return dataclasses.replace(state, atmos=dataclasses.replace(a, h=a.h * (1.0 + eps)))


def dryrun_rank(mesh, n_lat: int, n_lon: int, n_segs: int) -> dict:
    """One rank of the dry run (module docstring): its record."""
    mdl, ref = entry.build_world(n_lat, n_lon, dt_seconds=7200.0, device=mesh.device,
                                 dtype=torch.float64, hermetic=True)
    if mdl.routing_static is None:
        raise RuntimeError("the dry run needs routing on")
    mdl_s = shard_model_statics(mdl, mesh)
    spd = int(round(mdl.day_seconds / mdl.dt))
    seg_len = spd // 2
    chunk, chunk_s = M.make_chunk_fn(mdl, seg_len), M.make_chunk_fn(mdl_s, seg_len)
    gen = mdl.generator            # the sharded model's too
    segs, routed_total = [], 0.0
    t_sharded = 0.0
    for seg in range(n_segs):
        g0 = gen.get_state()
        mesh.reset_stats()
        t0 = time.perf_counter()
        new_s, diags = chunk_s(shard_state(ref, mesh, n_lon))
        t_sharded += time.perf_counter() - t0
        stats = dict(mesh.stats)
        new = gather_state(new_s, mesh, n_lon)
        ctrl = []
        for eps in (1e-13, -1e-13):
            gen.set_state(g0)
            ctrl.append(chunk(_perturbed(ref, eps))[0])
        gen.set_state(g0)
        ref, ref_diags = chunk(ref)
        d, worst = compare(ref, new)
        d_ctrl = max(compare(ref, c)[0] for c in ctrl)
        bound = min(0.2, max(1e-3, 300.0 * d_ctrl))
        ts_ref, ts_shd = float(ref_diags["Ts_mean"][-1]), float(diags["Ts_mean"][-1])
        routed = float(new.routing.routed_mass_kg)
        if not d < bound:
            raise AssertionError(
                f"seg {seg}: sharded vs unsharded max rel diff {d:.3e} at {worst} exceeds the "
                f"measured chaos envelope (d_ctrl {d_ctrl:.3e} -> bound {bound:.3e}): a "
                "sharding defect, not roundoff")
        if not abs(ts_shd - ts_ref) < bound * max(1.0, abs(ts_ref)):
            raise AssertionError(f"seg {seg}: Ts_mean {ts_shd} sharded, {ts_ref} unsharded")
        if not routed > 0.0:
            raise AssertionError(f"seg {seg}: no routing event fired")
        routed_total += routed
        segs.append({"seg": seg, "diff": d, "worst": worst, "ctrl": d_ctrl, "bound": bound,
                     "collectives_per_step": stats["collectives"] / seg_len,
                     "halo_bytes_per_step": stats["halo_bytes"] / seg_len,
                     "gather_bytes_per_step": stats["gather_bytes"] / seg_len})
    ts = ref.atmos.T_s
    return {"n_ranks": mesh.n, "backend": mesh.backend, "device": str(mesh.device),
            "grid": f"{n_lat}x{n_lon}", "n_segs": n_segs, "seg_len_steps": seg_len,
            "segments": segs, "routed_mass_kg": routed_total,
            "ts_min_K": float(ts.min()), "ts_max_K": float(ts.max()),
            "sharded_seconds": t_sharded}


def dryrun_multichip(nproc: int, backend: str = "nccl", device="cuda", n_lat: int = 91,
                     n_lon: int = 184, n_segs: int = 4, threads=None,
                     timeout: float = 3600.0) -> dict:
    """Shard the full coupled step over ``nproc`` ranks and hold
    ``n_segs`` resynced half-day segments against the unsharded run (module
    docstring). Returns rank 0's record; raises on a segment beyond its
    bound."""
    n_lon = max(2 * nproc, ((n_lon // nproc) * nproc) or nproc)
    resolve_device(device)      # without the card it names, raise before any rank starts
    return spawn_ranks(dryrun_rank, nproc, backend, device, (n_lat, n_lon, n_segs),
                       threads=threads, timeout=timeout)[0]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nlat", type=int, default=91)
    ap.add_argument("--nlon", type=int, default=184)
    ap.add_argument("--segs", type=int, default=4)
    ap.add_argument("--threads", type=int, default=None,
                    help="torch.set_num_threads of each rank")
    ap.add_argument("--timeout", type=float, default=3600.0,
                    help="seconds before the ranks are killed")
    ap.add_argument("--out", default=None, help="record path (default output/dryrun_torch_*.json)")
    args = ap.parse_args(argv)
    rec = dryrun_multichip(args.nproc, args.backend, args.device, args.nlat, args.nlon,
                           args.segs, args.threads, args.timeout)
    txt = ", ".join(f"seg{r['seg']} {r['diff']:.3e} ({r['worst']}; ctrl {r['ctrl']:.3e}, "
                    f"bound {r['bound']:.3e})" for r in rec["segments"])
    print(f"[dryrun_multichip] {rec['n_ranks']} ranks ({rec['backend']}, {rec['device']}), "
          f"grid {rec['grid']}, {rec['n_segs']} resynced half-day segments of "
          f"{rec['seg_len_steps']} steps == unsharded, max rel diff vs the ±1e-13 controls: "
          f"{txt}; routed mass {rec['routed_mass_kg']:.3e} kg; Ts "
          f"[{rec['ts_min_K']:.1f}, {rec['ts_max_K']:.1f}] K")
    out = Path(args.out or f"output/dryrun_torch_{rec['n_ranks']}x{rec['grid']}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=1))
    return rec


if __name__ == "__main__":
    main()
