"""How often torch.profiler loses the device events of a profile.

    python3 scripts/profiler_check.py [--seconds 120]

Takes ``chip_smoke.take_profile``'s profile (20 calls) of each of the four
kernels at the main path's shapes (float32), in turns, with each of
several idle times inside the profile before the first call and after the
last, until ``--seconds`` have passed. Each kernel call is one device
launch, so a profile should hold 20 device events. Prints, for each
(kernel, idle times), the profiles taken, those with no device event and
those with some but fewer than 20. Needs one CUDA card.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

# idle times (before the first call, after the last) inside a profile
PADS = ((0.0, 0.0), (0.002, 0.002), (0.02, 0.0), (0.0, 0.02), (0.02, 0.02),
        (chip_smoke.PROFILE_WAIT_S, 0.0))


def kernel_calls(dev):
    from qingdai_tpu_torch import constants as const
    from qingdai_tpu_torch.grid import make_grid
    from qingdai_tpu_torch.kernels.advect_bilinear import advect_bilinear_cuda
    from qingdai_tpu_torch.kernels.hyper4 import hyperdiffuse_cuda
    from qingdai_tpu_torch.kernels.median_pos import median_pos_cuda
    from qingdai_tpu_torch.kernels.ocean_substeps import ocean_substeps_cuda

    H, W, A, f32 = chip_smoke.H, chip_smoke.W, const.PLANET_RADIUS, torch.float32
    r = np.random.default_rng(0)
    g = make_grid(H, W, device=dev, dtype=f32)
    x = chip_smoke.on(dev, np.where(r.random((H, W)) < 0.6, 0.0, r.random((H, W)) * 1e-5), f32)
    F2 = chip_smoke.on(dev, 280.0 + 20.0 * r.standard_normal((2, H, W)), f32)
    u = chip_smoke.on(dev, 60.0 * r.standard_normal((H, W)), f32)
    v = chip_smoke.on(dev, 30.0 * r.standard_normal((H, W)), f32)
    F5 = chip_smoke.on(dev, 30.0 * r.standard_normal((5, H, W)), f32)
    k4 = (0.02 * g.k4_map_unit / 300.0)[None].expand(5, H, W).contiguous()
    mom, st, forc, geo, params = chip_smoke.k4_operands(dev, f32, chip_smoke.N_SPECIES, 1, 1,
                                                        5.0e3)
    return {
        "median_pos": lambda: median_pos_cuda(x, 1e-6),
        "advect_bilinear": lambda: advect_bilinear_cuda(F2, u, v, 300.0, A, g.dlat_rad,
                                                        g.dlon_rad, g.coslat_cap_tiny),
        "hyper4": lambda: hyperdiffuse_cuda(F5, k4, 300.0, 1, g.dlat_rad, g.dlon_rad,
                                            g.coslat_cap_02, A),
        "ocean_substeps": lambda: ocean_substeps_cuda(mom, st, forc, geo, **params),
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=120.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profiler_check: no CUDA device", file=sys.stderr)
        return 2
    from qingdai_tpu_torch.kernels import build

    build.build()
    build.load_library()
    calls = kernel_calls(torch.device("cuda"))
    reps = 20
    for fn in calls.values():
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    tally = {}
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < args.seconds:
        for pads in PADS:
            for name, fn in calls.items():
                n = len(chip_smoke.take_profile(fn, reps, pads)[0])
                t = tally.setdefault(f"{name} {pads[0]}/{pads[1]} s", [0, 0, 0])
                t[0] += 1
                t[1] += n == 0
                t[2] += 0 < n < reps
    print(json.dumps({"card": chip_smoke.card_label(), "torch": torch.__version__,
                      "seconds": time.perf_counter() - t0,
                      "profiles, empty, short": tally}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
