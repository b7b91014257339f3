"""Analytic flux verification (the port's counterpart of
``scripts/verify_calculation.py``): the orbital flux at t = 0 against its
closed form, Kepler's third law between the two orbits, and the flux over a
planetary year (4096 times), all positive. The flux is computed on the card
in float64; ``--device cpu`` asks for the CPU. Exits 1 if a check fails.

Usage:
  python -m qingdai_tpu_torch.verify_calculation [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import math

import numpy as np

from . import constants as const
from .grid import resolve_device
from .physics import orbital


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to compute on (default: cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    ok = True

    # t=0: planet at (a_p, 0), A at (r_A, 0), B at (−r_B, 0)
    d_A = const.A_PLANET - orbital.R_A
    d_B = const.A_PLANET + orbital.R_B
    S_expect = (const.L_A / (4 * math.pi * d_A ** 2)
                + const.L_B / (4 * math.pi * d_B ** 2))
    S_got = float(orbital.total_flux(0.0, device))
    err = abs(S_got - S_expect) / S_expect
    print(f"[Verify] t=0 flux: got {S_got:.4f}, analytic {S_expect:.4f}, "
          f"rel err {err:.2e} {'OK' if err < 1e-5 else 'FAIL'}")
    ok &= err < 1e-5

    # Kepler periods
    ratio = (orbital.T_PLANET / orbital.T_BINARY) ** 2
    expect = (const.A_PLANET / const.A_BINARY) ** 3
    err = abs(ratio - expect) / expect
    print(f"[Verify] Kepler T²∝a³: rel err {err:.2e} {'OK' if err < 1e-10 else 'FAIL'}")
    ok &= err < 1e-10

    # flux range over a year
    ts = np.linspace(0, orbital.T_PLANET, 4096)
    S = orbital.total_flux(ts, device).cpu().numpy()
    print(f"[Verify] flux over orbit: min {S.min():.1f}, max {S.max():.1f} W/m² "
          f"(variability {(S.max()/S.min()-1)*100:.2f}%)")
    ok &= bool(np.all(S > 0))

    print(f"[Verify] {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
