"""Orbit figures (the port's counterpart of ``scripts/generate_orbit_plots.py``):
the binary's trajectories, the planet's orbit and the total flux over a
planetary year. The positions and fluxes are computed on the card in
float64 (``--device cpu`` asks for the CPU) and printed; only then are they
copied to the host for the figure. Without matplotlib one line says so and
no PNG is written.

Usage:
  python -m qingdai_tpu_torch.generate_orbit_plots [--out output] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from . import constants as const
from .grid import resolve_device
from .physics import orbital
from .world import have_matplotlib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=str, default="output")
    ap.add_argument("--device", default="cuda",
                    help="torch device to compute on (default: cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    ts = np.linspace(0, orbital.T_PLANET, 2000)
    t = orbital.as_time(ts, device)
    S = orbital.total_flux(t)
    print(f"[Orbits] T_binary={orbital.T_BINARY/86400:.2f} Earth-days | "
          f"T_planet={orbital.T_PLANET/86400:.2f} Earth-days "
          f"({orbital.T_PLANET/const.DAY_SECONDS:.1f} Qingdai days) | flux over one orbit "
          f"{float(S.min()):.1f}–{float(S.max()):.1f} W/m² [{device}]")
    if not have_matplotlib():
        print("[Orbits] matplotlib is not installed: no figure is written")
        return 0
    xA, yA, xB, yB = (v.cpu().numpy() for v in orbital.stellar_positions(t))
    xp, yp = (v.cpu().numpy() for v in orbital.planet_position(t))
    S = S.cpu().numpy()

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    os.makedirs(args.out, exist_ok=True)
    fig, axes = plt.subplots(1, 2, figsize=(14, 6))
    au = const.AU
    axes[0].plot(xA / au, yA / au, label="Star A", lw=0.8)
    axes[0].plot(xB / au, yB / au, label="Star B", lw=0.8)
    axes[0].plot(xp / au, yp / au, label="Qingdai", lw=0.8)
    axes[0].set_aspect("equal")
    axes[0].legend()
    axes[0].set_title("Harmony system orbits (AU)")
    axes[1].plot(ts / const.DAY_SECONDS, S)
    axes[1].set_xlabel("planetary days")
    axes[1].set_ylabel("total flux (W/m²)")
    axes[1].set_title(f"Flux over one orbit: {S.min():.1f}–{S.max():.1f} W/m²")
    path = os.path.join(args.out, "orbits.png")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    print(f"[Orbits] wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
