"""Dual-star shortwave diagnostics (the port's counterpart of
``scripts/diag_isr.py``): each star's insolation map at a time, their
maxima, the subsolar points and their separation. The maps and the numbers
of the ``[ISR]`` line are computed on the card (``--device cpu`` asks for
the CPU); only then are the maps copied to the host for the panels. Without
matplotlib one line says so and no PNG is written.

Usage:
  python -m qingdai_tpu_torch.diag_isr [--t-days 0] [--nlat 91] [--nlon 180] \\
      [--out output] [--device cuda|cpu] [--dtype float32|float64]
"""

from __future__ import annotations

import argparse
import os

import torch

from . import constants as const
from .grid import Grid, make_grid
from .physics import forcing
from .world import have_matplotlib

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def isr_report(grid: Grid, t_days: float):
    """(insA, insB, report): the two stars' insolation maps at ``t_days``
    planetary days and, computed on the maps' device, each one's maximum
    (W/m²) and subsolar point (lat, lon in degrees, the argmax's cell) and
    the great-circle separation of the two points (degrees)."""
    insA, insB = forcing.insolation_components(grid, t_days * const.DAY_SECONDS)
    W = insA.shape[1]
    points = []
    for ins in (insA, insB):
        k = torch.argmax(ins)
        points.append((grid.lat[k // W].double(), grid.lon[k % W].double()))
    (latA, lonA), (latB, lonB) = [(torch.deg2rad(a), torch.deg2rad(b)) for a, b in points]
    sep = torch.rad2deg(torch.arccos(torch.clamp(
        torch.sin(latA) * torch.sin(latB)
        + torch.cos(latA) * torch.cos(latB) * torch.cos(lonA - lonB), -1.0, 1.0)))
    numbers = torch.stack([insA.max().double(), points[0][0], points[0][1],
                           insB.max().double(), points[1][0], points[1][1], sep]).tolist()
    keys = ("max_A", "lat_A", "lon_A", "max_B", "lat_B", "lon_B", "separation_deg")
    return insA, insB, dict(zip(keys, numbers))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--t-days", type=float, default=0.0)
    ap.add_argument("--nlat", type=int, default=91)
    ap.add_argument("--nlon", type=int, default=180)
    ap.add_argument("--out", type=str, default="output")
    ap.add_argument("--device", default="cuda",
                    help="torch device to compute on (default: cuda)")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="float32")
    args = ap.parse_args(argv)

    g = make_grid(args.nlat, args.nlon, device=args.device, dtype=DTYPES[args.dtype])
    insA, insB, r = isr_report(g, args.t_days)
    print(f"[ISR] t={args.t_days:.2f} d | max A={r['max_A']:.1f} W/m2 "
          f"@({r['lat_A']:.1f},{r['lon_A']:.1f}) | max B={r['max_B']:.1f} "
          f"@({r['lat_B']:.1f},{r['lon_B']:.1f}) | subsolar separation={r['separation_deg']:.2f}°"
          f" [{insA.device}, {args.dtype}]")
    if not have_matplotlib():
        print("[ISR] matplotlib is not installed: no panels are written")
        return 0
    insA, insB = insA.cpu().numpy(), insB.cpu().numpy()

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    os.makedirs(args.out, exist_ok=True)
    fig, axes = plt.subplots(1, 3, figsize=(16, 4))
    for ax, data, title in [(axes[0], insA, "ISR A"), (axes[1], insB, "ISR B"),
                            (axes[2], insA + insB, "ISR total")]:
        im = ax.imshow(data, origin="lower", aspect="auto",
                       extent=[0, 360, -90, 90], cmap="inferno")
        ax.set_title(f"{title} (W/m²)")
        plt.colorbar(im, ax=ax, fraction=0.04)
    path = os.path.join(args.out, f"diag_isr_day_{args.t_days:06.1f}.png")
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    print(f"[ISR] wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
