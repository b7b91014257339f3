"""Point-level ecology plot (the port's counterpart of
``scripts/plot_ecology_point.py``): the top-3 species at a lat/lon point
with the individual pool's distributions, from the state a default world
starts with (the autosave under ``data/`` if there is one). The world is
built on the card (``--device cpu`` asks for the CPU); its ecology and
individual states and the pool's statics are copied to the host for the
panel. Without matplotlib one line says so and no PNG is written.

Usage:
  python -m qingdai_tpu_torch.plot_ecology_point --lat 10 --lon 120 [--out output]
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from .world import QingdaiWorld, _to_host, have_matplotlib


def _host_static(static):
    """The individual pool's statics with every tensor a NumPy array."""
    return dataclasses.replace(static, **{
        f.name: getattr(static, f.name).cpu().numpy() for f in dataclasses.fields(static)
        if isinstance(getattr(static, f.name), torch.Tensor)})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lat", type=float, default=0.0)
    ap.add_argument("--lon", type=float, default=180.0)
    ap.add_argument("--out", type=str, default="output")
    ap.add_argument("--device", default="cuda",
                    help="torch device to build the world on (default: cuda)")
    args = ap.parse_args(argv)

    world = QingdaiWorld.create_default(device=args.device)
    if world.state.eco is None:
        print("[EcologyPoint] ecology disabled (QD_ECO_ENABLE=0); nothing to plot.")
        return 0
    if not have_matplotlib():
        print("[EcologyPoint] matplotlib is not installed: no panel is written")
        return 0
    from .viz.ploter import plot_top3_species_distributions

    host = _to_host(world.state, numpy=True)
    static = world.model.indiv_static
    path = plot_top3_species_distributions(
        host.eco, None if static is None else _host_static(static), host.indiv,
        world.land_mask, args.lat, args.lon, world.lat, world.lon,
        args.out, t_days=world.t_seconds / world.day_seconds)
    print(f"[EcologyPoint] wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
