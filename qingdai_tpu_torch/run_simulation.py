"""The port's simulation CLI, with the ``QD_*`` surface of
``scripts/run_simulation.py``: duration QD_TOTAL_YEARS > QD_SIM_DAYS > 5
planetary years; restart QD_RESTART_IN > the ``data/`` autosave > banded
init. It runs on the card; ``--device cpu`` asks for the CPU.

Usage:
  QD_SIM_DAYS=10 python -m qingdai_tpu_torch.run_simulation [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import torch


def describe(device: torch.device) -> str:
    if device.type == "cuda":
        return f"{device} ({torch.cuda.get_device_name(device)})"
    return str(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda; cpu runs the plain versions "
                         "of the kernels)")
    args = ap.parse_args(argv)
    from .grid import resolve_device
    from .world import QingdaiWorld
    device = resolve_device(args.device)
    print("--- Initializing Qingdai GCM (PyTorch / CUDA port) ---")
    print(f"[torch] device: {describe(device)}")
    world = QingdaiWorld.create_default(device=device)
    world.run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
