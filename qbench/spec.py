"""The benchmark's entries found by name: ``BENCHMARK.json`` at the root of
the checkout names the cells, configurations and metrics, and each has a
file of its own under ``qbench/``:

- a configuration ``<name>``: ``configs/<name>.json`` (grid, dt, dtype,
  ``QD_*`` settings, topography seed, the leaves each kind of step changes);
- a traffic mix ``<traffic>``: ``traffic/<traffic>.json`` (members,
  perturbation, diagnostics cadence, where on the day the run starts, the
  traced steps, the members the check compares), read by one generator;
- a cell ``<config>.<traffic>``: its limits of the check in
  ``limits/<cell>.json``;
- a metric ``<name>``: the reader ``metrics/<name>.py`` with ``read(ctx)``.

So a later change adds a cell, a configuration or a metric by adding files
and entries, and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    return json.loads(path.read_text())


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: tuple      # the BENCHMARK.json entries this cell reports
    per_layer: tuple


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench or benchmark()
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = entries[0]
    return Cell(name=name, chips=int(w["chips"]), config=_json("configs", w["config"]),
                traffic=_json("traffic", w["traffic"]), limits=_json("limits", name),
                end_to_end=tuple(m for m in bench["end_to_end"] if _reports(m, name)),
                per_layer=tuple(m for m in bench["per_layer"] if _reports(m, name)))


def reader(metric: str):
    """The ``read(ctx)`` of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader {path}")
    spec = importlib.util.spec_from_file_location(f"qbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
