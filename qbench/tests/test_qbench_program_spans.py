"""The readers of the measured package's own spans (``device_ms.physics``,
``device_ms.diagnostics``, ``device_ms.unspanned``, through
``metrics/_program.py``) on a synthetic trace and synthetic program
records, and a traced CPU run of a small cell whose program spans hold
every harness span at the boundary it wraps.

    python -m pytest qbench/tests -q
"""

from __future__ import annotations

import dataclasses
import time

import pytest
import torch

from qbench import cell as cell_mod
from qbench import plan, spec, trace
from qbench.metrics import _program

SMALL = {"n_lat": 19, "n_lon": 36}
CELL = "flagship-181.ens400"
READERS = ("device_ms.physics", "device_ms.diagnostics", "device_ms.unspanned")


def _rec(name, start, end, parent):
    from qingdai_tpu_torch.telemetry import Record
    return Record(name, start, end, parent)


# one step: ensemble.step ⊃ step ⊃ {physics.albedo ⊃ ecology.subdaily,
# dynamics, diag.water}, and diag.rows under ensemble.step; before the
# window, the records of a retried profile's first attempt
RECORDS = [
    ("physics.precip", -500, -100, -1),
    ("ensemble.step", 0, 1000, -1),
    ("step", 10, 900, 1),
    ("physics.albedo", 100, 300, 2),
    ("ecology.subdaily", 150, 200, 3),
    ("dynamics", 400, 600, 2),
    ("diag.water", 700, 800, 2),
    ("diag.rows", 910, 950, 1),
]
# (launch, device ns): each op's device time names where it should land
OPS = [
    (50, 1),            # step itself: unspanned
    (120, 10),          # physics.albedo
    (160, 100),         # ecology.subdaily, inside physics.albedo: ecology
    (450, 1000),        # dynamics
    (750, 10000),       # diag.water
    (920, 100000),      # diag.rows
    (905, 1000000),     # ensemble.step itself: unspanned
    (-300, 10 ** 7),    # the first attempt's physics.precip: outside the window
    (-1, 10 ** 8),      # no launch found: belongs to none
    (1200, 10 ** 9),    # after every span: belongs to none
]


def _run(records=RECORDS, n_steps=1):
    ops = [trace.DeviceOp("k", "kernel", 2000 + i, 2000 + i + d, launch)
           for i, (launch, d) in enumerate(OPS)]
    tr = trace.Trace(ops=ops, spans={trace.STEP: [(0, 1000)]}, t0=0, t1=3000,
                     n_steps=n_steps, step_kinds=[plan.ORDINARY] * n_steps,
                     host_s=[0.001] * n_steps)
    return type("R", (), {"trace": tr, "spans": trace.Spans()})()


@pytest.fixture
def program(monkeypatch):
    """Install ``records`` as the measured package's span records."""
    import qingdai_tpu_torch.telemetry as telemetry

    def install(records):
        monkeypatch.setattr(telemetry, "records", lambda: [_rec(*r) for r in records])
    return install


def test_each_op_goes_to_its_innermost_span(program):
    program(RECORDS)
    paths = _program.paths(_run())
    assert paths == {
        ("ensemble.step", "step"): 1,
        ("ensemble.step", "step", "physics.albedo"): 10,
        ("ensemble.step", "step", "physics.albedo", "ecology.subdaily"): 100,
        ("ensemble.step", "step", "dynamics"): 1000,
        ("ensemble.step", "step", "diag.water"): 10000,
        ("ensemble.step", "diag.rows"): 100000,
        ("ensemble.step",): 1000000,
    }


@pytest.mark.parametrize("n_steps", [1, 4])
def test_the_readers_sum_by_layer_a_step(program, n_steps):
    program(RECORDS)
    r = _run(n_steps=n_steps)
    got = {name: spec.reader(name)(r) for name in READERS}
    assert got == pytest.approx({
        # the subdaily ecology inside the albedo synthesis counts as ecology
        "device_ms.physics": 10e-6 / n_steps,
        "device_ms.diagnostics": (10000 + 100000) * 1e-6 / n_steps,
        "device_ms.unspanned": (1 + 1000000) * 1e-6 / n_steps,
    })
    assert _program.layer_ms(r, "ecology") == pytest.approx(100e-6 / n_steps)


def test_no_program_spans_read_none(program, monkeypatch):
    program([])
    assert all(spec.reader(name)(_run()) is None for name in READERS)
    program([RECORDS[0]])        # only records outside the window
    assert all(spec.reader(name)(_run()) is None for name in READERS)
    program(RECORDS)
    empty = _run()
    empty.trace = None
    assert all(spec.reader(name)(empty) is None for name in READERS)
    # a package without the module, as one before the spans were added
    monkeypatch.setattr(cell_mod, "PACKAGE", "qbench.ref")
    assert all(spec.reader(name)(_run()) is None for name in READERS)


def test_a_traced_run_nests_every_harness_span_in_its_stage():
    """A traced CPU run of the small cell over a whole day of steps: one
    program ``ensemble.step`` in each step, and each harness span inside
    the program span at the boundary it wraps, innermost."""
    c = spec.cell(CELL)
    c = dataclasses.replace(c, traffic=dict(c.traffic, members=2, trace_steps=240))
    r, _ = cell_mod.run(c, 2 ** 31 + 11, 0.1, True, "cpu", time.perf_counter(),
                        dtype_override=torch.float32, size_override=SMALL)
    tr = r.trace
    import qingdai_tpu_torch.telemetry as telemetry
    recs = [x for x in telemetry.records() if tr.t0 <= x.start_ns and x.end_ns <= tr.t1]
    roots = sorted((x.start_ns, x.end_ns) for x in recs if x.name == "ensemble.step")
    steps = tr.spans[trace.STEP]
    assert len(roots) == len(steps) == tr.n_steps == 240
    for (s, e), (rs, re_) in zip(steps, roots):
        assert s <= rs <= re_ <= e

    expected = {
        "dynamics.atmos_step": "dynamics", "ocean.ocean_step": "ocean",
        "routing.routing_step": "routing",
        "ecology.eco_step_daily": "ecology.daily",
        "ecology.surface_albedo_bands": "ecology.daily",
        "ecology.indiv_step_daily": "ecology.daily",
        "ecology.eco_step_subdaily": "ecology.subdaily",
        "ecology.indiv_try_substep": "ecology.indiv_substep",
        "ecology.phyto_step_daily": "ecology.phyto_daily",
        "ecology.phyto_apply_transport": "ecology.phyto_transport",
        "ecology.phyto_advect_diffuse": "ecology.phyto_transport",
        "K4.ocean_substeps": "ocean", "K1.model": "physics.clouds",
        "K1.dynamics": "dynamics.surface_energy", "K1.clouds": "physics.precip",
    }
    assert set(expected) == {name for _, _, name in trace.SPANS}
    seen = set()
    for name, ivs in tr.spans.items():
        if name not in expected:
            continue
        for s, e in ivs:
            # the enclosing spans form a chain in record order: the last is
            # the innermost
            around = [x for x in recs if x.start_ns <= s and e <= x.end_ns]
            assert around, (name, s)
            assert around[-1].name == expected[name], name
        seen.add(name)
    # a day of steps holds every wrapped call but two the flagship leaves
    # out: one ocean substep takes the chlorophyll along (no
    # phyto_advect_diffuse), and QD_ECO_BANDS_COUPLE is off
    assert seen == set(expected) - {"ecology.phyto_advect_diffuse",
                                    "ecology.surface_albedo_bands"}
