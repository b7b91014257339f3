"""The port's spans (``qingdai_tpu_torch.telemetry``) on the CPU: a 2-member
ensemble of the flagship planet at 19×36.

With no profiler the spans record nothing. Under a CPU ``torch.profiler``
an ordinary step and a day-end step each give one tree of spans under
``ensemble.step``, with the stages in the step's order; nearly every
PyTorch operator that runs in the step runs inside a stage; the spans
share the profiler's clock; and the step's numbers are the same bit for
bit with the profiler on and off.
"""

import dataclasses

import pytest
import torch

from qingdai_tpu_torch import entry
from qingdai_tpu_torch import ensemble as E
from qingdai_tpu_torch import state as S
from qingdai_tpu_torch import telemetry

DYNAMICS = ["dynamics", "dynamics.humidity", "dynamics.surface_energy", "dynamics.advect",
            "dynamics.height", "dynamics.momentum", "dynamics.filters", "dynamics.cloud",
            "dynamics.scrub"]
# the stages of a day-end step, in the order they open
DAY_END = (["physics.precip", "ecology.daily", "physics.clouds", "physics.insolation",
            "physics.snow", "ecology.indiv_substep", "ecology.phyto_daily", "physics.albedo",
            "ecology.subdaily"] + DYNAMICS
           + ["diag.energy", "physics.surface_fluxes", "ocean", "physics.sst_feedback",
              "ecology.phyto_transport", "physics.land_bucket", "routing", "clock",
              "diag.water"])
ORDINARY = [n for n in DAY_END if n not in ("ecology.daily", "ecology.phyto_daily")]


@pytest.fixture(scope="module")
def world():
    """(model, 2-member ensemble, generators, one-step chunk)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    model, _ = entry.build_world(19, 36, device="cpu", dtype=torch.float32)
    ens, gens = E.init_ensemble(model, 2, seed=3, perturb_k=0.01)
    yield model, ens, gens, E.make_ensemble_chunk_fn(model, 1, 1)
    torch.set_num_threads(threads)


def _at_step(ens, model, k: int):
    """``ens`` with the clock of ``k`` steps after t = 0, as a restart at
    that time holds it: the time and phases of ``init_clock``, the day and
    phytoplankton accumulators walked as the step walks them."""
    r = lambda x: S.round_to(x, model.dtype)
    dt_r, day_r = r(model.dt), r(model.day_seconds)
    accum, phyto = 0.0, day_r
    for _ in range(k):
        a = r(accum + dt_r)
        accum = r(a - day_r) if a >= day_r else a
        p = r(phyto + dt_r)
        phyto = r(p - day_r) if p >= day_r else p
    fresh = S.init_clock(model.grid, k * model.dt, model.dtype)
    clock = dataclasses.replace(
        ens.clock, t_seconds=fresh.t_seconds, phase_rot=fresh.phase_rot,
        phase_binary=fresh.phase_binary, phase_planet=fresh.phase_planet, step_idx=k,
        accum_t_day=accum, phyto_accum=phyto)
    return dataclasses.replace(ens, clock=clock)


def _profiled(fn):
    """(fn's result, the spans it recorded, the profiler's host events)."""
    telemetry.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    recs = telemetry.records()
    telemetry.clear()
    return out, recs, list(prof.profiler.kineto_results.events())


def _check_tree(recs, stages):
    assert recs[0].name == "ensemble.step" and recs[0].parent == -1
    for r in recs:
        assert r.start_ns <= r.end_ns, r
        if r.parent >= 0:
            p = recs[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns, (r, p)
    roots = [r for r in recs if r.parent == -1]
    assert len(roots) == 1
    step = [i for i, r in enumerate(recs) if r.name == "step"]
    assert len(step) == 1 and recs[step[0]].parent == 0
    assert recs[-1].name == "diag.rows" and recs[-1].parent == 0
    inside = [r.name for r in recs if r.name not in ("ensemble.step", "step", "diag.rows")]
    assert inside == stages
    # the dynamics' stages sit inside ``dynamics``, the subdaily ecology
    # inside the albedo synthesis, the day's ecology inside the precipitation
    # stage, the rest directly under the step
    for r in recs:
        parent = recs[r.parent].name if r.parent >= 0 else None
        if r.name.startswith("dynamics."):
            assert parent == "dynamics"
        elif r.name == "ecology.subdaily":
            assert parent == "physics.albedo"
        elif r.name == "ecology.daily":
            assert parent == "physics.precip"
        elif r.name in stages:
            assert parent == "step", r.name


def _leaves(ens):
    return {(g, f): v for g, f, v in E._leaves(ens)}


def test_off_records_nothing_and_shares_one_noop(world):
    model, ens, gens, chunk = world
    telemetry.clear()
    assert telemetry.span("a") is telemetry.span("b")
    chunk(_at_step(ens, model, 5), gens)
    assert telemetry.records() == []


@pytest.mark.parametrize("k, stages", [(5, ORDINARY), (239, DAY_END)],
                         ids=["ordinary", "dayend"])
def test_a_step_is_one_tree_of_its_stages(world, k, stages):
    model, ens, gens, chunk = world
    _, recs, events = _profiled(lambda: chunk(_at_step(ens, model, k), gens))
    _check_tree(recs, stages)

    # coverage: the operators that start in the step start in a stage
    step = next(r for r in recs if r.name == "step")
    leaves = sorted((r.start_ns, r.end_ns) for r in recs
                    if r.name not in ("ensemble.step", "step"))
    ops = [e for e in events if e.name().startswith("aten::")
           and step.start_ns <= e.start_ns() <= step.end_ns]
    loose = [e.name() for e in ops
             if not any(s <= e.start_ns() <= t for s, t in leaves)]
    print(f"{len(loose)} of {len(ops)} operators in the step outside a stage: {loose}")
    assert ops and len(loose) <= 0.01 * len(ops)


def test_spans_share_the_profilers_clock():
    def probe():
        with telemetry.span("probe"):
            with torch.profiler.record_function("qd.probe"):
                torch.ones(8).sum()

    _, recs, events = _profiled(probe)
    ev = next(e for e in events if e.name() == "qd.probe")
    (rec,) = recs
    assert rec.name == "probe"
    assert rec.start_ns <= ev.start_ns() <= ev.end_ns() <= rec.end_ns


def test_the_buffer_is_bounded(monkeypatch):
    monkeypatch.setattr(telemetry, "CAPACITY", 3)

    def spans():
        for i in range(5):
            with telemetry.span(f"s{i}"):
                with telemetry.span("inner"):
                    pass

    _, recs, _ = _profiled(spans)
    assert [r.name for r in recs] == ["s0", "inner", "s1"]
    assert [r.parent for r in recs] == [-1, 0, -1]


def test_the_step_is_bit_equal_under_the_profiler(world):
    model, ens, gens, chunk = world
    start = _at_step(ens, model, 239)
    plain, d_plain = chunk(start, gens)
    (traced, d_traced), recs, _ = _profiled(lambda: chunk(start, gens))
    assert recs
    a, b = _leaves(plain), _leaves(traced)
    assert a.keys() == b.keys()
    for k, v in a.items():
        if isinstance(v, torch.Tensor):
            _same(v, b[k])
        else:
            assert v == b[k], k
    for k in d_plain:
        _same(d_plain[k], d_traced[k])


def _same(x, y):
    """Equal bit for bit, NaN at the same places."""
    torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)
