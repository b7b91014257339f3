"""The benchmark's harness on the CPU: a whole run of a cell at 19×36 in
float64 with 3 members (no card), its result line, the frozen reference
against the measured package, the byte counts, the spans, the import check
and the faults and the control that ``correct`` has to catch.

    python -m pytest qbench/tests -q
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time

import pytest
import torch

from qbench import cell as cell_mod
from qbench import check, guard, plan, run, spec, states, trace, world
from qbench.peaks import PEAK_BYTES_PER_S

SMALL = {"n_lat": 19, "n_lon": 36}
CELL = "flagship-181.ens400"
SEED = 2 ** 31 + 77


def small_cell(name=CELL, members=3, **traffic):
    c = spec.cell(name)
    return dataclasses.replace(c, traffic=dict(c.traffic, members=members, **traffic))


def drive(c, traced=False, seed=SEED, dtype=torch.float64):
    return cell_mod.run(c, seed, 0.2, traced, "cpu", time.perf_counter(), dtype_override=dtype,
                        size_override=SMALL)


@pytest.fixture(scope="module")
def recorded():
    c = small_cell()
    r, results = drive(c)
    return c, r, results


# ---- discovery by name --------------------------------------------------

def test_every_entry_resolves_to_its_own_files():
    bench = spec.benchmark()
    for w in bench["workloads"]:
        c = spec.cell(w["name"], bench)
        assert c.config["n_lat"] > 0 and c.traffic["members"] >= 1
        assert set(c.limits["limits"]) == set(check.CHECKS)
        assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
        assert c.per_layer
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
    for cfg in bench["configs"]:
        assert (spec.ROOT / cfg["file"]).is_file()


def test_a_metric_file_is_found_by_its_name(tmp_path, monkeypatch):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "new.metric.py").write_text("def read(run):\n    return 1.5\n")
    monkeypatch.setattr(spec, "HERE", tmp_path)
    assert spec.reader("new.metric")(None) == 1.5
    with pytest.raises(FileNotFoundError):
        spec.reader("absent")


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_to_the_contract():
    bench = spec.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["end_to_end"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] in (1, 4) and len(w["why"]) <= 200
    cells = len(bench["workloads"])
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert cells <= 24


# ---- the result line ----------------------------------------------------

def test_result_line_has_the_contract_keys(recorded):
    c, r, results = recorded
    line = run.result_line(c, r, results, False, {"platform": "cpu"})
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert "setup_s" in line["metrics"]
    assert set(line["metrics"]) <= {m["name"] for m in c.end_to_end}
    for name, chk in line["checks"].items():
        assert set(chk) == {"value", "limit", "worst"}
    assert line["kernel_build_s"] == 0.0 and list(line)[-2] == "kernel_build_s"
    json.loads(json.dumps(line, allow_nan=False))
    assert r.steps >= 1 and len(r.step_ms) == r.steps


def test_run_needs_the_cards(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", CELL, "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


# ---- the reference against the measured package ----------------------------

def test_reference_follows_the_measured_ensemble(recorded):
    """An ordinary, a routing-event and a day-end step of a 3-member
    ensemble, on members other than member 0, and the start and warm-up."""
    c, r, results = recorded
    assert set(results) == set(check.CHECKS)
    for name, (gap, where) in results.items():
        assert gap <= 1e-12, (name, gap, where)


def test_check_plan_covers_every_kind_and_both_halves():
    model = world.build(cell_mod.PACKAGE, world.make_inputs(dict(spec.cell(CELL).config,
                                                               **SMALL)), "cpu", torch.float64)
    for seed in (0, 5, 2 ** 31 + 3):
        p = plan.check_plan(model, seed, 100, 240, {"check_members": 3})
        assert sorted(p.steps.values()) == sorted([plan.ORDINARY, plan.ROUTING, plan.DAY_END])
        assert any(0 < m < 50 for m in p.members) and any(m >= 50 for m in p.members)
    assert plan.warmup_steps(model, 215) == 25
    kinds = plan.first_day(model, 215)
    assert len(kinds) == 25 and kinds[0] == plan.ROUTING and kinds[-1] == plan.DAY_END
    window = plan.first_day(model, 240)
    assert len(window) == 240 and window.index(plan.ROUTING) == 47


# ---- byte counts -----------------------------------------------------------

def test_tensor_bytes_counts_each_member_once():
    x, shared = torch.zeros(5, 3, 4), torch.zeros(3, 4, dtype=torch.float64)
    seen = {}

    def body(a, b):
        seen["a"], seen["b"], seen["both"] = (trace.tensor_bytes(a), trace.tensor_bytes(b),
                                              trace.tensor_bytes({"x": (a, [b])}))
        return a

    torch.func.vmap(body, in_dims=(0, None))(x, shared)
    assert seen == {"a": 5 * 12 * 4, "b": 12 * 8, "both": 5 * 12 * 4 + 12 * 8}


def test_span_bytes_match_hand_counts():
    """K4 at 19×36, 3 members: mom (3) + st (SST + 10 chlorophyll) + forc (3)
    + geo (12) planes read, mom and st written; K1 one field read and one
    number written, per member."""
    c = small_cell(trace_steps=2)
    r, _ = drive(c, traced=True, dtype=torch.float32)
    hw, B, n = 19 * 36, 3, 2
    assert r.spans.calls["K4.ocean_substeps"] == n
    assert r.spans.bytes["K4.ocean_substeps"] == n * B * (3 + 11 + 3 + 12 + 3 + 11) * hw * 4
    assert r.spans.bytes["K1.model"] == n * B * (hw + 1) * 4


def test_step_roofline_bytes_from_the_changed_leaves(recorded):
    c, r, _ = recorded
    reader = spec.reader("step_roofline_mfu")
    changed = c.config["changed_leaves"]
    r2 = dataclasses.replace(r, trace=trace.Trace(
        ops=[trace.DeviceOp("k", "kernel", 0, 10, 0)], spans={}, t0=0, t1=10 ** 9, n_steps=2,
        step_kinds=[plan.ORDINARY, plan.DAY_END], host_s=[0.1, 0.1]))
    least = 2 * (sum(r.leaf_bytes[k] for k in changed["ordinary"])
                 + sum(r.leaf_bytes[k] for k in changed["dayend"])) / PEAK_BYTES_PER_S
    assert reader(r2) == pytest.approx(100 * least / 1.0)
    # every changed leaf exists, and a member's leaf counts each member
    assert r.leaf_bytes["atmos.T_s"] == 3 * 19 * 36 * 8


def test_trace_readers_on_a_synthetic_trace():
    ops = [trace.DeviceOp("a", "kernel", 100, 200, 10), trace.DeviceOp("b", "kernel", 150, 300, 20),
           trace.DeviceOp("c", "gpu_memcpy", 500, 600, 40)]
    tr = trace.Trace(ops=ops, spans={"qb.step": [(0, 700)], "ocean.ocean_step": [(5, 25)]},
                     t0=0, t1=1000, n_steps=1, step_kinds=[plan.ORDINARY], host_s=[0.002])
    assert tr.busy_ns() == 300
    assert [o.name for o in tr.inside(["ocean.ocean_step"])] == ["a", "b"]
    fake = type("R", (), {"trace": tr, "spans": trace.Spans()})()
    assert spec.reader("device_idle_share")(fake) == pytest.approx(70.0)
    assert spec.reader("launches_per_step")(fake) == 3
    assert spec.reader("device_ms.ocean")(fake) == pytest.approx((100 + 150) * 1e-6)
    assert spec.reader("device_ms.routing")(fake) is None
    assert spec.reader("host_ms_per_step")(fake) == pytest.approx(2.0)
    b = trace.breakdown(tr)
    assert b["device_ops"][0][0] == "b" and len(b["idle_gaps"]) <= 10


def test_launches_leave_out_the_check_copies():
    """The recorder's copies, launched inside the ``trace.RECORD`` span, are
    the harness's work and not counted as the step's launches."""
    ops = [trace.DeviceOp("a", "kernel", 100, 200, 10),
           trace.DeviceOp("m", "gpu_memcpy", 300, 400, 30),
           trace.DeviceOp("b", "kernel", 500, 600, 50)]
    tr = trace.Trace(ops=ops, spans={"qb.step": [(0, 20), (40, 60)], trace.RECORD: [(25, 35)]},
                     t0=0, t1=1000, n_steps=2, step_kinds=[plan.ORDINARY] * 2, host_s=[0.1, 0.1])
    fake = type("R", (), {"trace": tr, "spans": trace.Spans()})()
    assert spec.reader("launches_per_step")(fake) == 1.0


def test_parted_share_counts_entries_beyond_the_tolerance():
    r = torch.tensor([[5.0, -5.0], [1.0, 0.0]])
    p = torch.tensor([[-5.0, -5.0], [1.004, 0.0049]])
    # the scale is 5: entries off by more than 5e-3 part
    assert states.parted(p, r, 1e-3).tolist() == [[True, False], [False, False]]
    assert states.parted_share(p, r, 1e-3) == 0.25
    assert states.parted_share(torch.zeros(3), torch.zeros(3), 1e-3) == 0.0
    assert states.parted_share(torch.tensor([float("nan"), 1.0]), torch.ones(2), 1e-3) == 0.5
    assert states.parted_share(torch.tensor([1, 2, 3, 4]), torch.tensor([1, 2, 0, 4]), 1e-3) == 0.25
    assert states.parted_share(2.0, 1.0, 1e-3) == 1.0 and states.parted_share(1.0, 1.0, 1e-3) == 0.0
    share, at = states.worst_share({"a": p, "b": torch.ones(4)}, {"a": r, "b": torch.ones(4)}, 1e-3)
    assert (share, at) == (0.25, "a")


# ---- the spans leave the step unchanged ------------------------------------

def test_span_wrappers_leave_the_step_bit_equal():
    import qingdai_tpu_torch.ensemble as E
    import qingdai_tpu_torch.state as S
    inputs = world.make_inputs(dict(spec.cell(CELL).config, **SMALL))
    model = world.build(cell_mod.PACKAGE, inputs, "cpu", torch.float32)
    ens, gens = E.init_ensemble(model, 2, seed=3, perturb_k=0.01)
    ens = plan.set_clock(ens, model, S, 215)
    chunk = E.make_ensemble_chunk_fn(model, 1, 1)

    def steps(e):
        out = []
        for _ in range(25):
            e, d = chunk(e, gens)
            out.append(({k: v.clone() if isinstance(v, torch.Tensor) else v
                         for k, v in states.leaves(e).items()}, d))
        return out

    plain = steps(ens)
    with trace.install(cell_mod.PACKAGE, trace.Spans(counting=True)):
        wrapped = steps(ens)
    for (a, da), (b, db) in zip(plain, wrapped):
        for k in a:
            assert states.leaf_gap(b[k], a[k]) == 0.0, k
        for k in da:
            assert torch.equal(da[k], db[k]), k


# ---- the import check ------------------------------------------------------

def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sys.modules))"],
                         capture_output=True, text=True, check=True, cwd=spec.ROOT)
    return guard.top_levels(out.stdout.split())


def test_the_reference_imports_nothing_of_either_package():
    mods = _loaded("import qbench.ref.model, qbench.ref.members, qbench.ref.topography, "
                   "qbench.ref.hydro_network")
    assert not guard.forbidden_loaded(mods, also=(guard.MEASURED,))
    assert "torch" in mods


def test_the_harness_imports_no_jax():
    mods = _loaded("import qbench.run, qbench.cell, qbench.check, qbench.trace, "
                   "qingdai_tpu_torch.ensemble")
    assert not guard.forbidden_loaded(mods)
    assert guard.MEASURED in mods


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden_loaded(["qingdai_tpu_torch.model", "qingdai_tpu_torchx"]) == []
    assert guard.forbidden_loaded(["qingdai_tpu.model"]) == ["qingdai_tpu"]
    assert guard.forbidden_loaded(["jaxlib.xla_client", "jax"]) == ["jax", "jaxlib"]


# ---- what correct has to catch ---------------------------------------------

def _broken(fault):
    import qingdai_tpu_torch.ensemble as E
    real = E.make_ensemble_chunk_fn

    def factory(model, chunk_steps=None, diag_every=None):
        inner = real(model, chunk_steps, diag_every)

        def chunk(ens, generators=None):
            new, diags = inner(ens, generators)
            if fault == "unchanged":
                return ens, diags
            per_new, shared = E._split(new)
            per_old, _ = E._split(ens)
            if fault == "half":
                h = per_new[0].shape[0] // 2
                per = tuple(torch.cat([n[:h], o[h:]]) for n, o in zip(per_new, per_old))
                return E._join(new, per, shared), diags
            if fault == "altered":
                atmos = new.atmos
                ts = atmos.T_s.clone()
                ts[:, 5, 7] += 0.5
                return dataclasses.replace(new, atmos=dataclasses.replace(atmos, T_s=ts)), diags
            raise ValueError(fault)

        return chunk

    return factory


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_broken_step_is_not_correct(fault, monkeypatch):
    import qingdai_tpu_torch.ensemble as E
    monkeypatch.setattr(E, "make_ensemble_chunk_fn", _broken(fault))
    c = small_cell(members=4)
    r, results = drive(c, dtype=torch.float32)
    line = run.result_line(c, r, results, False, {"platform": "cpu"})
    assert line["correct"] is False, line["checks"]


def test_the_bfloat16_control_is_not_correct(recorded):
    """The reference in bfloat16 put in the program's place fails the
    cell's limits (the control of the check, at a test's size)."""
    c = small_cell()
    rec_c, r, _ = recorded
    rec = r.extra["recorder"]
    out = check.compare(rec, r.extra["inputs"], "cpu", torch.float64, SEED, c.traffic,
                        c.traffic["start_step"], r.extra["n_warmup"], control=True)
    failed = [k for k, (gap, _) in out.items() if gap > c.limits["limits"][k]]
    assert failed, out


@pytest.mark.gpu
def test_a_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run([sys.executable, "-m", "qbench.run", "--workload", CELL, "--seed", "3",
                           "--seconds", "5", "--trace", "0"], capture_output=True, text=True,
                          cwd=spec.ROOT, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
