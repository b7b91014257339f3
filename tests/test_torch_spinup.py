"""The port's spin-up SOP and restart regrid (``qingdai_tpu_torch.spinup``,
``qingdai_tpu_torch.regrid_restart``) against ``scripts/spinup.py`` and
``scripts/regrid_restart.py``, on the CPU at 19×36 with dt 7200 s (10 steps
a day).

- (a) ``acceptance_metrics``, ``build_criteria``, ``--reeval`` and the
  ``--prepend-series`` merge on seeded synthetic series (a transient chunk,
  a partial edge year) within 1e-12 of the JAX tool's.
- (b) ``regrid_bilinear`` bit for bit; the CLI on a restart written by the
  JAX package, every field equal to the JAX CLI's with the floors and caps
  applied; the ``.pt`` route without a NetCDF library.
- (c) both packages' ``run_phase`` over two 1-day chunks in float64 from
  one topography file: the first chunk's means within 1e-8 of each key's
  scale, the second's within the measured chaos envelope (the test's
  docstring says why). The JAX run is traced and compiled in a subprocess
  started when the module's first test runs, so it overlaps the port's
  tests.
- (d) the SOP's ``main``, with and without a NetCDF library: phase 1 →
  phase 2, then the same phase 2 as two segments (``--skip-phase1``, then
  ``--prepend-series``) equal bit for bit to the uninterrupted one in the
  final state, the generator and the merged series, with mutation on.
- (e) a 19×36 → 37×72 regrid and a phase-2 segment from it: the flux caches
  ride along, so no bootstrap and no transient chunk.
- (i) ``QD_TOPO_NC`` where no NetCDF library imports raises instead of
  building the mask-only planet; the topography handed over in memory is
  the one the file gives.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import scripts.regrid_restart as jregrid
import scripts.spinup as jsp
from qingdai_tpu.io import netcdf as jnc
from qingdai_tpu_torch import regrid_restart as tregrid
from qingdai_tpu_torch import spinup as tsp
from qingdai_tpu_torch import topography as ttopo
from qingdai_tpu_torch import world as tworld
from qingdai_tpu_torch.io import checkpoint as tckpt
from qingdai_tpu_torch.io import netcdf as tnc
from qingdai_tpu_torch.physics.orbital import T_PLANET

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
N_LAT, N_LON = 19, 36
DAY_YEARS = 72000.0 / T_PLANET
# the world of every run here: 10 steps a day, small species counts
TINY = {"QD_DT_SECONDS": "7200", "QD_ECO_NS": "3", "QD_PHYTO_NSPECIES": "3",
        "QD_ECO_INDIV_PER_CELL": "10"}


# ---------------------------------------------------------------- (a)

def _series(n=620, per_year=50, seed=0, edge=0.37):
    """A seeded per-chunk series over ~12 years whose time axis starts
    mid-year (a partial edge year), with one fallback-precip transient
    chunk, the routing and audit keys, and a NaN-only key."""
    r = np.random.default_rng(seed)
    t = edge + (np.arange(n) + 0.5) / per_year
    s = {"t_years": t, "_consts": np.asarray([0.998, 300.0, 2.5e6])}
    base = {"TOA_net": -90.0, "SFC_net": -11.0, "ATM_net": -74.0, "Ts_mean": 285.0,
            "E_mean": 6.8e-5, "P_mean": 2.0e-5, "R_mean": 1e-7, "LH_mean": 170.0,
            "LH_release_mean": 50.0, "total_reservoir_mean": 1e6, "CWV_mean": 6.8,
            "ICE_mean": 10.0, "W_land_mean": 20.0, "S_snow_mean": 1e6,
            "routing_mass_error_kg": 1e13, "routing_ocean_inflow_kgps": 1e8,
            "routing_stranded_kg": 1e3, "routing_routed_mass_kg": 2e9,
            "routing_store_out_kg": 0.0, "routing_lake_delta_kg": -1e13}
    for k, v in base.items():
        s[k] = v * (1.0 + 0.05 * r.standard_normal(n)) + 0.01 * abs(v) * np.sin(2 * np.pi * t)
    s["Ts_mean"] = s["Ts_mean"] + 0.003 * t
    for k in jsp.OPT_KEYS:
        if k.startswith("aud_"):
            s[k] = 10.0 * r.standard_normal(n)
    s["aud_uncoupled"] = np.full(n, np.nan)
    s["P_mean"][n // 3] = 0.03                      # a fallback-precip transient
    return s


def _assert_same(a, b, path="metrics"):
    assert type(a) is type(b) or {type(a), type(b)} <= {int, float}, (path, a, b)
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert a == b, path
    elif isinstance(a, float):
        if np.isnan(a):
            assert np.isnan(b), path
        else:
            assert abs(a - b) <= 1e-12 * max(abs(a), 1e-300), (path, a, b)
    else:
        assert a == b, path


@pytest.mark.parametrize("eval_years", [0.5, 3.3, 6.0, 20.0])
def test_acceptance_matches_jax(eval_years):
    """The metrics and the criteria of every eval window (an edge year cut
    mid-season, the whole series) equal the JAX tool's; the transient is
    counted and, inside the window, fails its criterion."""
    s = _series()
    ref, got = jsp.acceptance_metrics(s, eval_years), tsp.acceptance_metrics(s, eval_years)
    _assert_same(ref, got)
    assert got["transient_chunks_total"] == 1
    assert tsp.build_criteria(got) == jsp.build_criteria(ref)
    assert tsp._pick_trend(got["dTs_dt_annual_K_per_decade"], got["dTs_dt_annual_se"],
                           got["dTs_dt_K_per_decade"], 0.02) == jsp._pick_trend(
        ref["dTs_dt_annual_K_per_decade"], ref["dTs_dt_annual_se"],
        ref["dTs_dt_K_per_decade"], 0.02)


def test_reeval_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    np.savez("series.npz", **_series(seed=3))
    rec = {"protocol": "p", "grid": [N_LAT, N_LON], "phase1": {"skipped": True},
           "phase2": {"years": 12.0}, "accepted": False}
    os.makedirs("output")
    for path in ("jax.json", os.path.join("output", "port.json")):
        with open(path, "w") as f:
            json.dump(rec, f)
    monkeypatch.setattr(sys, "argv", ["spinup", "--reeval", "series.npz", "--out", "jax.json",
                                      "--eval-years", "7"])
    jsp.main()
    assert tsp.main(["--reeval", "series.npz", "--out", "port.json", "--eval-years", "7"]) == 0
    ref = json.load(open("jax.json"))
    got = json.load(open(os.path.join("output", "port.json")))
    _assert_same(ref, got, "record")
    assert got["phase2"]["reevaluated"]["eval_years"] == 7.0


def test_prepend_merge_matches_jax(tmp_path, monkeypatch):
    """``main --skip-phase1 --prepend-series`` of both tools, each with its
    ``run_phase`` giving the same synthetic segment: the merged series (a key
    the earlier segment lacks is NaN there) and the records are equal."""
    monkeypatch.chdir(tmp_path)
    for k in [k for k in os.environ if k.startswith("QD_")]:
        monkeypatch.delenv(k)
    prev = _series(n=300, seed=5)
    prev.pop("aud_part")
    np.savez("prev.npz", **prev)
    seg = _series(n=200, seed=6, edge=0.0)
    os.makedirs("data")
    open(os.path.join("data", "atmosphere.nc"), "w").close()   # the autosave's presence
    monkeypatch.setattr(jsp, "run_phase", lambda *a, **k: dict(seg))
    monkeypatch.setattr(tsp, "run_phase", lambda *a, **k: dict(seg))
    monkeypatch.setattr(jsp, "_ensure_topography", lambda *a, **k: "topo.nc")
    monkeypatch.setattr(tsp, "_ensure_topography", lambda *a, **k: ("topo.nc", None))
    args = ["--skip-phase1", "--phase2-years", "4", "--prepend-series", "prev.npz",
            "--nlat", str(N_LAT), "--nlon", str(N_LON)]
    monkeypatch.setattr(sys, "argv", ["spinup"] + args + ["--out", "jax.json"])
    jsp.main()
    assert tsp.main(args + ["--out", "port.json", "--device", "cpu"]) == 0
    ref, got = dict(np.load("jax_series.npz")), dict(np.load(os.path.join(
        "output", "port_series.npz")))
    assert set(ref) == set(got)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert np.isnan(got["aud_part"][:300]).all() and len(got["t_years"]) == 500
    jrec, trec = json.load(open("jax.json")), json.load(open(os.path.join("output",
                                                                           "port.json")))
    assert trec.pop("device") == "cpu"
    trec.pop("wall_hours"), jrec.pop("wall_hours")
    # the port's note also names the topography regenerated in memory
    assert "QD_TOPO_NC" in trec["phase2"]["prepended_series"].pop("note")
    jrec["phase2"]["prepended_series"].pop("note")
    _assert_same(jrec, trec, "record")


# ---------------------------------------------------------------- (b)

@pytest.mark.parametrize("src,dst", [((19, 36), (37, 72)), ((37, 72), (19, 36)),
                                     ((10, 18), (15, 30))])
def test_regrid_bilinear_matches_jax(src, dst):
    r = np.random.default_rng(sum(src))
    field = r.standard_normal(src)
    lat_s, lat_d = np.linspace(-90, 90, src[0]), np.linspace(-90, 90, dst[0])
    for lon_s in (np.linspace(0, 360, src[1]),                    # the seam twice
                  np.arange(src[1]) * 360.0 / src[1]):          # no seam column
        lon_d = np.linspace(0, 360, dst[1])
        np.testing.assert_array_equal(
            tregrid.regrid_bilinear(field, lat_s, lon_s, lat_d, lon_d),
            jregrid.regrid_bilinear(field, lat_s, lon_s, lat_d, lon_d))


def _restart_fields(r, shape):
    """Seeded restart fields with negative values and cloud above 1, so the
    floors and caps have work."""
    f = {k: 280 + 10 * r.standard_normal(shape) for k in
         ("u", "v", "h", "T_s", "uo", "vo", "eta", "Ts")}
    for k in tregrid.FLOORED:
        f[k] = r.standard_normal(shape) * (2.0 if k in tregrid.CAPPED else 1e-3)
    f["land_mask"] = (r.random(shape) < 0.3).astype(float)
    return f


def _without_netcdf(monkeypatch):
    """Make h5py and netCDF4 fail to import, as on a machine without them."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    monkeypatch.setitem(sys.modules, "netCDF4", None)
    monkeypatch.delitem(sys.modules, "qingdai_tpu_torch.io.ncdataset", raising=False)
    monkeypatch.delattr(sys.modules["qingdai_tpu_torch.io"], "ncdataset", raising=False)


def test_regrid_cli_matches_jax(tmp_path, monkeypatch, capsys):
    """A 19×36 restart written by the JAX package, regridded to 37×72 by both
    CLIs: every field equal, the floors and caps applied, the same line;
    then the ``.pt`` route of the port's CLI without a NetCDF library gives
    the same fields."""
    monkeypatch.chdir(tmp_path)
    lat, lon = np.linspace(-90, 90, N_LAT), np.linspace(0, 360, N_LON)
    fields = _restart_fields(np.random.default_rng(0), (N_LAT, N_LON))
    jnc.save_restart_fields("src.nc", lat, lon, fields, t_seconds=4.32e5)
    monkeypatch.setattr(sys, "argv", ["regrid", "--in", "src.nc", "--out", "jax.nc",
                                      "--nlat", "37", "--nlon", "72"])
    jregrid.main()
    assert tregrid.main(["--in", "src.nc", "--out", "port.nc", "--nlat", "37",
                         "--nlon", "72"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[1] == lines[0].replace("jax.nc", "port.nc")
    ref, got = jnc.load_restart("jax.nc"), jnc.load_restart("port.nc")
    assert set(ref) == set(got) and got["T_s"].shape == (37, 72) and got["t_seconds"] == 4.32e5
    for k, v in ref.items():
        if v is None:
            assert got[k] is None, k
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    for k in tregrid.FLOORED:
        assert got[k].min() >= 0.0 and ref[k].min() >= 0.0, k
    for k in tregrid.CAPPED:
        assert got[k].max() <= 1.0, k
    assert got["q"].max() > 0.0 and got["cloud_cover"].max() == 1.0

    tnc.save_restart_fields("src.pt", lat, lon, fields, t_seconds=4.32e5)
    _without_netcdf(monkeypatch)
    assert not tnc.have_netcdf()
    assert tregrid.main(["--in", "src.pt", "--out", "port.pt", "--nlat", "37",
                         "--nlon", "72"]) == 0
    pt = tnc.load_restart("port.pt")
    assert set(pt) == set(got)
    for k, v in got.items():
        if v is not None and k != "t_seconds":
            np.testing.assert_array_equal(pt[k], v, err_msg=k)
    assert pt["t_seconds"] == 4.32e5


def test_restart_containers_hold_the_same_fields(tmp_path):
    """``save_restart`` to ``.nc`` and to ``.pt`` from one state: the loaded
    dicts are equal (the fields from one shared function)."""
    from qingdai_tpu_torch import entry
    mdl, st = entry.build_world(N_LAT, N_LON, extra_env={"QD_HYDRO_ENABLE": "0", **TINY},
                                device="cpu", dtype=torch.float64)
    lat, lon = np.linspace(-90, 90, N_LAT), np.linspace(0, 360, N_LON)
    mask = mdl.static.land_mask.numpy()
    for ext in ("nc", "pt"):
        tnc.save_restart(str(tmp_path / f"r.{ext}"), lat, lon, st, mask, t_seconds=7.0)
    a, b = tnc.load_restart(str(tmp_path / "r.nc")), tnc.load_restart(str(tmp_path / "r.pt"))
    assert set(a) == set(b) == {"lat", "lon", "t_seconds", *tnc.RESTART_VARS}
    for k in a:
        np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]), err_msg=k)
    assert b["E_flux_last"].dtype == np.float32


# ---------------------------------------------------------------- (c)

def _phase_env(topo):
    return {**TINY, "QD_TOPO_NC": topo, "QD_N_LAT": N_LAT, "QD_N_LON": N_LON,
            "QD_DTYPE": "float64", "QD_ECO_RAND_SEED": "7", "QD_ENERGY_W": "1",
            "QD_INIT_BANDED": "1", "QD_OCEAN_USE_QNET": "1", "QD_ENERGY_AUDIT": "1",
            "QD_PLOT_EVERY_DAYS": 1e9, "QD_AUTOSAVE_ENABLE": 0, "QD_ECO_DIVERSITY_ENABLE": 0,
            "QD_MLD_M": 5.0, "QD_AUTOSAVE_LOAD": 0, "QD_LOAD_PLANKTON": 0}


JAX_PHASE = """
import json, os, sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np
from scripts import spinup
work, env, years, out = sys.argv[1], json.loads(sys.argv[2]), float(sys.argv[3]), sys.argv[4]
os.chdir(work)
np.savez(out, **spinup.run_phase("phase1", years, env, chunk_days=1))
"""


@pytest.fixture(scope="module")
def topo_file(tmp_path_factory):
    """The SOP's seeded 19×36 topography file, written by the port."""
    d = tmp_path_factory.mktemp("topo")
    path, arrays = tsp._ensure_topography(N_LAT, N_LON, path=str(d / "topography.nc"))
    assert arrays is None and os.path.exists(path)
    return path


@pytest.fixture(scope="module", autouse=True)
def jax_phase(tmp_path_factory, topo_file):
    """Start the JAX package's ``run_phase`` when the module's first test
    runs; yields a function that waits for it and returns its series."""
    work = tmp_path_factory.mktemp("jax_phase")
    out = work / "series.npz"
    env = {k: v for k, v in os.environ.items() if not k.startswith("QD_")}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    proc = subprocess.Popen([sys.executable, "-c", JAX_PHASE, str(work),
                             json.dumps({k: str(v) for k, v in _phase_env(topo_file).items()}),
                             repr(2 * DAY_YEARS), str(out)], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def result():
        log, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, log[-4000:]
        return dict(np.load(out))

    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


# chunk-mean keys that are differences of routed sums and can cancel to
# rounding noise: held relative to the routed mass (test_torch_model.py)
CANCELLING = ("routing_stranded_kg", "routing_mass_error_kg", "routing_lake_delta_kg")
# the controls' seed: h scaled by 1 ± this at the cold start, the size of
# the packages' one-step float64 difference (tests/test_torch_model.py holds
# one step to 1e-10)
SEED_REL = 1e-11


def _chunk_errs(ref, got):
    """{key: [|got − ref| per chunk] / the key's scale}."""
    routed = float(np.abs(np.asarray(ref["routing_routed_mass_kg"], float)).max())
    out = {}
    for k in ref:
        if k in ("t_years", "_consts"):
            continue
        r, g = np.asarray(ref[k], float), np.asarray(got[k], float)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(r), err_msg=k)
        scale = max(float(np.nanmax(np.abs(r), initial=0.0)), 1e-300)
        if k in CANCELLING:
            scale = max(scale, routed)
        out[k] = np.nan_to_num(np.abs(g - r)) / scale
    return out


def test_run_phase_matches_jax(jax_phase, topo_file, tmp_path, monkeypatch):
    """Two 1-day chunks of phase 1 (cold start, MLD 5, the SOP's energy
    path and audit) in float64 from one topography file. The first chunk's
    means of the port are within 1e-8 of the JAX package's, relative to each
    key's largest |value|. The second's are held to the chaos envelope: from
    this cold start at dt 7200 s a steep cloud response amplifies the
    packages' ~1e-11 one-step difference by ~1e3 at steps 6 and 12 (the
    positives counted by the three medians agree at every step), so the
    second chunk differs by up to ~4e-4 (ICE_mean). The envelope is
    measured: the port's own run with h scaled by 1 ± 1e-11 at the start
    (two controls); each key's second-chunk difference must lie within
    max(1e-8, 100 × the controls' difference)."""
    from qingdai_tpu_torch import model as TM
    monkeypatch.chdir(tmp_path)
    for k in [k for k in os.environ if k.startswith("QD_")]:
        monkeypatch.delenv(k)
    env = _phase_env(topo_file)
    got = tsp.run_phase("phase1", 2 * DAY_YEARS, env, chunk_days=1, device="cpu")
    init = TM.init_world
    controls = []
    for sign in (1.0, -1.0):
        def seeded(*a, **kw):
            st = init(*a, **kw)
            return dataclasses.replace(st, atmos=dataclasses.replace(
                st.atmos, h=st.atmos.h * (1.0 + sign * SEED_REL)))
        monkeypatch.setattr(TM, "init_world", seeded)
        controls.append(_chunk_errs(got, tsp.run_phase("phase1", 2 * DAY_YEARS, env,
                                                       chunk_days=1, device="cpu")))
    monkeypatch.setattr(TM, "init_world", init)
    ref = jax_phase()
    assert set(got) == set(ref) and len(got["t_years"]) == 2
    np.testing.assert_array_equal(got["t_years"], ref["t_years"])
    errs = _chunk_errs(ref, got)
    first = {k: float(e[0]) for k, e in errs.items() if e[0] > 1e-8}
    assert first == {}, first
    second = {k: (float(e[1]), max(c[k][1] for c in controls)) for k, e in errs.items()}
    beyond = {k: v for k, v in second.items() if v[0] > max(1e-8, 100.0 * v[1])}
    assert beyond == {}, beyond
    assert np.isfinite(got["aud_part"]).all() and np.isfinite(got["routing_mass_error_kg"]).all()
    assert os.path.exists(os.path.join("data", "restart_phase1.nc"))


# ---------------------------------------------------------------- (d), (e)

@pytest.fixture
def sop_env(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for k in [k for k in os.environ if k.startswith("QD_")]:
        monkeypatch.delenv(k)
    for k, v in {**TINY, "QD_ECO_MUT_RATE": "1.0"}.items():
        monkeypatch.setenv(k, v)
    return tmp_path


def _grid(h=N_LAT, w=N_LON):
    return ["--device", "cpu", "--chunk-days", "1", "--nlat", str(h), "--nlon", str(w)]


def _years(days):
    return repr(days * DAY_YEARS)


@pytest.mark.parametrize("netcdf", [True, False])
def test_two_segment_phase2_is_bit_exact(sop_env, monkeypatch, netcdf):
    """Phase 1 (1 day) → phase 2 (2 days) through ``main``; from a copy of
    ``data/`` as phase 1 left it, the same phase 2 as 1 + 1 days. The final
    sidecar (every leaf, the generator) and the merged series equal the
    uninterrupted run's, across the daily mutation draw of the second
    segment. Without a NetCDF library the phase restarts are ``.pt`` files,
    the topography stays in memory and the resume reads the sidecar."""
    if not netcdf:
        _without_netcdf(monkeypatch)
    orig = tsp.run_phase

    def keeping(name, *a, **k):
        out = orig(name, *a, **k)
        if name == "phase1":
            shutil.copytree("data", str(sop_env / "after1"))
        return out

    monkeypatch.setattr(tsp, "run_phase", keeping)
    os.makedirs("full")
    os.chdir("full")
    assert tsp.main(["--phase1-years", _years(1), "--phase2-years", _years(2)] + _grid()) == 0
    ext = "nc" if netcdf else "pt"
    assert sorted(f for f in os.listdir("data") if f.startswith("restart_")) == [
        f"restart_phase1.{ext}", f"restart_phase2.{ext}"]
    assert os.path.exists(os.path.join("data", "topography.nc")) == netcdf
    record = json.load(open(os.path.join("output", "spinup_torch.json")))
    assert {"protocol", "grid", "phase1", "phase2", "acceptance", "accepted", "wall_hours",
            "device"} <= set(record) and record["phase1"]["metrics"]
    s2 = dict(np.load(os.path.join("output", "spinup_torch_series.npz")))
    assert tsp.build_criteria(tsp.acceptance_metrics(
        s2, record["phase2"]["metrics"]["eval_years"])) == record["acceptance"]

    os.chdir(sop_env)
    shutil.copytree("after1", os.path.join("split", "data"))
    os.chdir("split")
    seg = ["--skip-phase1", "--phase2-years", _years(1)] + _grid()
    assert tsp.main(seg + ["--out", "a.json"]) == 0
    assert tsp.main(seg + ["--out", "b.json", "--prepend-series",
                           os.path.join("output", "a_series.npz")]) == 0
    merged = dict(np.load(os.path.join("output", "b_series.npz")))
    assert set(merged) == set(s2)
    for k in s2:
        np.testing.assert_array_equal(merged[k], s2[k], err_msg=k)
    full = torch.load(sop_env / "full" / "data" / tworld.SIDECAR, weights_only=True)
    split = torch.load(os.path.join("data", tworld.SIDECAR), weights_only=True)
    assert set(full["state"]) == set(split["state"])
    for k, v in full["state"].items():
        w = split["state"][k]
        if isinstance(v, torch.Tensor):
            assert v.dtype == w.dtype and v.numpy().tobytes() == w.numpy().tobytes(), k
        else:
            assert v == w, k
    assert torch.equal(full["generator"], split["generator"])
    assert int(split["state"]["eco.n_active"]) > 3          # the mutation drew
    assert tckpt.load_checkpoint_meta(os.path.join("data", tworld.SIDECAR)) == 3 * 72000.0


def test_regrid_then_phase2_segment(sop_env, monkeypatch, capsys):
    """A 19×36 SOP's phase-2 restart regridded to 37×72, then a
    ``--restart-in`` segment there of two chunks: the flux caches come from
    the file (no bootstrap), no transient chunk, every chunk mean finite."""
    assert tsp.main(["--phase1-years", _years(1), "--phase2-years", _years(1)] + _grid()) == 0
    assert tregrid.main(["--in", os.path.join("data", "restart_phase2.nc"), "--out",
                         "r37.pt", "--nlat", "37", "--nlon", "72"]) == 0
    os.makedirs("s37")
    shutil.move("r37.pt", os.path.join("s37", "r37.pt"))
    os.chdir("s37")
    capsys.readouterr()
    assert tsp.main(["--restart-in", "r37.pt", "--phase2-years", _years(2), "--out",
                     "s37.json"] + _grid(37, 72)) == 0
    out = capsys.readouterr().out
    assert "flux caches restored from the restart file" in out and "bootstrapped" not in out
    record = json.load(open(os.path.join("output", "s37.json")))
    assert record["grid"] == [37, 72] and record["phase1"]["skipped"]
    assert record["phase2"]["metrics"]["transient_chunks_total"] == 0
    s = dict(np.load(os.path.join("output", "s37_series.npz")))
    for k in tsp.KEYS:
        assert np.isfinite(s[k]).all() and len(s[k]) == 2, k
    rst = tnc.load_restart(os.path.join("data", "restart_phase2.nc"))
    assert rst["T_s"].shape == (37, 72) and rst["t_seconds"] == 4 * 72000.0


def test_missing_sources_are_refused(sop_env):
    with pytest.raises(SystemExit, match="requires data/atmosphere.nc or data/world_ckpt.pt"):
        tsp.main(["--skip-phase1", "--phase2-years", _years(1)] + _grid())
    with pytest.raises(SystemExit, match="does not exist"):
        tsp.main(["--restart-in", "nope.pt", "--phase2-years", _years(1)] + _grid())


# ---------------------------------------------------------------- (i)

def test_topo_nc_without_netcdf_raises(sop_env, monkeypatch, topo_file, capsys):
    """Where no NetCDF library imports, a ``QD_TOPO_NC`` file stops the build
    (the port used to fall back to the mask-only planet, elevation None,
    saying so only when verbose); the same planet handed over in memory
    builds, with the file's arrays."""
    monkeypatch.setenv("QD_N_LAT", str(N_LAT))
    monkeypatch.setenv("QD_N_LON", str(N_LON))
    monkeypatch.setenv("QD_TOPO_NC", topo_file)
    with_file = tworld.QingdaiWorld(verbose=False, device="cpu")
    assert with_file.elevation is not None
    lat, lon = np.linspace(-90, 90, N_LAT), np.linspace(0, 360, N_LON)
    loaded = ttopo.load_topography_from_netcdf(topo_file, lat, lon)

    _without_netcdf(monkeypatch)
    with pytest.raises(RuntimeError, match="QD_TOPO_NC.*neither h5py nor netCDF4"):
        tworld.QingdaiWorld(verbose=False, device="cpu")
    monkeypatch.delenv("QD_TOPO_NC")
    path, arrays = tsp._ensure_topography(N_LAT, N_LON)
    assert path is None and "in memory" in capsys.readouterr().out
    for name, a in zip(tworld.TOPO_ARRAYS, loaded):
        np.testing.assert_array_equal(arrays[name], a, err_msg=name)
        assert arrays[name].dtype == a.dtype, name
    in_memory = tworld.QingdaiWorld(verbose=False, device="cpu", topography=arrays)
    np.testing.assert_array_equal(in_memory.elevation, with_file.elevation)
    np.testing.assert_array_equal(in_memory.land_mask, with_file.land_mask)
    np.testing.assert_array_equal(in_memory.model.static.land_mask.numpy(),
                                  with_file.model.static.land_mask.numpy())


def test_unreadable_topo_nc_falls_back_loudly(sop_env, monkeypatch, capsys):
    """A file that cannot be read still falls back to the procedural planet,
    as in the JAX package, and says so whatever the verbosity."""
    (sop_env / "bad.nc").write_bytes(b"not a netcdf file")
    for k, v in {"QD_N_LAT": str(N_LAT), "QD_N_LON": str(N_LON),
                 "QD_TOPO_NC": str(sop_env / "bad.nc")}.items():
        monkeypatch.setenv(k, v)
    fallback = tworld.QingdaiWorld(verbose=False, device="cpu")
    assert fallback.elevation is None
    assert "[Topo] Failed to load" in capsys.readouterr().out


def test_ensure_topography_file_matches_jax(tmp_path):
    """The port's exporter writes the JAX tool's topography file: the same
    variables, values and attributes."""
    import h5py
    a, _ = tsp._ensure_topography(N_LAT, N_LON, path=str(tmp_path / "t.nc"))
    b = jsp._ensure_topography(N_LAT, N_LON, path=str(tmp_path / "j.nc"))
    with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
        assert set(fa) == set(fb)
        for k in fa:
            np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]), err_msg=k)
        assert {k: str(v) for k, v in fa.attrs.items()} == {k: str(v)
                                                            for k, v in fb.attrs.items()}


def test_restart_out_pt_without_netcdf(sop_env, monkeypatch):
    """Without a NetCDF library a ``QD_RESTART_OUT`` ending in ``.pt`` is
    accepted and written at the end of the run, with the state's fields."""
    _without_netcdf(monkeypatch)
    for k, v in {"QD_N_LAT": str(N_LAT), "QD_N_LON": str(N_LON),
                 "QD_RESTART_OUT": "final.pt", "QD_AUTOSAVE_ENABLE": "0"}.items():
        monkeypatch.setenv(k, v)
    w = tworld.QingdaiWorld(verbose=False, device="cpu")
    w.run(duration_seconds=2 * w.model.dt)
    rst = tnc.load_restart("final.pt")
    np.testing.assert_array_equal(rst["Ts"], w.state.ocean.sst.numpy().astype(np.float32))
    assert rst["t_seconds"] == 2 * w.model.dt
