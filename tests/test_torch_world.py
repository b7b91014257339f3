"""The port's world driver and restarts, on the CPU at 19×36.

- A NetCDF restart written by either package loads in the other and gives
  the state the other package's own loader gives; the port's file has the
  JAX file's variables, dims, dtypes and attributes.
- ``QingdaiWorld(device="cpu")``: create, run, autosave, reload; the sidecar
  resume equals an uninterrupted run bit for bit across a daily block with
  mutation on, with and without a NetCDF library; a corrupt or stale sidecar
  falls back to the NetCDF restart.
- ``QD_RESTART_OUT`` where no NetCDF library imports is refused when the
  world is built, not after its run; with one, the run ends by writing it.
- ``python -m qingdai_tpu_torch.run_simulation --device cpu`` runs 2 steps.
No JAX chunk is jitted here.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from qingdai_tpu.io import netcdf as jnc
from qingdai_tpu_torch import convert
from qingdai_tpu_torch import world as tworld
from qingdai_tpu_torch.io import checkpoint as tckpt
from qingdai_tpu_torch.io import netcdf as tnc

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
N_LAT, N_LON = 19, 36
RESTART_FIELDS = ("atmos.u", "atmos.v", "atmos.h", "atmos.T_s", "atmos.cloud_cover",
                  "atmos.q", "atmos.h_ice", "atmos.P_cond_flux_last", "atmos.E_flux_last",
                  "atmos.LH_last", "atmos.LH_release_last", "atmos.cloud_eff_last",
                  "ocean.uo", "ocean.vo", "ocean.eta", "ocean.sst", "land.W_land",
                  "land.S_snow", "land.C_snow")


@pytest.fixture(scope="module")
def jax_world():
    """A JAX state of the flagship planet whose restart fields are seeded
    noise, with its land mask and grid."""
    jm, js = graft._build_world(N_LAT, N_LON, extra_env={"QD_ECO_NS": "3"},
                                dtype=jnp.float64, hermetic=True)
    r = np.random.default_rng(11)
    groups = {}
    for g in ("atmos", "ocean", "land"):
        grp = getattr(js, g)
        kw = {f.name: jnp.asarray(np.abs(r.normal(1.0, 0.3, (N_LAT, N_LON))))
              for f in dataclasses.fields(grp) if f"{g}.{f.name}" in RESTART_FIELDS}
        groups[g] = dataclasses.replace(grp, **kw)
    js = dataclasses.replace(js, **groups)
    lat, lon = np.linspace(-90, 90, N_LAT), np.linspace(0, 360, N_LON)
    return js, np.asarray(jm.static.land_mask), lat, lon


def _restart_leaves(state):
    flat = convert.world_to_numpy(state)
    return {k: np.asarray(flat[k], np.float64) for k in RESTART_FIELDS}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_restart_loads_in_the_other_package(jax_world, tmp_path, writer):
    """The file of either writer, applied by each package's loader to the
    same state, gives the same fields; the unclipped ones are the written
    state's rounded to float32."""
    js, mask, lat, lon = jax_world
    ts = convert.world_from_numpy(js, "cpu", torch.float64)
    path = str(tmp_path / "atmosphere.nc")
    if writer == "jax":
        jnc.save_restart(path, lat, lon, js, mask, t_seconds=12345.0)
    else:
        tnc.save_restart(path, lat, lon, ts, mask, t_seconds=12345.0)
    jr, tr = jnc.load_restart(path), tnc.load_restart(path)
    assert jr["t_seconds"] == tr["t_seconds"] == 12345.0
    jgot = jnc.apply_restart_to_state(js, jr)
    tgot = tnc.apply_restart_to_state(ts, tr)
    assert all(x.device.type == "cpu" for x in (tgot.atmos.u, tgot.ocean.sst, tgot.land.W_land))
    ref, got, orig = _restart_leaves(jgot), _restart_leaves(tgot), _restart_leaves(js)
    for k in RESTART_FIELDS:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        if k in ("atmos.u", "atmos.T_s", "ocean.sst", "land.W_land"):
            np.testing.assert_array_equal(got[k], orig[k].astype(np.float32), err_msg=k)


def _describe(path):
    """{name: (shape, dtype, dims attribute, other attribute names)} of
    every dataset, and the global attributes."""
    out = {}
    with h5py.File(path, "r") as f:
        for name, ds in f.items():
            attrs = {k: v for k, v in ds.attrs.items() if k not in ("DIMENSION_LIST",
                                                                    "REFERENCE_LIST")}
            dims = tuple(attrs.pop("_nc_dims", ()))
            out[name] = (ds.shape, ds.dtype.str, dims, sorted(attrs))
        glob = {k: (v.decode() if isinstance(v, bytes) else v) for k, v in f.attrs.items()}
    return out, glob


def test_restart_schema_matches_jax(jax_world, tmp_path):
    js, mask, lat, lon = jax_world
    ts = convert.world_from_numpy(js, "cpu", torch.float64)
    jnc.save_restart(str(tmp_path / "j.nc"), lat, lon, js, mask, t_seconds=1.0)
    tnc.save_restart(str(tmp_path / "t.nc"), lat, lon, ts, mask, t_seconds=1.0)
    (jv, jg), (tv, tg) = _describe(tmp_path / "j.nc"), _describe(tmp_path / "t.nc")
    assert tv == jv
    assert jg.pop("creator") == "qingdai_tpu" and tg.pop("creator") == "qingdai_tpu_torch"
    assert {k: str(v) for k, v in tg.items()} == {k: str(v) for k, v in jg.items()}
    assert {"u", "Ts", "land_mask", "t_seconds", "E_flux_last"} <= set(tv)


@pytest.fixture
def tiny_env(tmp_path, monkeypatch):
    """A small planet in its own working directory: 19×36, dt 7200 s (10
    steps a day, a routing event every 3), mutation on, no autosave hooks."""
    monkeypatch.chdir(tmp_path)
    for k in [k for k in os.environ if k.startswith("QD_")]:
        monkeypatch.delenv(k)
    for k, v in {"QD_N_LAT": "19", "QD_N_LON": "36", "QD_DT_SECONDS": "7200",
                 "QD_CHUNK_STEPS": "4", "QD_ECO_NS": "3", "QD_PHYTO_NSPECIES": "3",
                 "QD_ECO_INDIV_PER_CELL": "10", "QD_ECO_MUT_RATE": "1.0",
                 "QD_AUTOSAVE_ENABLE": "0"}.items():
        monkeypatch.setenv(k, v)
    return tmp_path


def _world():
    w = tworld.QingdaiWorld(device="cpu")
    w.verbose = False
    return w


def _assert_states_equal(a, b):
    fa, fb = convert.world_to_numpy(a), convert.world_to_numpy(b)
    assert set(fa) == set(fb)
    for k in fa:
        np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]), err_msg=k)


def test_world_create_run_autosave_reload(tiny_env):
    w = _world()
    assert w.model.routing_static is not None and w.model.device.type == "cpu"
    w.run(duration_seconds=4 * w.model.dt)
    assert w.state.clock.step_idx == 4
    w.autosave()
    for f in ("atmosphere.nc", "ocean.nc", "ecology.nc", "genes.json", "plankton.json",
              "plankton.nc", "topography.nc", "hydrology.nc", tworld.SIDECAR):
        assert os.path.exists(os.path.join("data", f)), f
    w2 = _world()
    assert w2.restore_source == "sidecar" and w2.t0_seconds == w.t_seconds
    _assert_states_equal(w.state, w2.state)


@pytest.mark.parametrize("netcdf", [True, False])
def test_sidecar_resume_is_bit_exact(tiny_env, monkeypatch, netcdf):
    """7 steps, autosave, 6 more (the day ends at step 10, where the daily
    block draws mutations; routing events at steps 9 and 12), against a
    fresh world that resumes from the sidecar and runs the 6. Without a
    NetCDF library the autosave writes the sidecar alone, and the resume
    reads it alone."""
    if not netcdf:
        monkeypatch.setattr(tnc, "have_netcdf", lambda: False)
    wA = _world()
    wA.step_chunk(7)
    wA.autosave()
    assert os.path.exists(os.path.join("data", "atmosphere.nc")) == netcdf
    wA.step_chunk(6)
    wB = _world()
    assert wB.restore_source == "sidecar" and wB.state.clock.step_idx == 7
    assert wB.state.routing.t_accum == wA.model.dt
    wB.step_chunk(6)
    _assert_states_equal(wA.state, wB.state)
    assert torch.equal(wA.model.generator.get_state(), wB.model.generator.get_state())
    assert int(wB.state.eco.n_active) > 3           # the daily block mutated


@pytest.mark.parametrize("fault", ["corrupt", "stale"])
def test_bad_sidecar_falls_back_to_netcdf(tiny_env, fault):
    wA = _world()
    wA.step_chunk(4)
    wA.autosave()
    side = os.path.join("data", tworld.SIDECAR)
    if fault == "corrupt":
        with open(side, "wb") as f:
            f.write(b"not a checkpoint")
    else:
        tckpt.save_checkpoint_meta(side, wA.t_seconds + 7200.0 * 3)
    wB = _world()
    assert wB.restore_source == "netcdf"
    # the generator is the fresh model's, untouched by the refused sidecar
    assert torch.equal(wB.model.generator.get_state(),
                       torch.Generator().manual_seed(wB.cfg.run.seed).get_state())
    np.testing.assert_allclose(wB.state.atmos.T_s.numpy(), wA.state.atmos.T_s.numpy(),
                               atol=1e-3)
    assert wB.state.clock.accum_t_day == 0.0        # the NetCDF restart drops it


def test_cli_runs_two_steps_on_the_cpu(tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("QD_")}
    env.update(PYTHONPATH=str(REPO), QD_N_LAT="19", QD_N_LON="36", QD_CHUNK_STEPS="2",
               QD_SIM_DAYS=str(2 * 300.0 / 72000.0), QD_ECO_NS="3", QD_PHYTO_NSPECIES="3")
    out = subprocess.run([sys.executable, "-m", "qingdai_tpu_torch.run_simulation",
                          "--device", "cpu"], cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "[torch] device: cpu" in out.stdout and "2/2 steps" in out.stdout
    assert (tmp_path / "data" / tworld.SIDECAR).exists()     # the exit autosave


def test_nancheck_names_non_finite_leaves(tiny_env, capsys):
    """QD_DEBUG_NANCHECK's check names the leaves that hold a NaN, and only
    those (the albedo caches' NaN sentinels are not checked)."""
    w = _world()
    w._nancheck()
    assert "[NanCheck]" not in capsys.readouterr().out
    land = w.state.land
    w.state = dataclasses.replace(w.state, land=dataclasses.replace(
        land, W_land=torch.full_like(land.W_land, float("nan"))))
    w._nancheck()
    out = capsys.readouterr().out
    assert "[NanCheck]" in out and "land.W_land" in out and "albedo" not in out


def _without_netcdf(monkeypatch):
    """Make h5py and netCDF4 fail to import, as on a machine without them
    (h5py is installed here, so patching ``have_netcdf`` alone would hide
    the fault: the writers would still find it)."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    monkeypatch.setitem(sys.modules, "netCDF4", None)
    monkeypatch.delitem(sys.modules, "qingdai_tpu_torch.io.ncdataset", raising=False)
    monkeypatch.delattr(sys.modules["qingdai_tpu_torch.io"], "ncdataset", raising=False)


def test_restart_out_without_netcdf_is_refused_at_build(tiny_env, monkeypatch):
    """Without a NetCDF library the final restart cannot be written, so
    QD_RESTART_OUT is refused when the world is built, naming the missing
    libraries and the sidecar; without QD_RESTART_OUT the world builds and
    runs there."""
    _without_netcdf(monkeypatch)
    assert not tnc.have_netcdf()
    with pytest.raises(ImportError):
        tnc.Dataset("probe.nc", "w")                  # what save_restart would meet
    monkeypatch.setenv("QD_RESTART_OUT", "final.nc")
    with pytest.raises(RuntimeError, match="h5py nor netCDF4.*world_ckpt.pt"):
        _world()
    monkeypatch.delenv("QD_RESTART_OUT")
    w = _world()
    w.run(duration_seconds=w.model.dt)
    assert w.state.clock.step_idx == 1 and not os.path.exists("final.nc")


def test_restart_out_written_at_the_end(tiny_env, monkeypatch):
    """With a NetCDF library the run ends by writing QD_RESTART_OUT, which
    loads back to the final state's fields."""
    monkeypatch.setenv("QD_RESTART_OUT", "final.nc")
    w = _world()
    w.run(duration_seconds=2 * w.model.dt)
    assert os.path.exists("final.nc")
    with h5py.File("final.nc", "r") as f:
        np.testing.assert_array_equal(np.asarray(f["Ts"]), w.state.ocean.sst.numpy())


def test_ensemble_cli_runs_on_the_cpu(tmp_path):
    """``python -m qingdai_tpu_torch.run_ensemble --device cpu``: two members
    at 19×36, a 12-step warm chunk and a 12-step timed one."""
    import json
    env = {k: v for k, v in os.environ.items() if not k.startswith("QD_")}
    env.update(PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-m", "qingdai_tpu_torch.run_ensemble", "--members",
                          "2", "--days", "0.05", "--chunk-days", "0.05", "--nlat", "19",
                          "--nlon", "36", "--device", "cpu", "--json"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["members"] == 2 and summary["device"] == "cpu"
    assert summary["value"] == pytest.approx(2 * summary["sim_years_per_hour"])
    assert summary["spread"]["Ts_mean_spread"] > 0.0
