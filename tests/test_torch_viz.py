"""The port's panels and diversity diagnostics (``qingdai_tpu_torch.viz``,
``qingdai_tpu_torch.ecology.diversity``, ``population.canopy_height_map``)
against the JAX package's, and the world driver's cadence for them, on the
CPU at 19×36.

- (f) each panel of ``viz.plots``, ``plot_all`` and
  ``viz.ploter.plot_top3_species_distributions``, decoded with
  ``matplotlib.image.imread``, pixel-equal to the JAX package's from one
  seeded float64 state carried across with ``convert``.
- (g) the three diversity metrics, ``compute_and_plot`` and
  ``canopy_height_map`` within 1e-12 of the JAX package's.
- (h) ``world.run()`` writes the panels at the start and every
  ``QD_PLOT_EVERY_DAYS`` 24-hour days, and the diversity snapshot every
  ``QD_ECO_DIVERSITY_EVERY_DAYS`` planetary days, as the JAX driver does;
  without matplotlib it says so on one line, writes no panel and still
  writes the snapshot.
"""

import dataclasses
import os
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import matplotlib.image as mpimg
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from qingdai_tpu.ecology import diversity as jdiv
from qingdai_tpu.ecology import population as jpop
from qingdai_tpu.viz import ploter as jploter
from qingdai_tpu.viz import plots as jplots
from qingdai_tpu_torch import convert, entry
from qingdai_tpu_torch import topography as ttopo
from qingdai_tpu_torch import world as tworld
from qingdai_tpu_torch.ecology import diversity as tdiv
from qingdai_tpu_torch.ecology import population as tpop
from qingdai_tpu_torch.viz import ploter as tploter
from qingdai_tpu_torch.viz import plots as tplots

torch.set_num_threads(1)

N_LAT, N_LON = 19, 36
ENV = {"QD_ECO_NS": "3", "QD_PHYTO_NSPECIES": "3", "QD_ECO_INDIV_PER_CELL": "10",
       "QD_ECO_RAND_SEED": "7"}


def _seeded(group, r, fields):
    """``group`` with each named field replaced by seeded values of its
    shape: ``fields`` maps a name to (low, high)."""
    kw = {}
    for name, (lo, hi) in fields.items():
        x = np.asarray(getattr(group, name))
        kw[name] = jnp.asarray(lo + (hi - lo) * r.random(x.shape))
    return dataclasses.replace(group, **kw)


@pytest.fixture(scope="module")
def snapshots():
    """(JAX snapshot, port snapshot) of one seeded float64 state of the
    flagship planet, each with its package's model and the same grid,
    mask, elevation and configuration (ISR panel on)."""
    jm, js = graft._build_world(N_LAT, N_LON, extra_env=ENV, dtype=jnp.float64, hermetic=True)
    tm, _ = entry.build_world(N_LAT, N_LON, extra_env=ENV, device="cpu", dtype=torch.float64)
    r = np.random.default_rng(21)
    js = dataclasses.replace(
        js,
        atmos=_seeded(js.atmos, r, {"T_s": (240.0, 310.0), "u": (-30.0, 30.0),
                                    "v": (-20.0, 20.0), "h": (-50.0, 50.0),
                                    "cloud_cover": (0.0, 1.0), "q": (0.0, 0.02),
                                    "h_ice": (0.0, 2.0), "olr": (150.0, 300.0)}),
        ocean=_seeded(js.ocean, r, {"sst": (271.0, 303.0), "uo": (-1.0, 1.0),
                                    "vo": (-1.0, 1.0), "eta": (-0.5, 0.5)}),
        land=_seeded(js.land, r, {"W_land": (0.0, 100.0), "S_snow": (0.0, 50.0),
                                  "C_snow": (0.0, 1.0)}),
        eco=_seeded(js.eco, r, {"LAI_SK": (0.0, 3.0), "seed_bank": (0.0, 1.0),
                                "E_day": (0.0, 5.0)}),
        phyto=_seeded(js.phyto, r, {"C_phyto": (0.0, 2.0), "Kd_490": (0.02, 0.3),
                                    "alpha_scalar": (0.0, 0.1), "alpha_bands": (0.0, 0.2)}),
        routing=_seeded(js.routing, r, {"flow_accum_kgps": (0.0, 1e7)}),
        clock=dataclasses.replace(
            _seeded(js.clock, r, {"precip_day_last": (0.0, 30.0)}),
            phase_rot=jnp.asarray(1.3), phase_binary=jnp.asarray(0.4),
            phase_planet=jnp.asarray(2.2)),
        albedo=_seeded(js.albedo, r, {"alpha_ecology_last": (0.1, 0.4),
                                      "alpha_banded_daily": (0.1, 0.4)}),
        indiv=_seeded(js.indiv, r, {"E_day": (0.0, 5.0)}))
    ts = convert.world_from_numpy(js, "cpu", torch.float64)
    lat, lon = np.linspace(-90, 90, N_LAT), np.linspace(0, 360, N_LON)
    lon_mesh, lat_mesh = np.meshgrid(lon, lat)
    elevation = ttopo.create_land_sea_mask(lat_mesh, lon_mesh, 0.29, 42)[1]
    mask = np.asarray(jm.static.land_mask)
    np.testing.assert_array_equal(tm.static.land_mask.numpy(), mask)

    def snap(state, model):
        cfg = dataclasses.replace(model.cfg, run=dataclasses.replace(model.cfg.run,
                                                                     plot_isr=True))
        return SimpleNamespace(state=state, cfg=cfg, model=model, land_mask=mask,
                               elevation=elevation, lat=lat, lon=lon)
    return (snap(jax.device_get(js), jm), snap(tworld._to_host(ts, numpy=True), tm),
            (jm, tm))


def _same_png(a, b):
    pa, pb = mpimg.imread(a), mpimg.imread(b)
    assert pa.shape == pb.shape, (a, b)
    np.testing.assert_array_equal(pa, pb, err_msg=f"{a} against {b}")


PANELS = ("plot_state", "plot_true_color", "plot_ocean", "plot_ecology", "plot_plankton",
          "plot_isr_components")


@pytest.mark.parametrize("panel", PANELS)
def test_panel_pixel_equal_to_jax(snapshots, tmp_path, panel):
    jsnap, tsnap, _ = snapshots
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    pj = getattr(jplots, panel)(jsnap, 3.5, str(tmp_path / "j"))
    pt = getattr(tplots, panel)(tsnap, 3.5, str(tmp_path / "t"))
    assert os.path.basename(pj) == os.path.basename(pt) and os.path.getsize(pt) > 5000
    _same_png(pj, pt)


def test_plot_all_pixel_equal_to_jax(snapshots, tmp_path, capsys):
    """``plot_all``: the same files (the per-species plankton maps
    included), each pixel-equal, and the same console line."""
    jsnap, tsnap, _ = snapshots
    jplots.plot_all(jsnap, 7.0, str(tmp_path / "j"))
    jline = capsys.readouterr().out
    tplots.plot_all(tsnap, 7.0, str(tmp_path / "t"))
    assert capsys.readouterr().out == jline and "[TrueColor]" in jline
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "j")
                   for d, _, fs in os.walk(tmp_path / "j") for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), tmp_path / "t")
                           for d, _, fs in os.walk(tmp_path / "t") for f in fs)
    assert len(files) == 9 and "isr_day_00007.0.png" in files
    for f in files:
        _same_png(tmp_path / "j" / f, tmp_path / "t" / f)


def test_top3_species_pixel_equal_to_jax(snapshots, tmp_path):
    jsnap, tsnap, (jm, tm) = snapshots
    args = (jsnap.land_mask, 10.0, 200.0, jsnap.lat, jsnap.lon)
    pj = jploter.plot_top3_species_distributions(jsnap.state.eco, jm.indiv_static,
                                                 jsnap.state.indiv, *args, str(tmp_path / "j"),
                                                 t_days=2.0)
    pt = tploter.plot_top3_species_distributions(tsnap.state.eco, tm.indiv_static,
                                                 tsnap.state.indiv, *args, str(tmp_path / "t"),
                                                 t_days=2.0)
    assert os.path.basename(pj) == os.path.basename(pt)
    _same_png(pj, pt)


# ---------------------------------------------------------------- (g)

def _abundances(seed, S=4):
    r = np.random.default_rng(seed)
    L = r.random((S, N_LAT, N_LON)) * (r.random((S, N_LAT, N_LON)) < 0.7)
    L[:, :, :3] = 0.0                                   # empty cells
    L[0, 5] = -0.1                                      # clamped to 0
    mask = (r.random((N_LAT, N_LON)) < 0.4).astype(np.int8)
    lat_mesh = np.tile(np.linspace(-90, 90, N_LAT)[:, None], (1, N_LON))
    return L, mask, lat_mesh


def _close(a, b, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=what)
    fin = np.isfinite(a)
    assert np.abs(a[fin] - b[fin]).max(initial=0.0) <= 1e-12 * max(
        np.abs(a[fin]).max(initial=0.0), 1e-300), what


@pytest.mark.parametrize("seed", [0, 1])
def test_diversity_metrics_match_jax(seed):
    L, mask, lat_mesh = _abundances(seed)
    _close(jdiv.compute_alpha_eff_map(L, mask), tdiv.compute_alpha_eff_map(L, mask), "alpha")
    _close(jdiv.compute_local_bray_curtis(L, mask), tdiv.compute_local_bray_curtis(L, mask),
           "bray-curtis")
    jw, tw = (m.compute_whittaker_beta(L, mask, lat_mesh) for m in (jdiv, tdiv))
    assert set(jw) == set(tw)
    for k in jw:
        _close(jw[k], tw[k], k)
    # the eco state's device: tensors in, tensors out
    got = tdiv.compute_alpha_eff_map(torch.as_tensor(L), torch.as_tensor(mask))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float64


def test_compute_and_plot_matches_jax(tmp_path):
    """``compute_and_plot`` of one eco state: the summary scalars within
    1e-12, the same summary text and community snapshot, pixel-equal
    panels."""
    L, mask, lat_mesh = _abundances(3)
    lai = np.repeat(L[:, None], 2, axis=1) * 0.5                     # K = 2 layers
    lat, lon = np.linspace(-90, 90, N_LAT), np.linspace(0, 360, N_LON)
    jw = jdiv.compute_and_plot(lat, lon, lat_mesh, SimpleNamespace(LAI_SK=jnp.asarray(lai)),
                               mask, 4.0, str(tmp_path / "j"))
    tw = tdiv.compute_and_plot(lat, lon, lat_mesh, SimpleNamespace(LAI_SK=torch.as_tensor(lai)),
                               mask, 4.0, str(tmp_path / "t"))
    for k in jw:
        _close(jw[k], tw[k], k)
    files = sorted(os.listdir(tmp_path / "j" / "ecology"))
    assert files == sorted(os.listdir(tmp_path / "t" / "ecology")) and len(files) == 4
    for f in files:
        a, b = tmp_path / "j" / "ecology" / f, tmp_path / "t" / "ecology" / f
        if f.endswith(".png"):
            _same_png(a, b)
        elif f.endswith(".npz"):
            ja, tb = np.load(a), np.load(b)
            for k in ja.files:
                np.testing.assert_array_equal(ja[k], tb[k], err_msg=k)
        else:
            assert a.read_text() == b.read_text()


@pytest.mark.parametrize("K", [1, 3])
def test_canopy_height_map_matches_jax(snapshots, K):
    _, _, (jm, tm) = snapshots
    r = np.random.default_rng(K)
    lai = r.random((3, K, N_LAT, N_LON)) * 4.0 - 0.2
    land = np.array(jm.eco_static.land)
    cfg = jm.cfg.ecology
    ref = jpop.canopy_height_map(SimpleNamespace(K=K, land=land),
                                 SimpleNamespace(LAI_SK=jnp.asarray(lai)), cfg)
    got = tpop.canopy_height_map(SimpleNamespace(K=K, land=torch.as_tensor(land)),
                                 SimpleNamespace(LAI_SK=torch.as_tensor(lai)), tm.cfg.ecology)
    _close(ref, got.numpy(), f"canopy height K={K}")
    # the model's own statics and state (K = 1)
    if K == 1:
        jsnap, tsnap, _ = snapshots
        eco = convert.world_from_numpy(jax.device_get(jsnap.state.eco), "cpu", torch.float64)
        _close(jpop.canopy_height_map(jm.eco_static, jsnap.state.eco, cfg),
               tpop.canopy_height_map(tm.eco_static, eco, tm.cfg.ecology).numpy(), "model")


# ---------------------------------------------------------------- (h)

@pytest.fixture
def tiny_env(tmp_path, monkeypatch):
    """19×36, dt 7200 s (10 steps a day), chunks of 4 steps, panels every
    24-hour day (the state and TrueColor panels; the others are held to the
    JAX package's above) and diversity every planetary day."""
    monkeypatch.chdir(tmp_path)
    for k in [k for k in os.environ if k.startswith("QD_")]:
        monkeypatch.delenv(k)
    for k, v in {"QD_N_LAT": "19", "QD_N_LON": "36", "QD_DT_SECONDS": "7200",
                 "QD_CHUNK_STEPS": "4", "QD_AUTOSAVE_ENABLE": "0", "QD_PLOT_EVERY_DAYS": "1",
                 "QD_ECO_DIVERSITY_ENABLE": "1", "QD_ECO_DIVERSITY_EVERY_DAYS": "1",
                 "QD_PLOT_OCEAN": "0", "QD_PLOT_PHYTO": "0", "QD_ECO_PLOT": "0",
                 **ENV}.items():
        monkeypatch.setenv(k, v)
    return tmp_path


def test_run_writes_panels_on_cadence(tiny_env, capsys):
    """30 steps in chunks of 4: panels before the chunks that start at or
    past 0, 86400 and 172800 s (planetary days 0.0, 1.2, 2.4), the diversity
    snapshot after the chunks that end at or past planetary days 0, 1, 2
    and 3 (0.4, 1.2, 2.0, 3.0)."""
    w = tworld.QingdaiWorld(device="cpu")
    w.run(duration_seconds=30 * w.model.dt)
    out = capsys.readouterr().out
    assert "not in the port yet" not in out and "no compile cache to set up" in out
    state = sorted(f for f in os.listdir("output") if f.startswith("state_day_"))
    assert state == ["state_day_00000.0.png", "state_day_00001.2.png", "state_day_00002.4.png"]
    assert sorted(f for f in os.listdir("output") if f.startswith("truecolor_day_")) == [
        f.replace("state", "truecolor") for f in state]
    eco = sorted(os.listdir(os.path.join("output", "ecology")))
    days = ("000.4", "001.2", "002.0", "003.0")
    assert [f for f in eco if f.startswith("community_day_")] == [
        f"community_day_{d}.npz" for d in days]
    assert [f for f in eco if f.startswith("alpha_effective_day_")] == [
        f"alpha_effective_day_{d}.png" for d in days]
    snap = np.load(os.path.join("output", "ecology", "community_day_003.0.npz"))
    np.testing.assert_array_equal(
        snap["L_s"], np.clip(w.state.eco.LAI_SK.numpy(), 0.0, None).sum(axis=1).astype(np.float32))


def test_run_without_matplotlib_says_so_once(tiny_env, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert not tworld.have_matplotlib()
    w = tworld.QingdaiWorld(device="cpu")
    w.verbose = False
    w.run(duration_seconds=12 * w.model.dt)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[Viz]")]
    assert lines == ["[Viz] matplotlib is not installed: no panels are written (the diversity "
                     "snapshots and summaries still are)"]
    written = [f for _, _, fs in os.walk("output") for f in fs]
    assert not any(f.endswith(".png") for f in written)
    assert sorted(f for f in written if f.startswith("community_day_")) == [
        "community_day_000.4.npz", "community_day_001.2.npz"]
