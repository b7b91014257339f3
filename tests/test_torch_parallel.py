"""The port's multi-GPU layer on the CPU: two ranks over gloo, spawned once
for the module (``tests/torch_parallel_ranks.py``), float64, 19×36 with 18
columns a rank.

- Each halo op and each kernel's plain version on a rank (K1, K2 and K4
  on their operands gathered whole, K3 on the padded block) against the
  unsharded plain version: bit-equal, the reflect and one-sided seams
  included; K4's results and the ocean step's fields after its polar ring
  means within 1e-15 of each plane's max, the ring means' order of
  summation.
- The same ops against the JAX package's mesh forms on a 2-device
  ``qingdai_tpu.parallel.mesh.make_mesh(2)`` from the same numpy inputs,
  within 1e-12.
- The flagship planet sharded for 10 steps at dt 7200 s from a warm JAX
  state, across a day boundary and three routing events, against the JAX
  step unsharded: 1e-10 after one step, the dry run's envelope after ten.
- The member mesh (4 members over 2 ranks) bit-equal to the unsharded
  batched run, and one LETKF analysis of the gathered ensemble equal to the
  unsharded one.
- The diversity diagnostics of the sharded state, and the dry run's
  command line, on the CPU.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import __graft_entry__ as graft
import chip_smoke
import torch_parallel_ranks as ranks
from qingdai_tpu import config as JC
from qingdai_tpu import grid as jgrid
from qingdai_tpu import model as JM
from qingdai_tpu import ocean as jocean
from qingdai_tpu.ops import advect as jadv
from qingdai_tpu.ops import reductions as jred
from qingdai_tpu.ops import smooth as jsmooth
from qingdai_tpu.ops import stencil as jstencil
from qingdai_tpu.parallel import mesh as jmesh
from qingdai_tpu.state import OceanState as JOceanState
from qingdai_tpu_torch import assim as A
from qingdai_tpu_torch import constants as const
from qingdai_tpu_torch import convert, entry
from qingdai_tpu_torch import ensemble as E
from qingdai_tpu_torch.parallel import dryrun
from qingdai_tpu_torch.parallel.mesh import spawn_ranks

torch.set_num_threads(1)

N_LAT, N_LON, NPROC = ranks.N_LAT, ranks.N_LON, 2
W_RANK = N_LON // NPROC
N_STEPS, WARM_STEPS = 10, 20
ENS_MEMBERS, ENS_STEPS = 4, 6
TIMEOUT = 300.0          # seconds before a spawn's ranks are killed
EXACT = ("gauss_reflect", "gauss_wrap", "grad_lon", "grad_lat", "div", "vort", "lap",
         "shapiro", "spectral", "hyper4", "hyper4_grid", "advect", "median", "k4_st_1")
SUMMED = ("area_mean", "area_mean_c", "k4_mom_1", "k4_mom_2", "k4_st_2", "ocean_uo",
          "ocean_vo", "ocean_eta", "ocean_sst")


@pytest.fixture(scope="module")
def warm():
    """(JAX model, jitted JAX step, the JAX flagship planet at dt 7200 s
    warmed two planetary days)."""
    jm, js = graft._build_world(N_LAT, N_LON, dt_seconds=7200.0, extra_env=ranks.FLAGSHIP,
                                dtype=jnp.float64, hermetic=True)
    jstep = jax.jit(JM.make_step_fn(jm))
    for _ in range(WARM_STEPS):
        js, _ = jstep(js)
    return jm, jstep, js


@pytest.fixture(scope="module")
def run(warm):
    """(the ops' inputs, rank 0's results, the unsharded ops): one spawn of
    two ranks for every sharded check."""
    _, _, js = warm
    inputs = chip_smoke.par_op_inputs(N_LAT, N_LON, seed=3)
    res = spawn_ranks(ranks.rank_checks, NPROC, "gloo", "cpu",
                      (inputs, convert.world_from_numpy(js, "cpu", torch.float64), N_STEPS,
                       ENS_MEMBERS, ENS_STEPS), threads=1, timeout=TIMEOUT)[0]
    return inputs, res, chip_smoke.par_whole_ops(inputs)


def _rel(ref, got):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return float(np.abs(ref - got).max()) / max(float(np.abs(ref).max()), 1e-300)


@pytest.mark.parametrize("mode", chip_smoke.PAR_MODES)
def test_pad_lon_takes_neighbours_and_the_seam_mode(run, mode):
    """Each rank's padded block is the whole field's padded block at its
    columns: neighbours' columns inside, the seam's mode at columns 0 and
    W−1 only."""
    _, res, whole = run
    p = chip_smoke.PAR_PAD
    want = np.concatenate([whole[f"pad_{mode}"][:, r * W_RANK:r * W_RANK + W_RANK + 2 * p]
                           for r in range(NPROC)], axis=1)
    np.testing.assert_array_equal(res["ops"]["float64"][f"pad_{mode}"], want)


@pytest.mark.parametrize("op", EXACT)
def test_sharded_op_bit_equal_to_unsharded(run, op):
    _, res, whole = run
    np.testing.assert_array_equal(res["ops"]["float64"][op], whole[op])


def test_padded_static_operands_equal_the_exchanged(run):
    """The static maps a rank's shard grid holds padded (K3's ∇⁴ map and cos
    map) equal the same maps padded by a halo exchange, on every rank."""
    _, res, _ = run
    assert float(res["ops"]["float64"]["padded_operands"]) == 0.0


@pytest.mark.parametrize("op", SUMMED)
def test_summed_results_within_their_order_of_summation(run, op):
    """The means, K4's η (the mean's cross-rank sum) and what a second
    substep takes from it, and the ocean step's fields after the polar ring
    means: 1e-15 of each plane's max; K4's momentum planes other than η
    bit-equal with one substep."""
    _, res, whole = run
    got, ref = res["ops"]["float64"][op], whole[op]
    planes = zip(ref, got) if ref.ndim == 3 else [(ref, got)]
    assert max(_rel(a, b) for a, b in planes) <= 1e-15
    if op == "k4_mom_1":
        np.testing.assert_array_equal(got[:2], ref[:2])


def _jax_inputs(inputs):
    """The inputs sharded over a 2-device JAX mesh by the JAX package's own
    rule, and its grid with the mesh attached (``shard_model_statics``)."""
    m = jmesh.make_mesh(NPROC)

    def put(x):
        x = jnp.asarray(x)
        return jax.device_put(x, NamedSharding(m, jmesh._spec_for_leaf(x, N_LON, "lon")))

    g = jax.tree_util.tree_map(put, jgrid.make_grid(N_LAT, N_LON, jnp.float64))
    g = dataclasses.replace(g, mesh=m, mesh_axis="lon")
    return m, g, {k: put(np.asarray(v, np.float64) if k not in ("land", "ice") else v)
                  for k, v in inputs.items()}


def _jax_ops(inputs) -> dict:
    """The JAX package's forms of the ops on the sharded inputs, each
    jitted (its mesh forms compile once so)."""
    m, g, x = _jax_inputs(inputs)
    a, dlat, dlon = const.PLANET_RADIUS, g.dlat_rad, g.dlon_rad
    F, u, v, stack = x["F"], x["u"], x["v"], x["stack"]
    cfg = JC.SimConfig.from_env()
    ocn = JOceanState(uo=x["uo"], vo=x["vo"], eta=x["eta"], sst=x["sst"])
    ops = {"gauss_reflect": lambda: jsmooth.gaussian_filter(F, 1.0, mesh=m),
           "gauss_wrap": lambda: jsmooth.gaussian_filter(F, 1.0, "wrap", "wrap", mesh=m),
           "grad": lambda: jgrid.grad_lonlat(g, F),
           "div": lambda: jgrid.divergence(g, u, v),
           "vort": lambda: jgrid.vorticity(g, u, v),
           "lap": lambda: jstencil.laplacian_sphere(F, dlat, dlon, g.coslat_cap_02, a),
           "shapiro": lambda: jstencil.shapiro_filter_multi(stack, 2, mesh=m),
           "spectral": lambda: jstencil.spectral_zonal_filter(stack[0], N_LON, 0.75, 0.5),
           "hyper4": lambda: jstencil.hyperdiffuse_multi(stack, x["k4"], 300.0, 2, dlat, dlon,
                                                         g.coslat_cap_02, a, mesh=m),
           "advect": lambda: jadv.advect_semilag_multi(stack[:2], u, v, 300.0, a, dlat, dlon,
                                                       g.coslat_cap_tiny),
           "median": lambda: jred.masked_median_of_positive(x["pos"]),
           "area_mean": lambda: jred.area_mean(F, g.area_w),
           "area_mean_c": lambda: jred.area_mean_compensated(F, g.area_w),
           "ocean": lambda: jocean.ocean_step(g, cfg.ocean, x["land"], ocn, u, v, x["Q"],
                                              x["ice"], 0, 300.0, 1)[0]}
    out = {k: jax.device_get(jax.jit(fn)()) for k, fn in ops.items()}
    out["grad_lon"], out["grad_lat"] = out.pop("grad")
    ocn2 = out.pop("ocean")
    out.update({f"ocean_{k}": getattr(ocn2, k) for k in ("uo", "vo", "eta", "sst")})
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def jax_ops(run):
    return _jax_ops(run[0])


@pytest.mark.parametrize("op", ["gauss_reflect", "gauss_wrap", "grad_lon", "grad_lat", "div",
                                "vort", "lap", "shapiro", "spectral", "hyper4", "advect",
                                "median", "area_mean", "area_mean_c", "ocean_uo", "ocean_vo",
                                "ocean_eta", "ocean_sst"])
def test_sharded_op_matches_jax_mesh_form(run, jax_ops, op):
    _, res, _ = run
    assert _rel(jax_ops[op], res["ops"]["float64"][op]) <= 1e-12


def test_sharded_chunk_matches_jax(warm, run):
    """One step within 1e-10 of each leaf's max (the routing residuals of
    the routed mass), ten within the dry run's envelope of two ±1e-13
    controls, across the day boundary at step 10 and events at 1, 4, 7, 10."""
    _, jstep, js = warm
    _, res, _ = run
    assert float(js.routing.t_accum) == 2 * 7200.0      # the 6-h event fires next step
    assert res["step1"].routing.t_accum == 0.0
    assert res[f"step{N_STEPS}"].clock.accum_t_day == 0.0         # the day ended
    ref1, _ = jstep(js)
    errs = _leaf_errs(ref1, res["step1"])
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-10, (worst, errs[worst])

    def ten(s):
        for _ in range(N_STEPS):
            s, _ = jstep(s)
        return s

    ref = ten(js)
    ctrl = [ten(dataclasses.replace(js, atmos=dataclasses.replace(js.atmos,
                                                                  h=js.atmos.h * (1.0 + e))))
            for e in (1e-13, -1e-13)]
    d_ctrl = max(dryrun.compare(ref, c)[0] for c in ctrl)
    bound = min(0.2, max(1e-3, 300.0 * d_ctrl))
    d, leaf = dryrun.compare(ref, res[f"step{N_STEPS}"])
    assert d < bound, (leaf, d, d_ctrl)


def test_diversity_diagnostics_gather_on_the_mesh(run, tmp_path):
    """The diversity metrics of the sharded state, gathered at their
    cadence, equal the whole state's bit for bit."""
    from qingdai_tpu_torch.ecology import diversity
    from qingdai_tpu_torch.grid import make_grid
    _, res, _ = run
    g = make_grid(N_LAT, N_LON, device="cpu", dtype=torch.float64)
    land = entry.build_world(N_LAT, N_LON, dt_seconds=7200.0, extra_env=ranks.FLAGSHIP,
                             device="cpu", dtype=torch.float64)[0].static.land_mask
    want = diversity.compute_and_plot(g.lat, g.lon, g.lat_mesh, res[f"step{N_STEPS}"].eco,
                                      land, 1.0, str(tmp_path), plot=False)
    got = res["diversity"]
    for k in ("alpha_mean", "gamma_eff", "beta_whittaker"):
        assert got[k] == want[k], k
    np.testing.assert_array_equal(got["alpha_map"], want["alpha_map"])


def _leaf_errs(jworld, tworld) -> dict:
    ref, got = convert.world_to_numpy(jworld), convert.world_to_numpy(tworld)
    routed = float(np.abs(np.asarray(ref["routing.routed_mass_kg"])).max())
    errs = {}
    for k, r in ref.items():
        r = np.asarray(r, np.float64)
        g = np.asarray(got[k], np.float64)
        fin = np.isfinite(r)
        np.testing.assert_array_equal(fin, np.isfinite(g), err_msg=k)
        if not fin.any():
            continue
        scale = max(float(np.abs(r[fin]).max()), 1e-300)
        if k.split(".")[-1] in dryrun.ROUTED_SCALED:
            scale = max(scale, routed)
        errs[k] = float(np.abs(r[fin] - g[fin]).max()) / scale
    return errs


@pytest.fixture(scope="module")
def unsharded_ensemble():
    mdl, _ = entry.build_world(N_LAT, N_LON, device="cpu", dtype=torch.float64)
    ens, gens = E.init_ensemble(mdl, ENS_MEMBERS, h_amp=20.0)
    ens, _ = E.make_ensemble_chunk_fn(mdl, ENS_STEPS)(ens, gens)
    return mdl, ens


def test_member_mesh_bit_equal(run, unsharded_ensemble):
    _, ens = unsharded_ensemble
    ref, got = convert.world_to_numpy(ens), run[1]["ens"]
    assert set(ref) == set(got)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]), err_msg=k)


def test_analysis_of_the_gathered_ensemble(run, unsharded_ensemble):
    mdl, ens = unsharded_ensemble
    g = torch.Generator().manual_seed(5)
    cells = A.draw_obs_network(g, mdl, 40)
    y = A.synthetic_obs(g, E.member_state(ens, 0), cells, "T_s", 0.5)
    fidx = torch.zeros(40, dtype=torch.long)
    lat, lon = mdl.grid.lat_mesh.reshape(-1), mdl.grid.lon_mesh.reshape(-1)
    an = [A.letkf_analysis(X.reshape(ENS_MEMBERS, len(ranks.ENS_FIELDS), -1), y, cells, fidx,
                           lat, lon, obs_err=0.5, loc_radius_km=2000.0, inflation=1.04,
                           planet_radius_m=const.PLANET_RADIUS, rtps=0.6)
          for X in (A.gather_fields(ens, ranks.ENS_FIELDS), run[1]["ens_X"])]
    assert float((an[0] - an[1]).abs().max()) == 0.0
    assert float((an[0] - A.gather_fields(ens, ranks.ENS_FIELDS).reshape(an[0].shape))
                 .abs().max()) > 0.0


def test_dryrun_cli_on_the_cpu(tmp_path):
    """``python -m qingdai_tpu_torch.parallel.dryrun`` in this process at
    19×36: two resynced half-day segments of 5 steps over 2 ranks, each
    under its bound with a routing event, and the record written."""
    out = tmp_path / "dryrun.json"
    rec = dryrun.main(["--nproc", "2", "--backend", "gloo", "--device", "cpu", "--nlat", "19",
                       "--nlon", "36", "--segs", "2", "--threads", "1", "--timeout",
                       str(TIMEOUT), "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(rec))
    assert rec["grid"] == "19x36" and rec["seg_len_steps"] == 5
    for s in rec["segments"]:
        assert s["diff"] < s["bound"] and s["collectives_per_step"] > 0
    assert rec["routed_mass_kg"] > 0.0
