"""Parity of every ported physics function with its JAX counterpart, float64,
to 1e-12 relative to the largest |value| of each output, on the CPU.

Each case builds its inputs from a seed with NumPy, runs the JAX function and
the port's function of the same name, and compares every output leaf.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qingdai_tpu import grid as jgrid
from qingdai_tpu.config import SimConfig
from qingdai_tpu.ops import safegrad as jsg
from qingdai_tpu.physics import clouds as jcl
from qingdai_tpu.physics import energy as jen
from qingdai_tpu.physics import forcing as jfo
from qingdai_tpu.physics import humidity as jhu
from qingdai_tpu.physics import hydrology as jhy
from qingdai_tpu.physics import orbital as jor
from qingdai_tpu_torch import grid as tgrid
from qingdai_tpu_torch.ops import safegrad as tsg
from qingdai_tpu_torch.physics import clouds as tcl
from qingdai_tpu_torch.physics import energy as ten
from qingdai_tpu_torch.physics import forcing as tfo
from qingdai_tpu_torch.physics import humidity as thu
from qingdai_tpu_torch.physics import hydrology as thy
from qingdai_tpu_torch.physics import orbital as tor

torch.set_num_threads(1)

H, W = 19, 36
CFG = SimConfig()
JG = jgrid.make_grid(H, W, dtype=jnp.float64)
TG = tgrid.make_grid(H, W, device="cpu", dtype=torch.float64)


def _inputs(seed):
    """Physical-range fields shared by both packages (NumPy float64)."""
    r = np.random.default_rng(seed)
    f = {
        "Ts": 250.0 + 50.0 * r.random((H, W)),
        "Ta": 240.0 + 50.0 * r.random((H, W)),
        "u": 40.0 * r.standard_normal((H, W)),
        "v": 20.0 * r.standard_normal((H, W)),
        "h": 8000.0 + 300.0 * r.standard_normal((H, W)),
        "q": 0.02 * r.random((H, W)),
        "cloud": r.random((H, W)),
        "albedo": 0.1 + 0.5 * r.random((H, W)),
        "I": np.maximum(0.0, 1400.0 * r.standard_normal((H, W))),
        "land": (r.random((H, W)) < 0.3).astype(np.int32),
        "h_ice": np.where(r.random((H, W)) < 0.3, r.random((H, W)), 0.0),
        "P": np.where(r.random((H, W)) < 0.5, 0.0, 1e-4 * r.random((H, W))),
        "S": np.where(r.random((H, W)) < 0.5, 0.0, 80.0 * r.random((H, W))),
        "elev": np.maximum(0.0, 2000.0 * r.standard_normal((H, W))),
        "flux": 300.0 * r.standard_normal((H, W)),
    }
    f["Ts"][0, :5] = 272.0               # near-freezing polar cells for the ice fixes
    f["Ts"][-1, :5] = 272.0
    return f


def _to(pkg, x):
    if isinstance(x, np.ndarray):
        return jnp.asarray(x) if pkg == "jax" else torch.as_tensor(x.copy())
    return x


def _flatten(out):
    if isinstance(out, dict):
        return [out[k] for k in sorted(out)]
    if isinstance(out, (tuple, list)):
        return [leaf for o in out for leaf in _flatten(o)]
    return [out]


def _compare(jout, tout, rel=1e-12):
    J, T = _flatten(jout), _flatten(tout)
    assert len(J) == len(T)
    for j, t in zip(J, T):
        j = np.asarray(j, np.float64)
        t = (t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)).astype(np.float64)
        assert j.shape == t.shape
        scale = max(float(np.max(np.abs(j))), 1e-300)
        np.testing.assert_array_equal(np.isfinite(j), np.isfinite(t))
        fin = np.isfinite(j)
        assert np.max(np.abs(j[fin] - t[fin]), initial=0.0) <= rel * scale


def _call(name, jfn, tfn, args, kwargs=None):
    kwargs = kwargs or {}
    ja = [_to("jax", a) for a in args]
    ta = [_to("torch", a) for a in args]
    jk = {k: _to("jax", v) for k, v in kwargs.items()}
    tk = {k: _to("torch", v) for k, v in kwargs.items()}
    return jfn(*ja, **jk), tfn(*ta, **tk)


def _scalar(pkg, x):
    return jnp.asarray(x, jnp.float64) if pkg == "jax" else torch.tensor(x, dtype=torch.float64)


E_NOLOCK = dataclasses.replace(CFG.energy, gh_lock=False)
HY_CONST = dataclasses.replace(CFG.hydrology, snow_melt_mode="constant", swe_max_mm=40.0,
                               wland_cap_mm=30.0)
PH_NOFALLBACK = dataclasses.replace(CFG.physics, p_hybrid_fallback=False)


def case_list():
    f = _inputs(0)
    hc, ec, pc = CFG.humidity, CFG.energy, CFG.physics
    cs = dict(Cs_ocean=2.1e8, Cs_land=3.0e6, Cs_ice=5.0e6)
    phase = [0.3, 2.1, 5.9]
    return {
        # orbital + forcing
        "orbital": lambda: (
            [jor.stellar_positions_from_phase(_scalar("jax", p)) for p in phase]
            + [jor.planet_position_from_phase(_scalar("jax", p)) for p in phase],
            [tor.stellar_positions_from_phase(_scalar("torch", p)) for p in phase]
            + [tor.planet_position_from_phase(_scalar("torch", p)) for p in phase]),
        "insolation": lambda: (
            jfo.insolation_components_from_phases(JG, *[_scalar("jax", p) for p in phase]),
            tfo.insolation_components_from_phases(TG, *[_scalar("torch", p) for p in phase])),
        "equilibrium_temp": lambda: _call("", jfo.equilibrium_temp, tfo.equilibrium_temp,
                                          [f["I"], f["albedo"]]),
        # humidity
        "q_sat": lambda: _call("", jhu.q_sat, thu.q_sat, [f["Ts"]], {"p": 9.5e4}),
        "q_init": lambda: _call("", jhu.q_init, thu.q_init, [f["Ts"], 0.7, 1.0e5]),
        "surface_evaporation_factor": lambda: _call(
            "", jhu.surface_evaporation_factor, thu.surface_evaporation_factor,
            [f["land"], f["h_ice"], hc]),
        "evaporation_flux": lambda: _call(
            "", jhu.evaporation_flux, thu.evaporation_flux,
            [f["Ts"], f["q"], f["u"], f["v"], f["cloud"], hc]),
        "condensation": lambda: _call("", jhu.condensation, thu.condensation,
                                      [f["q"] * 2.0, f["Ta"], 300.0, hc]),
        "humidity_block": lambda: _call(
            "", jhu.humidity_block, thu.humidity_block,
            [f["Ts"], f["q"], f["u"], f["v"], f["h"], f["h_ice"], f["land"], 300.0, hc, 9.81]),
        # energy
        "shortwave": lambda: _call("", jen.shortwave_radiation, ten.shortwave_radiation,
                                   [f["I"], f["albedo"], f["cloud"], ec]),
        "longwave_v1_lock": lambda: _call("", jen.longwave_radiation, ten.longwave_radiation,
                                          [f["Ts"], f["Ta"], f["cloud"], ec]),
        "longwave_v1": lambda: (
            jen.longwave_radiation(jnp.asarray(f["Ts"]), jnp.asarray(f["Ta"]),
                                   jnp.asarray(f["cloud"]), E_NOLOCK,
                                   eps0=_scalar("jax", 0.6), kc=_scalar("jax", 0.3)),
            ten.longwave_radiation(torch.as_tensor(f["Ts"]), torch.as_tensor(f["Ta"]),
                                   torch.as_tensor(f["cloud"]), E_NOLOCK,
                                   eps0=_scalar("torch", 0.6), kc=_scalar("torch", 0.3))),
        "emissivity": lambda: _call("", jen.surface_emissivity_map, ten.surface_emissivity_map,
                                    [f["land"], f["cloud"], ec]),
        "longwave_v2": lambda: _call("", jen.longwave_radiation_v2, ten.longwave_radiation_v2,
                                     [f["Ts"], f["Ta"], f["cloud"], f["albedo"] + 0.4, E_NOLOCK]),
        "longwave_v2_lock": lambda: (
            jen.longwave_radiation_v2(jnp.asarray(f["Ts"]), jnp.asarray(f["Ta"]),
                                      jnp.asarray(f["cloud"]), jnp.asarray(f["albedo"]), ec,
                                      eps0=_scalar("jax", 0.65)),
            ten.longwave_radiation_v2(torch.as_tensor(f["Ts"]), torch.as_tensor(f["Ta"]),
                                      torch.as_tensor(f["cloud"]), torch.as_tensor(f["albedo"]),
                                      ec, eps0=_scalar("torch", 0.65))),
        "surface_energy_map": lambda: _call(
            "", jen.integrate_surface_energy_map, ten.integrate_surface_energy_map,
            [f["Ts"] - 100.0, f["flux"], f["flux"] * 0.3, f["flux"] * 0.1, f["flux"] * 0.2,
             3e5, np.where(f["land"] == 1, 3e6, 500.0)], {"audit": True}),
        "seaice": lambda: _call(
            "", jen.integrate_surface_energy_with_seaice,
            ten.integrate_surface_energy_with_seaice,
            [f["Ts"], f["flux"], f["flux"] * 0.3, f["flux"] * 0.1, f["flux"] * 0.2, 300.0,
             f["land"], f["h_ice"]], dict(cs, audit=True)),
        "seaice_no_polar_fix": lambda: _call(
            "", jen.integrate_surface_energy_with_seaice,
            ten.integrate_surface_energy_with_seaice,
            [f["Ts"], f["flux"], f["flux"] * 0.3, f["flux"] * 0.1, f["flux"] * 0.2, 300.0,
             f["land"], f["h_ice"]], dict(cs, polar_fix_s=False)),
        "boundary_layer": lambda: _call(
            "", jen.boundary_layer_fluxes, ten.boundary_layer_fluxes,
            [f["Ts"], f["Ta"], f["u"], f["v"], f["land"], ec]),
        "atmos_energy_height": lambda: _call(
            "", jen.integrate_atmos_energy_height, ten.integrate_atmos_energy_height,
            [f["h"], f["flux"], f["flux"], f["flux"], f["flux"], 300.0, 1.2, 800.0],
            {"weight": 0.5}),
        "energy_diagnostics": lambda: _call(
            "", jen.energy_diagnostics, ten.energy_diagnostics,
            [np.asarray(JG.area_w)] + [f["flux"] + 10.0 * i for i in range(7)]),
        "autotune": lambda: (
            jen.autotune_greenhouse(_scalar("jax", 0.7), _scalar("jax", 0.2),
                                    _scalar("jax", 3.5), ec),
            ten.autotune_greenhouse(_scalar("torch", 0.7), _scalar("torch", 0.2),
                                    _scalar("torch", 3.5), ec)),
        # clouds
        "diagnose_precipitation": lambda: (
            jcl.diagnose_precipitation(JG, jnp.asarray(f["u"]), jnp.asarray(f["v"]),
                                       jnp.asarray(f["cloud"]), pc.D_crit, pc.k_precip),
            tcl.diagnose_precipitation(TG, torch.as_tensor(f["u"]), torch.as_tensor(f["v"]),
                                       torch.as_tensor(f["cloud"]), pc.D_crit, pc.k_precip)),
        "cloud_from_precip": lambda: (
            jcl.cloud_from_precip(jnp.asarray(f["P"]), P_ref=_scalar("jax", 3e-5)),
            tcl.cloud_from_precip(torch.as_tensor(f["P"]), P_ref=_scalar("torch", 3e-5))),
        "parameterize_cloud_cover": lambda: (
            jcl.parameterize_cloud_cover(JG, *[jnp.asarray(f[k]) for k in ("Ts", "u", "v")]),
            tcl.parameterize_cloud_cover(TG, *[torch.as_tensor(f[k]) for k in ("Ts", "u", "v")])),
        "orographic_factor": lambda: (
            jcl.compute_orographic_factor(JG, *[jnp.asarray(f[k]) for k in ("elev", "u", "v")]),
            tcl.compute_orographic_factor(TG, *[torch.as_tensor(f[k])
                                                for k in ("elev", "u", "v")])),
        "dynamic_albedo_ice_frac": lambda: _call(
            "", jcl.calculate_dynamic_albedo, tcl.calculate_dynamic_albedo,
            [f["cloud"], f["Ts"], f["albedo"], 0.6, 0.5],
            {"land_mask": f["land"], "ice_frac": f["h_ice"]}),
        "dynamic_albedo_h_ice": lambda: _call(
            "", jcl.calculate_dynamic_albedo, tcl.calculate_dynamic_albedo,
            [f["cloud"], f["Ts"], f["albedo"], 0.6, 0.5], {"h_ice": f["h_ice"]}),
        "dynamic_albedo_ts": lambda: _call(
            "", jcl.calculate_dynamic_albedo, tcl.calculate_dynamic_albedo,
            [f["cloud"], f["Ts"], f["albedo"], 0.6, 0.5], {"land_mask": f["land"]}),
        "precip_hybrid": lambda: (
            jcl.diagnose_precipitation_hybrid(JG, jnp.asarray(f["u"]), jnp.asarray(f["v"]),
                                              jnp.asarray(f["cloud"]), jnp.asarray(f["P"]), pc,
                                              orog_factor=jnp.asarray(1.0 + f["cloud"])),
            tcl.diagnose_precipitation_hybrid(TG, torch.as_tensor(f["u"]),
                                              torch.as_tensor(f["v"]),
                                              torch.as_tensor(f["cloud"]),
                                              torch.as_tensor(f["P"]), pc,
                                              orog_factor=torch.as_tensor(1.0 + f["cloud"]))),
        "precip_hybrid_weak_moisture": lambda: (
            jcl.diagnose_precipitation_hybrid(JG, jnp.asarray(f["u"]), jnp.asarray(f["v"]),
                                              jnp.asarray(f["cloud"]),
                                              jnp.asarray(f["P"] * 1e-6), pc),
            tcl.diagnose_precipitation_hybrid(TG, torch.as_tensor(f["u"]),
                                              torch.as_tensor(f["v"]),
                                              torch.as_tensor(f["cloud"]),
                                              torch.as_tensor(f["P"] * 1e-6), pc)),
        "precip_hybrid_no_fallback": lambda: (
            jcl.diagnose_precipitation_hybrid(JG, jnp.asarray(f["u"]), jnp.asarray(f["v"]),
                                              jnp.asarray(f["cloud"]), jnp.zeros((H, W)),
                                              PH_NOFALLBACK),
            tcl.diagnose_precipitation_hybrid(TG, torch.as_tensor(f["u"]),
                                              torch.as_tensor(f["v"]),
                                              torch.as_tensor(f["cloud"]),
                                              torch.zeros((H, W), dtype=torch.float64),
                                              PH_NOFALLBACK)),
        # hydrology
        "phase_split_smooth": lambda: _call("", jhy.partition_precip_phase_smooth,
                                            thy.partition_precip_phase_smooth,
                                            [f["P"], f["Ts"]]),
        "snowpack_degree_day": lambda: _call(
            "", jhy.snowpack_step, thy.snowpack_step,
            [f["S"], f["P"] * 10.0, f["Ts"], CFG.hydrology, 300.0]),
        "snowpack_constant": lambda: _call(
            "", jhy.snowpack_step, thy.snowpack_step,
            [f["S"], f["P"] * 10.0, f["Ts"], HY_CONST, 300.0]),
        "land_bucket": lambda: _call("", jhy.update_land_bucket, thy.update_land_bucket,
                                     [f["S"], f["P"], f["P"] * 0.3, CFG.hydrology, 300.0]),
        "land_bucket_cap": lambda: _call("", jhy.update_land_bucket, thy.update_land_bucket,
                                         [f["S"], f["P"] * 1e5, f["P"], HY_CONST, 300.0]),
        "water_closure": lambda: _call(
            "", jhy.water_closure_means, thy.water_closure_means,
            [np.asarray(JG.area_w), f["q"], 1.2, 800.0, f["h_ice"], 917.0, f["S"], f["S"] * 0.5,
             f["P"], f["P"] * 2.0, f["P"] * 0.1]),
    }


CASES = case_list()


@pytest.mark.parametrize("name", sorted(CASES))
def test_physics_matches_jax(name):
    jout, tout = CASES[name]()
    _compare(jout, tout)


def test_safegrad_gradients():
    """Forward values of the plain expressions; zero subgradients at the
    singular points and the analytic derivative elsewhere."""
    x = torch.tensor([0.0, 1e-320, 2.0, 16.0], dtype=torch.float64, requires_grad=True)
    y = tsg.quartic_root(x)
    y.sum().backward()
    assert torch.equal(y.detach(), x.detach() ** 0.25)
    np.testing.assert_allclose(x.grad.numpy(), [0.0, 0.0, 0.25 * 2.0 ** -0.75, 0.25 / 8.0])

    u = torch.tensor([0.0, 3.0], dtype=torch.float64, requires_grad=True)
    v = torch.tensor([0.0, 4.0], dtype=torch.float64, requires_grad=True)
    s = tsg.speed(u, v)
    s.sum().backward()
    np.testing.assert_array_equal(s.detach().numpy(), [0.0, 5.0])
    np.testing.assert_allclose(u.grad.numpy(), [0.0, 0.6])
    np.testing.assert_allclose(v.grad.numpy(), [0.0, 0.8])

    c = torch.tensor([0.0, 2.0], dtype=torch.float64, requires_grad=True)
    p = torch.tensor(0.5, dtype=torch.float64, requires_grad=True)
    z = tsg.pow_safe(c, p)
    z.sum().backward()
    ref = jsg.pow_safe(jnp.asarray([0.0, 2.0]), 0.5)
    np.testing.assert_array_equal(z.detach().numpy(), np.asarray(ref))
    np.testing.assert_allclose(c.grad.numpy(), [0.0, 0.5 * 2.0 ** -0.5])
    np.testing.assert_allclose(float(p.grad), 2.0 ** 0.5 * np.log(2.0))
