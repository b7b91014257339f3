"""The port's time-based astronomy and the three CLIs over it: the orbital
functions of time and the insolation at a time against the JAX package's in
float64 (1e-12 relative), the analytic checks of tests/test_orbital_forcing.py
on the port, ``verify_calculation``'s checks, and the two plot CLIs with and
without matplotlib."""

import math
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qingdai_tpu import grid as jgrid
from qingdai_tpu.physics import forcing as jfo
from qingdai_tpu.physics import orbital as jor
from qingdai_tpu_torch import constants as const
from qingdai_tpu_torch import diag_isr, generate_orbit_plots, verify_calculation
from qingdai_tpu_torch import grid as tgrid
from qingdai_tpu_torch.physics import forcing as tfo
from qingdai_tpu_torch.physics import orbital as tor

torch.set_num_threads(1)

REL = 1e-12
H, W = 19, 36
YEAR = np.linspace(0, jor.T_PLANET, 4096)


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


@pytest.mark.parametrize("t", [0.0, 1.2345e6, YEAR], ids=["t0", "t1e6", "year4096"])
def test_orbit_matches_jax(t):
    """stellar_positions, planet_position and total_flux of a Python float or
    a NumPy array: float64 tensors on the device asked for, equal to JAX's."""
    for name in ("stellar_positions", "planet_position"):
        got = getattr(tor, name)(t, device="cpu")
        want = getattr(jor, name)(t)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == torch.float64 and g.device.type == "cpu"
            _close(g.numpy(), w)
    _close(tor.total_flux(t, device="cpu").numpy(), jor.total_flux(t))


def test_orbit_keeps_a_tensors_dtype_and_device():
    t = torch.tensor([0.0, 3.0e6], dtype=torch.float32)
    S = tor.total_flux(t)                  # a tensor: no device argument needed
    assert S.dtype == torch.float32 and S.device.type == "cpu"
    np.testing.assert_allclose(S.numpy(), tor.total_flux(t.double()).numpy(), rtol=1e-6)


def test_orbit_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tor.total_flux(0.0)


@pytest.mark.parametrize("t", [0.0, 4.1e5, 1.234e7, 3.3e8])
def test_insolation_matches_jax(t):
    """insolation_components and insolation_total at 19×36 in float64."""
    jg = jgrid.make_grid(H, W, dtype=jnp.float64)
    tg = tgrid.make_grid(H, W, device="cpu", dtype=torch.float64)
    for got, want in zip(tfo.insolation_components(tg, t), jfo.insolation_components(jg, t)):
        assert got.dtype == torch.float64
        _close(got.numpy(), want)
    _close(tfo.insolation_total(tg, t).numpy(), jfo.insolation_total(jg, t))


def test_insolation_float32_forms_the_phases_in_float64():
    """A float32 grid at t ≈ 1e7 s: the fields are float32 and within float32
    rounding of the float64 fields (a float32 product t·Ω would move the
    rotation phase by ~1e-3 rad)."""
    t = 1.234e7
    g32 = tgrid.make_grid(H, W, device="cpu", dtype=torch.float32)
    g64 = tgrid.make_grid(H, W, device="cpu", dtype=torch.float64)
    for a, b in zip(tfo.insolation_components(g32, t), tfo.insolation_components(g64, t)):
        assert a.dtype == torch.float32
        _close(a.double().numpy(), b.numpy(), rel=1e-6)


# mirrors of tests/test_orbital_forcing.py on the port

def test_periods_omega_consistency():
    assert tor.T_BINARY > 0 and tor.T_PLANET > tor.T_BINARY
    np.testing.assert_allclose(tor.OMEGA_BINARY * tor.T_BINARY, 2 * math.pi)
    np.testing.assert_allclose(tor.OMEGA_PLANET * tor.T_PLANET, 2 * math.pi)
    ratio = (tor.T_PLANET / tor.T_BINARY) ** 2
    np.testing.assert_allclose(ratio, (const.A_PLANET / const.A_BINARY) ** 3, rtol=1e-10)


def test_barycenter():
    xA, yA, xB, yB = (z.numpy() for z in tor.stellar_positions(1.2345e6, device="cpu"))
    scale = const.M_A * const.A_BINARY
    np.testing.assert_allclose(const.M_A * xA + const.M_B * xB, 0.0, atol=1e-12 * scale)
    np.testing.assert_allclose(const.M_A * yA + const.M_B * yB, 0.0, atol=1e-12 * scale)


def test_flux_at_t0_analytic():
    d_A = const.A_PLANET - tor.R_A
    d_B = const.A_PLANET + tor.R_B
    S = const.L_A / (4 * math.pi * d_A**2) + const.L_B / (4 * math.pi * d_B**2)
    np.testing.assert_allclose(float(tor.total_flux(0.0, device="cpu")), S, rtol=1e-6)


def test_flux_positive_and_varies():
    S = tor.total_flux(np.linspace(0, tor.T_PLANET, 64), device="cpu").numpy()
    assert np.all(S > 0)
    assert S.max() / S.min() > 1.001


def test_insolation_geometry():
    g = tgrid.make_grid(H, W, device="cpu")
    insA, insB = (x.numpy() for x in tfo.insolation_components(g, 0.0))
    assert insA.min() >= 0 and insB.min() >= 0
    assert insA.max() <= float(tor.total_flux(0.0, device="cpu"))
    assert (insA == 0).any() and (insA > 0).any()
    np.testing.assert_allclose(tfo.insolation_total(g, 0.0).numpy(), insA + insB, rtol=1e-6)


def test_equilibrium_temp():
    g = tgrid.make_grid(H, W, device="cpu")
    isr = tfo.insolation_total(g, 0.0)
    Teq = tfo.equilibrium_temp(isr, 0.3).numpy()
    ref = (np.maximum(isr.numpy() * 0.7, 0) / const.SIGMA) ** 0.25
    np.testing.assert_allclose(Teq, ref, rtol=1e-5)


# the CLIs

def test_verify_calculation_passes(capsys):
    assert verify_calculation.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in out] == [
        "[Verify] t=0 flux", "[Verify] Kepler T²∝a³", "[Verify] flux over orbit",
        "[Verify] PASS"]
    assert out[0].endswith("OK") and out[1].endswith("OK")


def test_verify_calculation_exits_1_on_fail(monkeypatch, capsys):
    monkeypatch.setattr(tor, "T_PLANET", tor.T_PLANET * 1.01)     # Kepler's law fails
    assert verify_calculation.main(["--device", "cpu"]) == 1
    assert capsys.readouterr().out.splitlines()[-1] == "[Verify] FAIL"


def test_astro_plot_clis(tmp_path, capsys):
    """diag_isr and generate_orbit_plots render into --out; the [ISR] line
    carries the numbers of diag_isr.isr_report, which match the JAX
    package's insolation."""
    out = str(tmp_path / "isr")
    assert diag_isr.main(["--nlat", "19", "--nlon", "36", "--out", out, "--device", "cpu",
                          "--dtype", "float64", "--t-days", "3"]) == 0
    assert any(f.endswith(".png") for f in os.listdir(out))
    line = capsys.readouterr().out.splitlines()[0]
    g = tgrid.make_grid(H, W, device="cpu", dtype=torch.float64)
    insA, insB, r = diag_isr.isr_report(g, 3.0)
    assert line.startswith(f"[ISR] t=3.00 d | max A={r['max_A']:.1f} W/m2")
    jA = np.asarray(jfo.insolation_components(jgrid.make_grid(H, W, dtype=jnp.float64),
                                              3.0 * const.DAY_SECONDS)[0])
    assert r["max_A"] == pytest.approx(jA.max(), rel=REL)
    j, i = np.unravel_index(np.argmax(jA), jA.shape)
    assert (r["lat_A"], r["lon_A"]) == pytest.approx((g.lat[j].item(), g.lon[i].item()))

    out2 = str(tmp_path / "orbits")
    assert generate_orbit_plots.main(["--out", out2, "--device", "cpu"]) == 0
    assert any(f.endswith(".png") for f in os.listdir(out2))


def test_astro_plot_clis_without_matplotlib(tmp_path, monkeypatch, capsys):
    """Without matplotlib each CLI prints its numbers and one line saying so,
    and writes no PNG."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out, out2 = str(tmp_path / "isr"), str(tmp_path / "orbits")
    assert diag_isr.main(["--nlat", "19", "--nlon", "36", "--out", out,
                          "--device", "cpu"]) == 0
    assert generate_orbit_plots.main(["--out", out2, "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("[ISR] t=0.00 d | max A=")
    assert lines[1] == "[ISR] matplotlib is not installed: no panels are written"
    assert lines[2].startswith("[Orbits] T_binary=")
    assert lines[3] == "[Orbits] matplotlib is not installed: no figure is written"
    assert len(lines) == 4
    assert not os.path.exists(out) and not os.path.exists(out2)


def test_astro_clis_default_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod, argv in ((verify_calculation, []), (diag_isr, ["--out", str(tmp_path)]),
                      (generate_orbit_plots, ["--out", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mod.main(argv)
