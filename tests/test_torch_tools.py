"""The port's offline tools against the JAX package's scripts on the CPU: the
routing validator's numbers (float64, 19×36), the point-ecology plot, and the
topography chain (generate → plot → analyze → D8 network), whose files the
two packages write equal array by array and attribute by attribute."""

import importlib
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qingdai_tpu_torch import plot_ecology_point, validate_hydro_routing

torch.set_num_threads(1)

H, W = 19, 36


def _run(package, name, argv, monkeypatch):
    """A tool's ``main`` in-process with ``argv``: the JAX package's script
    (``scripts``) or the port's module (``qingdai_tpu_torch``)."""
    mod = importlib.import_module(f"{package}.{name}")
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + argv)
    return mod.main()


def _jax_routing_numbers(n_lat, n_lon):
    """scripts/validate_hydro_routing.py's computation with the JAX package in
    float64 (the script itself routes in the JAX package's default float32)."""
    from qingdai_tpu import hydro_network as hn
    from qingdai_tpu import topography as topo
    from qingdai_tpu.config import HydrologyConfig
    from qingdai_tpu.grid import make_grid
    from qingdai_tpu.routing import build_routing_static, init_routing_state, routing_step

    lat, lon = np.linspace(-90, 90, n_lat), np.linspace(0, 360, n_lon)
    lon_mesh, lat_mesh = np.meshgrid(lon, lat)
    land, elev = topo.create_land_sea_mask(lat_mesh, lon_mesh, seed=42)
    net = hn.build_network(lat, lon, elev, land)
    flow_to = np.asarray(net["flow_to_index"]).reshape(land.shape)
    landb = land == 1
    bad = sum(1 for j, i in np.argwhere(landb)
              if flow_to[j, i] >= 0 and not landb.ravel()[flow_to[j, i]])
    grid = make_grid(n_lat, n_lon, dtype=jnp.float64)
    rs = build_routing_static(net, grid, dtype=jnp.float64)
    cfg = HydrologyConfig(dt_hydro_hours=1.0)
    st = init_routing_state(rs, dtype=jnp.float64)
    R = jnp.where(jnp.asarray(landb), 1e-5, 0.0)
    zeros = jnp.zeros(land.shape, jnp.float64)
    st = routing_step(rs, st, cfg, R, 1800.0, zeros, zeros)
    st = routing_step(rs, st, cfg, R, 1800.0, zeros, zeros)
    mass_in = float((np.asarray(R) * np.asarray(grid.cell_area) * 3600.0).sum())
    return {"violations": bad, "ocean_inflow_kgps": float(st.ocean_inflow_kgps),
            "mass_in_kg": mass_in, "rel_err": abs(float(st.mass_error_kg)) / mass_in}


def test_routing_validator_matches_jax(monkeypatch, capsys):
    """The numbers in float64 against the JAX package's (violations equal,
    inflow, mass and closure within 1e-10); the CLI's report lines against the
    JAX script's printed report (its float32 routing agrees to the printed
    digits but for the closure's), both exiting 0."""
    got = validate_hydro_routing.validate(H, W, device="cpu", dtype=torch.float64)
    want = _jax_routing_numbers(H, W)
    assert got["ok"] and got["violations"] == want["violations"] == 0
    for k in ("ocean_inflow_kgps", "mass_in_kg"):
        assert got[k] > 0
        assert got[k] == pytest.approx(want[k], rel=1e-10), k
    assert abs(got["rel_err"] - want["rel_err"]) <= 1e-10

    monkeypatch.setenv("QD_N_LAT", str(H))
    monkeypatch.setenv("QD_N_LON", str(W))
    monkeypatch.delenv("QD_HYDRO_NETCDF", raising=False)
    with pytest.raises(SystemExit) as e:
        _run("scripts", "validate_hydro_routing", [], monkeypatch)
    assert e.value.code == 0
    jax_lines = capsys.readouterr().out.splitlines()[-5:]
    assert validate_hydro_routing.main(["--device", "cpu", "--dtype", "float64"]) == 0
    lines = capsys.readouterr().out.splitlines()
    # the closure's value aside: the port's closure identity holds exactly in
    # the routing state's dtype, the JAX script's float32 reads ~4e-9
    closure = "[Validate] mass closure relative error="
    assert lines[3].startswith(closure) and lines[3].endswith("(must be ≈ 0): OK")
    assert jax_lines[3].startswith(closure) and jax_lines[3].endswith("(must be ≈ 0): OK")
    assert lines[:3] + lines[4:] == jax_lines[:3] + jax_lines[4:]
    assert jax_lines[-1] == "[Validate] PASS"


def test_routing_validator_reads_a_network_file(tmp_path, monkeypatch):
    """QD_HYDRO_NETCDF: the network written by generate_hydrology_maps is
    loaded, its grid taken from the file, and validated on it."""
    net = str(tmp_path / "net.nc")
    _run("qingdai_tpu_torch", "generate_hydrology_maps",
         ["--out", net, "--nlat", str(H), "--nlon", str(W)], monkeypatch)
    got = validate_hydro_routing.validate(61, 120, net, device="cpu", dtype=torch.float64)
    assert got["source"] == f"Loaded network '{net}'" and got["ok"]
    procedural = validate_hydro_routing.validate(H, W, device="cpu", dtype=torch.float64)
    assert got["mass_in_kg"] == pytest.approx(procedural["mass_in_kg"], rel=1e-12)


def test_plot_ecology_point_cli(tmp_path, monkeypatch, capsys):
    """tests/test_scripts_cli.py::test_plot_ecology_point_cli on the port: the
    default world at 19×36 on the CPU, the 3×4 top-3-species panel from its
    initial state, drawn from host copies of its states."""
    monkeypatch.setenv("QD_N_LAT", str(H))
    monkeypatch.setenv("QD_N_LON", str(W))
    monkeypatch.setenv("QD_AUTOSAVE_LOAD", "0")
    monkeypatch.chdir(tmp_path)
    out = str(tmp_path / "eco")
    assert plot_ecology_point.main(["--lat", "10", "--lon", "120", "--out", out,
                                    "--device", "cpu"]) == 0
    msg = capsys.readouterr().out
    assert "[EcologyPoint] wrote" in msg
    assert any(f.endswith(".png") for f in os.listdir(out))


def test_plot_ecology_point_without_matplotlib(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("QD_N_LAT", str(H))
    monkeypatch.setenv("QD_N_LON", str(W))
    monkeypatch.setenv("QD_AUTOSAVE_LOAD", "0")
    monkeypatch.setenv("QD_HYDRO_ENABLE", "0")
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.chdir(tmp_path)
    out = str(tmp_path / "eco")
    assert plot_ecology_point.main(["--out", out, "--device", "cpu"]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == (
        "[EcologyPoint] matplotlib is not installed: no panel is written")
    assert not os.path.exists(out)


def _attrs(obj):
    """An HDF5 object's attributes; one that holds object references (the
    dimension scales' links) by its shape."""
    return {k: v.shape if isinstance(v, np.ndarray) and v.dtype.hasobject else v
            for k, v in obj.attrs.items()}


def _nc(path):
    """{name: (array, attributes)} of every variable of a NetCDF-4 file, and
    the file's own attributes under "/"."""
    import h5py
    out = {}
    with h5py.File(path, "r") as f:
        out["/"] = (np.zeros(0), _attrs(f))
        f.visititems(lambda name, obj: out.__setitem__(name, (obj[()], _attrs(obj)))
                     if isinstance(obj, h5py.Dataset) else None)
    return out


def _equal_files(a, b):
    """Every array equal bit for bit, in dtype too, and every attribute equal
    but the file's creator (``created_by``), which names the writing module."""
    fa, fb = _nc(a), _nc(b)
    assert set(fa) == set(fb) and len(fa) > 4
    for name, (xa, aa) in fa.items():
        xb, ab = fb[name]
        assert xa.dtype == xb.dtype, name
        np.testing.assert_array_equal(xa, xb, err_msg=name)
        assert set(aa) == set(ab), name
        for k in aa:
            if (name, k) == ("/", "created_by"):
                assert str(ab[k]).replace("qingdai_tpu_torch", "qingdai_tpu") == str(aa[k])
                continue
            np.testing.assert_array_equal(aa[k], ab[k], err_msg=f"{name} {k}")


def test_topography_chain_matches_jax(tmp_path, monkeypatch):
    """generate → plot → analyze → D8 network, by each package with seed 7 at
    19×36 (tests/test_scripts_cli.py::test_topography_chain): the topography
    files, the statistics and the network files are equal."""
    for key in [k for k in os.environ if k.startswith("QD_")]:
        monkeypatch.delenv(key)
    files = {}
    for package in ("scripts", "qingdai_tpu_torch"):
        d = tmp_path / package
        topo, png = str(d / "topo.nc"), str(d / "topo.png")
        stats, net = str(d / "stats.json"), str(d / "net.nc")
        _run(package, "generate_topography",
             ["--nlat", str(H), "--nlon", str(W), "--seed", "7", "--out", topo], monkeypatch)
        _run(package, "plot_topography", ["--topo", topo, "--out", png], monkeypatch)
        assert os.path.getsize(png) > 0
        _run(package, "analyze_topography", ["--topo", topo, "--out", stats], monkeypatch)
        _run(package, "generate_hydrology_maps",
             ["--topo", topo, "--out", net, "--nlat", str(H), "--nlon", str(W)], monkeypatch)
        files[package] = (topo, stats, net)
    (jt, js, jn), (tt, ts, tn) = files["scripts"], files["qingdai_tpu_torch"]
    _equal_files(jt, tt)
    with open(js) as f, open(ts) as g:
        s = json.load(g)
        assert s == json.load(f)
    assert s["max_elevation_m"] > 0 and 0.0 < s["land_fraction_area_weighted"] < 1.0
    _equal_files(jn, tn)
    from qingdai_tpu_torch.hydro_network import load_network_netcdf
    assert np.asarray(load_network_netcdf(tn)["flow_to_index"]).size == H * W


@pytest.mark.parametrize("tool,argv", [
    ("generate_topography", ["--nlat", "10", "--nlon", "20", "--out", "t.nc"]),
    ("generate_hydrology_maps", ["--nlat", "10", "--nlon", "20", "--out", "n.nc"])])
def test_file_tools_raise_without_a_netcdf_library(tmp_path, monkeypatch, tool, argv):
    """Without netCDF4 and h5py a tool that writes a file raises and names
    h5py; it writes nothing."""
    monkeypatch.chdir(tmp_path)
    for name in ("h5py", "netCDF4"):
        monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.delitem(sys.modules, "qingdai_tpu_torch.io.ncdataset")
    with pytest.raises(ImportError, match="h5py"):
        _run("qingdai_tpu_torch", tool, argv, monkeypatch)
    assert not os.path.exists(argv[-1])
