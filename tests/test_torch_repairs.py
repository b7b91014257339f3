"""The port stands alone: it imports neither JAX nor the JAX package (nor its
scripts), keeps its own copies of the configuration catalog, the topography
generator and exporter, the point-ecology plots, the double buffers, the
scalar plant, the spin-up tools' host math and the host tools' ``main``
(equal to the JAX package's), and its entry points run on the card unless
the caller asks for the CPU. The root ``conftest.py`` queues the heavy test
files first."""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from qingdai_tpu import config as JC
from qingdai_tpu import flags
from qingdai_tpu import topography as jtopo
from qingdai_tpu_torch import config as TC
from qingdai_tpu_torch import (assimilate, calibrate_joint, convert, diag_isr, entry,
                               generate_orbit_plots, grid, model, plot_ecology_point,
                               regrid_restart, run_simulation, sensitivity, spinup,
                               validate_hydro_routing, verify_calculation, world)
from qingdai_tpu_torch import topography as ttopo

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "qingdai_tpu", "__graft_entry__", "scripts")


def _port_sources():
    return sorted((REPO / "qingdai_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _absolute_imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_no_jax():
    """No file of the port and not chip_smoke.py imports JAX, the JAX
    package, its scripts or the JAX entry module, at any place in the file."""
    assert len(_port_sources()) > 30
    names = {p.relative_to(REPO).as_posix() for p in _port_sources()}
    assert {"qingdai_tpu_torch/io/netcdf.py", "qingdai_tpu_torch/io/ncdataset.py",
            "qingdai_tpu_torch/io/checkpoint.py", "qingdai_tpu_torch/world.py",
            "qingdai_tpu_torch/routing.py", "qingdai_tpu_torch/hydro_network.py",
            "qingdai_tpu_torch/run_simulation.py", "qingdai_tpu_torch/ensemble.py",
            "qingdai_tpu_torch/run_ensemble.py", "qingdai_tpu_torch/ops/members.py",
            "qingdai_tpu_torch/adjoint.py", "qingdai_tpu_torch/sensitivity.py",
            "qingdai_tpu_torch/calibrate_joint.py", "qingdai_tpu_torch/assim.py",
            "qingdai_tpu_torch/assimilate.py", "qingdai_tpu_torch/spinup.py",
            "qingdai_tpu_torch/regrid_restart.py", "qingdai_tpu_torch/ecology/diversity.py",
            "qingdai_tpu_torch/viz/plots.py", "qingdai_tpu_torch/viz/ploter.py",
            "qingdai_tpu_torch/parallel/__init__.py", "qingdai_tpu_torch/parallel/mesh.py",
            "qingdai_tpu_torch/parallel/halo.py", "qingdai_tpu_torch/parallel/dryrun.py",
            "qingdai_tpu_torch/numerics/double_buffer.py", "qingdai_tpu_torch/ecology/plant.py",
            "qingdai_tpu_torch/verify_calculation.py", "qingdai_tpu_torch/generate_orbit_plots.py",
            "qingdai_tpu_torch/diag_isr.py", "qingdai_tpu_torch/validate_hydro_routing.py",
            "qingdai_tpu_torch/plot_ecology_point.py", "qingdai_tpu_torch/generate_topography.py",
            "qingdai_tpu_torch/plot_topography.py", "qingdai_tpu_torch/analyze_topography.py",
            "qingdai_tpu_torch/generate_hydrology_maps.py"} <= names
    bad = [(p.relative_to(REPO).as_posix(), m) for p in _port_sources()
           for m in _absolute_imports(p) if m.split(".")[0] in FORBIDDEN]
    assert bad == []


ENVS = {
    "default": {},
    "overrides": {"QD_N_LAT": "37", "QD_DT_SECONDS": "600", "QD_ECO_NS": "6",
                  "QD_PHYTO_NSPECIES": "4", "QD_OCEAN_K4_NSUB": "2", "QD_HYDRO_ENABLE": "0",
                  "QD_ENERGY_AUDIT": "1", "QD_DIAG_EVERY": "24", "QD_ECO_RAND_SEED": "3",
                  "QD_PHYTO_KD0": "0.03,0.04", "QD_ECO_SPECTRAL_RANGE_NM": "400,700"},
    "switches_off": {"QD_USE_OCEAN": "0", "QD_ECO_ENABLE": "0", "QD_PHYTO_ENABLE": "0",
                     "QD_CLOUD_ADVECT": "0", "QD_OCEAN_OUTLIER": "clamp"},
}


@pytest.mark.parametrize("env", sorted(ENVS))
def test_config_matches_jax(monkeypatch, env):
    """SimConfig.from_env() of the port equals the JAX package's, field by
    field, under the default environment and a few QD_* overrides."""
    for k in [k for k in __import__("os").environ if k.startswith("QD_")]:
        monkeypatch.delenv(k)
    for k, v in ENVS[env].items():
        monkeypatch.setenv(k, v)
    try:
        assert dataclasses.asdict(TC.SimConfig.from_env()) == dataclasses.asdict(
            JC.SimConfig.from_env())
    finally:
        monkeypatch.undo()
        flags.refresh()      # the JAX config froze its gates from this env


@pytest.mark.parametrize("seed,shape", [(42, (19, 36)), (7, (46, 90))])
def test_topography_matches_jax(seed, shape):
    lat, lon = np.linspace(-90, 90, shape[0]), np.linspace(0, 360, shape[1])
    lon_mesh, lat_mesh = np.meshgrid(lon, lat)
    jm, je = jtopo.create_land_sea_mask(lat_mesh, lon_mesh, seed=seed)
    tm, te = ttopo.create_land_sea_mask(lat_mesh, lon_mesh, seed=seed)
    np.testing.assert_array_equal(jm, tm)
    np.testing.assert_array_equal(je, te)
    for a, b in zip(jtopo.generate_base_properties(jm, je, lat_mesh),
                    ttopo.generate_base_properties(tm, te, lat_mesh)):
        np.testing.assert_array_equal(a, b)


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a card the default device raises; it never runs on the CPU.
    (A card's presence is masked, so this runs the same everywhere.)"""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env = {"QD_HYDRO_ENABLE": "0"}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry.build_world(19, 36, extra_env=env)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        grid.make_grid(19, 36)
    mdl, st = entry.build_world(19, 36, extra_env=env, device="cpu")
    assert mdl.device.type == "cpu" and st.atmos.u.device.type == "cpu"
    mask = mdl.static.land_mask.numpy()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.build_model(mdl.cfg, mask, mask * 0.3, mask * 1e-6)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.world_from_numpy(st)


def test_one_rank_mesh_calls_no_collective(monkeypatch):
    """A mesh of one rank (no process group) calls no collective:
    ``torch.distributed`` refuses a send to its own rank. Its sharded step
    equals the unsharded step bit for bit."""
    import torch.distributed as dist

    from qingdai_tpu_torch.parallel import halo
    from qingdai_tpu_torch.parallel.mesh import make_mesh, shard_model_statics, shard_state

    def refuse(*a, **k):
        raise AssertionError("a one-rank mesh called a collective")

    for name in ("all_reduce", "all_gather", "batch_isend_irecv", "isend", "irecv", "barrier"):
        monkeypatch.setattr(dist, name, refuse)
    mesh = make_mesh("gloo", "cpu")
    assert mesh.n == 1 and mesh.group is None
    mdl, st = entry.build_world(19, 36, device="cpu", dtype=torch.float64)
    x = torch.arange(19 * 36, dtype=torch.float64).reshape(19, 36)
    for mode in ("wrap", "reflect", "nearest"):
        assert halo.pad_lon(x, 3, mode, mesh).shape == (19, 42)
    assert torch.equal(halo.all_gather_lon(x, mesh), x)
    assert torch.equal(halo.gsum(x, mesh), torch.sum(x))
    one = model.make_step_fn(shard_model_statics(mdl, mesh))(shard_state(st, mesh, 36))
    ref = model.make_step_fn(mdl)(st)
    got, want = convert.world_to_numpy(one[0]), convert.world_to_numpy(ref[0])
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert mesh.stats["collectives"] == 0


def test_nccl_needs_a_card_a_rank(monkeypatch):
    """More NCCL ranks than cards raise and name the gloo backend; nothing
    switches backend by itself, and the mesh's entry points default to the
    card."""
    from qingdai_tpu_torch.parallel import dryrun
    from qingdai_tpu_torch.parallel.mesh import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        make_mesh("nccl", "cuda", rank=0, world_size=2, init_method="file:///nonexistent")
    with pytest.raises(ValueError, match="gloo"):
        make_mesh("nccl", "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh("gloo")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.main(["--nproc", "2", "--backend", "gloo"])


def _members(module):
    """{name: source} of the functions and classes defined in ``module``."""
    import inspect
    return {n: inspect.getsource(o) for n, o in vars(module).items()
            if (inspect.isfunction(o) or inspect.isclass(o)) and o.__module__ == module.__name__}


@pytest.mark.parametrize("name", ["hydro_network", "io.ncdataset", "topography", "viz.ploter",
                                  "numerics.double_buffer"])
def test_copies_equal_their_originals(name):
    """Every function and class of the port's copies of JAX-free modules has
    the source of the original's, the package's own name aside (a file's
    creator attribute); the topography copy holds the generator, the
    exporter and the reader."""
    import importlib
    orig = _members(importlib.import_module(f"qingdai_tpu.{name}"))
    copy = _members(importlib.import_module(f"qingdai_tpu_torch.{name}"))
    assert set(copy) == set(orig)
    for n, src in orig.items():
        assert copy[n].replace("qingdai_tpu_torch", "qingdai_tpu") == src, n


def test_driver_and_cli_default_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        world.QingdaiWorld()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_simulation.main([])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sensitivity.main(["--json"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calibrate_joint.main(["--json"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        assimilate.main(["--json"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        spinup.main(["--phase1-years", "0.001"])
    for cli in (verify_calculation, generate_orbit_plots, diag_isr, validate_hydro_routing,
                plot_ecology_point):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main([])
    assert not (tmp_path / "data").exists() and not (tmp_path / "output").exists()


def test_plant_scalar_part_equals_the_original():
    """The scalar plant (its state enum, report, stress knob and ``Plant``) is
    the JAX package's source; the pool is the port's own."""
    import inspect

    from qingdai_tpu.ecology import plant as jplant
    from qingdai_tpu_torch.ecology import plant as tplant
    for n in ("PlantState", "PlantReport", "_stress_days_env", "Plant"):
        assert inspect.getsource(getattr(tplant, n)) == inspect.getsource(getattr(jplant, n)), n
    assert tplant.MATURE_LEAF_AREA == jplant.MATURE_LEAF_AREA


@pytest.mark.parametrize("tool", ["generate_topography", "plot_topography",
                                  "analyze_topography", "generate_hydrology_maps"])
def test_host_tools_main_equals_the_scripts(tool):
    """The four topography and hydrology tools are NumPy on the host: each
    one's ``main`` is the JAX script's, over the port's own copies of
    ``topography``, ``hydro_network`` and ``constants``."""
    import importlib
    import inspect
    orig = importlib.import_module(f"scripts.{tool}")
    copy = importlib.import_module(f"qingdai_tpu_torch.{tool}")
    assert inspect.getsource(copy.main) == inspect.getsource(orig.main)
    for alias in ("topo", "hn", "const"):
        if hasattr(orig, alias):
            assert getattr(copy, alias).__name__ == getattr(orig, alias).__name__.replace(
                "qingdai_tpu", "qingdai_tpu_torch")


# mirrors of tests/test_numerics.py on the port's copy of the double buffers

def test_read_write_isolation():
    from qingdai_tpu_torch.numerics.double_buffer import DoubleBufferingArray
    d = DoubleBufferingArray((4, 4))
    d[0, 0] = 5.0
    assert d[0, 0] == 0.0
    assert d.write[0, 0] == 5.0
    d.swap()
    assert d[0, 0] == 5.0


def test_sync_and_ufunc_out():
    from qingdai_tpu_torch.numerics.double_buffer import DoubleBufferingArray
    d = DoubleBufferingArray(np.arange(6.0).reshape(2, 3))
    np.multiply(d, 2.0, out=d)
    assert np.allclose(d.read, np.arange(6.0).reshape(2, 3))
    d.swap()
    assert np.allclose(d.read, 2.0 * np.arange(6.0).reshape(2, 3))
    d.sync()
    assert np.allclose(d.write, d.read)


def test_divmod_tuple_out():
    from qingdai_tpu_torch.numerics.double_buffer import DoubleBufferingArray
    d = DoubleBufferingArray(np.arange(1.0, 7.0).reshape(2, 3))
    q = DoubleBufferingArray((2, 3))
    r = DoubleBufferingArray((2, 3))
    np.divmod(d, 2.0, out=(q, r))
    q.swap()
    r.swap()
    qq, rr = np.divmod(np.arange(1.0, 7.0).reshape(2, 3), 2.0)
    assert np.allclose(q.read, qq) and np.allclose(r.read, rr)


def test_self_alias_raises():
    from qingdai_tpu_torch.numerics.double_buffer import DoubleBufferingArray
    d = DoubleBufferingArray((3,))
    with pytest.raises(ValueError):
        d[:] = d.write


def test_host_double_buffer():
    from qingdai_tpu_torch.numerics.double_buffer import HostDoubleBuffer
    buf = HostDoubleBuffer()
    assert buf.latest() is None
    buf.publish({"a": 1})
    assert buf.latest() == {"a": 1}
    buf.publish({"a": 2})
    assert buf.latest() == {"a": 2}


def test_conftest_heavy_files_are_the_marked_ones():
    """The root conftest's list of heavy files is the set of test files whose
    source carries ``pytest.mark.heavy``, and its scheduler puts their work
    units first, each group in its own order."""
    import importlib.util
    from collections import OrderedDict
    spec = importlib.util.spec_from_file_location("root_conftest", REPO / "conftest.py")
    conf = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(conf)
    def heavy(path):
        return any(isinstance(n, ast.Attribute) and n.attr == "heavy"
                   and ast.unparse(n.value) == "pytest.mark"
                   for n in ast.walk(ast.parse(path.read_text())))

    marked = sorted(p.name for p in (REPO / "tests").glob("test_*.py") if heavy(p))
    assert sorted(conf.HEAVY_FILES) == marked
    # no JAX anywhere; xdist only inside the hook, which only xdist calls
    assert not any(m.split(".")[0] in ("jax", "jaxlib")
                   for m in _absolute_imports(REPO / "conftest.py"))
    top = ast.parse((REPO / "conftest.py").read_text()).body
    assert not any(isinstance(n, ast.ImportFrom) and n.module.startswith("xdist")
                   or isinstance(n, ast.Import) and any(a.name.startswith("xdist")
                                                        for a in n.names) for n in top)
    q = OrderedDict((f"tests/{n}", {}) for n in (
        "test_torch_kernels.py", "test_assim.py", "test_ops.py", "test_adjoint.py",
        "test_numerics.py"))
    conf.heavy_first(q)
    assert list(q) == ["tests/test_assim.py", "tests/test_adjoint.py",
                       "tests/test_torch_kernels.py", "tests/test_ops.py",
                       "tests/test_numerics.py"]


@pytest.mark.parametrize("module,names", [
    ("regrid_restart", ("regrid_bilinear",)),
    ("spinup", ("acceptance_metrics", "_pick_trend", "build_criteria"))])
def test_spinup_host_math_equals_the_scripts(module, names):
    """The spin-up tools' host math is the JAX scripts' source, the import of
    the planet's year aside (the port's own orbital module)."""
    import importlib
    import inspect
    orig = importlib.import_module(f"scripts.{module}")
    copy = {"regrid_restart": regrid_restart, "spinup": spinup}[module]
    for n in names:
        src = inspect.getsource(getattr(copy, n)).replace(
            "from .physics.orbital import", "from qingdai_tpu.physics.orbital import")
        assert src == inspect.getsource(getattr(orig, n)), n
    if module == "spinup":
        assert (copy.KEYS, copy.OPT_KEYS, copy.AUD_INTERNAL) == (orig.KEYS, orig.OPT_KEYS,
                                                                  orig.AUD_INTERNAL)
