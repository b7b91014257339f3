"""The port stands alone: it imports neither JAX nor the JAX package, keeps
its own copies of the configuration catalog and the topography generator
(equal to the JAX package's), and its entry points run on the card unless
the caller asks for the CPU."""

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
from qingdai_tpu_torch import convert, entry, grid, model
from qingdai_tpu_torch import topography as ttopo

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "qingdai_tpu", "__graft_entry__")


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
    package or the JAX entry module, at any place in the file."""
    assert len(_port_sources()) > 30
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
