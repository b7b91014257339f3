"""What one rank of ``tests/test_torch_parallel.py`` runs, in a module of its
own: ``parallel.mesh.spawn_ranks`` starts fresh processes, which import the
rank's function by module name, and this module imports neither JAX nor
pytest."""

import tempfile

import torch

import chip_smoke
from qingdai_tpu_torch import assim as A
from qingdai_tpu_torch import convert, entry
from qingdai_tpu_torch import ensemble as E
from qingdai_tpu_torch import model as M
from qingdai_tpu_torch.ecology import diversity
from qingdai_tpu_torch.parallel.mesh import gather_state, shard_model_statics, shard_state

N_LAT, N_LON = 19, 36
FLAGSHIP = {"QD_ECO_RAND_SEED": "7"}
ENS_FIELDS = ("T_s", "sst", "h", "q", "u", "v")


def rank_checks(mesh, inputs, warm, n_steps, ens_members, ens_steps):
    """Every sharded check of one rank: ``chip_smoke.par_sharded_ops``; the
    flagship planet at dt 7200 s from the JAX package's ``warm`` state for
    ``n_steps`` steps (the gathered state after the first and the last)
    and its diversity diagnostics;
    the ensemble of ``ens_members`` members at dt 300 s over the member mesh
    for ``ens_steps`` steps (gathered, with its analysis fields). Rank 0
    returns them, the others None."""
    out = {"ops": chip_smoke.par_sharded_ops(mesh, inputs)}

    mdl, _ = entry.build_world(N_LAT, N_LON, dt_seconds=7200.0, extra_env=FLAGSHIP,
                               device="cpu", dtype=torch.float64)
    mdl = shard_model_statics(mdl, mesh)
    step = M.make_chunk_fn(mdl, 1)
    st = shard_state(warm, mesh, N_LON)
    for i in range(n_steps):
        st, _ = step(st)
        if i in (0, n_steps - 1):
            out[f"step{i + 1}"] = gather_state(st, mesh, N_LON)
    g = mdl.grid
    with tempfile.TemporaryDirectory() as tmp:
        out["diversity"] = diversity.compute_and_plot(
            g.lat, g.lon, g.lat_mesh, st.eco, mdl.static.land_mask, 1.0, tmp, plot=False,
            mesh=mesh)

    mdl, _ = entry.build_world(N_LAT, N_LON, device="cpu", dtype=torch.float64)
    ens, gens = E.init_ensemble(mdl, ens_members, h_amp=20.0)
    ens, gens = E.shard_ensemble(ens, mesh, gens)
    ens, _ = E.make_ensemble_chunk_fn(mdl, ens_steps)(ens, gens)
    whole = E.gather_ensemble(ens, mesh)
    out["ens"] = convert.world_to_numpy(whole)
    out["ens_X"] = A.gather_fields(whole, ENS_FIELDS)
    return out if mesh.rank == 0 else None
