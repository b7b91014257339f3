"""The port's river routing against the JAX package's, on the CPU in float64.

Each case builds the routing statics of both packages from one network
dict, drives both ``routing_step``s with the same seeded runoff,
precipitation and evaporation, and compares every ``RoutingState`` leaf to
1e-12 relative to the leaf's largest |value|. Two leaves are differences of
routed sums, ``mass_error_kg`` and ``stranded_kg``, and can cancel to
rounding noise: their scale is the larger of that and ``routed_mass_kg``.
The firing step is compared in float32 and float64.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qingdai_tpu import grid as jgrid
from qingdai_tpu import hydro_network as jhn
from qingdai_tpu import routing as jr
from qingdai_tpu import topography as jtopo
from qingdai_tpu.config import HydrologyConfig as JHydro
from qingdai_tpu_torch import convert
from qingdai_tpu_torch import grid as tgrid
from qingdai_tpu_torch import hydro_network as thn
from qingdai_tpu_torch import routing as tr
from qingdai_tpu_torch.config import HydrologyConfig as THydro

torch.set_num_threads(1)

CANCELLING = ("mass_error_kg", "stranded_kg")


def _toy_network():
    """The network of ``tests/test_routing.py``'s ``_toy_world``."""
    rng = np.random.default_rng(0)
    lat, lon = np.linspace(-90, 90, 12), np.linspace(0, 360, 24)
    elev = rng.standard_normal((12, 24)).cumsum(axis=0) * 100.0
    land = np.zeros((12, 24), np.uint8)
    land[3:9, 4:16] = 1
    return jhn.build_network(lat, lon, elev, land)


def _kahn_network():
    """The Kahn-order lake-outlet case of ``tests/test_routing.py``: a lake
    whose outlet sits at a lower raw level but later in ``flow_order``."""
    H, W = 4, 6
    land = np.zeros((H, W), np.uint8)
    u1, u2, L, o, p = 1 * W + 1, 1 * W + 2, 1 * W + 3, 2 * W + 1, 2 * W + 2
    for c in (u1, u2, L, o, p):
        land.ravel()[c] = 1
    flow_to = np.full(H * W, -1, np.int64)
    flow_to[u1], flow_to[u2], flow_to[o] = u2, L, p
    raw_level, _ = jhn.topo_levels(flow_to, land)
    lake_mask = np.zeros(H * W, np.uint8)
    lake_mask[L] = 1
    lake_id = np.zeros(H * W, np.int32)
    lake_id[L] = 1
    return {"land_mask": land, "flow_to_index": flow_to.reshape(H, W),
            "flow_level": raw_level.reshape(H, W), "n_levels": int(raw_level.max()) + 1,
            "lake_mask": lake_mask.reshape(H, W), "lake_id": lake_id.reshape(H, W),
            "n_lakes": 1, "lake_outlet_index": np.array([o], np.int32),
            "flow_order": np.array([u1, u2, L, o, p], np.int64)}


@pytest.fixture(scope="module")
def planet_net():
    """A ``build_network`` planet at 46×90 (seed 42): 21 lakes."""
    lat, lon = np.linspace(-90, 90, 46), np.linspace(0, 360, 90)
    lon_mesh, lat_mesh = np.meshgrid(lon, lat)
    mask, elev = jtopo.create_land_sea_mask(lat_mesh, lon_mesh, seed=42)
    return (lat, lon, elev, mask), jhn.build_network(lat, lon, elev, mask)


NETS = {"toy": lambda _: _toy_network(), "kahn": lambda _: _kahn_network(),
        "planet_46x90": lambda p: p[1]}


def _forcing(shape, land, seed):
    r = np.random.default_rng(seed)
    R = np.where(land == 1, r.uniform(0.0, 2e-5, shape), r.uniform(0.0, 1e-5, shape))
    return R, r.uniform(0.0, 3e-5, shape), r.uniform(0.0, 2e-5, shape)


def _pair(net, dtype=torch.float64, dt_hydro_hours=1.0):
    shape = tuple(net["land_mask"].shape)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    jrs = jr.build_routing_static(net, jgrid.make_grid(*shape, dtype=jdt), jdt)
    trs = tr.build_routing_static(net, tgrid.make_grid(*shape, device="cpu", dtype=dtype),
                                  dtype)
    return (jrs, JHydro(dt_hydro_hours=dt_hydro_hours),
            trs, THydro(dt_hydro_hours=dt_hydro_hours))


def _leaves(rs) -> dict:
    """Every RoutingState leaf of either package as a float64 array."""
    return {f.name: np.asarray(getattr(rs, f.name), np.float64)
            for f in dataclasses.fields(tr.RoutingState)}


def _assert_routing_close(js, ts, rel=1e-12):
    ref, got = _leaves(js), _leaves(ts)
    routed = abs(float(ref["routed_mass_kg"]))
    for k, r in ref.items():
        g = got[k]
        assert r.shape == g.shape, k
        scale = float(np.max(np.abs(r), initial=0.0))
        if k in CANCELLING:
            scale = max(scale, routed)
        err = float(np.max(np.abs(r - g), initial=0.0))
        assert err <= rel * max(scale, 1e-300), (k, err, scale)


def _drive(jpair, net, steps, dt, seed=1):
    jrs, jcfg, trs, tcfg = jpair
    land = net["land_mask"]
    jstep = jax.jit(lambda st, R, P, E: jr.routing_step(jrs, st, jcfg, R, dt, P, E))
    js, ts = jr.init_routing_state(jrs, jnp.float64), tr.init_routing_state(trs)
    events = 0
    for i in range(steps):
        R, P, E = _forcing(land.shape, land, seed + i)
        js = jstep(js, *(jnp.asarray(x) for x in (R, P, E)))
        before = tr.route_event.events
        ts = tr.routing_step(trs, ts, tcfg, torch.as_tensor(R), dt, torch.as_tensor(P),
                             torch.as_tensor(E))
        events += tr.route_event.events - before
        assert float(js.t_accum) == ts.t_accum, i
    return js, ts, events


@pytest.mark.parametrize("name", sorted(NETS))
def test_routing_step_matches_jax(name, planet_net):
    """Five steps of 1800 s with a 1 h event: events at steps 2 and 4, then
    one accumulation step; every leaf after the last step."""
    net = NETS[name](planet_net)
    pair = _pair(net)
    js, ts, events = _drive(pair, net, 5, 1800.0)
    assert events == 2 and ts.t_accum == 1800.0
    assert float(js.routed_mass_kg) > 0.0
    _assert_routing_close(js, ts)
    # the decomposition identity of RoutingState, to rounding
    routed = float(ts.routed_mass_kg)
    gap = float(ts.mass_error_kg) - (float(ts.store_out_kg) - float(ts.lake_delta_kg))
    assert abs(gap) <= 1e-12 * routed
    total = float(ts.ocean_inflow_kgps) * 3600.0 + float(ts.store_out_kg) + float(ts.stranded_kg)
    assert abs(total - routed) <= 1e-12 * routed


def test_statics_match_jax(planet_net):
    """The level-sorted compaction equals the JAX package's, and the rounds
    cover every forwarding row once with unique targets in each round."""
    net = planet_net[1]
    jrs, _, trs, _ = _pair(net)
    assert (trs.n_levels, trs.n_lakes, trs.level_starts) == (jrs.n_levels, jrs.n_lakes,
                                                             jrs.level_starts)
    np.testing.assert_array_equal(trs.order.numpy(), np.asarray(jrs.order))
    np.testing.assert_array_equal(trs.to_ocean_ordered.numpy(), np.asarray(jrs.to_ocean_ordered))
    fwd = ~np.asarray(jrs.to_ocean_ordered | jrs.to_store_ordered | jrs.backward_ordered)
    assert np.asarray(jrs.backward_ordered).any()         # stranding edges are present
    src, tgt = trs.fwd_src.numpy(), trs.fwd_tgt.numpy()
    assert sorted(src.tolist()) == np.nonzero(fwd)[0].tolist()
    np.testing.assert_array_equal(tgt, np.asarray(jrs.dn_pos_ordered)[src])
    for a, b in trs.rounds:
        assert len(set(tgt[a:b].tolist())) == b - a
    assert len(trs.level_rounds) == trs.n_levels


def test_kahn_order_lake_routes_to_the_ocean():
    """The lake's mass goes through its outlet to the ocean, as in the
    reference's sequential loop: nothing is stranded or stored."""
    net = _kahn_network()
    pair = _pair(net)
    land = net["land_mask"]
    ts = tr.init_routing_state(pair[2])
    R = torch.as_tensor(np.where(land == 1, 1e-5, 0.0))
    zero = torch.zeros(land.shape, dtype=torch.float64)
    ts = tr.routing_step(pair[2], ts, pair[3], R, 3600.0, zero, zero)
    assert abs(float(ts.ocean_inflow_kgps) * 3600.0 - float(ts.routed_mass_kg)) <= (
        1e-12 * float(ts.routed_mass_kg))
    assert float(ts.stranded_kg) == 0.0


def test_two_events_from_one_buffer_are_bit_equal(planet_net):
    net = planet_net[1]
    trs = _pair(net)[2]
    land = net["land_mask"]
    acc = torch.as_tensor(_forcing(land.shape, land, 3)[0] * 1e9).reshape(-1)
    vol = torch.zeros(max(trs.n_lakes, 1), dtype=torch.float64)
    a, b = tr.route_event(trs, acc, vol), tr.route_event(trs, acc, vol)
    assert torch.equal(a[0], b[0]) and all(torch.equal(x, y) for x, y in zip(a[1], b[1]))


@pytest.mark.parametrize("dt", [300.0, 700.0, 301.7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_firing_step_matches_jax(dt, dtype):
    """The event fires on the same steps in both packages over 160 steps
    with a 6 h event: the port's host clock is rounded to the model dtype as
    the JAX package's device scalar is."""
    net = _kahn_network()
    jrs, jcfg, trs, tcfg = _pair(net, dtype, dt_hydro_hours=6.0)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    zero_j = jnp.zeros(net["land_mask"].shape, jdt)
    zero_t = torch.zeros(net["land_mask"].shape, dtype=dtype)
    jstep = jax.jit(lambda st: jr.routing_step(jrs, st, jcfg, zero_j, dt, zero_j, zero_j))
    js, ts = jr.init_routing_state(jrs, jdt), tr.init_routing_state(trs, dtype)
    jfire, tfire = [], []
    for i in range(160):
        js, ts = jstep(js), tr.routing_step(trs, ts, tcfg, zero_t, dt, zero_t, zero_t)
        jfire += [i] if float(js.t_accum) == 0.0 else []
        tfire += [i] if ts.t_accum == 0.0 else []
        assert np.float64(np.asarray(js.t_accum)) == ts.t_accum, i
    assert jfire == tfire and len(tfire) >= 2


def test_convert_routing_group_round_trip(planet_net):
    """A JAX routing group converts into the port (``t_accum`` a host float)
    and flattens back to the same numbers."""
    net = planet_net[1]
    pair = _pair(net)
    js, _, _ = _drive(pair, net, 3, 1800.0, seed=5)
    ts = convert.world_from_numpy(js, "cpu", torch.float64)
    assert isinstance(ts, tr.RoutingState) and isinstance(ts.t_accum, float)
    assert ts.t_accum == 1800.0
    ref, got = _leaves(js), _leaves(ts)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_build_network_copy_matches_original(planet_net):
    (lat, lon, elev, mask), ref = planet_net
    got = thn.build_network(lat, lon, elev, mask)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]), err_msg=k)
    for k in ("flow_to_index", "flow_order", "lake_id", "lake_outlet_index"):
        assert np.asarray(got[k]).dtype == np.asarray(ref[k]).dtype, k
    assert ref["n_lakes"] > 0
