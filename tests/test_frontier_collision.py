"""The beam planner's frontier collision test vs the host planner's check.

``lattice.wavefront.frontier_collision`` (one XLA broadcast over frontier
poses x primitives x check points x obstacles x half-planes) must flag
exactly the (pose, primitive) pairs for which the host-side NumPy check
(``worlds.obstacles.check_collision`` against every obstacle's margin-grown
half-planes, the test the host search applies) finds a collision.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mpc_for_av_at_intersection_tpu.lattice import primitive_table
from mpc_for_av_at_intersection_tpu.lattice.wavefront import (
    frontier_collision,
    prepare_primitives,
)
from mpc_for_av_at_intersection_tpu.models import bicycle_geometry
from mpc_for_av_at_intersection_tpu.worlds import (
    compile_scenario,
    intersection,
    roundabout,
    t_intersection,
)
from mpc_for_av_at_intersection_tpu.worlds.obstacles import check_collision


def _frontier_poses(start, n, seed=0):
    rng = np.random.default_rng(seed)
    ep = np.tile(np.asarray(start, np.float64), (n, 1))
    ep[:, 0] += rng.uniform(-20, 20, n)
    ep[:, 1] += rng.uniform(-20, 20, n)
    ep[:, 2] = rng.uniform(-np.pi, np.pi, n)
    return ep


def _host_collide(sc, ep, prims, margin):
    """(F, P) host-side oracle: transform each primitive's valid check
    points to the frontier pose and test them against every obstacle."""
    hps = [o.halfplanes(margin=margin) for o in sc.obstacles]
    F, P = ep.shape[0], prims.cc.shape[0]
    out = np.zeros((F, P), bool)
    for f in range(F):
        c, s = np.cos(ep[f, 2]), np.sin(ep[f, 2])
        for p in range(P):
            pts = prims.cc[p][prims.cc_mask[p]].astype(np.float64)
            wx = ep[f, 0] + c * pts[:, 0] - s * pts[:, 1]
            wy = ep[f, 1] + s * pts[:, 0] + c * pts[:, 1]
            xy = np.stack([wx, wy], axis=1)
            out[f, p] = any(check_collision(hp, xy) for hp in hps)
    return out


def _setup(sc):
    geom = bicycle_geometry()
    prims = prepare_primitives(primitive_table(geom), geom)
    arr = compile_scenario(sc, margin=geom.radius)
    return geom, prims, arr


@pytest.mark.parametrize("sc", [
    intersection(turn_indicator=1, start_pos=4),
    t_intersection(turn_indicator=2, start_pos=4),
    roundabout(turn_indicator=1, start_pos=1),
], ids=["intersection", "t_intersection", "roundabout"])
def test_frontier_collision_matches_host_check(sc):
    geom, prims, arr = _setup(sc)
    ep = _frontier_poses(arr.start, 48)
    got = np.asarray(jax.jit(frontier_collision)(
        jnp.asarray(ep, jnp.float32), prims.cc, prims.cc_mask,
        jnp.asarray(arr.halfplanes, jnp.float32),
        jnp.asarray(arr.obstacle_valid)))
    want = _host_collide(sc, ep, prims, geom.radius)
    # a check point within float32 rounding of a half-plane boundary may
    # flip; anything beyond one such pair is a real disagreement
    assert np.sum(got != want) <= 1
    # the random frontier must produce a mix of hits and misses
    assert 0 < int(want.sum()) < want.size


def test_frontier_collision_under_vmap():
    """Two junctions batched under vmap (the planner's layout) give each
    junction's own unbatched answer."""
    scs = [intersection(turn_indicator=1, start_pos=4),
           intersection(turn_indicator=2, start_pos=1)]
    geom, prims, _ = _setup(scs[0])
    arrs = [compile_scenario(s, margin=geom.radius) for s in scs]
    hp = jnp.asarray(np.stack([a.halfplanes for a in arrs]), jnp.float32)
    ov = jnp.asarray(np.stack([a.obstacle_valid for a in arrs]))
    eps = jnp.asarray(np.stack([_frontier_poses(a.start, 32, seed=i)
                                for i, a in enumerate(arrs)]), jnp.float32)

    def one(ep, h, o):
        return frontier_collision(ep, prims.cc, prims.cc_mask, h, o)

    got = np.asarray(jax.jit(jax.vmap(one))(eps, hp, ov))
    for i in range(2):
        np.testing.assert_array_equal(got[i], np.asarray(one(eps[i], hp[i], ov[i])))
        want = _host_collide(scs[i], np.asarray(eps[i], np.float64), prims,
                             geom.radius)
        assert np.sum(got[i] != want) <= 1
