"""Multi-ego interactive engine: N egos crossing one intersection, each
running the full bi-level stack and predicting the others.

(The reference's interactive mode never ran — SURVEY 2.11 — so the oracle
here is outcome-based: goals reached, no ego-ego collision.)
"""

import numpy as np
import pytest

import jax

from mpc_for_av_at_intersection_tpu.agents import stack_agents
from mpc_for_av_at_intersection_tpu.engine import (
    EngineConfig,
    init_multi_ego_state,
    make_multi_ego_world,
    run_multi_ego_episode,
)
from mpc_for_av_at_intersection_tpu.lattice import (
    MotionPrimitiveSearch,
    SearchWeights,
    primitive_table,
)
from mpc_for_av_at_intersection_tpu.models import bicycle_geometry
from mpc_for_av_at_intersection_tpu.worlds import intersection

N_STEPS = 180


def _course(geom, table, start_pos, turn):
    sc = intersection(turn_indicator=turn, start_pos=start_pos)
    s = MotionPrimitiveSearch(sc, geom, table, margin=geom.radius,
                              weights=SearchWeights.modified())
    _, _, traj = s.run()
    return traj


def test_two_ego_crossing():
    geom = bicycle_geometry()
    table = primitive_table(geom)
    # ego A: south -> straight north; ego B: east -> left turn to south.
    # B's turn crosses A's lane; decentralized yielding must resolve it.
    trajs = [
        _course(geom, table, start_pos=1, turn=2),
        _course(geom, table, start_pos=4, turn=1),
    ]
    cfg = EngineConfig()
    params, ag = stack_agents([], n_slots=cfg.n_agents)
    world = make_multi_ego_world(trajs, params, cfg)
    st0 = init_multi_ego_state(world, ag, cfg, N_STEPS)

    run = jax.jit(lambda w, s: run_multi_ego_episode(w, s, cfg, geom, N_STEPS))
    final, tel = run(world, st0)
    tel = jax.tree.map(np.asarray, tel)

    assert bool(final.done[0]) and bool(final.done[1]), (
        f"egos unfinished: done={np.asarray(final.done)} "
        f"pos={np.asarray(final.egos)[:, :2]}"
    )
    for e, traj in enumerate(trajs):
        k = int(final.ticks_to_goal[e])
        d = np.hypot(tel.x[k - 1, e] - traj[-1, 0], tel.y[k - 1, e] - traj[-1, 1])
        assert d < 1.6

    # no ego-ego collision at any tick (circle clearance)
    cc = geom.circle_centers
    tmax = int(np.max(np.asarray(final.ticks_to_goal)))
    min_clear = np.inf
    for k in range(tmax):
        pa = np.array([tel.x[k, 0], tel.y[k, 0]])
        pb = np.array([tel.x[k, 1], tel.y[k, 1]])
        ya, yb = tel.yaw[k, 0], tel.yaw[k, 1]
        for cax, cay in cc:
            for cbx, cby in cc:
                a = pa + [np.cos(ya) * cax - np.sin(ya) * cay,
                          np.sin(ya) * cax + np.cos(ya) * cay]
                b = pb + [np.cos(yb) * cbx - np.sin(yb) * cby,
                          np.sin(yb) * cbx + np.cos(yb) * cby]
                min_clear = min(min_clear, np.linalg.norm(a - b))
    assert min_clear > 2 * geom.radius * 0.7, f"ego-ego clearance {min_clear}"

    # the interaction machinery must have engaged for at least one ego
    assert tel.collision_found.any()


def test_batched_tick_matches_vmapped_tick():
    """multi_ego_tick_batched (fleet-style pre -> batched solver -> post)
    must evolve the episode like the vmapped per-ego tick."""
    from mpc_for_av_at_intersection_tpu.engine.multi_ego import (
        multi_ego_tick,
        multi_ego_tick_batched,
    )

    geom = bicycle_geometry()
    table = primitive_table(geom)
    trajs = [
        _course(geom, table, start_pos=1, turn=2),
        _course(geom, table, start_pos=4, turn=1),
    ]
    cfg = EngineConfig()
    params, ag = stack_agents([], n_slots=cfg.n_agents)
    world = make_multi_ego_world(trajs, params, cfg)
    st_a = init_multi_ego_state(world, ag, cfg, 12)
    st_b = st_a

    tick_a = jax.jit(lambda s: multi_ego_tick(world, s, cfg, geom))
    tick_b = jax.jit(
        lambda s: multi_ego_tick_batched(world, s, cfg, geom)
    )
    for _ in range(12):
        st_a, tel_a = tick_a(st_a)
        st_b, tel_b = tick_b(st_b)
        np.testing.assert_allclose(
            np.asarray(st_b.egos), np.asarray(st_a.egos), atol=2e-4
        )
        assert np.array_equal(np.asarray(st_b.done), np.asarray(st_a.done))
        np.testing.assert_allclose(
            np.asarray(tel_b.accel), np.asarray(tel_a.accel), atol=2e-3
        )


def test_fleet_tick_matches_batched_tick():
    """multi_ego_fleet_tick over S stacked junction instances must evolve
    each exactly like the per-scenario batched tick."""
    from mpc_for_av_at_intersection_tpu.engine.multi_ego import (
        multi_ego_fleet_tick,
        multi_ego_tick_batched,
    )

    geom = bicycle_geometry()
    table = primitive_table(geom)
    trajs = [
        _course(geom, table, start_pos=1, turn=2),
        _course(geom, table, start_pos=4, turn=1),
    ]
    cfg = EngineConfig()
    params, ag = stack_agents([], n_slots=cfg.n_agents)
    world = make_multi_ego_world(trajs, params, cfg)
    st = init_multi_ego_state(world, ag, cfg, 12)

    S = 3
    worldS = jax.tree.map(
        lambda a: jax.numpy.broadcast_to(a, (S,) + a.shape), world)
    stS = jax.tree.map(
        lambda a: jax.numpy.broadcast_to(a, (S,) + a.shape), st)

    tick1 = jax.jit(
        lambda s: multi_ego_tick_batched(world, s, cfg, geom)
    )
    tickS = jax.jit(
        lambda w, s: multi_ego_fleet_tick(w, s, cfg, geom)
    )
    for _ in range(6):
        st, tel1 = tick1(st)
        stS, telS = tickS(worldS, stS)
        for s_i in range(S):
            np.testing.assert_allclose(
                np.asarray(stS.egos)[s_i], np.asarray(st.egos), atol=2e-4
            )
        np.testing.assert_allclose(
            np.asarray(telS.accel)[0], np.asarray(tel1.accel), atol=2e-3
        )
        assert np.array_equal(np.asarray(stS.done)[0], np.asarray(st.done))
