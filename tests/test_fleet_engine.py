"""Fleet engine (batched tick around one batched solve) vs vmapped engine."""

import numpy as np
import pytest

import jax

from mpc_for_av_at_intersection_tpu import api
from mpc_for_av_at_intersection_tpu.engine import (
    EngineConfig,
    run_episode,
    run_fleet_episodes,
)
from mpc_for_av_at_intersection_tpu.parallel import (
    run_batch_episodes,
    stack_states,
    stack_worlds,
)


def test_fleet_engine_matches_vmapped_engine():
    rng = np.random.default_rng(0)
    geom, worlds, states, _ = api.sample_intersection_fleet(6, rng, n_steps=40)
    wb, sb = stack_worlds(worlds), stack_states(states)
    cfg = EngineConfig()

    f_ref, t_ref = jax.jit(jax.vmap(
        lambda w, s: run_episode(w, s, cfg, geom, 40)))(wb, sb)
    f_new, t_new = jax.jit(
        lambda w, s: run_fleet_episodes(w, s, cfg, geom, 40)
    )(wb, sb)

    # telemetry from the vmapped path is (B, T, ...); fleet path is (T, B, ...)
    np.testing.assert_allclose(
        np.asarray(t_new.x).T, np.asarray(t_ref.x), atol=2e-4
    )
    np.testing.assert_allclose(
        np.asarray(t_new.steer).T, np.asarray(t_ref.steer), atol=5e-4
    )
    np.testing.assert_allclose(
        np.asarray(f_new.ego), np.asarray(f_ref.ego), atol=2e-4
    )
    np.testing.assert_array_equal(
        np.asarray(f_new.done), np.asarray(f_ref.done)
    )


def test_fleet_fast_path_through_batch_runner():
    """run_batch_episodes (the dispatched runner) returns the uniform
    (B, T) telemetry layout and matches vmap(run_episode)'s outcome."""
    rng = np.random.default_rng(1)
    geom, worlds, states, _ = api.sample_intersection_fleet(4, rng, n_steps=25)
    wb, sb = stack_worlds(worlds), stack_states(states)
    cfg = EngineConfig()

    f1, t1 = jax.jit(jax.vmap(
        lambda w, s: run_episode(w, s, cfg, geom, 25)))(wb, sb)
    f2, t2, s2 = run_batch_episodes(wb, sb, cfg, geom, 25)
    assert np.asarray(t2.x).shape == np.asarray(t1.x).shape
    np.testing.assert_allclose(np.asarray(t2.x), np.asarray(t1.x), atol=2e-4)
    assert int(np.asarray(f1.done).sum()) == int(s2["n_done"])


def test_batched_fleet_builder_matches_loop_builder():
    """sample_intersection_fleet_batched must reproduce the per-scenario
    loop builder exactly (same rng -> element-wise identical stacked
    arrays)."""
    rng_a = np.random.default_rng(77)
    rng_b = np.random.default_rng(77)
    n = 40
    _, worlds, states, meta_l = api.sample_intersection_fleet(
        n, rng_a, n_steps=50)
    wb_ref, sb_ref = stack_worlds(worlds), stack_states(states)
    _, wb, sb, meta = api.sample_intersection_fleet_batched(
        n, rng_b, n_steps=50)

    for a, b in zip(jax.tree.leaves(wb_ref), jax.tree.leaves(wb)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree.leaves(sb_ref), jax.tree.leaves(sb)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(
        meta["start_pos"], [m["start_pos"] for m in meta_l])
    np.testing.assert_array_equal(
        meta["n_agents"], [m["n_agents"] for m in meta_l])


def test_sampled_geometry_fleet_reaches_goals():
    """sample_intersection_fleet_geom: per-scenario junction geometry
    (road / median / corner radius sampled), planned per scenario, runs
    closed-loop to the goal."""
    rng = np.random.default_rng(11)
    geom, wb, sb, meta = api.sample_intersection_fleet_geom(
        3, rng, n_steps=220, planner="native")
    # geometries actually vary
    assert len(set(np.round(meta["road"], 3))) == 3
    cfg = EngineConfig()
    final, tel, _ = run_batch_episodes(wb, sb, cfg, geom, 220)
    assert np.asarray(final.done).all(), np.asarray(final.ticks_to_goal)
    assert (~np.asarray(tel.solved)).sum() == 0
