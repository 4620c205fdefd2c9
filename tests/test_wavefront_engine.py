"""Device-planned course feeding the closed-loop engine: the full
on-device bi-level pipeline (wavefront plan -> batched MPC tracking)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mpc_for_av_at_intersection_tpu.agents import stack_agents
from mpc_for_av_at_intersection_tpu.engine import (
    EngineConfig,
    init_engine_state,
    make_world,
    run_episode,
)
from mpc_for_av_at_intersection_tpu.lattice import (
    WavefrontConfig,
    prepare_primitives,
    primitive_table,
    wavefront_search,
)
from mpc_for_av_at_intersection_tpu.models import bicycle_geometry
from mpc_for_av_at_intersection_tpu.worlds import compile_scenario, intersection


def test_wavefront_plan_drives_closed_loop():
    geom = bicycle_geometry()
    table = primitive_table(geom)
    prims = prepare_primitives(table, geom)
    sc = intersection(turn_indicator=1, start_pos=4)
    arrs = compile_scenario(sc, margin=geom.radius)

    res = jax.jit(
        lambda: wavefront_search(
            jnp.asarray(arrs.halfplanes, jnp.float32),
            jnp.asarray(arrs.obstacle_valid),
            jnp.asarray(arrs.start, jnp.float32),
            jnp.asarray(arrs.goal_point, jnp.float32),
            jnp.asarray(arrs.goal_area_corners, jnp.float32),
            jnp.asarray(arrs.goal_theta_tol, jnp.float32),
            prims, WavefrontConfig(),
        )
    )()
    assert bool(res.found)
    traj = np.asarray(res.trajectory)[: int(res.n_points)].astype(np.float64)

    cfg = EngineConfig()
    params, ag = stack_agents([], n_slots=cfg.n_agents)
    world = make_world(traj, params, cfg)
    st0 = init_engine_state(world, ag, cfg, 200)
    run = jax.jit(lambda w, s: run_episode(w, s, cfg, geom, 200))
    final, tel = run(world, st0)
    tel = jax.tree.map(np.asarray, tel)

    assert bool(final.done), "ego did not finish on the device-planned course"
    k = int(final.ticks_to_goal)
    assert np.hypot(tel.x[k - 1] - traj[-1, 0], tel.y[k - 1] - traj[-1, 1]) < 1.6
    assert tel.solved.all()
