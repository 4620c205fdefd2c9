"""Fleet engine: natively batched closed-loop ticks.

The plain batched runner vmaps the whole per-scenario tick, which forces
the QP solver through vmapped small ops. This path splits the tick around
the solver — vmap(pre) -> mpc_step_batched (one batched solve) ->
vmap(post) — for fleet-scale throughput. Semantically identical to
vmap(engine_tick); covered by an equivalence test.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..agents import agents_get, agents_step, predict_constant_control
from ..backend import fp32_matmuls
from ..models import VehicleGeometry
from ..mpc.batch import mpc_step_batched
from .closed_loop import (
    EngineConfig,
    EngineState,
    WorldArrays,
    ego_subtick_post,
    ego_subtick_pre,
)


@fp32_matmuls
def engine_tick_fleet(
    world: WorldArrays,     # batched along leading axis
    st: EngineState,        # batched
    cfg: EngineConfig,
    geom: VehicleGeometry,
):
    dt = cfg.mpc.dt

    obs6 = jax.vmap(lambda p, s: agents_get(p, s, dt))(world.agent_params, st.agents)
    preds = predict_constant_control(obs6, dt, geom.wheelbase, cfg.n_pred)

    def pre_vmap(course, n, dl, goal, ego, ctrl, cut, aidx, first, done,
                 pr, act):
        return jax.vmap(
            lambda course, n, dl, goal, ego, ctrl, cut, aidx, first, done,
            pr, act: ego_subtick_pre(course, n, dl, goal, ego, ctrl, cut,
                                     aidx, first, done, pr, act, cfg, geom)
        )(course, n, dl, goal, ego, ctrl, cut, aidx, first, done, pr, act)

    pre = pre_vmap(
        world.course, world.n_course, world.dl, world.goal_xy,
        st.ego, st.ctrl, st.cutoff_len, st.agent_idx, st.first_tick, st.done,
        preds, world.agent_params.active,
    )
    done_now, agent_idx, scan, cutoff_len, course_len_for_mpc, cv = pre

    out = mpc_step_batched(
        st.ego, world.course, cv, course_len_for_mpc, world.dl,
        st.ctrl, cfg.mpc, geom.wheelbase,
    )

    (ego, ctrl, cutoff_out, aidx_out, done_out), tel = jax.vmap(
        lambda course, ego, c, dn, ai, sc, cl, o:
        ego_subtick_post(course, ego, c, dn, ai, sc, cl, o, cfg, geom)
    )(world.course, st.ego, st.ctrl, done_now, agent_idx, scan, cutoff_len, out)

    agents = jax.vmap(lambda p, s: agents_step(p, s, dt, geom.wheelbase))(
        world.agent_params, st.agents
    )
    agents = jax.tree.map(
        lambda a, b: jnp.where(
            done_now.reshape((-1,) + (1,) * (a.ndim - 1)), b, a
        ),
        agents, st.agents,
    )

    new_st = EngineState(
        ego=ego,
        ctrl=ctrl,
        agents=agents,
        cutoff_len=jnp.where(done_now, st.cutoff_len, cutoff_out),
        agent_idx=jnp.where(done_now, st.agent_idx, aidx_out),
        first_tick=jnp.zeros_like(st.first_tick) | (st.first_tick & done_now),
        done=done_now,
        ticks_to_goal=jnp.where(done_now & ~st.done, st.tick, st.ticks_to_goal),
        tick=st.tick + 1,
    )
    return new_st, tel


def run_fleet_episodes(
    world: WorldArrays,
    state0: EngineState,
    cfg: EngineConfig,
    geom: VehicleGeometry,
    n_steps: int,
):
    def step(st, _):
        return engine_tick_fleet(world, st, cfg, geom)

    return jax.lax.scan(step, state0, None, length=n_steps)
