"""Multi-ego interactive mode: N vehicles each running the full bi-level
stack, predicting each other.

The reference *intended* this capability (``main/scenarios/interactive_mpc.py``
+ ``lib/other_agents_prediction.py``) but the committed code cannot run
(undefined names, class indexing — SURVEY section 2.11); its round-robin
design also let later egos react to earlier egos' already-updated states.
This rebuild delivers it properly the way SURVEY section 7.2.6 prescribes:
egos are a batch axis *within* the scenario, every ego plans against the
OTHER egos' start-of-tick states simultaneously (decentralized,
prediction-based, no negotiation), and all plants step together.

Prediction of peer egos is a constant-control rollout of (x, y, v, yaw,
a=0, steer=last commanded). Note: the reference's ``OtherAgentsPrediction``
doubles the peer's velocity every step (``other_agents_prediction.py:26``,
`self.v += self.v`) — a bug in code that never ran; we use the standard
constant-velocity rollout instead (documented divergence).

Scripted traffic can coexist with the egos: each ego treats (other egos +
scripted agents) uniformly as predicted obstacles.
"""

from __future__ import annotations

from typing import List, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..agents import (
    AgentParams,
    AgentStates,
    agents_get,
    agents_step,
    predict_constant_control,
)
from ..backend import fp32_matmuls
from ..models import VehicleGeometry
from ..mpc.batch import mpc_step_batched
from ..mpc.controller import ControllerState, init_controller_state
from .closed_loop import (
    EngineConfig,
    Telemetry,
    WorldArrays,
    ego_subtick,
    ego_subtick_post,
    ego_subtick_pre,
    make_world,
)


class MultiEgoWorld(NamedTuple):
    courses: jnp.ndarray      # (E, N, 3)
    n_courses: jnp.ndarray    # (E,)
    dls: jnp.ndarray          # (E,)
    goals_xy: jnp.ndarray     # (E, 2)
    agent_params: AgentParams  # scripted traffic (A,) padded


class MultiEgoState(NamedTuple):
    egos: jnp.ndarray         # (E, 4)
    ctrls: ControllerState    # fields stacked along E
    agents: AgentStates       # scripted traffic
    cutoff_lens: jnp.ndarray  # (E,)
    agent_idxs: jnp.ndarray   # (E,)
    first_tick: jnp.ndarray   # () bool
    done: jnp.ndarray         # (E,)
    ticks_to_goal: jnp.ndarray  # (E,)
    tick: jnp.ndarray         # ()


def make_multi_ego_world(
    trajectories: List[np.ndarray],
    agent_params: AgentParams,
    cfg: EngineConfig,
    dtype=jnp.float32,
) -> MultiEgoWorld:
    worlds = [make_world(t, agent_params, cfg, dtype) for t in trajectories]
    return MultiEgoWorld(
        courses=jnp.stack([w.course for w in worlds]),
        n_courses=jnp.stack([w.n_course for w in worlds]),
        dls=jnp.stack([w.dl for w in worlds]),
        goals_xy=jnp.stack([w.goal_xy for w in worlds]),
        agent_params=worlds[0].agent_params,
    )


def init_multi_ego_state(
    world: MultiEgoWorld, agent_states: AgentStates, cfg: EngineConfig,
    n_steps: int, dtype=jnp.float32,
) -> MultiEgoState:
    E = world.courses.shape[0]
    egos = jnp.concatenate(
        [
            world.courses[:, 0, :2],
            jnp.zeros((E, 1), dtype),
            world.courses[:, 0, 2:3],
        ],
        axis=1,
    ).astype(dtype)
    cs0 = init_controller_state(cfg.mpc, dtype)
    ctrls = jax.tree.map(lambda x: jnp.broadcast_to(x, (E,) + x.shape).copy(), cs0)
    return MultiEgoState(
        egos=egos,
        ctrls=ctrls,
        agents=jax.tree.map(jnp.asarray, agent_states),
        cutoff_lens=world.n_courses,
        agent_idxs=jnp.zeros((E,), jnp.int32),
        first_tick=jnp.asarray(True),
        done=jnp.zeros((E,), bool),
        ticks_to_goal=jnp.full((E,), n_steps, jnp.int32),
        tick=jnp.asarray(0, jnp.int32),
    )


@fp32_matmuls
def multi_ego_tick(
    world: MultiEgoWorld,
    st: MultiEgoState,
    cfg: EngineConfig,
    geom: VehicleGeometry,
):
    dt = cfg.mpc.dt
    E = st.egos.shape[0]
    dtype = st.egos.dtype

    # predictions: every ego (constant speed, last steer, a=0) + scripted
    ego_obs6 = jnp.stack(
        [
            st.egos[:, 0], st.egos[:, 1], st.egos[:, 2], st.egos[:, 3],
            jnp.zeros((E,), dtype), st.ctrls.last_steer,
        ],
        axis=1,
    )
    scripted_obs6 = agents_get(world.agent_params, st.agents, dt)
    all_obs6 = jnp.concatenate([ego_obs6, scripted_obs6])
    preds = predict_constant_control(all_obs6, dt, geom.wheelbase, cfg.n_pred)

    # ego i sees: all egos except itself, plus active scripted agents
    eye = jnp.eye(E, dtype=bool)
    ego_active = ~eye                                           # (E, E)
    scripted_active = jnp.broadcast_to(
        world.agent_params.active, (E,) + world.agent_params.active.shape
    )
    active = jnp.concatenate([ego_active, scripted_active], axis=1)

    sub = jax.vmap(
        lambda course, n, dl, goal, ego, ctrl, cut, aidx, done, act: ego_subtick(
            course, n, dl, goal, ego, ctrl, cut, aidx, st.first_tick, done,
            preds, act, cfg, geom,
        )
    )
    (egos, ctrls, cutoffs, aidxs, done_now), tel = sub(
        world.courses, world.n_courses, world.dls, world.goals_xy,
        st.egos, st.ctrls, st.cutoff_lens, st.agent_idxs, st.done, active,
    )

    agents = agents_step(world.agent_params, st.agents, dt, geom.wheelbase)

    new_st = MultiEgoState(
        egos=egos,
        ctrls=ctrls,
        agents=agents,
        cutoff_lens=jnp.where(done_now, st.cutoff_lens, cutoffs),
        agent_idxs=jnp.where(done_now, st.agent_idxs, aidxs),
        first_tick=jnp.asarray(False),
        done=done_now,
        ticks_to_goal=jnp.where(
            done_now & ~st.done, st.tick, st.ticks_to_goal
        ),
        tick=st.tick + 1,
    )
    return new_st, tel


def _multi_ego_pre(world, st, cfg, geom):
    """Per-scenario pre stage: peer + scripted prediction, per-ego
    localization/resample/conflict-scan/cutoff (everything before the QP)."""
    dt = cfg.mpc.dt
    E = st.egos.shape[0]
    dtype = st.egos.dtype

    ego_obs6 = jnp.stack(
        [
            st.egos[:, 0], st.egos[:, 1], st.egos[:, 2], st.egos[:, 3],
            jnp.zeros((E,), dtype), st.ctrls.last_steer,
        ],
        axis=1,
    )
    scripted_obs6 = agents_get(world.agent_params, st.agents, dt)
    all_obs6 = jnp.concatenate([ego_obs6, scripted_obs6])
    preds = predict_constant_control(all_obs6, dt, geom.wheelbase, cfg.n_pred)

    eye = jnp.eye(E, dtype=bool)
    scripted_active = jnp.broadcast_to(
        world.agent_params.active, (E,) + world.agent_params.active.shape
    )
    active = jnp.concatenate([~eye, scripted_active], axis=1)

    return jax.vmap(
        lambda course, n, dl, goal, ego, ctrl, cut, aidx, done, act:
        ego_subtick_pre(course, n, dl, goal, ego, ctrl, cut, aidx,
                        st.first_tick, done, preds, act, cfg, geom)
    )(
        world.courses, world.n_courses, world.dls, world.goals_xy,
        st.egos, st.ctrls, st.cutoff_lens, st.agent_idxs, st.done, active,
    )


def _multi_ego_post(world, st, pre, out, cfg, geom):
    """Per-scenario post stage: plant steps, freeze-on-done, telemetry,
    scripted-agents step, state reassembly."""
    dt = cfg.mpc.dt
    done_now, agent_idx, scan, cutoff_len, _course_len, _cv = pre

    (egos, ctrls, cutoffs, aidxs, done_out), tel = jax.vmap(
        lambda course, ego, c, dn, ai, sc, cl, o:
        ego_subtick_post(course, ego, c, dn, ai, sc, cl, o, cfg, geom)
    )(world.courses, st.egos, st.ctrls, done_now, agent_idx, scan,
      cutoff_len, out)

    agents = agents_step(world.agent_params, st.agents, dt, geom.wheelbase)

    new_st = MultiEgoState(
        egos=egos,
        ctrls=ctrls,
        agents=agents,
        cutoff_lens=jnp.where(done_out, st.cutoff_lens, cutoffs),
        agent_idxs=jnp.where(done_out, st.agent_idxs, aidxs),
        first_tick=jnp.asarray(False),
        done=done_out,
        ticks_to_goal=jnp.where(
            done_out & ~st.done, st.tick, st.ticks_to_goal
        ),
        tick=st.tick + 1,
    )
    return new_st, tel


@fp32_matmuls
def multi_ego_tick_batched(
    world: MultiEgoWorld,
    st: MultiEgoState,
    cfg: EngineConfig,
    geom: VehicleGeometry,
):
    """Same semantics as ``multi_ego_tick`` but the E egos' QPs are solved
    as ONE natively batched ``mpc_step_batched`` call, mirroring the fleet
    engine's pre -> batched solve -> post split. Preferred at E >= 8;
    equivalence covered by tests."""
    pre = _multi_ego_pre(world, st, cfg, geom)
    _done_now, _agent_idx, _scan, _cutoff_len, course_len_for_mpc, cv = pre

    out = mpc_step_batched(
        st.egos, world.courses, cv, course_len_for_mpc, world.dls,
        st.ctrls, cfg.mpc, geom.wheelbase,
    )

    return _multi_ego_post(world, st, pre, out, cfg, geom)


@fp32_matmuls
def multi_ego_fleet_tick(
    world: MultiEgoWorld,      # fields batched along a leading S axis
    st: MultiEgoState,         # fields batched along a leading S axis
    cfg: EngineConfig,
    geom: VehicleGeometry,
):
    """S independent multi-ego junctions in one tick: per-scenario
    prediction/pre/post are vmapped, and ALL S*E QPs are solved by one
    ``mpc_step_batched`` call (a vmapped ``multi_ego_tick_batched`` would
    shatter the solver batch). This is the throughput configuration of
    BASELINE config 4 (reference intent:
    ``main/scenarios/interactive_mpc.py:117-190``)."""
    S, E = st.egos.shape[:2]
    pre = jax.vmap(lambda w, s: _multi_ego_pre(w, s, cfg, geom))(world, st)
    _done_now, _agent_idx, _scan, _cutoff_len, course_len_for_mpc, cv = pre

    def flat(a):
        return a.reshape((S * E,) + a.shape[2:])

    out_flat = mpc_step_batched(
        flat(st.egos), flat(world.courses), flat(cv),
        flat(course_len_for_mpc), flat(world.dls),
        jax.tree.map(flat, st.ctrls), cfg.mpc, geom.wheelbase,
    )
    out = jax.tree.map(lambda a: a.reshape((S, E) + a.shape[1:]), out_flat)

    return jax.vmap(
        lambda w, s, p, o: _multi_ego_post(w, s, p, o, cfg, geom)
    )(world, st, pre, out)


def run_multi_ego_episode(
    world: MultiEgoWorld,
    state0: MultiEgoState,
    cfg: EngineConfig,
    geom: VehicleGeometry,
    n_steps: int,
    batched: bool | None = None,
):
    """Run a multi-ego episode. ``batched=None`` (default) routes fleets of
    E >= 8 egos through the natively batched solver and small fleets
    through the vmapped per-ego tick; pass an explicit bool to force
    either path."""
    if batched is None:
        batched = int(world.courses.shape[0]) >= 8

    def step(st, _):
        if batched:
            return multi_ego_tick_batched(world, st, cfg, geom)
        return multi_ego_tick(world, st, cfg, geom)

    return jax.lax.scan(step, state0, None, length=n_steps)
