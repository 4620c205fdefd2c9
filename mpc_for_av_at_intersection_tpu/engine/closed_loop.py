"""The jitted closed-loop receding-horizon engine.

Functional rebuild of the reference scenario drivers' main loop
(``main/scenarios/mpc_intersection.py:95-159``): per tick —

1. goal test (on the previous tick's controller state),
2. advance the driver's own course-localization index (frozen once the
   cut course has collapsed to the agent's position, :100-105),
3. ego reachability resampling of the remaining course (:110-116),
4. constant-control prediction of every moving agent (:119-122),
5. frame-windowed conflict scan (:125-126),
6. course cutoff before the conflict minus a car-length margin (:129-136)
   — or, in speed-reference mode, zeroing of the reference speed past the
   conflict (``mpc_intersection_new_ref.py:122-139``),
7. MPC solve, 8. agents step, 9. plant step.

One scenario = one call of ``engine_tick``; an episode is a ``lax.scan``;
a fleet of scenarios is a ``vmap``/``shard_map`` over the leading axis
(see ``parallel/``). Finished scenarios freeze in place so a batch can run
to a fixed step count without ragged control flow.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..agents import (
    AgentParams,
    AgentStates,
    agents_get,
    agents_step,
    check_collision_moving_cars,
    cutoff_index_by_position,
    predict_constant_control,
)
from ..backend import fp32_matmuls
from ..core.curves import compact_by_mask, nearest_index_in_direction, resample_mask
from ..core.dynamics import SimLimits, plant_step
from ..models import VehicleGeometry
from ..mpc.config import MPCConfig
from ..mpc.controller import (
    ControllerState,
    init_controller_state,
    is_goal,
    mpc_step,
    xref_deviation,
)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    mpc: MPCConfig = MPCConfig.canonical()
    n_traj: int = 1024          # padded course buffer
    n_frames: int = 128         # frame buffer for the conflict scan
    n_agents: int = 4           # padded moving-agent slots
    time_horizon: float = 7.0   # prediction horizon [s]
    frame_window: int = 20
    yield_by_speed: bool = False  # True: speed-ref variant (keep full path)

    @property
    def n_pred(self) -> int:
        return int(np.ceil(self.time_horizon / self.mpc.dt))


class WorldArrays(NamedTuple):
    """Per-scenario constants (batchable along a leading axis)."""

    course: jnp.ndarray        # (n_traj, 3) padded full reference trajectory
    n_course: jnp.ndarray      # () int32
    dl: jnp.ndarray            # () course tick
    goal_xy: jnp.ndarray       # (2,) original course end
    agent_params: AgentParams  # padded (n_agents,) rows


class EngineState(NamedTuple):
    ego: jnp.ndarray           # (4,) x, y, v, yaw
    ctrl: ControllerState
    agents: AgentStates
    cutoff_len: jnp.ndarray    # () int32 current course valid length
    agent_idx: jnp.ndarray     # () int32 driver-side localization index
    first_tick: jnp.ndarray    # () bool
    done: jnp.ndarray          # () bool
    ticks_to_goal: jnp.ndarray  # () int32 (n_steps if never finished)
    tick: jnp.ndarray          # () int32


class Telemetry(NamedTuple):
    """Per-tick telemetry (replaces the reference ``History``)."""

    x: jnp.ndarray
    y: jnp.ndarray
    yaw: jnp.ndarray
    v: jnp.ndarray
    accel: jnp.ndarray
    steer: jnp.ndarray
    xref_dev: jnp.ndarray
    solved: jnp.ndarray
    collision_found: jnp.ndarray
    collision_xy: jnp.ndarray
    cutoff_len: jnp.ndarray
    done: jnp.ndarray


def make_world(
    trajectory: np.ndarray,
    agent_params: AgentParams,
    cfg: EngineConfig,
    dtype=jnp.float32,
) -> WorldArrays:
    """Pad a host-side reference trajectory into device world arrays.

    The course yaw is sequentially unwrapped here, once — replicating the
    reference's in-place ``smooth_yaw`` through a view of the trajectory
    array (see ``core.angles.smooth_yaw_numpy``); without this, the +-pi
    node normalization at lattice-edge boundaries injects 2*pi jumps into
    the yaw-tracking cost.
    """
    from ..core.angles import smooth_yaw_numpy

    n = len(trajectory)
    if n > cfg.n_traj:
        raise ValueError(f"trajectory length {n} > n_traj={cfg.n_traj}")
    trajectory = np.asarray(trajectory, dtype=np.float64).copy()
    trajectory[:, 2] = smooth_yaw_numpy(trajectory[:, 2])
    course = np.zeros((cfg.n_traj, 3), dtype=np.float64)
    course[:n] = trajectory
    course[n:] = trajectory[-1]
    dl = float(np.linalg.norm(trajectory[1, :2] - trajectory[0, :2]))
    return WorldArrays(
        course=jnp.asarray(course, dtype),
        n_course=jnp.asarray(n, jnp.int32),
        dl=jnp.asarray(dl, dtype),
        goal_xy=jnp.asarray(trajectory[-1, :2], dtype),
        agent_params=jax.tree.map(jnp.asarray, agent_params),
    )


def init_engine_state(
    world: WorldArrays, agent_states: AgentStates, cfg: EngineConfig,
    n_steps: int, dtype=jnp.float32,
) -> EngineState:
    ego = jnp.concatenate(
        [world.course[0, :2], jnp.zeros((1,), dtype), world.course[0, 2:3]]
    ).astype(dtype)
    return EngineState(
        ego=ego,
        ctrl=init_controller_state(cfg.mpc, dtype),
        agents=jax.tree.map(jnp.asarray, agent_states),
        cutoff_len=world.n_course,
        agent_idx=jnp.asarray(0, jnp.int32),
        first_tick=jnp.asarray(True),
        done=jnp.asarray(False),
        ticks_to_goal=jnp.asarray(n_steps, jnp.int32),
        tick=jnp.asarray(0, jnp.int32),
    )


def ego_subtick(
    course,            # (N, 3) padded course for this ego
    n_course,          # () int32
    dl,                # ()
    goal_xy,           # (2,)
    ego,               # (4,)
    ctrl: ControllerState,
    cutoff_len,        # () int32 — previous tick's
    agent_idx,         # () int32 — previous tick's
    first_tick,        # () bool
    done,              # () bool
    preds,             # (n_obs, n_pred, 3) predicted obstacle trajectories
    preds_active,      # (n_obs,) bool
    cfg: EngineConfig,
    geom: VehicleGeometry,
):
    """One ego's control tick given pre-computed obstacle predictions.

    Shared by the single-ego engine (scripted traffic) and the multi-ego
    engine (where "obstacles" are the other egos + scripted traffic).
    Returns (new per-ego state tuple, Telemetry, control).
    """
    pre = ego_subtick_pre(
        course, n_course, dl, goal_xy, ego, ctrl, cutoff_len, agent_idx,
        first_tick, done, preds, preds_active, cfg, geom,
    )
    done_now, agent_idx, scan, cutoff_len, course_len_for_mpc, cv = pre

    out = mpc_step(
        ego, course, cv, course_len_for_mpc, dl, ctrl, cfg.mpc, geom.wheelbase
    )

    return ego_subtick_post(
        course, ego, ctrl, done_now, agent_idx, scan, cutoff_len, out, cfg, geom
    )


def ego_subtick_pre(
    course, n_course, dl, goal_xy, ego, ctrl: ControllerState,
    cutoff_len, agent_idx, first_tick, done, preds, preds_active,
    cfg: EngineConfig, geom: VehicleGeometry,
):
    """Everything before the MPC solve: goal test, localization advance,
    reachability resample, conflict scan, cutoff / speed-zero decision."""
    mpc_cfg = cfg.mpc
    dt = mpc_cfg.dt
    N = course.shape[0]
    dtype = course.dtype
    circle_centers = jnp.asarray(geom.circle_centers, dtype)

    # 1. goal test against the PREVIOUS tick's controller/cutoff state
    done_now = done | is_goal(ego, goal_xy, ctrl.target_idx, cutoff_len, mpc_cfg)

    # 2. driver-side localization advance, frozen when the cut course has
    #    already collapsed onto the agent (reference :100-105)
    tip = course[jnp.maximum(cutoff_len - 1, 0)]
    collapsed = jnp.all(course[agent_idx] == tip)
    advance = first_tick | ~collapsed
    agent_idx = jnp.where(
        advance,
        nearest_index_in_direction(
            ego[:2], course[:, :2], agent_idx, n_course, forward=True
        ),
        agent_idx,
    )

    # remaining full-course suffix (detailed path). The clamped gather
    # course[min(agent_idx + i, N-1)] is a SHIFT: dynamic-slice a doubled
    # buffer whose upper half repeats the final row (the padded course
    # already repeats it from n_course on) — a contiguous copy instead of
    # an N-row gather, exactly equal element-wise (PROFILE_ENGINE r5: the
    # pre stage was ~70% of the fleet tick, led by this gather + the
    # compaction scatter).
    course2 = jnp.concatenate(
        [course, jnp.broadcast_to(course[-1], course.shape)], axis=0)
    detail = jax.lax.dynamic_slice(
        course2, (agent_idx, jnp.asarray(0, agent_idx.dtype)), (N, 3))
    n_detail = n_course - agent_idx

    # 3. ego reachability resample of the suffix (reference :110-116)
    i = jnp.arange(N, dtype=dtype)
    accel_dl = dt * jnp.minimum(ego[2] + mpc_cfg.max_accel * (i + 1.0), mpc_cfg.max_speed)
    flat_dl = jnp.full((N,), dt * mpc_cfg.max_speed, dtype)
    res_dl = jnp.where(ego[2] < mpc_cfg.max_speed, accel_dl, flat_dl)
    valid_suffix = jnp.arange(N) < n_detail
    keep = resample_mask(detail, res_dl, valid_suffix, keep_last=True)
    ego_traj, n_ego = compact_by_mask(detail, keep, cfg.n_frames)

    # 5. conflict scan (reference :125-126)
    scan = check_collision_moving_cars(
        ego_traj, n_ego, detail, n_detail, preds,
        preds_active, circle_centers, geom.radius,
        cfg.frame_window, cfg.n_frames,
    )

    # 6. cutoff (reference :129-136): margin of ~a car length
    margin = 4 * jnp.ceil(geom.radius / dl).astype(jnp.int32)
    cut_found, cut_idx = cutoff_index_by_position(course, n_course, scan.xy)
    use_cut = scan.found & cut_found
    cut = jnp.maximum(agent_idx + 1, cut_idx - margin)
    cutoff_len = jnp.where(use_cut, cut, n_course)

    if cfg.yield_by_speed:
        # speed-reference yielding: keep the full path, zero the reference
        # speed from the cutoff on (mpc_with_speed.py:275-282)
        course_len_for_mpc = n_course
        cv = jnp.where(
            jnp.arange(N) < cutoff_len,
            jnp.asarray(mpc_cfg.target_speed, dtype),
            jnp.asarray(0.0, dtype),
        )
    else:
        course_len_for_mpc = cutoff_len
        cv = jnp.zeros((N,), dtype)

    return done_now, agent_idx, scan, cutoff_len, course_len_for_mpc, cv


def ego_subtick_post(
    course, ego, ctrl: ControllerState, done_now, agent_idx, scan,
    cutoff_len, out, cfg: EngineConfig, geom: VehicleGeometry,
):
    """Everything after the MPC solve: plant step, freeze-on-done,
    telemetry assembly."""
    mpc_cfg = cfg.mpc
    dt = mpc_cfg.dt
    limits = SimLimits(
        max_steer=mpc_cfg.max_steer,
        max_speed=mpc_cfg.max_speed,
        min_speed=mpc_cfg.min_speed,
    )

    dev = xref_deviation(ego, course, out.target_idx)

    control = jnp.stack([out.accel, out.steer])
    new_ego = plant_step(ego, control, dt, geom.wheelbase, limits)

    # freeze this ego once done
    def frz(new, old):
        return jax.tree.map(lambda a, b: jnp.where(done_now, b, a), new, old)

    ego_out = frz(new_ego, ego)
    ctrl_out = frz(out.state, ctrl)

    tel = Telemetry(
        x=ego_out[0], y=ego_out[1], yaw=ego_out[3], v=ego_out[2],
        accel=jnp.where(done_now, 0.0, out.accel),
        steer=jnp.where(done_now, 0.0, out.steer),
        xref_dev=dev,
        solved=out.solved | done_now,
        collision_found=scan.found & ~done_now,
        collision_xy=scan.xy,
        cutoff_len=cutoff_len,
        done=done_now,
    )
    return (ego_out, ctrl_out, cutoff_len, agent_idx, done_now), tel


@fp32_matmuls
def engine_tick(
    world: WorldArrays,
    st: EngineState,
    cfg: EngineConfig,
    geom: VehicleGeometry,
):
    dt = cfg.mpc.dt

    # 4. constant-control prediction of every scripted agent (reference
    #    :119-122) — computed once, outside the per-ego subtick
    obs6 = agents_get(world.agent_params, st.agents, dt)
    preds = predict_constant_control(obs6, dt, geom.wheelbase, cfg.n_pred)

    (ego, ctrl, cutoff_len, agent_idx, done_now), tel = ego_subtick(
        world.course, world.n_course, world.dl, world.goal_xy,
        st.ego, st.ctrl, st.cutoff_len, st.agent_idx, st.first_tick, st.done,
        preds, world.agent_params.active, cfg, geom,
    )

    # 8. scripted agents step. Documented divergence (QUIRKS #21): the
    #    reference keeps stepping obstacles after the ego parks
    #    (mpc_intersection.py:154-156); here finished scenarios freeze ALL
    #    state so a fixed-step fleet scan is deterministic and cheap.
    #    Pre-goal agent motion is bit-identical.
    agents = agents_step(world.agent_params, st.agents, dt, geom.wheelbase)
    agents = jax.tree.map(
        lambda a, b: jnp.where(done_now, b, a), agents, st.agents
    )

    new_st = EngineState(
        ego=ego,
        ctrl=ctrl,
        agents=agents,
        cutoff_len=jnp.where(done_now, st.cutoff_len, cutoff_len),
        agent_idx=jnp.where(done_now, st.agent_idx, agent_idx),
        # stays "first tick" only if the scenario finished before ever
        # executing a control step (degenerate already-at-goal case)
        first_tick=st.first_tick & done_now,
        done=done_now,
        ticks_to_goal=jnp.where(done_now & ~st.done, st.tick, st.ticks_to_goal),
        tick=st.tick + 1,
    )
    return new_st, tel


def run_episode(
    world: WorldArrays,
    state0: EngineState,
    cfg: EngineConfig,
    geom: VehicleGeometry,
    n_steps: int,
):
    """Scan a full episode. Returns (final_state, stacked Telemetry)."""

    def step(st, _):
        return engine_tick(world, st, cfg, geom)

    return jax.lax.scan(step, state0, None, length=n_steps)


def run_episode_live(
    world: WorldArrays,
    state0: EngineState,
    cfg: EngineConfig,
    geom: VehicleGeometry,
    n_steps: int,
    on_tick=None,
):
    """Host-loop episode: one jitted ``engine_tick`` per iteration, with a
    per-tick host callback — the live-rendering execution mode of the
    reference's closed loop (``mpc_intersection.py:150, 273-316``: redraw +
    ``plt.pause`` every control tick).

    ``on_tick(k, state, tel, agents6)`` receives the tick index, the
    post-tick ``EngineState``, that tick's ``Telemetry`` row, and the
    scripted agents' ``(n_agents, 6)`` states — all as host numpy. Breaks
    early when the scenario finishes (like the reference's goal-test
    ``break``). Returns ``(final_state, Telemetry)`` with telemetry stacked
    over the executed ticks only.

    This trades fleet throughput for per-tick host visibility — the
    offline ``run_episode`` scan stays the production path; benchmarks
    never route through here.
    """
    from ..agents import agents_get

    tick = jax.jit(
        lambda w, s: engine_tick(w, s, cfg, geom), static_argnames=()
    )
    st = state0
    rows = []
    for k in range(n_steps):
        st, tel = tick(world, st)
        tel_np = jax.tree.map(np.asarray, tel)
        rows.append(tel_np)
        if on_tick is not None:
            st_np = jax.tree.map(np.asarray, st)
            obs6 = np.asarray(
                agents_get(world.agent_params, st.agents, cfg.mpc.dt)
            )
            on_tick(k, st_np, tel_np, obs6)
        if bool(st.done):
            break
    telemetry = jax.tree.map(lambda *xs: np.stack(xs), *rows)
    return st, telemetry
