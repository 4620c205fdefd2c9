"""The tracking-MPC controller as a pure function over explicit state.

Functional twin of reference ``main/lib/mpc.py:242-326`` (class ``MPC``):
per tick — localize on the course, extract the velocity-lookahead
reference, roll the nonlinear plant along the previous plan for the
linearization operating point, condense, solve the box-QP, return the first
control. All mutable members of the reference class (previous plan, course
localization index, last steer) live in an explicit ``ControllerState``
pytree so the whole thing jits, scans, and vmaps.

Failure semantics (reference mpc.py:294-297): if the solve is unusable, the
controller commands maximum braking, keeps the previous steering angle, and
drops the warm start.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..backend import fp32_matmuls
from ..core.dynamics import SimLimits, plant_rollout
from .condense import condense
from .config import MPCConfig
from .linearize import linearize_bicycle
from .qp import QPSolution, solve_box_qp
from .reference import compute_reference


class ControllerState(NamedTuple):
    oa: jnp.ndarray          # (T,) previous planned accelerations
    od: jnp.ndarray          # (T,) previous planned steers
    have_prev: jnp.ndarray   # () bool
    ov: jnp.ndarray          # (T+1,) previous planned speeds
    have_ov: jnp.ndarray     # () bool
    target_idx: jnp.ndarray  # () int32 course localization index
    last_steer: jnp.ndarray  # () last commanded steer (kept on failure)
    # cross-tick QP warm start (round-5): previous tick's primal/dual
    # solution and final ADMM penalty. Successive receding-horizon ticks
    # solve nearly identical QPs, so seeding the ADMM from these cuts warm
    # iteration counts by an order of magnitude (the same lever as the
    # reference's control warm start, ``main/lib/mpc.py:222-224``).
    # Dropped on solve failure, exactly like ``oa``/``od``.
    qp_x: jnp.ndarray        # (n_qp,) previous QP primal
    qp_y: jnp.ndarray        # (m_qp,) previous QP dual
    qp_rho: jnp.ndarray      # () previous final ADMM rho (scaled problem)
    have_qp: jnp.ndarray     # () bool


class MPCStepOut(NamedTuple):
    accel: jnp.ndarray       # () commanded acceleration
    steer: jnp.ndarray       # () commanded steering angle
    state: ControllerState
    solved: jnp.ndarray      # () bool
    plan_xy: jnp.ndarray     # (T+1, 2) planned positions (diagnostics)
    xref: jnp.ndarray        # (4, T+1)
    target_idx: jnp.ndarray  # () int32


def init_controller_state(cfg: MPCConfig, dtype=jnp.float32) -> ControllerState:
    T = cfg.T
    n_qp, m_qp = cfg.qp_dims
    return ControllerState(
        oa=jnp.zeros((T,), dtype),
        od=jnp.zeros((T,), dtype),
        have_prev=jnp.asarray(False),
        ov=jnp.zeros((T + 1,), dtype),
        have_ov=jnp.asarray(False),
        target_idx=jnp.asarray(0, jnp.int32),
        last_steer=jnp.asarray(0.0, dtype),
        qp_x=jnp.zeros((n_qp,), dtype),
        qp_y=jnp.zeros((m_qp,), dtype),
        qp_rho=jnp.asarray(cfg.admm_rho, dtype),
        have_qp=jnp.asarray(False),
    )


def qp_warm_start(cs: ControllerState, cfg: MPCConfig):
    """Warm tuple for ``solve_box_qp`` from the carried state (batched or
    not — broadcasting handles both). Falls back to the cold (zeros,
    rho0) start wherever ``have_qp`` is unset or warm starting is off."""
    if not cfg.warm_start_qp:
        return None
    have = cs.have_qp
    hx = have[..., None] if cs.qp_x.ndim > have.ndim else have
    return (
        jnp.where(hx, cs.qp_x, jnp.zeros_like(cs.qp_x)),
        jnp.where(hx, cs.qp_y, jnp.zeros_like(cs.qp_y)),
        jnp.where(have, cs.qp_rho, jnp.full_like(cs.qp_rho, cfg.admm_rho)),
    )


def qp_carry_update(sol, solved, cfg: MPCConfig):
    """(qp_x, qp_y, qp_rho, have_qp) fields for the next tick's state —
    kept on success, dropped to the cold start on failure (the same
    failure semantics as the control warm start)."""
    ok = solved if cfg.warm_start_qp else jnp.zeros_like(solved)
    okx = ok[..., None] if sol.x.ndim > ok.ndim else ok
    rho = sol.rho if sol.rho is not None else jnp.full(
        solved.shape, cfg.admm_rho, sol.x.dtype)
    return dict(
        qp_x=jnp.where(okx, sol.x, jnp.zeros_like(sol.x)),
        qp_y=jnp.where(okx, sol.y, jnp.zeros_like(sol.y)),
        qp_rho=jnp.where(ok, rho.astype(sol.x.dtype),
                         jnp.asarray(cfg.admm_rho, sol.x.dtype)),
        have_qp=ok,
    )


@fp32_matmuls
def mpc_step(
    state4,            # (4,) x, y, v, yaw
    course,            # (N, 3) padded course (post-cutoff)
    course_speed,      # (N,) speed channel (speed-ref variant; zeros else)
    valid_len,         # () int32 current (possibly cut) course length
    dl,                # () course tick
    cs: ControllerState,
    cfg: MPCConfig,
    wheelbase: float,
) -> MPCStepOut:
    if cfg.jerk:
        from .jerk import mpc_step_jerk

        return mpc_step_jerk(
            state4, course, course_speed, valid_len, dl, cs, cfg, wheelbase
        )
    T = cfg.T
    dtype = course.dtype
    limits = SimLimits(
        max_steer=cfg.max_steer, max_speed=cfg.max_speed, min_speed=cfg.min_speed
    )

    oa = jnp.where(cs.have_prev, cs.oa, jnp.zeros_like(cs.oa))
    od = jnp.where(cs.have_prev, cs.od, jnp.zeros_like(cs.od))
    ov = cs.ov
    have_ov = cs.have_ov
    target_idx = cs.target_idx
    warm = qp_warm_start(cs, cfg)

    sol = None
    Ff = gf = None
    xref = None
    # re-linearization loop (reference `_iterative_linear_mpc_control`,
    # MAX_ITER is 1 in every shipped config; static Python loop)
    for _ in range(max(cfg.max_iter, 1)):
        ref = compute_reference(
            state4, course, course_speed, valid_len, dl, target_idx,
            ov, have_ov, T, cfg.dt, use_speed_channel=cfg.speed_ref,
        )
        xref, target_idx, reaches_end = ref

        controls = jnp.stack([oa, od], axis=-1)              # (T, 2)
        xbar = plant_rollout(state4, controls, cfg.dt, wheelbase, limits)
        dref = jnp.zeros((T,), dtype)
        A, B, C = linearize_bicycle(xbar[:-1, 2], xbar[:-1, 3], dref, cfg.dt, wheelbase)

        cqp = condense(A, B, C, state4, xref, reaches_end, cfg)
        (checks, check_iters, s_eps, s_band,
         s_cap, s_ratio) = cfg.solver_schedule
        sol = solve_box_qp(
            cqp.P, cqp.q, cqp.G, cqp.lo, cqp.hi,
            rounds=checks, iters=check_iters,
            rho0=cfg.admm_rho, sigma=cfg.admm_sigma, alpha=cfg.admm_alpha,
            polish=cfg.polish,
            warm=warm, eps=s_eps, refactor_band=s_band,
            stall_cap=s_cap, stall_ratio=s_ratio,
            ruiz_iters=cfg.admm_ruiz_iters,
        )
        # re-linearization iterations warm from the solve just done
        warm = (sol.x, sol.y, sol.rho) if cfg.warm_start_qp else None
        u = sol.x.reshape(T, 2)
        oa, od = u[:, 0], u[:, 1]
        Ff, gf = cqp.F, cqp.g
        X = (Ff @ sol.x + gf).reshape(T, 4)
        ov = jnp.concatenate([state4[2:3], X[:, 2]])
        have_ov = jnp.asarray(True)

    solved = (
        jnp.all(jnp.isfinite(sol.x))
        & jnp.isfinite(sol.prim_res)
        & (sol.prim_res < 1e-2)
    )

    # commanded controls clamped to the actuator boxes: the reference's
    # interior-point solve returns feasible-to-1e-8 controls; a rare
    # polish-rejected ADMM iterate here can overshoot a box by ~1e-3
    accel = jnp.where(
        solved, jnp.clip(oa[0], cfg.max_decel, cfg.max_accel),
        jnp.asarray(cfg.max_decel, dtype))
    steer = jnp.clip(
        jnp.where(solved, od[0], cs.last_steer),
        -cfg.max_steer, cfg.max_steer)

    new_cs = ControllerState(
        oa=jnp.where(solved, oa, jnp.zeros_like(oa)),
        od=jnp.where(solved, od, jnp.zeros_like(od)),
        have_prev=solved,
        ov=jnp.where(solved, ov, jnp.zeros_like(ov)),
        have_ov=solved,
        target_idx=target_idx,
        last_steer=steer,
        **qp_carry_update(sol, solved, cfg),
    )

    X = (Ff @ sol.x + gf).reshape(T, 4)
    plan_xy = jnp.concatenate([state4[None, :2], X[:, :2]])

    return MPCStepOut(accel, steer, new_cs, solved, plan_xy, xref, target_idx)


def xref_deviation(state4, course, target_idx):
    """Perpendicular-ish deviation metric, replicating the reference's
    element-wise formula exactly (mpc.py:301-308 — note it multiplies the
    component-wise difference by cos/sin separately rather than projecting)."""
    ref = course[target_idx]
    diff = ref[:2] - state4[:2]
    perp = ref[2] + jnp.pi / 2.0
    v = jnp.stack([jnp.cos(perp) * diff[0], jnp.sin(perp) * diff[1]])
    return jnp.linalg.norm(v)


def is_goal(state4, goal_xy, target_idx, valid_len, cfg: MPCConfig):
    """Goal test (reference mpc.py:310-326): close to the ORIGINAL course
    end, localized near the end of the CURRENT (possibly cut) course, and
    stopped."""
    d = jnp.hypot(state4[0] - goal_xy[0], state4[1] - goal_xy[1])
    near = d <= cfg.goal_dist
    at_end = jnp.abs(target_idx - valid_len) < 5
    stopped = jnp.abs(state4[2]) <= cfg.stop_speed
    return near & at_end & stopped
