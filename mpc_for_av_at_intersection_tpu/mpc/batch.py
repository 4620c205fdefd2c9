"""Natively batched controller step (fleet-scale path).

Same per-scenario semantics as ``controller.mpc_step`` (which stays the
single-scenario reference used by the engine), but with the QP solved by
``solve_box_qp_batched`` — one batched solve whose inner ADMM loop runs in
the platform's implementation (``backend.stages().admm``) — instead of a
vmapped per-scenario solver. Used by the fleet engine, the multi-ego
engine and the bench. Equivalence with the vmapped path is covered by
tests.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..backend import fp32_matmuls
from ..core.dynamics import SimLimits, plant_rollout
from .condense import condense
from .config import MPCConfig
from .controller import (
    ControllerState,
    MPCStepOut,
    qp_carry_update,
    qp_warm_start,
)
from .linearize import linearize_bicycle
from .qp import solve_box_qp_batched
from .reference import compute_reference


@fp32_matmuls
def mpc_step_batched(
    states,         # (B, 4)
    courses,        # (B, N, 3)
    course_speeds,  # (B, N)
    valid_lens,     # (B,)
    dls,            # (B,)
    cs: ControllerState,  # fields batched along B
    cfg: MPCConfig,
    wheelbase: float,
) -> MPCStepOut:
    T = cfg.T
    nx = cfg.nx            # 5 for the jerk variant (extra accel state)
    B = states.shape[0]
    dtype = courses.dtype
    limits = SimLimits(
        max_steer=cfg.max_steer, max_speed=cfg.max_speed, min_speed=cfg.min_speed
    )
    if cfg.jerk:
        from .jerk import condense_jerk as _condense
    else:
        _condense = condense

    oa = jnp.where(cs.have_prev[:, None], cs.oa, jnp.zeros_like(cs.oa))
    od = jnp.where(cs.have_prev[:, None], cs.od, jnp.zeros_like(cs.od))
    ov = cs.ov
    have_ov = cs.have_ov
    target_idx = cs.target_idx
    warm = qp_warm_start(cs, cfg)
    (checks, check_iters, s_eps, s_band,
     s_cap, s_ratio) = cfg.solver_schedule

    sol = None
    Ff = gf = xref = None
    for _ in range(max(cfg.max_iter, 1)):
        ref = jax.vmap(
            lambda s, c, v, n, d, ti, o, h: compute_reference(
                s, c, v, n, d, ti, o, h, T, cfg.dt,
                use_speed_channel=cfg.speed_ref,
            )
        )(states, courses, course_speeds, valid_lens, dls, target_idx, ov, have_ov)
        xref, target_idx, reaches_end = ref

        controls = jnp.stack([oa, od], axis=-1)              # (B, T, 2)
        xbar = jax.vmap(
            lambda s, u: plant_rollout(s, u, cfg.dt, wheelbase, limits)
        )(states, controls)
        dref = jnp.zeros((B, T), dtype)
        A, B_, C = jax.vmap(
            lambda v, p, d: linearize_bicycle(v, p, d, cfg.dt, wheelbase,
                                              nx=nx)
        )(xbar[:, :-1, 2], xbar[:, :-1, 3], dref)

        cqp = jax.vmap(
            lambda a, b, c, s, r, e: _condense(a, b, c, s, r, e, cfg)
        )(A, B_, C, states, xref, reaches_end)
        sol = solve_box_qp_batched(
            cqp.P, cqp.q, cqp.G, cqp.lo, cqp.hi,
            rounds=checks, iters=check_iters,
            rho0=cfg.admm_rho, sigma=cfg.admm_sigma, alpha=cfg.admm_alpha,
            polish=cfg.polish, warm=warm, eps=s_eps, refactor_band=s_band,
            stall_cap=s_cap, stall_ratio=s_ratio,
            ruiz_iters=cfg.admm_ruiz_iters,
        )
        warm = (sol.x, sol.y, sol.rho) if cfg.warm_start_qp else None
        # jerk variant: decision vector is [u_flat (2T); a0] — controls are
        # the first 2T entries either way
        u = sol.x[:, : 2 * T].reshape(B, T, 2)
        oa, od = u[:, :, 0], u[:, :, 1]
        Ff, gf = cqp.F, cqp.g
        X = (jnp.einsum("bij,bj->bi", Ff, sol.x) + gf).reshape(B, T, nx)
        ov = jnp.concatenate([states[:, 2:3], X[:, :, 2]], axis=1)
        have_ov = jnp.ones((B,), bool)

    solved = (
        jnp.all(jnp.isfinite(sol.x), axis=1)
        & jnp.isfinite(sol.prim_res)
        & (sol.prim_res < 1e-2)
    )
    # commanded controls clamped to the actuator boxes (see mpc_step)
    accel = jnp.where(
        solved, jnp.clip(oa[:, 0], cfg.max_decel, cfg.max_accel),
        jnp.asarray(cfg.max_decel, dtype))
    steer = jnp.clip(
        jnp.where(solved, od[:, 0], cs.last_steer),
        -cfg.max_steer, cfg.max_steer)

    new_cs = ControllerState(
        oa=jnp.where(solved[:, None], oa, jnp.zeros_like(oa)),
        od=jnp.where(solved[:, None], od, jnp.zeros_like(od)),
        have_prev=solved,
        ov=jnp.where(solved[:, None], ov, jnp.zeros_like(ov)),
        have_ov=solved,
        target_idx=target_idx,
        last_steer=steer,
        **qp_carry_update(sol, solved, cfg),
    )
    X = (jnp.einsum("bij,bj->bi", Ff, sol.x) + gf).reshape(B, T, nx)
    plan_xy = jnp.concatenate([states[:, None, :2], X[:, :, :2]], axis=1)
    return MPCStepOut(accel, steer, new_cs, solved, plan_xy, xref, target_idx)
