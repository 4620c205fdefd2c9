"""Condense the horizon-T tracking QP into a dense box-constrained QP in u.

The reference builds the QP sparsely in CVXPY (state trajectory as decision
variables, dynamics as equality constraints — ``main/lib/mpc.py:148-191``)
and hands it to ECOS. Here we eliminate the states through the affine
time-varying dynamics instead: with X = [x_1..x_T] = F u + g, the problem
becomes

    min_u  1/2 u' P u + q' u   s.t.  lo <= G u <= hi

with u in R^{2T} (T=13 -> 26 vars), P dense 2Tx2T, and G stacking the
velocity rows of F, the input boxes, and the steer-rate differences
(m = 4T-1 rows). Small dense batched matmuls; no sparse KKT factorization
needed.

Cost blocks (parity with mpc.py:156-184):
  t = 1..T  tracking: anisotropic xy quadratic rotated to the reference yaw
            (w_perp about yaw+pi/2, w_para about yaw) + diag(q_v, q_yaw),
            switching to Qf * T on `reaches_end` slots
  t = 0..T-1 input: diag(r_accel, r_steer), switching to
            end_input_weight * I on `reaches_end`
  t = 0..T-2 input rate: diag(rd_accel, rd_steer)
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..backend import fp32_matmuls
from .config import MPCConfig


class CondensedQP(NamedTuple):
    P: jnp.ndarray      # (2T, 2T)
    q: jnp.ndarray      # (2T,)
    G: jnp.ndarray      # (4T-1, 2T)
    lo: jnp.ndarray     # (4T-1,)
    hi: jnp.ndarray     # (4T-1,)
    F: jnp.ndarray      # (T*nx, 2T) prediction matrix
    g: jnp.ndarray      # (T*nx,) affine offset (X = F u + g)


def prediction_matrices(A, B, C, x0):
    """Forward-accumulate the prediction operator.

    A (T,nx,nx), B (T,nx,nu), C (T,nx), x0 (nx,) ->
    F (T, nx, T*nu), g (T, nx) with x_t = F[t-1] @ u_flat + g[t-1].
    """
    T, nx, nu = B.shape
    dtype = A.dtype

    def step(carry, inp):
        row, gvec, t = carry
        At, Bt, Ct = inp
        row = jnp.einsum("ij,jk->ik", At, row)
        row = jax.lax.dynamic_update_slice(row, Bt, (0, t * nu))
        gvec = At @ gvec + Ct
        return (row, gvec, t + 1), (row, gvec)

    # seed the carry from an input so its varying-axis type matches the scan
    # output under shard_map
    row0 = jnp.zeros((nx, T * nu), dtype) + x0[0] * 0.0
    (_, _, _), (F, g) = jax.lax.scan(step, (row0, x0, 0), (A, B, C))
    return F, g


def _tracking_blocks(xref, reaches_end, cfg: MPCConfig, dtype):
    """(T, 4, 4) tracking cost blocks for t = 1..T."""
    T = cfg.T
    yaw = xref[3, 1:]
    c, s = jnp.cos(yaw), jnp.sin(yaw)
    # w_perp * M(yaw + pi/2) + w_para * M(yaw), M(a) = [[c^2, cs], [cs, s^2]]
    qxx = cfg.w_perp * s * s + cfg.w_para * c * c
    qxy = (-cfg.w_perp + cfg.w_para) * c * s
    qyy = cfg.w_perp * c * c + cfg.w_para * s * s

    Q = jnp.zeros((T, 4, 4), dtype)
    Q = Q.at[:, 0, 0].set(qxx)
    Q = Q.at[:, 0, 1].set(qxy)
    Q = Q.at[:, 1, 0].set(qxy)
    Q = Q.at[:, 1, 1].set(qyy)
    Q = Q.at[:, 2, 2].set(cfg.q_v)
    Q = Q.at[:, 3, 3].set(cfg.q_yaw)

    qf = jnp.asarray(cfg.qf, dtype) * cfg.T
    Qf = jnp.zeros((4, 4), dtype).at[jnp.arange(4), jnp.arange(4)].set(qf)
    end = reaches_end[1:, None, None]
    return jnp.where(end, Qf[None], Q)


@fp32_matmuls
def condense(A, B, C, x0, xref, reaches_end, cfg: MPCConfig) -> CondensedQP:
    """Build the dense condensed QP for one scenario/tick. vmap to batch.

    Runs with every matmul at full fp32 (``backend.fp32_matmuls``):
    reduced-precision passes in the F'QF products measurably perturb the
    QP data."""
    T, nu = cfg.T, cfg.nu
    nx = 4
    dtype = A.dtype
    n = T * nu

    F, g = prediction_matrices(A, B, C, x0)       # (T,nx,n), (T,nx)
    Ff = F.reshape(T * nx, n)
    gf = g.reshape(T * nx)

    # --- cost ---
    Q = _tracking_blocks(xref, reaches_end, cfg, dtype)       # (T,4,4)
    r = xref[:, 1:].T                                          # (T,4) targets
    QF = jnp.einsum("tij,tjn->tin", Q, F).reshape(T * nx, n)   # Q-weighted F
    P = Ff.T @ QF
    qvec = QF.T @ (gf - r.reshape(T * nx))

    # input cost R_t (switches on reaches_end[0..T-1])
    r_end = reaches_end[:T]
    r_diag = jnp.where(
        r_end[:, None],
        jnp.full((1, 2), cfg.end_input_weight, dtype),
        jnp.asarray([[cfg.r_accel, cfg.r_steer]], dtype),
    ).reshape(n)
    P = P + jnp.diag(r_diag)

    # input-rate cost via difference operator D: (T-1)*nu x n
    eye = jnp.eye(n, dtype=dtype)
    Dm = eye[nu:] - eye[:-nu]                                  # ((T-1)*nu, n)
    rd = jnp.tile(jnp.asarray([cfg.rd_accel, cfg.rd_steer], dtype), T - 1)
    P = P + (Dm.T * rd) @ Dm

    P = 2.0 * (0.5 * (P + P.T))   # symmetrize; factor 2 matches quad_form sums
    qvec = 2.0 * qvec

    # --- constraints ---
    v_rows = Ff.reshape(T, nx, n)[:, 2, :]                     # (T, n)
    g_v = g[:, 2]
    lo_v = cfg.min_speed - g_v
    hi_v = cfg.max_speed - g_v

    acc_rows = eye[0::2]
    steer_rows = eye[1::2]
    rate_rows = Dm[1::2]                                       # steer diffs

    G = jnp.concatenate([v_rows, acc_rows, steer_rows, rate_rows])
    ones_T = jnp.ones((T,), dtype)
    ones_R = jnp.ones((T - 1,), dtype)
    lo = jnp.concatenate(
        [lo_v, cfg.max_decel * ones_T, -cfg.max_steer * ones_T,
         -cfg.max_dsteer * cfg.dt * ones_R]
    )
    hi = jnp.concatenate(
        [hi_v, cfg.max_accel * ones_T, cfg.max_steer * ones_T,
         cfg.max_dsteer * cfg.dt * ones_R]
    )

    return CondensedQP(P, qvec, G, lo, hi, Ff, gf)
