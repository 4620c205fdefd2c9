"""Float64 oracle for the tracking-MPC QP, in the reference's SPARSE form.

Mirrors the CVXPY formulation of reference ``main/lib/mpc.py:138-194`` row
by row (states AND inputs as decision variables, dynamics as equality
constraints) — deliberately a different formulation than the framework's
condensed device solver, so agreement between the two validates both the
condensing algebra and the solver. Solved by long-run ADMM + exact active-set
polish in float64; every solution is certified by its KKT residuals
(``kkt_residuals``) rather than trusted implicitly. cvxpy/ECOS is not
available in this environment; a KKT-certified solution of a convex QP is
just as authoritative.

Cost/constraint parity notes:
- tracking cost for t=1..T with rotated anisotropic xy weights;
- `reaches_end[t]` switches tracking to Qf*T and the input cost to 10*I;
- velocity box applies to ALL x_t including x_0 (redundant but mirrored);
- steer-rate constraint |u1[t+1]-u1[t]| <= max_dsteer*dt.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.linalg


@dataclasses.dataclass
class SparseQP:
    P: np.ndarray
    q: np.ndarray
    A: np.ndarray
    lo: np.ndarray
    hi: np.ndarray
    T: int


def build_sparse_mpc_qp(
    A_dyn, B_dyn, C_dyn, x0, xref, reaches_end,
    w_perp, w_para, q_v, q_yaw, qf, end_input_weight,
    r_accel, r_steer, rd_accel, rd_steer,
    max_accel, max_decel, max_dsteer_dt, max_steer, max_speed, min_speed,
) -> SparseQP:
    T = A_dyn.shape[0]
    nx, nu = 4, 2
    nz = nx * (T + 1) + nu * T

    def xi(t):  # slice of x_t
        return slice(nx * t, nx * (t + 1))

    def ui(t):
        return slice(nx * (T + 1) + nu * t, nx * (T + 1) + nu * (t + 1))

    P = np.zeros((nz, nz))
    q = np.zeros(nz)

    for t in range(1, T + 1):
        if reaches_end[t]:
            Q = np.diag(np.asarray(qf, dtype=np.float64)) * T
        else:
            yaw = xref[3, t]
            c, s = np.cos(yaw), np.sin(yaw)
            Qxy = w_perp * np.array([[s * s, -c * s], [-c * s, c * c]]) + \
                w_para * np.array([[c * c, c * s], [c * s, s * s]])
            Q = np.zeros((4, 4))
            Q[:2, :2] = Qxy
            Q[2, 2], Q[3, 3] = q_v, q_yaw
        r = xref[:, t]
        P[xi(t), xi(t)] += 2.0 * Q
        q[xi(t)] += -2.0 * Q @ r

    for t in range(T):
        R = np.diag([end_input_weight] * 2) if reaches_end[t] else np.diag([r_accel, r_steer])
        P[ui(t), ui(t)] += 2.0 * R

    Rd = np.diag([rd_accel, rd_steer])
    for t in range(T - 1):
        a, b = ui(t), ui(t + 1)
        P[a, a] += 2.0 * Rd
        P[b, b] += 2.0 * Rd
        P[a.start:a.stop, b.start:b.stop] += -2.0 * Rd
        P[b.start:b.stop, a.start:a.stop] += -2.0 * Rd

    rows, los, his = [], [], []

    def add_row(vec, lo_v, hi_v):
        rows.append(vec)
        los.append(lo_v)
        his.append(hi_v)

    # x_0 = x0
    for k in range(nx):
        v = np.zeros(nz)
        v[k] = 1.0
        add_row(v, x0[k], x0[k])
    # dynamics
    for t in range(T):
        for k in range(nx):
            v = np.zeros(nz)
            v[xi(t + 1)][k] = 1.0  # note: view assignment
            v[xi(t)] -= A_dyn[t, k]
            v[ui(t)] -= B_dyn[t, k]
            add_row(v, C_dyn[t, k], C_dyn[t, k])
    # velocity box (all t incl. 0)
    for t in range(T + 1):
        v = np.zeros(nz)
        v[nx * t + 2] = 1.0
        add_row(v, min_speed, max_speed)
    # input boxes
    for t in range(T):
        v = np.zeros(nz)
        v[ui(t)][0] = 1.0
        add_row(v, max_decel, max_accel)
    for t in range(T):
        v = np.zeros(nz)
        v[ui(t)][1] = 1.0
        add_row(v, -max_steer, max_steer)
    # steer rate
    for t in range(T - 1):
        v = np.zeros(nz)
        v[ui(t + 1)][1] = 1.0
        v[ui(t)][1] -= 1.0
        add_row(v, -max_dsteer_dt, max_dsteer_dt)

    return SparseQP(P, q, np.array(rows), np.array(los), np.array(his), T)


def build_sparse_jerk_qp(
    A_dyn, B_dyn, C_dyn, x0, xref, reaches_end,
    w_perp, w_para, q_v, q_yaw, qf5, end_input_weight,
    r_accel, r_steer, rd_accel, rd_steer, jerk_weight,
    max_accel, max_decel, max_dsteer_dt, max_steer, max_speed, min_speed,
) -> SparseQP:
    """Sparse oracle for the jerk variant (reference mpc_jerk.py): 5-state
    dynamics, free initial accel state (only x[:4,0] pinned), jerk penalty
    on accel-state differences, 5x5 terminal Qf (see mpc/jerk.py docstring
    for the documented Qf fix)."""
    T = A_dyn.shape[0]
    nx, nu = 5, 2
    nz = nx * (T + 1) + nu * T

    def xi(t):
        return slice(nx * t, nx * (t + 1))

    def ui(t):
        return slice(nx * (T + 1) + nu * t, nx * (T + 1) + nu * (t + 1))

    P = np.zeros((nz, nz))
    q = np.zeros(nz)

    for t in range(1, T + 1):
        if reaches_end[t]:
            Q = np.diag(np.asarray(qf5, dtype=np.float64)) * T
        else:
            yaw = xref[3, t]
            c, s = np.cos(yaw), np.sin(yaw)
            Qxy = w_perp * np.array([[s * s, -c * s], [-c * s, c * c]]) + \
                w_para * np.array([[c * c, c * s], [c * s, s * s]])
            Q = np.zeros((5, 5))
            Q[:2, :2] = Qxy
            Q[2, 2], Q[3, 3] = q_v, q_yaw
        r = np.append(xref[:, t], 0.0)
        P[xi(t), xi(t)] += 2.0 * Q
        q[xi(t)] += -2.0 * Q @ r

    for t in range(T):
        R = np.diag([end_input_weight] * 2) if reaches_end[t] else np.diag([r_accel, r_steer])
        P[ui(t), ui(t)] += 2.0 * R

    Rd = np.diag([rd_accel, rd_steer])
    for t in range(T - 1):
        a, b = ui(t), ui(t + 1)
        P[a, a] += 2.0 * Rd
        P[b, b] += 2.0 * Rd
        P[a.start:a.stop, b.start:b.stop] += -2.0 * Rd
        P[b.start:b.stop, a.start:a.stop] += -2.0 * Rd
        # jerk penalty on accel-state difference (mpc_jerk.py:190)
        ia, ib = nx * t + 4, nx * (t + 1) + 4
        P[ia, ia] += 2.0 * jerk_weight
        P[ib, ib] += 2.0 * jerk_weight
        P[ia, ib] += -2.0 * jerk_weight
        P[ib, ia] += -2.0 * jerk_weight

    rows, los, his = [], [], []

    def add_row(vec, lo_v, hi_v):
        rows.append(vec)
        los.append(lo_v)
        his.append(hi_v)

    # x[:4, 0] = x0 — the accel state is free (mpc_jerk.py:193)
    for k in range(4):
        v = np.zeros(nz)
        v[k] = 1.0
        add_row(v, x0[k], x0[k])
    for t in range(T):
        for k in range(nx):
            v = np.zeros(nz)
            v[xi(t + 1)][k] = 1.0
            v[xi(t)] -= A_dyn[t, k]
            v[ui(t)] -= B_dyn[t, k]
            add_row(v, C_dyn[t, k], C_dyn[t, k])
    for t in range(T + 1):
        v = np.zeros(nz)
        v[nx * t + 2] = 1.0
        add_row(v, min_speed, max_speed)
    for t in range(T):
        v = np.zeros(nz)
        v[ui(t)][0] = 1.0
        add_row(v, max_decel, max_accel)
    for t in range(T):
        v = np.zeros(nz)
        v[ui(t)][1] = 1.0
        add_row(v, -max_steer, max_steer)
    for t in range(T - 1):
        v = np.zeros(nz)
        v[ui(t + 1)][1] = 1.0
        v[ui(t)][1] -= 1.0
        add_row(v, -max_dsteer_dt, max_dsteer_dt)

    return SparseQP(P, q, np.array(rows), np.array(los), np.array(his), T)


def extract_controls_jerk(qp: SparseQP, z: np.ndarray) -> np.ndarray:
    T = qp.T
    return z[5 * (T + 1):].reshape(T, 2)


def kkt_residuals(P, q, A, lo, hi, z, y):
    Az = A @ z
    stat = np.max(np.abs(P @ z + q + A.T @ y))
    prim = np.max(np.maximum(np.maximum(Az - hi, lo - Az), 0.0))
    ypos, yneg = np.maximum(y, 0), np.minimum(y, 0)
    comp = np.max(np.abs(ypos * np.minimum(hi - Az, 1e6)) + np.abs(yneg * np.minimum(Az - lo, 1e6)))
    return stat, prim, comp


def solve_sparse_qp(qp: SparseQP, iters=40000, rho=0.5, rho_eq_scale=1e3, sigma=1e-8):
    """Long-run float64 ADMM + exact polish. Returns (z, y, kkt_tuple)."""
    P, q, A, lo, hi = qp.P, qp.q, qp.A, qp.lo, qp.hi
    n, m = P.shape[0], A.shape[0]
    eq = np.isclose(lo, hi)
    rho_vec = np.where(eq, rho * rho_eq_scale, rho)

    M = P + sigma * np.eye(n) + A.T @ (rho_vec[:, None] * A)
    cho = scipy.linalg.cho_factor(M)

    z = np.zeros(n)
    s = np.clip(np.zeros(m), lo, hi)
    y = np.zeros(m)
    alpha = 1.6
    for _ in range(iters):
        rhs = sigma * z - q + A.T @ (rho_vec * s - y)
        zt = scipy.linalg.cho_solve(cho, rhs)
        Azt = A @ zt
        z = alpha * zt + (1 - alpha) * z
        st = alpha * Azt + (1 - alpha) * s
        s_new = np.clip(st + y / rho_vec, lo, hi)
        y = y + rho_vec * (st - s_new)
        s = s_new

    # exact polish on a guessed active set: first the dual-identified set,
    # then primal proximity |Az - bound| at a ladder of tolerances (an ADMM
    # run that stalls near 1e-6 leaves small spurious duals on inactive
    # rows). A candidate counts only with admissible dual signs; the one
    # with the smallest KKT residual wins over the raw ADMM iterate.
    Az = A @ z
    best = (z, y, kkt_residuals(P, q, A, lo, hi, z, y))
    act = eq | (y > 1e-8) | (y < -1e-8) | (np.abs(Az - lo) < 1e-7) | (np.abs(Az - hi) < 1e-7)
    act_lo = (~eq) & act & (np.abs(Az - lo) <= np.abs(Az - hi))
    guesses = [(act_lo, (~eq) & act & ~act_lo)]
    scale = 1.0 + np.maximum(np.abs(lo), np.abs(hi))
    for tol in (1e-9, 1e-7, 1e-6, 1e-5, 1e-4):
        near_lo = (~eq) & (Az - lo <= tol * scale)
        guesses.append((near_lo, (~eq) & (hi - Az <= tol * scale) & ~near_lo))
    for g_lo, g_hi in guesses:
        act = eq | g_lo | g_hi
        b = np.where(eq | g_lo, lo, hi)
        Aact = A[act]
        k = Aact.shape[0]
        K = np.block([[P, Aact.T], [Aact, np.zeros((k, k))]])
        try:
            sol, *_ = np.linalg.lstsq(K, np.concatenate([-q, b[act]]), rcond=None)
        except np.linalg.LinAlgError:
            continue
        zp = sol[:n]
        yp = np.zeros(m)
        yp[act] = sol[n:n + k]
        sign_ok = np.all(yp[g_lo] <= 1e-7) and np.all(yp[g_hi] >= -1e-7)
        res = kkt_residuals(P, q, A, lo, hi, zp, yp)
        if sign_ok and max(res) < max(best[2]):
            best = (zp, yp, res)
    return best


def extract_controls(qp: SparseQP, z: np.ndarray) -> np.ndarray:
    """(T, 2) control sequence from the sparse solution vector."""
    T = qp.T
    return z[4 * (T + 1):].reshape(T, 2)


def extract_states(qp: SparseQP, z: np.ndarray) -> np.ndarray:
    """(T+1, 4) state trajectory from the sparse solution vector."""
    T = qp.T
    return z[: 4 * (T + 1)].reshape(T + 1, 4)
