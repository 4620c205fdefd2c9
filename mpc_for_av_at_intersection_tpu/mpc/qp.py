"""Batched dense box-constrained QP solver: OSQP-style ADMM + active-set polish.

Replaces the reference's CVXPY/ECOS interior-point solve
(``main/lib/mpc.py:193-194``) with an accelerator-shaped algorithm:

- fixed iteration counts (no data-dependent control flow under jit),
- one small Cholesky refactorization per outer round (rho adaptation),
- an active-set polish solve that recovers interior-point-level accuracy
  when ADMM has identified the active set (the usual case),
- everything dtype-polymorphic and vmap-batchable: a batch of scenarios
  is (B, n, n) Cholesky factorizations + (B, m, n) matvecs.

Problem form: min 1/2 x'Px + q'x  s.t.  lo <= Gx <= hi.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..backend import fp32_matmuls, stages


class QPSolution(NamedTuple):
    x: jnp.ndarray          # (n,) primal solution
    y: jnp.ndarray          # (m,) dual for lo <= Gx <= hi (+: upper, -: lower)
    polished: jnp.ndarray   # () bool — polish accepted
    prim_res: jnp.ndarray   # () inf-norm of primal residual (pre-polish)
    dual_res: jnp.ndarray   # () inf-norm of dual residual (pre-polish)
    # diagnostics for cross-tick warm starting (round-5): final ADMM
    # penalty (scaled problem) and number of iteration blocks executed
    rho: jnp.ndarray = None
    checks: jnp.ndarray = None


def _ruiz_equilibrate(P, q, G, iters: int = 10):
    """Modified Ruiz equilibration of the KKT operator [[P, G'], [G, 0]]
    plus OSQP-style cost normalization. Returns (d, e, c): variable scaling,
    constraint scaling, cost scaling. Dramatically evens out ADMM
    convergence across instances (cost scales here span 1e-2..260)."""
    n = P.shape[0]
    m = G.shape[0]
    dtype = P.dtype
    # carries seeded from inputs so varying-axis types line up under
    # shard_map (a constant init would mismatch the varying loop output)
    zero = q[0] * 0.0
    d = jnp.ones((n,), dtype) + zero
    e = jnp.ones((m,), dtype) + zero
    c = jnp.asarray(1.0, dtype) + zero
    eps = jnp.asarray(1e-8, dtype)

    def body(_, carry):
        d, e, c = carry
        Ps = (c * d[:, None]) * P * d[None, :]
        Gs = e[:, None] * G * d[None, :]
        col_x = jnp.maximum(
            jnp.max(jnp.abs(Ps), axis=0), jnp.max(jnp.abs(Gs), axis=0)
        )
        row_y = jnp.max(jnp.abs(Gs), axis=1)
        d = d / jnp.sqrt(jnp.maximum(col_x, eps))
        e = e / jnp.sqrt(jnp.maximum(row_y, eps))
        # cost normalization
        Ps = (c * d[:, None]) * P * d[None, :]
        qs = c * d * q
        g = jnp.maximum(
            jnp.mean(jnp.max(jnp.abs(Ps), axis=0)), jnp.max(jnp.abs(qs))
        )
        c = c / jnp.maximum(g, eps)
        return d, e, c

    d, e, c = jax.lax.fori_loop(0, iters, body, (d, e, c))
    return d, e, c


class _PolishFactors(NamedTuple):
    """Active-set-independent factorizations, shared across attempts."""

    Lp: jnp.ndarray        # (n, n) Cholesky of P
    H: jnp.ndarray         # (m, m) G P^-1 G'
    Piq: jnp.ndarray       # (n,) P^-1 q


def _polish_factor(P, q, G):
    """One Cholesky of P + one Gram matrix; every active-set guess then
    costs only a Cholesky of its masked (m, m) Schur complement — no
    pivoted LU anywhere."""
    Lp = jnp.linalg.cholesky(P)
    Y = jax.scipy.linalg.cho_solve((Lp, True), G.T)    # (n, m) = P^-1 G'
    H = G @ Y
    Piq = jax.scipy.linalg.cho_solve((Lp, True), q)
    return _PolishFactors(Lp, H, Piq)


def _polish_masks(P, q, G, lo, hi, act_lo, act_hi, fac: _PolishFactors):
    """Equality-constrained resolve on a given active-set guess via the
    Schur complement of the KKT system.

    Fixed-shape trick: inactive rows contribute an identity row to the
    Schur matrix S = D H D + (I - D), forcing their multiplier to zero, so
    S keeps shape (m, m) regardless of which set is active. One step of
    iterative refinement through the same factorizations recovers fp32
    accuracy (the explicit P^-1 round-trip loses a few digits).
    """
    m = G.shape[0]
    dtype = P.dtype
    act = act_lo | act_hi
    d = act.astype(dtype)
    b = jnp.where(act_lo, lo, hi)

    S = d[:, None] * fac.H * d[None, :] + jnp.diag(1.0 - d)
    # OSQP-style delta regularization: a degenerate active set (e.g. a
    # velocity row that is a linear combination of active accel rows —
    # routine when braking to a stop) makes S singular; the ridge keeps
    # the factorization stable and the refinement pass below recovers the
    # accuracy. The accept test still guards the result.
    reg = 1e-7 * jnp.maximum(jnp.max(jnp.diag(S)), 1.0)
    S = S + reg * jnp.eye(m, dtype=dtype)
    Ls = jnp.linalg.cholesky(S)

    def kkt_solve(r1, r2):
        # P dx + G'D dl = r1 ; D G dx = r2 ; (I-D) dl = 0
        Pir1 = jax.scipy.linalg.cho_solve((fac.Lp, True), r1)
        dl = jax.scipy.linalg.cho_solve((Ls, True), d * (G @ Pir1) - r2)
        dx = Pir1 - jax.scipy.linalg.cho_solve((fac.Lp, True), G.T @ (d * dl))
        return dx, dl

    xp, lam = kkt_solve(-q, d * b)
    # one refinement pass (exact KKT residual through the same factors)
    r1 = -(q + P @ xp + G.T @ (d * lam))
    r2 = d * (b - G @ xp)
    dx, dl = kkt_solve(r1, r2)
    xp = xp + dx
    lam = lam + dl
    return xp, d * lam


def _certified_resolve(P, q, G, lo, hi, act_lo, act_hi, fac):
    """Resolve on an active-set guess and certify it: (x, y, Gx, ok).

    ``ok`` is a KKT certificate: the resolve is finite and primal feasible,
    and every active row's multiplier has the sign of its bound;
    stationarity holds by construction, so a certified x is the QP's
    optimum up to rounding. (Comparing objectives with the ADMM iterate
    instead rejects true optima: a loose iterate is slightly infeasible
    and can score lower.)"""
    xp, yp = _polish_masks(P, q, G, lo, hi, act_lo, act_hi, fac)
    Gxp = G @ xp
    span = jnp.maximum(jnp.max(jnp.abs(hi)), 1.0)
    viol = jnp.max(jnp.maximum(Gxp - hi, lo - Gxp))
    ys = jnp.maximum(jnp.max(jnp.abs(yp)), 1.0)
    signs = jnp.all(jnp.where(act_hi, yp >= -1e-5 * ys, True)
                    & jnp.where(act_lo, yp <= 1e-5 * ys, True))
    finite = jnp.all(jnp.isfinite(xp)) & jnp.all(jnp.isfinite(yp))
    return xp, yp, Gxp, finite & (viol <= 1e-5 * span) & signs


def _near_bounds(Gx, lo, hi):
    """Active-set guess from primal proximity: rows within 1e-3 of their
    span from a bound (a row cannot be active at both bounds; ties break
    toward the closer one)."""
    ptol = 1e-3 * jnp.maximum(jnp.maximum(jnp.abs(lo), jnp.abs(hi)), 1.0)
    return ((Gx - lo <= ptol) & (Gx - lo <= hi - Gx),
            (hi - Gx <= ptol) & (hi - Gx < Gx - lo))


def _polished(G, lo, hi, prim, dual, ok, x_out, y_out):
    # report the primal infeasibility of the RETURNED x (a successful polish
    # means an exact solve even when the raw ADMM residual was loose)
    Gx_out = G @ x_out
    viol_out = jnp.max(
        jnp.maximum(jnp.maximum(Gx_out - hi, lo - Gx_out), 0.0)
    )
    prim_out = jnp.where(ok, viol_out, jnp.maximum(prim, viol_out))
    return QPSolution(x_out, y_out, ok, prim_out, dual)


def _polish_and_select(P, q, G, lo, hi, x, y, prim, dual, act_tol_rel):
    """Two-attempt polish with branchless selection.

    Attempt 1 identifies the active set from the ADMM duals (the OSQP
    recipe). Attempt 2 re-identifies it from primal proximity (|Gx - bound|
    small), which rescues instances whose loosely converged dual
    mis-identifies the set. The P-Cholesky and Gram matrix are factored
    once and shared; each attempt adds only an (m, m) Cholesky, and always
    computing both keeps the path branchless under jit/vmap. Each attempt
    must pass ``_certified_resolve``; a row neither certifies keeps the
    ADMM iterate with ``polished`` False (``_polish_updates`` and the
    solvers' resumed ADMM take it from there).
    """
    fac = _polish_factor(P, q, G)
    tol = act_tol_rel * jnp.maximum(jnp.max(jnp.abs(y)), 1.0)
    xp1, yp1, _, ok1 = _certified_resolve(P, q, G, lo, hi, y < -tol,
                                          y > tol, fac)
    near_lo, near_hi = _near_bounds(G @ x, lo, hi)
    xp2, yp2, _, ok2 = _certified_resolve(P, q, G, lo, hi, near_lo, near_hi,
                                          fac)
    x_out = jnp.where(ok1, xp1, jnp.where(ok2, xp2, x))
    y_out = jnp.where(ok1, yp1, jnp.where(ok2, yp2, y))
    return _polished(G, lo, hi, prim, dual, ok1 | ok2, x_out, y_out)


def _polish_updates(P, q, G, lo, hi, x, y, prim, dual, steps: int = 3):
    """Polish by primal-dual active-set updates, for a row the two attempts
    did not certify: from the primal-proximity set, each step drops the
    active rows whose multiplier has the wrong sign and adds the rows the
    last resolve violates, until a resolve is certified or ``steps``
    updates are spent (the loop stops as soon as every row is certified)."""
    fac = _polish_factor(P, q, G)
    vtol = 1e-7 * jnp.maximum(jnp.maximum(jnp.abs(lo), jnp.abs(hi)), 1.0)
    act = _near_bounds(G @ x, lo, hi)
    xp, yp, Gxp, ok = _certified_resolve(P, q, G, lo, hi, *act, fac)
    x_out = jnp.where(ok, xp, x)
    y_out = jnp.where(ok, yp, y)

    def cond(carry):
        k, _, _, _, _, ok = carry
        return (k < steps) & ~ok

    def body(carry):
        k, (act_lo, act_hi), x_out, y_out, (yp, Gxp), _ = carry
        free = ~(act_lo | act_hi)
        act = ((act_lo & (yp < 0)) | (free & (lo - Gxp > vtol)),
               (act_hi & (yp > 0)) | (free & (Gxp - hi > vtol)))
        xp, yp, Gxp, ok = _certified_resolve(P, q, G, lo, hi, *act, fac)
        return (k + 1, act, jnp.where(ok, xp, x_out),
                jnp.where(ok, yp, y_out), (yp, Gxp), ok)

    _, _, x_out, y_out, _, ok = jax.lax.while_loop(
        cond, body, (jnp.asarray(0, jnp.int32), act, x_out, y_out,
                     (yp, Gxp), ok))
    return _polished(G, lo, hi, prim, dual, ok, x_out, y_out)


def _repair_rows(sol: QPSolution, repair, chunk: int) -> QPSolution:
    """Rewrite the rows of a batched ``sol`` that no polish certified with
    ``repair(idx, take)``, a QPSolution for the rows ``idx`` (``take``
    marks the failing ones; the rest pad the chunk). ``chunk`` rows at a
    time are gathered to a fixed shape, so the repair costs what the
    failing rows need and not a whole-batch pass. No failing row: no
    pass."""
    chunk = min(chunk, sol.polished.shape[0])

    def cond(carry):
        return jnp.any(carry[1])

    def body(carry):
        sol, todo = carry
        idx = jnp.argsort(jnp.logical_not(todo), stable=True)[:chunk]
        take = todo[idx]
        new = repair(idx, take)
        sol = jax.tree.map(
            lambda a, b: a.at[idx].set(jnp.where(
                take.reshape((-1,) + (1,) * (b.ndim - 1)), b, a[idx])),
            sol, new)
        return sol, todo.at[idx].set(False)

    return jax.lax.while_loop(
        cond, body, (sol, jnp.logical_not(sol.polished)))[0]


def _unless_polished(sol: QPSolution, repair) -> QPSolution:
    """``repair(sol)`` for a single-scenario solve that is not polished,
    as a loop of at most one pass: under vmap a ``cond`` would run the
    repair for every row, this only when some row needs it."""
    def body(carry):
        _, sol = carry
        return jnp.asarray(True), repair(sol)

    return jax.lax.while_loop(
        lambda c: jnp.logical_not(c[0] | c[1].polished), body,
        (jnp.asarray(False), sol))[1]


@fp32_matmuls
def solve_box_qp(
    P,
    q,
    G,
    lo,
    hi,
    rounds: int = 6,
    iters: int = 30,
    rho0: float = 0.1,
    sigma: float = 1e-6,
    alpha: float = 1.6,
    polish: bool = True,
    act_tol_rel: float = 1e-4,
    scale: bool = True,
    warm=None,                  # None | (x0 (n,), y0 (m,), rho_w ())
    eps: float = 0.0,           # relative-residual early exit (0 = off)
    refactor_band: float = 0.0,  # rho drift band (<= 1 = refactor always)
    stall_cap: float = 0.0,      # stall-exit score cap (0 = off)
    stall_ratio: float = 0.5,    # min per-block improvement factor
    ruiz_iters: int = 10,
) -> QPSolution:
    """Solve one dense box-QP (vmap over a leading batch axis to batch).

    ``rounds`` x ``iters`` is the iteration budget (refactorize + rho
    adapt between rounds). With ``eps > 0`` the solver exits as soon as
    both relative residuals drop below it, and with ``refactor_band > 1``
    rounds reuse the previous factorization while rho stays inside the
    band (OSQP's direct-solver policy). ``warm`` carries the previous
    tick's (x, y, rho) — the cross-tick closed-loop MPC warm start
    (reference intent: ``main/lib/mpc.py:222-224``).

    Runs with every matmul at full fp32 (``backend.fp32_matmuls``):
    reduced-precision matmul passes degrade polish acceptance and the
    residuals.
    """
    n = P.shape[0]
    m = G.shape[0]
    dtype = P.dtype

    if scale:
        d, e, c = _ruiz_equilibrate(P, q, G, iters=ruiz_iters)
        Ps = (c * d[:, None]) * P * d[None, :]
        qs = c * d * q
        Gs = e[:, None] * G * d[None, :]
        los = e * lo
        his = e * hi
    else:
        d = jnp.ones((n,), dtype)
        e = jnp.ones((m,), dtype)
        c = jnp.asarray(1.0, dtype)
        Ps, qs, Gs, los, his = P, q, G, lo, hi

    # init seeded from inputs so scan-carry varying-axis types line up
    # under shard_map; warm start scaled into the equilibrated problem
    zero = q[0] * 0.0
    if warm is None:
        x = jnp.zeros((n,), dtype) + zero
        y = jnp.zeros((m,), dtype) + zero
        rho = jnp.asarray(rho0, dtype) + zero
    else:
        x0, y0, rho_w = warm
        x = x0 / d + zero
        y = (c * y0) / e + zero
        rho = jnp.asarray(rho_w, dtype) + zero
    z = jnp.clip(Gs @ x, los, his)

    # seeded from inputs: under shard_map the cond-wrapped factorization
    # requires every operand's varying axes to match
    eye = jnp.eye(n, dtype=dtype) + zero

    def factorize(rho):
        M = Ps + sigma * eye + rho * (Gs.T @ Gs)
        L = jnp.linalg.cholesky(M)
        # explicit inverse: one triangular solve with n right-hand sides
        # per factorization, so the hot inner loop is pure matvecs;
        # accuracy is recovered by the polish afterwards
        return jax.scipy.linalg.cho_solve((L, True), eye)

    def run_checks(carry, eps, stall_cap):
        """ADMM check blocks from ``carry`` until every row converges
        (relative residuals <= ``eps``, or the stall exit) or ``rounds``."""
        def check_cond(carry):
            (k, x, z, y, rho_f, rho_p, refac, Minv, prim, dual,
             done, prev_score) = carry
            return (k < rounds) & jnp.logical_not(done)

        def check_body(carry):
            (k, x, z, y, rho_f, rho_p, refac, Minv, prim, dual,
             done, prev_score) = carry
            Minv = jax.lax.cond(refac, lambda: factorize(rho_p), lambda: Minv)
            rho_v = jnp.where(refac, rho_p, rho_f)

            def it(carry, _):
                x, z, y = carry
                rhs = sigma * x - qs + Gs.T @ (rho_v * z - y)
                xt = Minv @ rhs
                Gxt = Gs @ xt
                x_n = alpha * xt + (1.0 - alpha) * x
                z_t = alpha * Gxt + (1.0 - alpha) * z
                z_n = jnp.clip(z_t + y / rho_v, los, his)
                y_n = y + rho_v * (z_t - z_n)
                return (x_n, z_n, y_n), None

            (x, z, y), _ = jax.lax.scan(it, (x, z, y), None, length=iters)

            # residuals + OSQP-style rho adaptation
            Gx = Gs @ x
            prim = jnp.max(jnp.abs(Gx - z))
            Px = Ps @ x
            dual = jnp.max(jnp.abs(Px + qs + Gs.T @ y))
            prim_rel = prim / jnp.maximum(
                jnp.maximum(jnp.max(jnp.abs(Gx)), jnp.max(jnp.abs(z))), 1e-6
            )
            dual_rel = dual / jnp.maximum(
                jnp.maximum(jnp.max(jnp.abs(Px)), jnp.max(jnp.abs(qs))), 1e-6
            )
            rho_n = jnp.clip(
                rho_v * jnp.sqrt((prim_rel + 1e-12) / (dual_rel + 1e-12)),
                1e-6, 1e6,
            )
            score = jnp.maximum(prim_rel, dual_rel)
            if eps > 0.0:
                done = (prim_rel <= eps) & (dual_rel <= eps)
                if stall_cap > 0.0:
                    # stall exit: near-converged but no longer improving ->
                    # stop and let the polish finish
                    done = done | ((score <= stall_cap)
                                   & (score > stall_ratio * prev_score)
                                   & (prim <= 5e-3))
            prev_score = score
            if refactor_band > 1.0:
                ratio = rho_n / rho_v
                refac_n = ((ratio > refactor_band)
                           | (ratio * refactor_band < 1.0)) & jnp.logical_not(done)
            else:
                refac_n = jnp.asarray(True)
            return (k + 1, x, z, y, rho_v, rho_n, refac_n, Minv, prim, dual,
                    done, prev_score)

        return jax.lax.while_loop(check_cond, check_body, carry)

    # non-scalar/boolean carries seeded from inputs so varying-axis types
    # line up under shard_map (a constant init would mismatch the varying
    # loop outputs)
    carry0 = (
        jnp.asarray(0, jnp.int32), x, z, y, rho, rho,
        zero == 0.0, jnp.zeros((n, n), dtype) + zero,
        jnp.zeros((), dtype) + zero, jnp.zeros((), dtype) + zero,
        zero > 1.0, jnp.full((), 1e30, dtype) + zero,
    )
    carry = run_checks(carry0, eps, stall_cap)

    def unscaled(carry):
        (k, xs, _, ys, rho_f, _, _, _, prim, dual, _, _) = carry
        # back to the original problem
        return d * xs, (e * ys) / c, prim, dual, rho_f, k

    def finish(carry):
        x, y, prim, dual, rho_f, k = unscaled(carry)
        if not polish:
            Gx = G @ x
            viol = jnp.max(jnp.maximum(jnp.maximum(Gx - hi, lo - Gx), 0.0))
            return QPSolution(x, y, jnp.asarray(False), viol, dual,
                              rho=rho_f, checks=k)
        sol = _polish_and_select(P, q, G, lo, hi, x, y, prim, dual,
                                 act_tol_rel)
        sol = sol._replace(rho=rho_f, checks=k)

        def updates(sol):
            x, y, prim, dual, _, _ = unscaled(carry)
            return _polish_updates(P, q, G, lo, hi, x, y, prim, dual)._replace(
                rho=sol.rho, checks=sol.checks)

        return _unless_polished(sol, updates)

    sol = finish(carry)
    if not polish:
        return sol

    def resume(sol):
        # still uncertified: ADMM resumes where it stopped, at a 10x
        # tighter tolerance without the stall exit, and polishes again
        (k, xs, zs, ys, rho_f, rho_p, _, Minv, prim, dual, _, _) = carry
        again = (k * 0, xs, zs, ys, rho_f, rho_p, zero == 0.0, Minv, prim,
                 dual, zero > 1.0, jnp.full((), 1e30, dtype) + zero)
        sol2 = finish(run_checks(again, 0.1 * eps, 0.0))
        return sol2._replace(checks=sol2.checks + k)

    return _unless_polished(sol, resume)


@fp32_matmuls
def solve_box_qp_batched(
    P,      # (B, n, n)
    q,      # (B, n)
    G,      # (B, m, n)
    lo,     # (B, m)
    hi,     # (B, m)
    rounds: int = 10,
    iters: int = 50,
    rho0: float = 0.1,
    sigma: float = 1e-6,
    alpha: float = 1.6,
    polish: bool = True,
    warm=None,                  # None | (x0 (B, n), y0 (B, m), rho_w (B,))
    eps: float = 0.0,
    refactor_band: float = 0.0,
    stall_cap: float = 0.0,
    stall_ratio: float = 0.5,
    ruiz_iters: int = 10,
) -> QPSolution:
    """Natively batched solver: same algorithm as ``solve_box_qp``, with
    each scenario freezing at its own convergence, tracking its own rho
    and refactorizing on its own drift. The inner ADMM iterations run in
    the implementation ``backend.stages().admm`` picks for the platform."""
    if stages().admm == "triton":
        from ..ops.admm_triton import admm_block_triton as admm_block
    else:
        admm_block = _admm_block_xla
    return _solve_box_qp_batched(
        P, q, G, lo, hi, rounds, iters, rho0, sigma, alpha, polish, warm,
        eps, refactor_band, stall_cap, stall_ratio, ruiz_iters, admm_block)


def _admm_block_xla(Minv, Gs, qs, los, his, rho, run, x, z, y, *,
                    iters, sigma, alpha):
    """``iters`` ADMM iterations for each scenario with ``run`` set (the
    XLA twin of ``ops.admm_triton.admm_block_triton``)."""
    frz = jnp.logical_not(run)[:, None]

    def it(carry, _):
        x, z, y = carry
        t = rho[:, None] * z - y
        rhs = sigma * x - qs + jnp.einsum("bmn,bm->bn", Gs, t)
        xt = jnp.einsum("bnk,bk->bn", Minv, rhs)
        Gxt = jnp.einsum("bmn,bn->bm", Gs, xt)
        xn = alpha * xt + (1 - alpha) * x
        zt = alpha * Gxt + (1 - alpha) * z
        zn = jnp.clip(zt + y / rho[:, None], los, his)
        yn = y + rho[:, None] * (zt - zn)
        return (jnp.where(frz, x, xn), jnp.where(frz, z, zn),
                jnp.where(frz, y, yn)), None

    (x, z, y), _ = jax.lax.scan(it, (x, z, y), None, length=iters)
    return x, z, y


def _equilibrate_batched(P, q, G, lo, hi, ruiz_iters):
    """Per-scenario Ruiz scaling of a batch: (d, e, c) and the scaled
    (P, q, G, lo, hi)."""
    d, e, c = jax.vmap(lambda P_, q_, G_: _ruiz_equilibrate(
        P_, q_, G_, iters=ruiz_iters))(P, q, G)
    Ps = (c[:, None, None] * d[:, :, None]) * P * d[:, None, :]
    qs = c[:, None] * d * q
    Gs = e[:, :, None] * G * d[:, None, :]
    return d, e, c, Ps, qs, Gs, e * lo, e * hi


def _admm_operator_batched(Ps, Gs, rho, sigma, eye):
    """(P + sigma I + rho G'G)^-1 per scenario: one Cholesky and one
    triangular solve with n right-hand sides per factorization, so the hot
    inner loop is pure matvecs; accuracy is recovered by the polish."""
    B, n = Ps.shape[:2]
    GtG = jnp.einsum("bmn,bmk->bnk", Gs, Gs)
    M = Ps + sigma * eye[None] + rho[:, None, None] * GtG
    L = jnp.linalg.cholesky(M)
    return jax.scipy.linalg.cho_solve(
        (L, True), jnp.broadcast_to(eye, (B, n, n)))


def _solve_box_qp_batched(
    P, q, G, lo, hi, rounds, iters, rho0, sigma, alpha, polish, warm,
    eps, refactor_band, stall_cap, stall_ratio, ruiz_iters, admm_block,
) -> QPSolution:
    B, n = q.shape
    m = lo.shape[1]
    dtype = q.dtype

    d, e, c, Ps, qs, Gs, los, his = _equilibrate_batched(
        P, q, G, lo, hi, ruiz_iters)

    if warm is None:
        x = jnp.zeros((B, n), dtype)
        y = jnp.zeros((B, m), dtype)
        rho = jnp.full((B,), rho0, dtype)
    else:
        x0, y0, rho_w = warm
        x = x0 / d
        y = (c[:, None] * y0) / e
        rho = rho_w.astype(dtype)
    z = jnp.clip(jnp.einsum("bmn,bn->bm", Gs, x), los, his)

    # seeded from inputs for shard_map varying-axis alignment
    eye = jnp.eye(n, dtype=dtype) + q[0, 0] * 0.0

    def run_checks(carry, prob, eps, stall_cap):
        """ADMM check blocks from ``carry`` on the scaled problem ``prob``
        until every row converges (relative residuals <= ``eps``, or the
        stall exit) or ``rounds``."""
        Ps, qs, Gs, los, his = prob

        def factorize(rho):
            return _admm_operator_batched(Ps, Gs, rho, sigma, eye)

        def check_cond(carry):
            (k, x, z, y, rho_f, rho_p, refac, conv, Minv,
             prim, dual, checks_v, prev_score) = carry
            return (k < rounds) & jnp.logical_not(jnp.all(conv))

        def check_body(carry):
            (k, x, z, y, rho_f, rho_p, refac, conv, Minv,
             prim, dual, checks_v, prev_score) = carry
            rho_v = jnp.where(refac, rho_p, rho_f)
            Minv = jax.lax.cond(
                jnp.any(refac), lambda: factorize(rho_v), lambda: Minv)
            checks_v = checks_v + jnp.logical_not(conv).astype(dtype)

            x, z, y = admm_block(Minv, Gs, qs, los, his, rho_v,
                                 jnp.logical_not(conv), x, z, y,
                                 iters=iters, sigma=sigma, alpha=alpha)

            # residuals + rho adaptation (per scenario)
            Gx = jnp.einsum("bmn,bn->bm", Gs, x)
            prim_n = jnp.max(jnp.abs(Gx - z), axis=1)
            Px = jnp.einsum("bnk,bk->bn", Ps, x)
            Gty = jnp.einsum("bmn,bm->bn", Gs, y)
            dual_n = jnp.max(jnp.abs(Px + qs + Gty), axis=1)
            prim = jnp.where(conv, prim, prim_n)
            dual = jnp.where(conv, dual, dual_n)
            prim_rel = prim / jnp.maximum(
                jnp.maximum(jnp.max(jnp.abs(Gx), axis=1), jnp.max(jnp.abs(z), axis=1)),
                1e-6,
            )
            dual_rel = dual / jnp.maximum(
                jnp.maximum(jnp.max(jnp.abs(Px), axis=1), jnp.max(jnp.abs(qs), axis=1)),
                1e-6,
            )
            rho_n = jnp.clip(
                rho_v * jnp.sqrt((prim_rel + 1e-12) / (dual_rel + 1e-12)), 1e-6, 1e6
            )
            rho_f = jnp.where(conv, rho_f, rho_v)
            rho_p = jnp.where(conv, rho_p, rho_n)
            score = jnp.maximum(prim_rel, dual_rel)
            if eps > 0.0:
                conv_now = (prim_rel <= eps) & (dual_rel <= eps)
                if stall_cap > 0.0:
                    # stall exit: near-converged but no longer improving ->
                    # stop and let the polish finish
                    conv_now = conv_now | ((score <= stall_cap)
                                           & (score > stall_ratio * prev_score)
                                           & (prim <= 5e-3))
                conv = conv | conv_now
            prev_score = jnp.where(conv, prev_score, score)
            if refactor_band > 1.0:
                ratio = rho_n / rho_v
                refac_n = (
                    (ratio > refactor_band) | (ratio * refactor_band < 1.0)
                ) & jnp.logical_not(conv)
            else:
                refac_n = jnp.logical_not(conv)
            return (k + 1, x, z, y, rho_f, rho_p, refac_n, conv, Minv,
                    prim, dual, checks_v, prev_score)

        return jax.lax.while_loop(check_cond, check_body, carry)

    # seeded from inputs for shard_map varying-axis alignment (see the
    # single-scenario twin)
    zeroB = q[:, 0] * 0.0
    falseB = zeroB > 1.0
    carry0 = (
        jnp.asarray(0, jnp.int32), x, z, y, rho, rho,
        jnp.logical_not(falseB), falseB,
        jnp.zeros((B, n, n), dtype) + zeroB[:, None, None],
        zeroB, zeroB, zeroB, zeroB + 1e30,
    )
    prob = (Ps, qs, Gs, los, his)
    carry = run_checks(carry0, prob, eps, stall_cap)

    def unscaled(carry, d, e, c):
        (_, x, _, y, rho_f, _, _, _, _, prim, dual, checks_v, _) = carry
        return d * x, (e * y) / c[:, None], prim, dual, rho_f, checks_v

    x, y, prim, dual, rho_f, checks_v = unscaled(carry, d, e, c)
    if not polish:
        Gx = jnp.einsum("bmn,bn->bm", G, x)
        viol = jnp.max(jnp.maximum(jnp.maximum(Gx - hi, lo - Gx), 0.0),
                       axis=1)
        return QPSolution(x, y, jnp.zeros((B,), bool), viol, dual,
                          rho=rho_f, checks=checks_v)

    sol = jax.vmap(lambda *a: _polish_and_select(*a, 1e-4))(
        P, q, G, lo, hi, x, y, prim, dual)._replace(rho=rho_f,
                                                    checks=checks_v)

    def rows(tree, idx):
        return jax.tree.map(lambda a: a[idx], tree)

    # rows neither attempt certified (~20% of warm closed-loop solves):
    # active-set updates, a quarter of the batch at a time
    def updates(idx, take):
        return jax.vmap(_polish_updates)(
            *rows((P, q, G, lo, hi, x, y, prim, dual), idx))._replace(
                rho=rho_f[idx], checks=checks_v[idx])

    sol = _repair_rows(sol, updates, max(1, B // 4))

    # rows still uncertified (~0.5%): ADMM resumes where it stopped, at a
    # 10x tighter tolerance without the stall exit, and is polished again
    def resume(idx, take):
        (k, xs, zs, ys, rf, rp, _, _, Minv, pr, du, cv, ps) = carry
        again = (k * 0, xs[idx], zs[idx], ys[idx], rf[idx], rp[idx], take,
                 jnp.logical_not(take), Minv[idx], pr[idx], du[idx], cv[idx],
                 ps[idx] * 0.0 + 1e30)
        sub = rows((P, q, G, lo, hi), idx)
        x2, y2, pr2, du2, rf2, cv2 = unscaled(
            run_checks(again, rows(prob, idx), 0.1 * eps, 0.0),
            *rows((d, e, c), idx))
        s2 = jax.vmap(lambda *a: _polish_and_select(*a, 1e-4))(
            *sub, x2, y2, pr2, du2)
        s3 = jax.vmap(_polish_updates)(*sub, x2, y2, pr2, du2)
        s2 = jax.tree.map(
            lambda a, b: jnp.where(
                s2.polished.reshape((-1,) + (1,) * (a.ndim - 1)), a, b),
            s2, s3)
        return s2._replace(rho=rf2, checks=cv2)

    return _repair_rows(sol, resume, max(1, B // 64))


def kkt_residuals(P, q, G, lo, hi, x, y):
    """(stationarity, primal, complementarity) inf-norm residuals — the
    correctness certificate used by tests and by the float64 oracle."""
    Gx = G @ x
    stat = jnp.max(jnp.abs(P @ x + q + G.T @ y))
    prim = jnp.max(jnp.maximum(jnp.maximum(Gx - hi, lo - Gx), 0.0))
    y_pos = jnp.maximum(y, 0.0)
    y_neg = jnp.minimum(y, 0.0)
    comp = jnp.max(jnp.abs(y_pos * (hi - Gx)) + jnp.abs(y_neg * (Gx - lo)))
    return stat, prim, comp
