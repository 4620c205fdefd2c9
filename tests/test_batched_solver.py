"""Batched solver (XLA and Triton inner loops) vs the per-scenario vmapped
solver and the float64 oracle."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mpc_for_av_at_intersection_tpu import backend
from mpc_for_av_at_intersection_tpu.mpc import MPCConfig, solve_box_qp
from mpc_for_av_at_intersection_tpu.mpc import qp as qpmod
from mpc_for_av_at_intersection_tpu.mpc.qp import (
    _admm_block_xla,
    solve_box_qp_batched,
)
from mpc_for_av_at_intersection_tpu.ops import admm_triton


@pytest.fixture
def triton_interpret(monkeypatch):
    """Route the CPU platform's ADMM inner loop through the Triton kernel,
    run by the Pallas interpreter."""
    monkeypatch.setitem(backend._STAGES, "cpu", backend.Stages(admm="triton"))
    monkeypatch.setattr(
        admm_triton, "admm_block_triton",
        functools.partial(admm_triton.admm_block_triton, interpret=True))


def _random_batch(rng, B, n, m):
    Z = rng.normal(size=(B, n, n))
    P = np.einsum("bij,bkj->bik", Z, Z) + 0.1 * np.eye(n)
    q = rng.normal(size=(B, n))
    G = rng.normal(size=(B, m, n))
    center = rng.normal(size=(B, m))
    width = rng.uniform(0.1, 2.0, size=(B, m))
    return (jnp.asarray(P, jnp.float32), jnp.asarray(q, jnp.float32),
            jnp.asarray(G, jnp.float32), jnp.asarray(center - width, jnp.float32),
            jnp.asarray(center + width, jnp.float32))


def test_batched_xla_matches_vmapped():
    rng = np.random.default_rng(0)
    P, q, G, lo, hi = _random_batch(rng, 7, 6, 9)
    ref = jax.vmap(lambda *a: solve_box_qp(*a, rounds=8, iters=60))(P, q, G, lo, hi)
    got = solve_box_qp_batched(P, q, G, lo, hi, rounds=8, iters=60)
    np.testing.assert_allclose(np.asarray(got.x), np.asarray(ref.x), atol=2e-4)


def test_active_set_updates_certify_loose_iterates():
    """From loose ADMM iterates (one short block), the primal-dual
    active-set updates certify rows the two polish attempts do not, and
    every row they certify is the QP's optimum (the float64 solve)."""
    rng = np.random.default_rng(5)
    P, q, G, lo, hi = _random_batch(rng, 64, 8, 16)
    with jax.default_matmul_precision("float32"):
        loose = solve_box_qp_batched(P, q, G, lo, hi, rounds=1, iters=12,
                                     polish=False)
        args = (P, q, G, lo, hi, loose.x, loose.y, loose.prim_res,
                loose.dual_res)
        two = jax.vmap(lambda *a: qpmod._polish_and_select(*a, 1e-4))(*args)
        upd = jax.vmap(qpmod._polish_updates)(*args)
    with jax.enable_x64(True):
        ref = solve_box_qp_batched(
            *(jnp.asarray(a, jnp.float64) for a in (P, q, G, lo, hi)),
            rounds=40, iters=100, eps=1e-10)
    two_ok, upd_ok = np.asarray(two.polished), np.asarray(upd.polished)
    assert (two_ok | upd_ok).sum() > two_ok.sum() >= 1
    err = np.abs(np.asarray(upd.x, np.float64) - np.asarray(ref.x))
    assert err[upd_ok].max() < 1e-4


@pytest.mark.parametrize("path", ["batched", "single"])
def test_uncertified_rows_resume_admm_and_polish_again(monkeypatch, path):
    """A row neither the polish attempts nor the active-set updates
    certify resumes ADMM where it stopped (at a tighter tolerance) and is
    polished again: with the first pass's polish forced to fail, every row
    still ends certified, at the solution of an undisturbed solve, after
    more check blocks."""
    states, course, cv, n, dl = _mpc_instances(21, 6)
    cqp = _mpc_qps(states, course, cv, n, dl, MPCConfig(T=13))
    args = (cqp.P, cqp.q, cqp.G, cqp.lo, cqp.hi)
    kw = dict(rounds=16, iters=32, eps=1e-2, ruiz_iters=3)

    def solver(polish=True):
        k = dict(kw, polish=polish)
        if path == "batched":
            return jax.jit(lambda *a: solve_box_qp_batched(*a, **k))
        return jax.jit(jax.vmap(lambda *a: solve_box_qp(*a, **k)))

    with jax.default_matmul_precision("float32"):
        plain = solver()(*args)
        first_pass = solver(polish=False)(*args)
    calls = []

    def failing_first_pass(name):
        real = getattr(qpmod, name)

        def polish(*a, **k):
            sol = real(*a, **k)
            calls.append(name)
            if calls.count(name) == 1:
                return sol._replace(x=a[5],
                                    polished=jnp.zeros_like(sol.polished))
            return sol

        monkeypatch.setattr(qpmod, name, polish)

    failing_first_pass("_polish_and_select")
    failing_first_pass("_polish_updates")
    with jax.default_matmul_precision("float32"):
        got = solver()(*args)
    assert len(calls) == 4
    assert np.asarray(plain.polished).all() and np.asarray(got.polished).all()
    assert (np.asarray(got.checks) > np.asarray(first_pass.checks)).all()
    np.testing.assert_allclose(np.asarray(got.x), np.asarray(plain.x),
                               atol=1e-4)


def _block_args(rng, B, n, m):
    """One check block's inputs on a real (Ruiz-free) ADMM operator:
    Minv = (P + sigma I + rho G'G)^-1, warm (x, z, y) from a few iterations."""
    P, q, G, lo, hi = _random_batch(rng, B, n, m)
    rho = jnp.asarray(rng.uniform(0.05, 2.0, B), jnp.float32)
    M = P + 1e-6 * jnp.eye(n, dtype=jnp.float32) + rho[:, None, None] * (
        jnp.einsum("bmn,bmk->bnk", G, G, precision="highest"))
    Minv = jnp.linalg.inv(M)
    run = jnp.asarray(rng.random(B) < 0.8)
    x = jnp.asarray(rng.normal(size=(B, n)), jnp.float32)
    z = jnp.clip(jnp.einsum("bmn,bn->bm", G, x, precision="highest"), lo, hi)
    y = jnp.asarray(rng.normal(size=(B, m)), jnp.float32) * 0.1
    return Minv, G, q, lo, hi, rho, run, x, z, y


@pytest.mark.parametrize("n,m", [(6, 9), (8, 16)], ids=["padded", "unpadded"])
def test_triton_block_matches_xla_block(n, m):
    """One warm-started check block of the Triton kernel (Pallas
    interpreter) vs the XLA scan: n, m that need in-kernel padding to
    powers of two and n, m that do not. Frozen rows must not move."""
    rng = np.random.default_rng(n)
    args = _block_args(rng, 13, n, m)
    kw = dict(iters=32, sigma=1e-6, alpha=1.6)
    got = admm_triton.admm_block_triton(*args, interpret=True, **kw)
    with jax.default_matmul_precision("float32"):
        want = _admm_block_xla(*args, **kw)
    run = np.asarray(args[6])
    for g, w, start in zip(got, want, args[7:]):
        g, w = np.asarray(g), np.asarray(w)
        scale = np.maximum(np.abs(w).max(axis=1, keepdims=True), 1.0)
        assert np.max(np.abs(g - w) / scale) <= 1e-4
        np.testing.assert_array_equal(g[~run], np.asarray(start)[~run])


@pytest.mark.gpu
def test_triton_block_compiled_matches_xla_block(gpu_device):
    """The Triton kernel as compiled for the card (no interpreter) at the
    flagship widths (T=20: n=40, m=79) vs the XLA scan."""
    rng = np.random.default_rng(20)
    args = _block_args(rng, 256, 40, 79)
    kw = dict(iters=32, sigma=1e-6, alpha=1.6)
    got = jax.jit(lambda *a: admm_triton.admm_block_triton(*a, **kw))(*args)
    with jax.default_matmul_precision("float32"):
        want = jax.jit(lambda *a: _admm_block_xla(*a, **kw))(*args)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        scale = np.maximum(np.abs(w).max(axis=1, keepdims=True), 1.0)
        assert np.max(np.abs(g - w) / scale) <= 1e-4


def test_triton_solver_matches_xla_solver(triton_interpret):
    """The full adaptive batched solve with the Triton inner loop lands on
    the XLA path's solutions, cold and warm-started."""
    rng = np.random.default_rng(1)
    P, q, G, lo, hi = _random_batch(rng, 24, 6, 9)
    kw = dict(rounds=16, iters=32, eps=1e-4, refactor_band=5.0,
              stall_cap=3e-3, stall_ratio=0.5)
    got = solve_box_qp_batched(P, q, G, lo, hi, **kw)
    got_w = solve_box_qp_batched(P, q, G, lo, hi,
                                 warm=(got.x, got.y, got.rho), **kw)
    backend._STAGES["cpu"] = backend.Stages(admm="xla")
    ref = solve_box_qp_batched(P, q, G, lo, hi, **kw)
    _assert_solutions_match(ref, got)
    assert int(got.polished.sum()) >= int(ref.polished.sum()) - 1
    # rows whose cold solve converged re-converge from their own solution
    # within two blocks (rows that hit the check cap cold have no fixed
    # point to warm from)
    conv = np.asarray(got.checks) < 16
    assert conv.sum() >= 18
    assert np.asarray(got_w.checks)[conv].max() <= 2
    both = conv & np.asarray(got.polished) & np.asarray(got_w.polished)
    np.testing.assert_allclose(np.asarray(got_w.x)[both],
                               np.asarray(got.x)[both], atol=5e-4)


def _assert_solutions_match(a, b, atol=5e-4, loose=2e-2):
    """Solutions must agree tightly wherever BOTH paths' polish accepted
    (exact active-set solves). On rows where exactly one path's polish
    accepted — the accept test sits on a numerical boundary, and the two
    inner loops sum in a different order — the accepted side is the
    *better* solution, so only loose agreement with the other side's raw
    ADMM iterate is required."""
    ax, bx = np.asarray(a.x), np.asarray(b.x)
    both = np.asarray(a.polished) & np.asarray(b.polished)
    np.testing.assert_allclose(bx[both], ax[both], atol=atol)
    np.testing.assert_allclose(bx[~both], ax[~both], atol=loose)


def _mpc_instances(seed, B, N=200):
    from mpc_for_av_at_intersection_tpu.core.angles import smooth_yaw_numpy

    rng = np.random.default_rng(seed)
    dl = 0.083
    turn = rng.normal(0, 0.01, size=(B, N)).cumsum(axis=1)
    yaw = rng.uniform(-np.pi, np.pi, size=(B, 1)) + turn
    xy = np.cumsum(np.stack([np.cos(yaw), np.sin(yaw)], axis=-1) * dl, axis=1)
    course = np.concatenate([xy, yaw[..., None]], axis=-1)
    for b in range(B):
        course[b, :, 2] = smooth_yaw_numpy(course[b, :, 2])
    i0 = rng.integers(3, 30, size=B)
    states = np.stack(
        [course[np.arange(B), i0, 0], course[np.arange(B), i0, 1],
         rng.uniform(0, 8, B), course[np.arange(B), i0, 2]], axis=1)
    return (jnp.asarray(states, jnp.float32), jnp.asarray(course, jnp.float32),
            jnp.zeros((B, N), jnp.float32), jnp.full((B,), N, jnp.int32),
            jnp.full((B,), dl, jnp.float32))


def _mpc_qps(states, course, cv, n, dl, cfg, wb=2.86):
    """Condensed tracking QPs of the instances, linearized about zero
    controls (the cold first tick)."""
    from mpc_for_av_at_intersection_tpu.core.dynamics import (
        SimLimits,
        plant_rollout,
    )
    from mpc_for_av_at_intersection_tpu.mpc import condense, linearize_bicycle
    from mpc_for_av_at_intersection_tpu.mpc.reference import compute_reference

    T = cfg.T
    limits = SimLimits(max_steer=cfg.max_steer, max_speed=cfg.max_speed,
                       min_speed=cfg.min_speed)

    def build(s, c, v, n_, d):
        xref, _, re = compute_reference(
            s, c, v, n_, d, jnp.asarray(0, jnp.int32),
            jnp.zeros((T + 1,), s.dtype), False, T, cfg.dt,
            use_speed_channel=False)
        xbar = plant_rollout(s, jnp.zeros((T, 2), s.dtype), cfg.dt, wb,
                             limits)
        A, Bm, C = linearize_bicycle(xbar[:-1, 2], xbar[:-1, 3],
                                     jnp.zeros((T,), s.dtype), cfg.dt, wb)
        return condense(A, Bm, C, s, xref, re, cfg)

    with jax.default_matmul_precision("float32"):
        return jax.vmap(build)(states, course, cv, n, dl)


def test_batched_mpc_step_matches_vmapped_mpc_step():
    from mpc_for_av_at_intersection_tpu.core.angles import smooth_yaw_numpy
    from mpc_for_av_at_intersection_tpu.models import bicycle_geometry
    from mpc_for_av_at_intersection_tpu.mpc import init_controller_state, mpc_step
    from mpc_for_av_at_intersection_tpu.mpc.batch import mpc_step_batched

    geom = bicycle_geometry()
    # pin the fixed iteration budget: this test checks the BATCHING math
    # identity, and the adaptive early exit legitimately diverges between
    # per-scenario (vmapped while_loop freezes converged rows) and grouped
    # (whole batch iterates until all rows converge) execution on the rare
    # rows the polish rejects
    cfg = MPCConfig(T=13, admm_eps=0.0)
    rng = np.random.default_rng(3)
    B, N = 5, 200
    dl = 0.083
    turn = rng.normal(0, 0.01, size=(B, N)).cumsum(axis=1)
    yaw = rng.uniform(-np.pi, np.pi, size=(B, 1)) + turn
    xy = np.cumsum(np.stack([np.cos(yaw), np.sin(yaw)], axis=-1) * dl, axis=1)
    course = np.concatenate([xy, yaw[..., None]], axis=-1)
    for b in range(B):
        course[b, :, 2] = smooth_yaw_numpy(course[b, :, 2])
    i0 = rng.integers(3, 30, size=B)
    states = np.stack(
        [course[np.arange(B), i0, 0], course[np.arange(B), i0, 1],
         rng.uniform(0, 8, B), course[np.arange(B), i0, 2]], axis=1
    )

    cs0 = init_controller_state(cfg, jnp.float32)
    cs = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), cs0)
    args = (
        jnp.asarray(states, jnp.float32), jnp.asarray(course, jnp.float32),
        jnp.zeros((B, N), jnp.float32), jnp.full((B,), N, jnp.int32),
        jnp.full((B,), dl, jnp.float32),
    )

    ref = jax.vmap(lambda s, c, v, n, d, k: mpc_step(s, c, v, n, d, k, cfg, geom.wheelbase))(
        *args, cs
    )
    got = mpc_step_batched(*args, cs, cfg, geom.wheelbase)
    np.testing.assert_allclose(np.asarray(got.accel), np.asarray(ref.accel), atol=2e-4)
    np.testing.assert_allclose(np.asarray(got.steer), np.asarray(ref.steer), atol=2e-4)
    np.testing.assert_array_equal(np.asarray(got.target_idx), np.asarray(ref.target_idx))


@pytest.mark.parametrize("triton_inner_loop", [False, True])
def test_batched_jerk_matches_vmapped_jerk(triton_inner_loop, request):
    """The jerk (comfort) variant through the natively batched solver —
    decision vector [u_flat; a0] (2T+1 vars: n=41 pads to 64 in the Triton
    kernel) — vs the vmapped single-scenario ``mpc_step_jerk``."""
    if triton_inner_loop:
        request.getfixturevalue("triton_interpret")
    from mpc_for_av_at_intersection_tpu.core.angles import smooth_yaw_numpy
    from mpc_for_av_at_intersection_tpu.models import bicycle_geometry
    from mpc_for_av_at_intersection_tpu.mpc import init_controller_state
    from mpc_for_av_at_intersection_tpu.mpc.batch import mpc_step_batched
    from mpc_for_av_at_intersection_tpu.mpc.jerk import mpc_step_jerk

    geom = bicycle_geometry()
    # fixed budget: this test checks the jerk BATCHING/kernel math
    # identity; the adaptive exit legitimately diverges between the
    # per-scenario and batch-grouped paths on polish-rejected rows (see
    # test_batched_mpc_step_matches_vmapped_mpc_step)
    import dataclasses
    cfg = dataclasses.replace(MPCConfig.with_jerk(), admm_eps=0.0)
    rng = np.random.default_rng(5)
    B, N = 8 if triton_inner_loop else 5, 200
    dl = 0.083
    turn = rng.normal(0, 0.01, size=(B, N)).cumsum(axis=1)
    yaw = rng.uniform(-np.pi, np.pi, size=(B, 1)) + turn
    xy = np.cumsum(np.stack([np.cos(yaw), np.sin(yaw)], axis=-1) * dl, axis=1)
    course = np.concatenate([xy, yaw[..., None]], axis=-1)
    for b in range(B):
        course[b, :, 2] = smooth_yaw_numpy(course[b, :, 2])
    i0 = rng.integers(3, 30, size=B)
    states = np.stack(
        [course[np.arange(B), i0, 0], course[np.arange(B), i0, 1],
         rng.uniform(0, 8, B), course[np.arange(B), i0, 2]], axis=1
    )

    cs0 = init_controller_state(cfg, jnp.float32)
    cs = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), cs0)
    args = (
        jnp.asarray(states, jnp.float32), jnp.asarray(course, jnp.float32),
        jnp.zeros((B, N), jnp.float32), jnp.full((B,), N, jnp.int32),
        jnp.full((B,), dl, jnp.float32),
    )

    ref = jax.vmap(
        lambda s, c, v, n, d, k: mpc_step_jerk(s, c, v, n, d, k, cfg, geom.wheelbase)
    )(*args, cs)
    got = mpc_step_batched(*args, cs, cfg, geom.wheelbase)
    assert np.asarray(got.solved).all()
    np.testing.assert_allclose(np.asarray(got.accel), np.asarray(ref.accel), atol=5e-4)
    np.testing.assert_allclose(np.asarray(got.steer), np.asarray(ref.steer), atol=5e-4)
    np.testing.assert_array_equal(np.asarray(got.target_idx), np.asarray(ref.target_idx))


def test_mpc_step_triton_matches_xla(triton_interpret):
    """The controller tick at the flagship horizon (T=20: n=40, m=79, both
    padded in-kernel) with the Triton inner loop vs the XLA inner loop."""
    from mpc_for_av_at_intersection_tpu.models import bicycle_geometry
    from mpc_for_av_at_intersection_tpu.mpc import init_controller_state
    from mpc_for_av_at_intersection_tpu.mpc.batch import mpc_step_batched

    geom = bicycle_geometry()
    cfg = MPCConfig(T=20)
    B = 16
    args = _mpc_instances(3, B)
    cs0 = init_controller_state(cfg, jnp.float32)
    cs = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), cs0)
    got = mpc_step_batched(*args, cs, cfg, geom.wheelbase)
    backend._STAGES["cpu"] = backend.Stages(admm="xla")
    ref = mpc_step_batched(*args, cs, cfg, geom.wheelbase)
    both = np.asarray(ref.solved) & np.asarray(got.solved)
    assert both.sum() >= B - 1
    np.testing.assert_allclose(np.asarray(got.accel)[both],
                               np.asarray(ref.accel)[both], atol=1e-3)
    np.testing.assert_allclose(np.asarray(got.steer)[both],
                               np.asarray(ref.steer)[both], atol=1e-3)
    np.testing.assert_array_equal(np.asarray(got.target_idx),
                                  np.asarray(ref.target_idx))


def test_adaptive_early_exit_matches_fixed_budget():
    """eps/stall-driven early exit + lazy refactorization must land on the
    same polished solutions as the fixed-budget schedule (both
    batched XLA paths) wherever both polish — the polished
    solves are exact active-set resolves, so the iteration policy cannot
    change them. (Unpolished rows legitimately differ: the rho schedule
    diverges once refactorization is lazy.)"""
    rng = np.random.default_rng(7)
    P, q, G, lo, hi = _random_batch(rng, 128, 6, 9)
    fixed = solve_box_qp_batched(P, q, G, lo, hi, rounds=16, iters=32)
    adap = solve_box_qp_batched(
        P, q, G, lo, hi, rounds=16, iters=32,
        eps=1e-4, refactor_band=5.0, stall_cap=3e-3, stall_ratio=0.5,
    )
    both = np.asarray(fixed.polished) & np.asarray(adap.polished)
    assert both.sum() >= 30
    np.testing.assert_allclose(np.asarray(adap.x)[both],
                               np.asarray(fixed.x)[both], atol=5e-4)
    # the stall exit must actually fire: no row may burn the full budget
    # only to land where it already was two blocks earlier
    checks = np.asarray(adap.checks).astype(int)
    assert checks.mean() < 12 and checks.min() <= 4


def test_warm_start_resolve_is_faster_and_agrees():
    """Re-solving the same instances warm-started from their own solution
    must converge in the minimum one block and reproduce the solution."""
    rng = np.random.default_rng(8)
    P, q, G, lo, hi = _random_batch(rng, 128, 6, 9)
    kw = dict(rounds=16, iters=32,
              eps=1e-4, refactor_band=5.0, stall_cap=3e-3, stall_ratio=0.5)
    cold = solve_box_qp_batched(P, q, G, lo, hi, **kw)
    cold_checks = int(np.asarray(cold.checks)[0])
    warm = solve_box_qp_batched(
        P, q, G, lo, hi, **kw,
        warm=(cold.x, cold.y, cold.rho),
    )
    # rows whose cold solve converged must re-converge in the minimum one
    # block from their own solution (rows that hit the check cap cold are
    # adversarial instances with no fixed point to warm from)
    conv = np.asarray(cold.checks) < 16
    assert conv.sum() >= 100
    # eps-converged rows re-converge in 1 block; rows that exited on the
    # stall rule need one extra block to re-detect the stall
    assert np.asarray(warm.checks)[conv].max() <= 2
    both = conv & np.asarray(cold.polished) & np.asarray(warm.polished)
    np.testing.assert_allclose(np.asarray(warm.x)[both],
                               np.asarray(cold.x)[both], atol=5e-4)


def test_warm_start_single_scenario_xla():
    """The single-scenario XLA twin: warm re-solve exits in one check and
    agrees with the cold solve."""
    rng = np.random.default_rng(9)
    P, q, G, lo, hi = _random_batch(rng, 4, 6, 9)
    kw = dict(rounds=16, iters=32, eps=1e-3, refactor_band=5.0)
    cold = jax.vmap(lambda *a: solve_box_qp(*a, **kw))(P, q, G, lo, hi)
    warm = jax.vmap(
        lambda p, q_, g, l, h, wx, wy, wr: solve_box_qp(
            p, q_, g, l, h, warm=(wx, wy, wr), **kw)
    )(P, q, G, lo, hi, cold.x, cold.y, cold.rho)
    conv = np.asarray(cold.checks) < 16
    assert conv.sum() >= 2
    assert np.asarray(warm.checks)[conv].max() <= 2
    both = conv & np.asarray(cold.polished) & np.asarray(warm.polished)
    np.testing.assert_allclose(np.asarray(warm.x)[both],
                               np.asarray(cold.x)[both], atol=5e-4)


def test_mpc_step_warm_carry_across_ticks():
    """Two consecutive controller ticks: the second tick's QP must be
    warm-started from the first (have_qp set, fewer checks than a cold
    solve of the same tick), with identical controls to a no-warm run
    wherever both solves polished."""
    from mpc_for_av_at_intersection_tpu.core.angles import smooth_yaw_numpy
    from mpc_for_av_at_intersection_tpu.models import bicycle_geometry
    from mpc_for_av_at_intersection_tpu.mpc import init_controller_state
    from mpc_for_av_at_intersection_tpu.mpc.batch import mpc_step_batched

    geom = bicycle_geometry()
    cfg = MPCConfig(T=13)
    assert cfg.warm_start_qp and cfg.admm_eps > 0
    rng = np.random.default_rng(10)
    B, N = 128, 200
    dl = 0.083
    turn = rng.normal(0, 0.01, size=(B, N)).cumsum(axis=1)
    yaw = rng.uniform(-np.pi, np.pi, size=(B, 1)) + turn
    xy = np.cumsum(np.stack([np.cos(yaw), np.sin(yaw)], axis=-1) * dl, axis=1)
    course = np.concatenate([xy, yaw[..., None]], axis=-1)
    for b in range(B):
        course[b, :, 2] = smooth_yaw_numpy(course[b, :, 2])
    i0 = rng.integers(3, 30, size=B)
    states = np.stack(
        [course[np.arange(B), i0, 0], course[np.arange(B), i0, 1],
         rng.uniform(0, 8, B), course[np.arange(B), i0, 2]], axis=1
    )

    cs0 = init_controller_state(cfg, jnp.float32)
    cs = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), cs0)
    args = (
        jnp.asarray(states, jnp.float32), jnp.asarray(course, jnp.float32),
        jnp.zeros((B, N), jnp.float32), jnp.full((B,), N, jnp.int32),
        jnp.full((B,), dl, jnp.float32),
    )

    out1 = mpc_step_batched(*args, cs, cfg, geom.wheelbase)
    assert np.asarray(out1.state.have_qp).all()
    # advance the plant one tick along the commanded control
    from mpc_for_av_at_intersection_tpu.core.dynamics import SimLimits, plant_step
    limits = SimLimits(max_steer=cfg.max_steer, max_speed=cfg.max_speed,
                       min_speed=cfg.min_speed)
    states2 = jax.vmap(
        lambda s, a, d: plant_step(s, jnp.stack([a, d]), cfg.dt,
                                   geom.wheelbase, limits)
    )(args[0], out1.accel, out1.steer)
    args2 = (states2,) + args[1:]

    out_warm = mpc_step_batched(*args2, out1.state, cfg, geom.wheelbase)
    cold_state = out1.state._replace(
        have_qp=jnp.zeros_like(out1.state.have_qp))
    out_cold = mpc_step_batched(*args2, cold_state, cfg, geom.wheelbase)

    # random wiggly-course instances include a few adversarial rows the
    # polish rejects either way — require near-universal solve success and
    # control agreement wherever both the warm and cold ticks solved
    sw = np.asarray(out_warm.solved)
    sc = np.asarray(out_cold.solved)
    assert sw.sum() >= 126
    both = sw & sc
    da = np.abs(np.asarray(out_warm.accel) - np.asarray(out_cold.accel))[both]
    ds = np.abs(np.asarray(out_warm.steer) - np.asarray(out_cold.steer))[both]
    # solved-but-unpolished rows carry the solver's documented ~prim<1e-2
    # tolerance; the bulk must agree tightly, every row loosely
    assert np.quantile(da, 0.95) < 2e-3 and np.quantile(ds, 0.95) < 2e-3
    assert da.max() < 2e-2 and ds.max() < 2e-2


def test_batched_solver_matches_f64_oracle():
    """The shipping fp32 batched solve (adaptive schedule, then re-solved
    warm from its own solution) stays within the 1e-3 control parity
    budget of the float64 sparse oracle on real MPC instances wherever the
    polish accepted (an exact active-set solve); the warm re-solve must
    polish every row."""
    import sys
    import os

    sys.path.insert(0, os.path.dirname(__file__))
    from oracles import qp_oracle

    from mpc_for_av_at_intersection_tpu.core.dynamics import (
        SimLimits,
        plant_rollout,
    )
    from mpc_for_av_at_intersection_tpu.mpc import condense, linearize_bicycle
    from mpc_for_av_at_intersection_tpu.mpc.reference import compute_reference

    cfg = MPCConfig(T=13)
    wb = 2.86
    B = 5
    states, course, cv, n, dl = _mpc_instances(21, B)
    limits = SimLimits(max_steer=cfg.max_steer, max_speed=cfg.max_speed,
                       min_speed=cfg.min_speed)
    T = cfg.T

    def build(s, c, v, n_, d):
        xref, _, re = compute_reference(
            s, c, v, n_, d, jnp.asarray(0, jnp.int32), jnp.zeros((T + 1,),
            s.dtype), False, T, cfg.dt, use_speed_channel=False)
        xbar = plant_rollout(s, jnp.zeros((T, 2), s.dtype), cfg.dt, wb, limits)
        A, Bm, C = linearize_bicycle(xbar[:-1, 2], xbar[:-1, 3],
                                     jnp.zeros((T,), s.dtype), cfg.dt, wb)
        return A, Bm, C, xref, re

    A, Bm, C, xref, re = jax.vmap(build)(states, course, cv, n, dl)
    cqp = jax.vmap(lambda a, b, c, s, r, e: condense(a, b, c, s, r, e, cfg))(
        A, Bm, C, states, xref, re)
    kw = dict(rounds=cfg.admm_max_checks, iters=cfg.admm_check_iters,
              eps=cfg.admm_eps, refactor_band=cfg.admm_refactor_band,
              stall_cap=cfg.admm_stall_cap, stall_ratio=cfg.admm_stall_ratio,
              ruiz_iters=cfg.admm_ruiz_iters)
    cold = solve_box_qp_batched(cqp.P, cqp.q, cqp.G, cqp.lo, cqp.hi, **kw)
    warm = solve_box_qp_batched(cqp.P, cqp.q, cqp.G, cqp.lo, cqp.hi,
                                warm=(cold.x, cold.y, cold.rho), **kw)
    assert np.asarray(warm.polished).all()
    assert np.asarray(cold.polished).sum() >= B - 1
    for b in range(B):
        qp = qp_oracle.build_sparse_mpc_qp(
            *(np.asarray(a[b], np.float64) for a in (A, Bm, C, states,
                                                     xref)),
            np.asarray(re[b]),
            w_perp=cfg.w_perp, w_para=cfg.w_para, q_v=cfg.q_v,
            q_yaw=cfg.q_yaw, qf=cfg.qf, end_input_weight=cfg.end_input_weight,
            r_accel=cfg.r_accel, r_steer=cfg.r_steer,
            rd_accel=cfg.rd_accel, rd_steer=cfg.rd_steer,
            max_accel=cfg.max_accel, max_decel=cfg.max_decel,
            max_dsteer_dt=cfg.max_dsteer * cfg.dt, max_steer=cfg.max_steer,
            max_speed=cfg.max_speed, min_speed=cfg.min_speed)
        z, _, kkt = qp_oracle.solve_sparse_qp(qp)
        assert max(kkt) < 1e-7
        u_ref = qp_oracle.extract_controls(qp, z)
        for sol in (cold, warm):
            if bool(sol.polished[b]):
                u = np.asarray(sol.x[b], np.float64).reshape(T, 2)
                assert np.abs(u - u_ref).max() < 1e-3, (b, np.abs(u - u_ref).max())
