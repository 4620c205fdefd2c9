"""On-card smoke check of the closed-loop MPC engine on an NVIDIA GPU.

    python chip_smoke.py               # one GPU: phases 1-6
    python chip_smoke.py --four-cards  # four GPUs of one host: phase 7 only

Drives the main path once through the entry points a user calls, at the
sizes its users run, and checks every result against a reference:

1. device check: JAX's default backend is the GPU, with no CPU fallback;
2. flagship episode (``run_episode``, 256 ticks) vs the same run on the
   in-process CPU device;
3. batched solver (``mpc_step_batched``, B=4096, T=20, warm-started for 20
   ticks): on 64 scenarios of the last tick drawn uniformly, the commanded
   controls within 1e-3 of the float64 sparse oracle (the planned horizon
   reported); the Triton ADMM kernel vs its XLA twin end to end, and
   after one check block against the float64 block, both timed;
4. fleet (``run_batch_episodes``, 1024 scenarios x 32 ticks): no unsolved
   tick; 64 scenarios' first 8 ticks vs a CPU float64 run;
5. multi-ego (``run_multi_ego_episode``, 8 egos x 128 junctions, 32 ticks):
   collision-free, no unsolved tick;
6. device planner (``plan_courses_device``, 32 four-way junctions): every
   cost inside the cost band of the exact host planner (the C++ core);
7. ``--four-cards``: ``run_batch_episodes`` sharded over a flat 4-GPU
   ``batch`` mesh at 4096 scenarios x 160 ticks vs the same on one GPU:
   equal summaries and per-scenario outcomes, final ego states within
   1e-4 (and where runs first differ, tick by tick, against a rerun of
   the one-card program and against each shard run alone).

Prints each phase's numbers, the card's name and power limit, and as its
last line one JSON object ``{"ok": true, "device": {...}}``. Exits
non-zero, printing no result, when a phase fails, when no GPU is found, or
when run outside a checkout of the repository.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BAND = (0.85, 1.10)        # device planner cost band vs the host search
CTRL_TOL = 1e-3            # control parity budget (ROADMAP aim 1)
FINAL_TOL = 1e-4           # sharded vs one-card final ego states


class PhaseError(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def log(*args):
    print(*args, flush=True)


def _timed(fn, *args, reps=3):
    """(first-call seconds incl. compile, median steady seconds, result)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return first, sorted(ts)[len(ts) // 2], out


def _oracle_controls(task):
    """Float64 sparse-oracle controls of one MPC QP (pool worker: imports
    no JAX, so no second process opens the card)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from oracles import qp_oracle

    A, B, C, x0, xref, re, w = task
    qp = qp_oracle.build_sparse_mpc_qp(A, B, C, x0, xref, re, **w)
    z, _, kkt = qp_oracle.solve_sparse_qp(qp)
    return qp_oracle.extract_controls(qp, z), max(kkt)


# ---------------------------------------------------------------- phases


def phase_device(n_cards):
    import jax

    from mpc_for_av_at_intersection_tpu import backend

    plat = jax.default_backend()
    check(plat == "gpu", f"no GPU: JAX's default backend is {plat!r}")
    devs = jax.devices()
    check(all(d.platform == "gpu" for d in devs), f"non-GPU devices {devs}")
    check(len(devs) >= n_cards, f"{n_cards} GPUs needed, found {len(devs)}")
    check(backend.platform() == "gpu", "dispatch did not pick the GPU")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        smi = f"nvidia-smi unavailable: {exc}"
    for line in smi.splitlines():
        log(f"card: {line}")
    log(f"[1] device: {len(devs)} x {devs[0].device_kind}, jax "
        f"{jax.__version__}, stages {backend.stages()}")


def phase_flagship(n_ticks=256):
    import jax
    import numpy as np

    from mpc_for_av_at_intersection_tpu import api
    from mpc_for_av_at_intersection_tpu.engine import run_episode
    from mpc_for_av_at_intersection_tpu.native import native_available

    log(f"    native C++ planner built and used: {native_available()}")
    setup = api.build_intersection(start_pos=4, turn_indicator=1,
                                   n_steps=n_ticks)

    def episode(w, s):
        return run_episode(w, s, setup.cfg, setup.geom, n_ticks)

    first, steady, (final, tel) = _timed(jax.jit(episode), setup.world,
                                         setup.state0)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        w, s = jax.device_put((setup.world, setup.state0), cpu)
        final_c, tel_c = jax.jit(episode)(w, s)
    done, k = bool(final.done), int(final.ticks_to_goal)
    done_c, k_c = bool(final_c.done), int(final_c.ticks_to_goal)
    unsolved = int((~np.asarray(tel.solved)).sum())
    log(f"[2] flagship: gpu done={done} ticks_to_goal={k} unsolved={unsolved}"
        f" | cpu done={done_c} ticks_to_goal={k_c} | first call {first:.1f}s,"
        f" {n_ticks} ticks in {steady * 1e3:.1f} ms")
    check(done and done == done_c and k == k_c,
          f"flagship differs from the CPU run: gpu ({done}, {k}) vs "
          f"cpu ({done_c}, {k_c})")
    check(unsolved == 0, f"{unsolved} unsolved ticks")


def _instances(rng, B, n_course=512):
    """bench.py's tracking instances: smooth random courses (their yaw is a
    cumulative sum of small steps, so already unwrapped), ego states near
    the course with varying speed."""
    import numpy as np

    dl = 0.083
    turn = rng.normal(0.0, 0.01, size=(B, n_course)).cumsum(axis=1)
    yaw = rng.uniform(-np.pi, np.pi, size=(B, 1)) + turn
    xy = np.cumsum(np.stack([np.cos(yaw), np.sin(yaw)], axis=-1) * dl, axis=1)
    course = np.concatenate([xy, yaw[..., None]], axis=-1)
    i0 = rng.integers(3, 40, size=B)
    state = np.stack([
        course[np.arange(B), i0, 0] + rng.normal(0, 0.2, B),
        course[np.arange(B), i0, 1] + rng.normal(0, 0.2, B),
        rng.uniform(0.0, 8.0, B),
        course[np.arange(B), i0, 2] + rng.normal(0, 0.1, B),
    ], axis=1)
    return state, course, dl


def _linearized(states, courses, cv, valid, dls, cs, cfg, wheelbase):
    """One tick's QP inputs (A, B, C, xref, reaches_end), rebuilt from the
    public pieces exactly as ``mpc_step_batched`` builds them."""
    import jax
    import jax.numpy as jnp

    from mpc_for_av_at_intersection_tpu.core.dynamics import (
        SimLimits,
        plant_rollout,
    )
    from mpc_for_av_at_intersection_tpu.mpc.linearize import linearize_bicycle
    from mpc_for_av_at_intersection_tpu.mpc.reference import compute_reference

    T = cfg.T
    limits = SimLimits(max_steer=cfg.max_steer, max_speed=cfg.max_speed,
                       min_speed=cfg.min_speed)
    oa = jnp.where(cs.have_prev[:, None], cs.oa, 0.0)
    od = jnp.where(cs.have_prev[:, None], cs.od, 0.0)
    xref, _, re = jax.vmap(
        lambda s, c, v, n, d, ti, o, h: compute_reference(
            s, c, v, n, d, ti, o, h, T, cfg.dt, use_speed_channel=False)
    )(states, courses, cv, valid, dls, cs.target_idx, cs.ov, cs.have_ov)
    xbar = jax.vmap(lambda s, u: plant_rollout(s, u, cfg.dt, wheelbase,
                                               limits))(
        states, jnp.stack([oa, od], axis=-1))
    A, B, C = jax.vmap(lambda v, p: linearize_bicycle(
        v, p, jnp.zeros_like(v), cfg.dt, wheelbase))(
        xbar[:, :-1, 2], xbar[:, :-1, 3])
    return A, B, C, xref, re


def phase_solver(pool, B=4096, T=20, warm_ticks=20, n_sample=64):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mpc_for_av_at_intersection_tpu.backend import fp32_matmuls, stages
    from mpc_for_av_at_intersection_tpu.core.dynamics import (
        SimLimits,
        plant_step,
    )
    from mpc_for_av_at_intersection_tpu.models import bicycle_geometry
    from mpc_for_av_at_intersection_tpu.mpc import MPCConfig
    from mpc_for_av_at_intersection_tpu.mpc import qp as qpmod
    from mpc_for_av_at_intersection_tpu.mpc.batch import mpc_step_batched
    from mpc_for_av_at_intersection_tpu.mpc.condense import condense
    from mpc_for_av_at_intersection_tpu.mpc.controller import (
        init_controller_state,
        qp_warm_start,
    )

    geom = bicycle_geometry()
    wb = geom.wheelbase
    cfg = MPCConfig(T=T)
    f32 = jnp.float32
    rng = np.random.default_rng(0)
    state, course, dl = _instances(rng, B)
    N = course.shape[1]
    states = jnp.asarray(state, f32)
    courses = jnp.asarray(course, f32)
    cv = jnp.zeros((B, N), f32)
    valid = jnp.full((B,), N, jnp.int32)
    dls = jnp.full((B,), dl, f32)
    cs = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape),
                      init_controller_state(cfg, f32))
    limits = SimLimits(max_steer=cfg.max_steer, max_speed=cfg.max_speed,
                       min_speed=cfg.min_speed)

    @jax.jit
    def tick(states, cs, courses, cv, valid, dls):
        out = mpc_step_batched(states, courses, cv, valid, dls, cs, cfg, wb)
        nxt = jax.vmap(lambda s, a, d: plant_step(
            s, jnp.stack([a, d]), cfg.dt, wb, limits))(
            states, out.accel, out.steer)
        return nxt, out

    world = (courses, cv, valid, dls)
    t0 = time.perf_counter()
    jax.block_until_ready(tick(states, cs, *world))
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    kept = {}                     # tick -> (states, controller state) in
    for k in range(1, warm_ticks + 1):
        if k in (warm_ticks // 2, warm_ticks):
            kept[k] = (states, cs)
        states, out = tick(states, cs, *world)
        cs = out.state
    jax.block_until_ready(out)
    tick_ms = (time.perf_counter() - t0) / warm_ticks * 1e3
    solved = np.asarray(out.solved)
    log(f"[3] solver: B={B} T={T} first call {compile_s:.1f}s, warm tick "
        f"{tick_ms:.2f} ms ({B / tick_ms * 1e3:.0f} solves/s), solved "
        f"{solved.sum()}/{B} on the last tick")
    check(solved.all(), f"{B - solved.sum()} unsolved scenarios")

    build = jax.jit(fp32_matmuls(jax.vmap(
        lambda a, b, c, s, r, e: condense(a, b, c, s, r, e, cfg))))

    def tick_qp(states, cs):
        """A kept tick's QP, rebuilt on the card, and its warm start."""
        A, Bm, C, xref, re = _linearized(states, courses, cv, valid, dls, cs,
                                         cfg, wb)
        return build(A, Bm, C, states, xref, re), qp_warm_start(cs, cfg)

    (checks, iters, eps, band, cap, ratio) = cfg.solver_schedule
    kw = dict(rounds=checks, iters=iters, rho0=cfg.admm_rho,
              sigma=cfg.admm_sigma, alpha=cfg.admm_alpha, polish=True,
              eps=eps, refactor_band=band, stall_cap=cap,
              stall_ratio=ratio, ruiz_iters=cfg.admm_ruiz_iters)

    def solve_with(block):
        return jax.jit(fp32_matmuls(lambda P, q, G, lo, hi, warm: (
            qpmod._solve_box_qp_batched(P, q, G, lo, hi, warm=warm,
                                        admm_block=block, **kw))))

    from mpc_for_av_at_intersection_tpu.ops.admm_triton import (
        admm_block_triton,
    )

    blocks = {"xla": qpmod._admm_block_xla, "triton": admm_block_triton}
    prev_states, prev_cs = kept[warm_ticks]
    qp, warm = tick_qp(prev_states, prev_cs)
    sols = {}
    for name, block in blocks.items():
        first, steady, sols[name] = _timed(solve_with(block), qp.P, qp.q,
                                           qp.G, qp.lo, qp.hi, warm)
        log(f"    solve [{name:6s}] first call {first:.1f}s, steady "
            f"{steady * 1e3:.2f} ms, polished {int(sols[name].polished.sum())}"
            f"/{B}, mean checks {float(sols[name].checks.mean()):.2f}")
    # both polished solves are exact active-set resolves, but fp32
    # resolves of a QP with cond(P) ~1e6 differ across the horizon by up to
    # ~1e-3 wherever the two inner loops hand over different (equally
    # optimal, degenerate) active sets; the commanded controls are what
    # the plant gets
    both = np.asarray(sols["xla"].polished & sols["triton"].polished)
    dx = np.abs(np.asarray(sols["xla"].x) - np.asarray(sols["triton"].x))
    d_cmd = dx[both, :2].max()
    log(f"    triton vs xla solve on {both.sum()} rows both polished: max "
        f"|d commanded control| {d_cmd:.2e} (tolerance {CTRL_TOL:g}), over "
        f"the horizon {dx[both].max():.2e}; dispatched: {stages().admm}")
    check(d_cmd <= CTRL_TOL, "Triton and XLA solves disagree")

    # one check block from the warm start of two ticks, read in four row
    # groups each: the Triton kernel's distance from the float64 block
    # must sit below the geometric mean of two readings of the same block,
    # the XLA scan in fp32 (the floor: the operator's conditioning
    # amplifies fp32 rounding) and the XLA scan with its operators rounded
    # to TF32 (the ceiling: what a kernel with TF32 products would reach)
    bkw = dict(iters=iters, sigma=cfg.admm_sigma, alpha=cfg.admm_alpha)
    readings = {"xla": [], "triton": [], "tf32": [], "triton_vs_xla": []}
    for k in sorted(kept):
        bargs = _block_inputs(*tick_qp(*kept[k]), cfg)
        if k == warm_ticks:
            for name, block in blocks.items():
                fn = jax.jit(fp32_matmuls(
                    lambda *a, block=block: block(*a, **bkw)))
                _, t, _ = _timed(fn, *bargs, reps=5)
                log(f"    one block of {iters} iterations [{name:6s}]: "
                    f"{t * 1e3:.3f} ms")
        err = _block_errors(bargs, bkw, blocks)
        for name, e in err.items():
            readings[name] += [float(g.max()) for g in np.split(e, 4)]
    lower, upper = max(readings["xla"]), min(readings["tf32"])
    limit = float(np.sqrt(lower * upper))
    log(f"    x after one block vs float64, max relative |dx| over "
        f"{len(readings['xla'])} groups of {B // 4} rows: xla "
        f"{min(readings['xla']):.2e}-{lower:.2e}, TF32-operator control "
        f"{upper:.2e}-{max(readings['tf32']):.2e}, triton "
        f"{min(readings['triton']):.2e}-{max(readings['triton']):.2e} "
        f"(limit {limit:.2e}, the geometric mean of the xla maximum and "
        f"the control minimum); triton vs xla "
        f"{max(readings['triton_vs_xla']):.2e} (stated tolerance 1e-4 between the two: "
        f"{'met' if max(readings['triton_vs_xla']) <= 1e-4 else 'not met'})")
    check(upper > 2 * lower, "TF32 control indistinguishable from fp32")
    check(max(readings["triton"]) <= limit,
          "Triton block is not at fp32 accuracy")

    # float64 sparse oracle on 64 rows drawn uniformly from the last tick's
    # QPs, as solved by the dispatched inner loop: the commanded controls
    # (the first step, which the plant gets) within the 1e-3 parity budget
    sol = sols[stages().admm]
    pol = np.asarray(sol.polished)
    idx = np.sort(rng.choice(B, n_sample, replace=False))
    cpu = jax.devices("cpu")[0]
    host = jax.tree.map(lambda a: np.asarray(a)[idx],
                        (prev_states, courses, cv, valid, dls, prev_cs))
    with jax.enable_x64(True), jax.default_device(cpu):
        f64 = jax.tree.map(
            lambda a: jnp.asarray(a, jnp.float64)
            if np.issubdtype(a.dtype, np.floating) else jnp.asarray(a), host)
        A64, B64, C64, xr64, re64 = [np.asarray(a)
                                     for a in _linearized(*f64, cfg, wb)]
    weights = dict(
        w_perp=cfg.w_perp, w_para=cfg.w_para, q_v=cfg.q_v, q_yaw=cfg.q_yaw,
        qf=cfg.qf, end_input_weight=cfg.end_input_weight,
        r_accel=cfg.r_accel, r_steer=cfg.r_steer, rd_accel=cfg.rd_accel,
        rd_steer=cfg.rd_steer, max_accel=cfg.max_accel,
        max_decel=cfg.max_decel, max_dsteer_dt=cfg.max_dsteer * cfg.dt,
        max_steer=cfg.max_steer, max_speed=cfg.max_speed,
        min_speed=cfg.min_speed)
    x0 = np.asarray(host[0], np.float64)
    tasks = [(A64[i], B64[i], C64[i], x0[i], xr64[i], re64[i], weights)
             for i in range(len(idx))]
    t0 = time.perf_counter()
    results = pool.map(_oracle_controls, tasks)
    u_dev = np.asarray(sol.x)[idx, :2 * T].reshape(len(idx), T, 2)
    u_ref = np.stack([u for u, _ in results])
    err = np.abs(u_dev - u_ref)                              # (rows, T, 2)
    e_cmd = err[:, 0, :].max(axis=1)
    e_plan = err.max(axis=(1, 2))
    cert = np.array([k < 1e-7 for _, k in results])
    log(f"    f64 oracle on {n_sample} rows drawn uniformly "
        f"({time.perf_counter() - t0:.1f}s): {cert.sum()}/{n_sample} "
        f"certified (KKT < 1e-7), {int(pol[idx].sum())}/{n_sample} polished "
        f"({int(pol.sum())}/{B} in the batch); max error of the commanded "
        f"controls {e_cmd.max():.2e} (tolerance {CTRL_TOL:g}), of the "
        f"planned horizon {e_plan.max():.2e} "
        f"({int((e_plan > CTRL_TOL).sum())} rows above {CTRL_TOL:g})")
    check(cert.all(), "oracle solutions not certified")
    check(e_cmd.max() <= CTRL_TOL, "commanded controls off the f64 oracle")


def _block_inputs(qp, warm, cfg):
    """One check block's inputs from a warm start, both sides at HIGHEST:
    (Minv, Gs, qs, los, his, rho, run, x, z, y)."""
    import jax
    import jax.numpy as jnp

    from mpc_for_av_at_intersection_tpu.backend import fp32_matmuls
    from mpc_for_av_at_intersection_tpu.mpc import qp as qpmod

    @jax.jit
    @fp32_matmuls
    def build(P, q, G, lo, hi, warm):
        d, e, c, Ps, qs, Gs, los, his = qpmod._equilibrate_batched(
            P, q, G, lo, hi, cfg.admm_ruiz_iters)
        x = warm[0] / d
        y = (c[:, None] * warm[1]) / e
        z = jnp.clip(jnp.einsum("bmn,bn->bm", Gs, x), los, his)
        eye = jnp.eye(d.shape[1], dtype=d.dtype)
        Minv = qpmod._admm_operator_batched(Ps, Gs, warm[2], cfg.admm_sigma,
                                            eye)
        return (Minv, Gs, qs, los, his, warm[2],
                jnp.ones(d.shape[:1], bool), x, z, y)

    return build(qp.P, qp.q, qp.G, qp.lo, qp.hi, warm)


def _block_errors(bargs, bkw, blocks):
    """Per-row max |dx| after one block, relative to the row's scale: each
    inner loop and the TF32-operator control against the float64 block,
    and the Triton kernel against the XLA scan."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mpc_for_av_at_intersection_tpu.backend import fp32_matmuls
    from mpc_for_av_at_intersection_tpu.mpc import qp as qpmod

    def tf32(a):
        return jax.lax.reduce_precision(a, exponent_bits=8, mantissa_bits=10)

    res = {name: jax.jit(fp32_matmuls(
        lambda *a, block=block: block(*a, **bkw)))(*bargs)
        for name, block in blocks.items()}
    res["tf32"] = jax.jit(fp32_matmuls(
        lambda Minv, Gs, *rest: qpmod._admm_block_xla(
            tf32(Minv), tf32(Gs), *rest, **bkw)))(*bargs)
    with jax.enable_x64(True):
        b64 = [a.astype(jnp.float64) if a.dtype == jnp.float32 else a
               for a in bargs]
        res["f64"] = jax.jit(
            lambda *a: qpmod._admm_block_xla(*a, **bkw))(*b64)

    def rel(a, b):
        a, b = np.asarray(a[0], np.float64), np.asarray(b[0], np.float64)
        return np.abs(a - b).max(axis=1) / np.maximum(np.abs(b).max(axis=1),
                                                      1.0)

    out = {k: rel(res[k], res["f64"]) for k in ("xla", "triton", "tf32")}
    out["triton_vs_xla"] = rel(res["triton"], res["xla"])
    return out


def phase_fleet(n=1024, steps=32, n_check=64, check_ticks=8):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mpc_for_av_at_intersection_tpu import api
    from mpc_for_av_at_intersection_tpu.engine import EngineConfig
    from mpc_for_av_at_intersection_tpu.parallel import (
        run_batch_episodes,
        stack_states,
        stack_worlds,
    )

    rng = np.random.default_rng(1)
    cfg = EngineConfig()
    geom, worlds, states, _ = api.sample_intersection_fleet(n, rng,
                                                            n_steps=steps)
    wb, sb = stack_worlds(worlds), stack_states(states)
    first, steady, (final, tel, summary) = _timed(
        lambda w, s: run_batch_episodes(w, s, cfg, geom, steps), wb, sb)
    n_unsolved = int(summary["n_unsolved_ticks"])
    log(f"[4] fleet: {n} x {steps} ticks, first call {first:.1f}s, steady "
        f"{steady:.3f}s = {n * steps / steady:.0f} scenario-ticks/s, "
        f"done {int(summary['n_done'])}, unsolved ticks {n_unsolved}")
    check(n_unsolved == 0, f"{n_unsolved} unsolved fleet ticks")

    idx = np.sort(rng.choice(n, n_check, replace=False))
    cpu = jax.devices("cpu")[0]
    host = jax.tree.map(lambda a: np.asarray(a)[idx], (wb, sb))
    with jax.enable_x64(True), jax.default_device(cpu):
        w64, s64 = jax.tree.map(
            lambda a: jnp.asarray(a, jnp.float64)
            if np.issubdtype(a.dtype, np.floating) else jnp.asarray(a), host)
        _, tel_c, _ = run_batch_episodes(w64, s64, cfg, geom, check_ticks)
        tel_c = jax.tree.map(np.asarray, tel_c)
    err = max(
        float(np.abs(np.asarray(getattr(tel, f))[idx, :check_ticks]
                     - getattr(tel_c, f)).max())
        for f in ("accel", "steer"))
    log(f"    {n_check} scenarios x first {check_ticks} ticks vs CPU float64:"
        f" max |d accel|, |d steer| {err:.2e} (tolerance {CTRL_TOL:g})")
    check(err <= CTRL_TOL, "fleet controls differ from the CPU f64 run")


def _eight_ego_courses(geom):
    """The correctness-tested 8-ego junction (2 lanes x 4 arms, as in
    bench_multi_ego.py)."""
    from mpc_for_av_at_intersection_tpu import api
    from mpc_for_av_at_intersection_tpu.native import native_available
    from mpc_for_av_at_intersection_tpu.worlds import intersection_multi_lanes

    combos = [(1, 2, 1), (1, 3, 2), (2, 2, 1), (2, 3, 2),
              (3, 2, 1), (3, 3, 2), (4, 2, 1), (4, 3, 2)]
    return [api.plan_course(
        intersection_multi_lanes(turn_indicator=t, start_pos=s,
                                 start_lane=lane, goal_lane=lane,
                                 number_of_lanes=2),
        geom, use_native=native_available()) for s, t, lane in combos]


def phase_multi_ego(S=128, steps=32):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mpc_for_av_at_intersection_tpu.agents import stack_agents
    from mpc_for_av_at_intersection_tpu.engine import (
        EngineConfig,
        init_multi_ego_state,
        make_multi_ego_world,
        run_multi_ego_episode,
    )
    from mpc_for_av_at_intersection_tpu.models import bicycle_geometry

    geom = bicycle_geometry()
    cfg = EngineConfig(n_agents=2)
    trajs = _eight_ego_courses(geom)
    E = len(trajs)
    params, ag = stack_agents([], n_slots=cfg.n_agents)
    world = make_multi_ego_world(trajs, params, cfg)
    st0 = init_multi_ego_state(world, ag, cfg, steps)
    worldS, stS = jax.tree.map(
        lambda a: jnp.broadcast_to(a, (S,) + a.shape), (world, st0))
    run = jax.jit(jax.vmap(
        lambda w, s: run_multi_ego_episode(w, s, cfg, geom, steps)))
    first, steady, (final, tel) = _timed(run, worldS, stS, reps=1)
    tel = jax.tree.map(np.asarray, tel)                  # (S, T, E)
    cc = np.asarray(geom.circle_centers)
    cth, sth = np.cos(tel.yaw), np.sin(tel.yaw)
    px = (tel.x[..., None] + cth[..., None] * cc[:, 0]
          - sth[..., None] * cc[:, 1])                   # (S, T, E, C)
    py = (tel.y[..., None] + sth[..., None] * cc[:, 0]
          + cth[..., None] * cc[:, 1])
    clear = np.inf
    for a in range(E):
        for b in range(a + 1, E):
            d = np.hypot(px[:, :, a, :, None] - px[:, :, b, None, :],
                         py[:, :, a, :, None] - py[:, :, b, None, :])
            clear = min(clear, float(d.min()))
    unsolved = int((~tel.solved).sum())
    log(f"[5] multi-ego: {E} egos x {S} junctions x {steps} ticks, first call"
        f" {first:.1f}s, steady {steady:.3f}s = "
        f"{S * E * steps / steady:.0f} ego-ticks/s, min ego-ego clearance "
        f"{clear:.2f} m, unsolved ticks {unsolved}")
    check(clear > 2 * geom.radius * 0.7, f"ego-ego clearance {clear:.2f} m")
    check(unsolved == 0, f"{unsolved} unsolved multi-ego ticks")


def phase_planner(n=32):
    import numpy as np

    from mpc_for_av_at_intersection_tpu.lattice import (
        MotionPrimitiveSearch,
        SearchWeights,
        primitive_table,
    )
    from mpc_for_av_at_intersection_tpu.lattice.wavefront import (
        plan_courses_device,
    )
    from mpc_for_av_at_intersection_tpu.models import bicycle_geometry
    from mpc_for_av_at_intersection_tpu.native import (
        NativeMotionPrimitiveSearch,
        native_available,
    )
    from mpc_for_av_at_intersection_tpu.worlds import intersection

    # the exact host search: the C++ core where g++ built it, else the
    # Python search it is bit-exact with (tests/test_native_search.py)
    host = (NativeMotionPrimitiveSearch if native_available()
            else MotionPrimitiveSearch)
    geom = bicycle_geometry()
    table = primitive_table(geom)
    rng = np.random.default_rng(2)
    # every (start arm, turn) pair, each junction with its own corner
    # radius around the reference's 6 m (road and median widths kept: some
    # narrower roads put a right turn beyond the host search's budget)
    scenarios = [
        intersection(turn_indicator=1 + i % 3, start_pos=1 + (i // 3) % 4,
                     corner_radius=float(rng.uniform(5.0, 7.5)))
        for i in range(n)]
    t0 = time.perf_counter()
    res = plan_courses_device(scenarios, geom)
    found = np.asarray(res.found)
    cost = np.asarray(res.cost)
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = np.array([host(sc, geom, table, margin=geom.radius,
                         weights=SearchWeights.modified()).run()[0]
                    for sc in scenarios])
    t_nat = time.perf_counter() - t0
    ratio = cost / ref
    log(f"[6] planner: {n} junctions on device in {t_dev:.1f}s (first call),"
        f" host search ({host.__name__}) {t_nat:.1f}s; found {found.sum()}/{n}, cost / host in "
        f"[{ratio.min():.3f}, {ratio.max():.3f}] (band {BAND})")
    check(found.all(), f"device planner missed {np.flatnonzero(~found)}")
    check(((ratio >= BAND[0] - 1e-6) & (ratio <= BAND[1] + 1e-6)).all(),
          "device plan cost outside the band")


def phase_four_cards(n=4096, steps=160):
    import jax
    import numpy as np

    from mpc_for_av_at_intersection_tpu import api
    from mpc_for_av_at_intersection_tpu.engine import EngineConfig
    from mpc_for_av_at_intersection_tpu.parallel import (
        batch_mesh,
        run_batch_episodes,
    )

    cfg = EngineConfig()
    geom, wb, sb, _ = api.sample_intersection_fleet_batched(
        n, np.random.default_rng(3), n_steps=steps)
    mesh = batch_mesh(jax.devices()[:4])
    runs = {}
    for label, m in (("1 card", None), ("4 cards", mesh)):
        first, steady, out = _timed(
            lambda w, s, m=m: run_batch_episodes(w, s, cfg, geom, steps,
                                                 mesh=m), wb, sb, reps=1)
        runs[label] = jax.tree.map(np.asarray, out)
        summ = {k: int(v) for k, v in out[2].items()}
        log(f"[7] {label}: {n} x {steps} ticks, first call {first:.1f}s, "
            f"steady {steady:.3f}s = {n * steps / steady:.0f} "
            f"scenario-ticks/s, summary {summ}")
    # the one-card program again (run-to-run determinism), and each card's
    # shard run alone on one card (the sharded program's per-card twin)
    runs["1 card again"] = jax.tree.map(
        np.asarray, run_batch_episodes(wb, sb, cfg, geom, steps))
    q = n // 4
    shards = [jax.tree.map(np.asarray, run_batch_episodes(
        *jax.tree.map(lambda a: a[i * q:(i + 1) * q], (wb, sb)),
        cfg, geom, steps)[:2]) for i in range(4)]
    runs["shards alone"] = jax.tree.map(
        lambda *a: np.concatenate(a), *shards)

    def compare(a, b):
        (fa, ta), (fb, tb) = runs[a][:2], runs[b][:2]
        d = np.abs(fa.ego - fb.ego).max(axis=1)
        dxy = np.maximum(np.abs(ta.x - tb.x), np.abs(ta.y - tb.y))  # (n, T)
        per_tick = dxy.max(axis=0)
        first = np.flatnonzero(per_tick > 0.0)
        where = (f"first differing tick {first[0]} (|dxy| {per_tick[first[0]]:.1e}), "
                 f"first above 1e-4: "
                 f"{int(np.argmax(per_tick > 1e-4)) if (per_tick > 1e-4).any() else 'none'}"
                 if first.size else "bit-identical telemetry")
        log(f"    final ego states, {a} vs {b}: max {d.max():.2e}, "
            f"{int((d > FINAL_TOL).sum())}/{n} above {FINAL_TOL:g}; {where}")
        return d.max()

    compare("1 card again", "1 card")
    compare("4 cards", "shards alone")
    compare("shards alone", "1 card")
    d41 = compare("4 cards", "1 card")
    f1, f4 = runs["1 card"][0], runs["4 cards"][0]
    s1 = {k: int(v) for k, v in runs["1 card"][2].items()}
    s4 = {k: int(v) for k, v in runs["4 cards"][2].items()}
    same = (np.array_equal(f1.done, f4.done)
            and np.array_equal(f1.ticks_to_goal, f4.ticks_to_goal))
    log(f"    per-scenario done flags and ticks to goal equal: {same} "
        f"({int(f1.done.sum())}/{n} scenarios reached their goal)")
    check(s1 == s4, f"summaries differ: {s1} vs {s4}")
    check(same, "per-scenario outcomes differ across the mesh")
    check(d41 <= FINAL_TOL,
          f"final states of the sharded run differ from one card by "
          f"{d41:.2e} (tolerance {FINAL_TOL:g})")


# ------------------------------------------------------------------ main


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-GPU sharded fleet and its "
                         "1-GPU comparison")
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    try:
        import jax
        from mpc_for_av_at_intersection_tpu.backend import (
            enable_compile_cache,
        )
    except ImportError as exc:
        print(f"chip_smoke.py runs from a checkout of the repository with "
              f"JAX installed: {exc}", file=sys.stderr)
        return 1
    enable_compile_cache()

    import multiprocessing

    t_start = time.perf_counter()
    try:
        if args.four_cards:
            phase_device(4)
            phase_four_cards()
        else:
            phase_device(1)
            phase_flagship()
            # oracle workers: NumPy only, one BLAS thread each
            for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                        "MKL_NUM_THREADS"):
                os.environ[var] = "1"
            ctx = multiprocessing.get_context("spawn")
            with ctx.Pool(min(16, os.cpu_count() or 1)) as pool:
                phase_solver(pool)
            phase_fleet()
            phase_multi_ego()
            phase_planner()
    except PhaseError as exc:
        print(f"FAILED: {exc}", file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    log(f"all phases passed in {time.perf_counter() - t_start:.0f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
