"""Per-stage device profile of the FULL engine tick.

Times the fleet tick's stages: each stage is a jitted ``lax.scan`` of K
dependent repetitions on a REAL mid-episode fleet state (the flagship
sampled-intersection batch), so wall/K is that stage's steady device time.

Stages (engine/fleet.py::engine_tick_fleet at B scenarios):
  predict    agents_get + constant-control prediction rollout (n_pred steps)
  pre        vmapped ego_subtick_pre (localization, resample, conflict scan)
  loc        ... localization advance alone (nearest_index_in_direction)
  resample   ... reachability resample + compact_by_mask alone
  conflict   ... frame-windowed conflict scan alone
  mpc        mpc_step_batched (the controller tick)
  post       ego_subtick_post + agents_step + state reassembly
  full_tick  engine_tick_fleet end-to-end (cross-check)

Prints one JSON object; pass a path to persist it.
"""

import json
import os
import statistics
import sys
import time

import numpy as np

B = int(os.environ.get("PROFILE_B", 1024))
N_STEPS_WARM = int(os.environ.get("PROFILE_WARM_TICKS", 12))
K = 8
REPS = 5


def main():
    import jax

    from mpc_for_av_at_intersection_tpu.backend import enable_compile_cache

    enable_compile_cache()
    # the stages below are traced outside the engine's fp32_matmuls scope
    jax.config.update("jax_default_matmul_precision", "float32")

    import jax.numpy as jnp

    from mpc_for_av_at_intersection_tpu import api
    from mpc_for_av_at_intersection_tpu.agents import (
        agents_get,
        agents_step,
        check_collision_moving_cars,
        predict_constant_control,
    )
    from mpc_for_av_at_intersection_tpu.core.curves import (
        compact_by_mask,
        nearest_index_in_direction,
        resample_mask,
    )
    from mpc_for_av_at_intersection_tpu.engine import EngineConfig
    from mpc_for_av_at_intersection_tpu.engine.fleet import engine_tick_fleet
    from mpc_for_av_at_intersection_tpu.mpc.batch import mpc_step_batched
    from mpc_for_av_at_intersection_tpu.models import bicycle_geometry
    from mpc_for_av_at_intersection_tpu.parallel import stack_states, stack_worlds

    cfg = EngineConfig()
    geom = bicycle_geometry()
    rng = np.random.default_rng(7)
    _, worlds, states, _ = api.sample_intersection_fleet(B, rng, n_steps=64)
    world = stack_worlds(worlds)
    st0 = stack_states(states)

    # advance to a mid-episode state so the stages see realistic cutoffs,
    # active conflicts, and warm-started controllers
    @jax.jit
    def warm(world, st):
        def body(s, _):
            s2, _tel = engine_tick_fleet(world, s, cfg, geom)
            return s2, ()
        sf, _ = jax.lax.scan(body, st, None, length=N_STEPS_WARM)
        return sf

    st = warm(world, st0)
    st = jax.tree.map(lambda x: x.block_until_ready(), st)

    report = {"device": str(jax.devices()[0]), "batch": B,
              "warm_ticks": N_STEPS_WARM, "k_steps": K, "reps": REPS,
              "n_pred": cfg.n_pred, "n_frames": cfg.n_frames,
              "frame_window": cfg.frame_window}
    eps = np.float32(1e-30)
    dt = cfg.mpc.dt

    def timed(name, fn, *args):
        out = fn(*args)
        jax.block_until_ready(out)
        ts = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            out = fn(*args)
            jax.block_until_ready(out)
            ts.append((time.perf_counter() - t0) / K)
        ms = statistics.median(ts) * 1e3
        report[name + "_ms"] = round(ms, 3)
        print(f"{name:12s} {ms:9.3f} ms", file=sys.stderr, flush=True)
        return ms

    # ---- full engine tick (cross-check) ----
    @jax.jit
    def full_chain(world, st):
        def body(s, _):
            s2, _tel = engine_tick_fleet(world, s, cfg, geom)
            return s2, ()
        sf, _ = jax.lax.scan(body, st, None, length=K)
        return sf.ego

    t_full = timed("full_tick", full_chain, world, st)

    # ---- stage: prediction ----
    @jax.jit
    def predict_chain(world, st):
        def body(e, _):
            # thread the carry into the INPUT so the body cannot be
            # hoisted out of the scan as loop-invariant (XLA LICM would
            # otherwise compute it once and report ~1/K of the cost)
            agents = jax.tree.map(
                lambda a: a + (eps * e).reshape(
                    (-1,) + (1,) * (a.ndim - 1)).astype(a.dtype)
                if a.dtype.kind == 'f' else a, st.agents)
            obs6 = jax.vmap(lambda p, s: agents_get(p, s, dt))(
                world.agent_params, agents)
            preds = predict_constant_control(obs6, dt, geom.wheelbase, cfg.n_pred)
            return e + eps * preds[:, 0, 0, 0], ()
        ef, _ = jax.lax.scan(body, st.ego[:, 0], None, length=K)
        return ef

    t_pred = timed("predict", predict_chain, world, st)

    obs6 = jax.jit(jax.vmap(lambda p, s: agents_get(p, s, dt)))(
        world.agent_params, st.agents)
    preds = jax.jit(
        lambda o: predict_constant_control(o, dt, geom.wheelbase, cfg.n_pred)
    )(obs6)
    preds = preds.block_until_ready()

    # ---- stage: pre (all of ego_subtick_pre) ----
    from mpc_for_av_at_intersection_tpu.engine.closed_loop import ego_subtick_pre

    @jax.jit
    def pre_chain(world, st, preds):
        def body(e, _):
            ego = st.ego + (eps * e)[:, None]    # carry -> input (no LICM)
            pre = jax.vmap(
                lambda course, n, dl, goal, ego, ctrl, cut, aidx, first, done,
                pr, act: ego_subtick_pre(course, n, dl, goal, ego, ctrl, cut,
                                         aidx, first, done, pr, act, cfg, geom)
            )(world.course, world.n_course, world.dl, world.goal_xy,
              ego, st.ctrl, st.cutoff_len, st.agent_idx, st.first_tick,
              st.done, preds, world.agent_params.active)
            return e + eps * pre[4].astype(jnp.float32), ()
        ef, _ = jax.lax.scan(
            body, st.cutoff_len.astype(jnp.float32), None, length=K)
        return ef

    t_pre = timed("pre", pre_chain, world, st, preds)

    # ---- sub-stage: localization advance ----
    @jax.jit
    def loc_chain(world, st):
        def body(ai, _):
            ai2 = jax.vmap(
                lambda ego, course, a, n: nearest_index_in_direction(
                    ego[:2], course[:, :2], a, n, forward=True)
            )(st.ego, world.course, ai, world.n_course)
            return ai2, ()
        af, _ = jax.lax.scan(body, st.agent_idx, None, length=K)
        return af

    t_loc = timed("loc", loc_chain, world, st)

    # ---- sub-stage: reachability resample + compact ----
    mpc_cfg = cfg.mpc
    N = world.course.shape[1]

    @jax.jit
    def resample_chain(world, st):
        def one(course, ego, aidx, n_course):
            course2 = jnp.concatenate(
                [course, jnp.broadcast_to(course[-1], course.shape)], axis=0)
            detail = jax.lax.dynamic_slice(
                course2, (aidx, jnp.asarray(0, aidx.dtype)), (N, 3))
            n_detail = n_course - aidx
            i = jnp.arange(N, dtype=course.dtype)
            accel_dl = dt * jnp.minimum(
                ego[2] + mpc_cfg.max_accel * (i + 1.0), mpc_cfg.max_speed)
            flat_dl = jnp.full((N,), dt * mpc_cfg.max_speed, course.dtype)
            res_dl = jnp.where(ego[2] < mpc_cfg.max_speed, accel_dl, flat_dl)
            valid_suffix = jnp.arange(N) < n_detail
            keep = resample_mask(detail, res_dl, valid_suffix, keep_last=True)
            ego_traj, n_ego = compact_by_mask(detail, keep, cfg.n_frames)
            return ego_traj[0, 0] + eps * n_ego

        def body(e, _):
            ego = st.ego + (eps * e)[:, None]    # carry -> input (no LICM)
            v = jax.vmap(one)(world.course, ego, st.agent_idx, world.n_course)
            return e + eps * v, ()
        ef, _ = jax.lax.scan(
            body, st.cutoff_len.astype(world.course.dtype), None, length=K)
        return ef

    t_res = timed("resample", resample_chain, world, st)

    # ---- sub-stage: conflict scan ----
    circle_centers = jnp.asarray(geom.circle_centers, world.course.dtype)

    @jax.jit
    def conflict_chain(world, st, preds):
        def one(course, ego, aidx, n_course, pr, act):
            course2 = jnp.concatenate(
                [course, jnp.broadcast_to(course[-1], course.shape)], axis=0)
            detail = jax.lax.dynamic_slice(
                course2, (aidx, jnp.asarray(0, aidx.dtype)), (N, 3))
            n_detail = n_course - aidx
            i = jnp.arange(N, dtype=course.dtype)
            accel_dl = dt * jnp.minimum(
                ego[2] + mpc_cfg.max_accel * (i + 1.0), mpc_cfg.max_speed)
            res_dl = jnp.where(
                ego[2] < mpc_cfg.max_speed, accel_dl,
                jnp.full((N,), dt * mpc_cfg.max_speed, course.dtype))
            valid_suffix = jnp.arange(N) < n_detail
            keep = resample_mask(detail, res_dl, valid_suffix, keep_last=True)
            ego_traj, n_ego = compact_by_mask(detail, keep, cfg.n_frames)
            scan = check_collision_moving_cars(
                ego_traj, n_ego, detail, n_detail, pr, act,
                circle_centers, geom.radius, cfg.frame_window, cfg.n_frames)
            return scan.xy[0] + eps * scan.frame_idx

        def body(e, _):
            ego = st.ego + (eps * e)[:, None]    # carry -> input (no LICM)
            v = jax.vmap(one)(world.course, ego, st.agent_idx,
                              world.n_course, preds,
                              world.agent_params.active)
            return e + eps * v, ()
        ef, _ = jax.lax.scan(
            body, st.cutoff_len.astype(world.course.dtype), None, length=K)
        return ef

    t_scan_total = timed("resample_plus_conflict", conflict_chain, world, st, preds)
    report["conflict_ms"] = round(t_scan_total - t_res, 3)
    print(f"{'conflict':12s} {t_scan_total - t_res:9.3f} ms (derived)",
          file=sys.stderr, flush=True)

    # ---- stage: mpc (controller tick on this fleet's real inputs) ----
    @jax.jit
    def mpc_chain(world, st):
        cv = jnp.zeros_like(world.course[:, :, 0])
        def body(cs, _):
            out = mpc_step_batched(
                st.ego, world.course, cv, st.cutoff_len, world.dl, cs,
                cfg.mpc, geom.wheelbase)
            return out.state, ()
        csf, _ = jax.lax.scan(body, st.ctrl, None, length=K)
        return csf.oa

    t_mpc = timed("mpc", mpc_chain, world, st)

    # ---- stage: post (plant step + agents step + freeze/telemetry) ----
    from mpc_for_av_at_intersection_tpu.engine.closed_loop import ego_subtick_post

    pre_out = jax.jit(
        lambda w, s, p: jax.vmap(
            lambda course, n, dl, goal, ego, ctrl, cut, aidx, first, done,
            pr, act: ego_subtick_pre(course, n, dl, goal, ego, ctrl, cut,
                                     aidx, first, done, pr, act, cfg, geom)
        )(w.course, w.n_course, w.dl, w.goal_xy, s.ego, s.ctrl, s.cutoff_len,
          s.agent_idx, s.first_tick, s.done, p, w.agent_params.active)
    )(world, st, preds)
    done_now, agent_idx, scan, cutoff_len, course_len, cv = jax.tree.map(
        lambda x: x.block_until_ready(), pre_out)
    out = jax.jit(
        lambda w, s, v, cl: mpc_step_batched(
            s.ego, w.course, v, cl, w.dl, s.ctrl, cfg.mpc, geom.wheelbase)
    )(world, st, cv, course_len)
    out = jax.tree.map(lambda x: x.block_until_ready(), out)

    @jax.jit
    def post_chain(world, st, done_now, agent_idx, scan, cutoff_len, out):
        def body(e, _):
            ego_in = st.ego + (eps * e)[:, None]  # carry -> input (no LICM)
            (ego, ctrl, cut2, ai2, dn2), tel = jax.vmap(
                lambda course, ego, c, dn, ai, sc, cl, o:
                ego_subtick_post(course, ego, c, dn, ai, sc, cl, o, cfg, geom)
            )(world.course, ego_in, st.ctrl, done_now, agent_idx, scan,
              cutoff_len, out)
            agents = jax.vmap(lambda p, s: agents_step(p, s, dt, geom.wheelbase))(
                world.agent_params, st.agents)
            lead = jax.tree.leaves(agents)[0].reshape(ego.shape[0], -1)[:, 0]
            return e + eps * ego[:, 0] + eps * lead.astype(e.dtype), ()
        ef, _ = jax.lax.scan(body, st.ego[:, 0], None, length=K)
        return ef

    t_post = timed("post", post_chain, world, st, done_now, agent_idx, scan,
                   cutoff_len, out)

    accounted = t_pred + t_pre + t_mpc + t_post
    report["accounted_ms"] = round(accounted, 2)
    report["unaccounted_ms"] = round(t_full - accounted, 2)
    report["note"] = (
        "stage timings are measured STANDALONE (each its own fused jit "
        "chain); composition changes XLA fusion, so stage sums need not "
        "equal full_tick_ms (loc/resample/conflict also overlap pre_ms)")
    report["ticks_per_s_implied"] = round(B / (t_full / 1e3), 1)

    out_s = json.dumps(report, indent=2)
    print(out_s)
    paths = [a for a in sys.argv[1:] if not a.startswith("--")]
    if paths:
        with open(paths[0], "w") as f:
            f.write(out_s + "\n")


if __name__ == "__main__":
    main()
