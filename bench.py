"""Benchmark: batched MPC solves/s per device at the N=20 bicycle horizon.

One "solve" is a full controller tick — course localization,
velocity-lookahead reference, nonlinear operating rollout, linearization,
condensing, ADMM + polish — i.e. what the reference does per tick through
CVXPY/ECOS.

Prints ONE JSON line on stdout, naming the device it ran on.
"""

import json
import sys
import time

import numpy as np

HORIZON = 20
BATCH = 4096
N_COURSE = 512
STEADY_ITERS = 20


def main():
    import jax
    import jax.numpy as jnp

    from mpc_for_av_at_intersection_tpu.backend import enable_compile_cache

    enable_compile_cache()

    from mpc_for_av_at_intersection_tpu.core.angles import smooth_yaw_numpy
    from mpc_for_av_at_intersection_tpu.models import bicycle_geometry
    from mpc_for_av_at_intersection_tpu.mpc import (
        MPCConfig,
        init_controller_state,
        mpc_step,
    )

    geom = bicycle_geometry()
    cfg = MPCConfig(T=HORIZON)
    dtype = jnp.float32

    # realistic per-scenario tracking instances: smooth random courses,
    # ego states near the course with varying speed
    import os

    seed = int(os.environ.get("BENCH_SEED", "0"))
    rng = np.random.default_rng(seed)
    dl = 0.083
    turn = rng.normal(0.0, 0.01, size=(BATCH, N_COURSE)).cumsum(axis=1)
    yaw = rng.uniform(-np.pi, np.pi, size=(BATCH, 1)) + turn
    xy = np.cumsum(np.stack([np.cos(yaw), np.sin(yaw)], axis=-1) * dl, axis=1)
    course = np.concatenate([xy, yaw[..., None]], axis=-1)
    for b in range(0, BATCH, max(BATCH // 64, 1)):
        course[b, :, 2] = smooth_yaw_numpy(course[b, :, 2])
    i0 = rng.integers(3, 40, size=BATCH)
    state = np.stack(
        [
            course[np.arange(BATCH), i0, 0] + rng.normal(0, 0.2, BATCH),
            course[np.arange(BATCH), i0, 1] + rng.normal(0, 0.2, BATCH),
            rng.uniform(0.0, 8.0, BATCH),
            course[np.arange(BATCH), i0, 2] + rng.normal(0, 0.1, BATCH),
        ],
        axis=1,
    )

    course_j = jnp.asarray(course, dtype)
    state_j = jnp.asarray(state, dtype)
    cv = jnp.zeros((BATCH, N_COURSE), dtype)
    valid_len = jnp.full((BATCH,), N_COURSE, jnp.int32)
    dl_j = jnp.full((BATCH,), dl, dtype)
    cs0 = init_controller_state(cfg, dtype)
    cs = jax.tree.map(lambda x: jnp.broadcast_to(x, (BATCH,) + x.shape), cs0)

    from mpc_for_av_at_intersection_tpu.mpc.batch import mpc_step_batched

    @jax.jit
    def solve_batch(state, course, cv, valid_len, dl, cs):
        out = mpc_step_batched(
            state, course, cv, valid_len, dl, cs, cfg, geom.wheelbase,
        )
        return out.accel, out.steer, out.state

    t0 = time.perf_counter()
    compiled = solve_batch.trace(
        state_j, course_j, cv, valid_len, dl_j, cs
    ).lower().compile()
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    a, d, cs1 = jax.block_until_ready(
        compiled(state_j, course_j, cv, valid_len, dl_j, cs))
    first_exec_s = time.perf_counter() - t0

    # steady state: feed the updated controller state back (warm-started
    # solves, like a real receding-horizon fleet)
    t0 = time.perf_counter()
    for _ in range(STEADY_ITERS):
        a, d, cs1 = compiled(state_j, course_j, cv, valid_len, dl_j, cs1)
    jax.block_until_ready(a)
    dt_iter = (time.perf_counter() - t0) / STEADY_ITERS

    solves_per_sec = BATCH / dt_iter

    # Real-junction fleet metric (VERDICT r2 #5): scenario ticks/s through
    # the FULL pipeline — localization, prediction, conflict scan, cutoff,
    # QP, plant — on sampled intersection scenarios, next to the synthetic
    # solver headline above. Set BENCH_FLEET=0 to skip (solver-only run).
    fleet_ticks_per_s = None
    if os.environ.get("BENCH_FLEET", "1") == "1":
        from mpc_for_av_at_intersection_tpu import api
        from mpc_for_av_at_intersection_tpu.engine import EngineConfig
        from mpc_for_av_at_intersection_tpu.parallel import (
            run_batch_episodes,
            stack_states,
            stack_worlds,
        )

        n_scen, n_steps = 1024, 32
        geomF, worlds, statesF, _ = api.sample_intersection_fleet(
            n_scen, np.random.default_rng(seed), n_steps=n_steps
        )
        wb, sb = stack_worlds(worlds), stack_states(statesF)
        # warm (compile + first exec)
        jax.block_until_ready(run_batch_episodes(
            wb, sb, EngineConfig(), geomF, n_steps))
        t0 = time.perf_counter()
        jax.block_until_ready(run_batch_episodes(
            wb, sb, EngineConfig(), geomF, n_steps))
        fleet_ticks_per_s = n_scen * n_steps / (time.perf_counter() - t0)

    dev = jax.devices()[0]
    out = {
        "metric": "mpc_solves_per_sec_per_device_T20",
        "value": round(solves_per_sec, 1),
        "unit": "solves/s/device",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    if fleet_ticks_per_s is not None:
        out["fleet_scenario_ticks_per_s"] = round(fleet_ticks_per_s, 1)
    print(json.dumps(out))
    print(
        f"# batch={BATCH} iter_time={dt_iter*1e3:.1f}ms compile={compile_s:.1f}s "
        f"first_exec={first_exec_s:.1f}s seed={seed} device={dev}",
        file=sys.stderr,
    )


if __name__ == "__main__":
    main()
