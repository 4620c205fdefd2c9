"""Scaling + latency report: solves/s at 1 .. N devices, p50 tick latency.

Complements bench.py (single-device headline) with the BASELINE.md
reporting requirements:

- p50 control-step latency vs the 0.2 s real-time budget: a jitted
  ``lax.scan`` of K dependent steps is one dispatch, so per-step time is
  wall / K. Both (a) one batch-1 ``mpc_step`` and (b) one full
  single-scenario ``engine_tick`` on the flagship intersection are
  reported.
- throughput scaling rows at 1 device, 1 host x N devices (1-D mesh), and
  hosts=2 (emulated 2-axis mesh). The mesh rows are produced by a CPU
  subprocess (``JAX_PLATFORMS=cpu``) with 8 virtual devices — labeled as
  emulated; they validate the sharded program, not interconnect bandwidth.
- max real-time batch (GPU only): largest fleet whose tick stays under
  0.2 s.

Prints one JSON object; pass a path argument to persist it.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np


def _mk_instances(B, N_COURSE, HORIZON, dtype):
    import jax.numpy as jnp

    from mpc_for_av_at_intersection_tpu.core.angles import smooth_yaw_numpy

    rng = np.random.default_rng(0)
    dl = 0.083
    turn = rng.normal(0.0, 0.01, size=(B, N_COURSE)).cumsum(axis=1)
    yaw = rng.uniform(-np.pi, np.pi, size=(B, 1)) + turn
    xy = np.cumsum(np.stack([np.cos(yaw), np.sin(yaw)], axis=-1) * dl, axis=1)
    course = np.concatenate([xy, yaw[..., None]], axis=-1)
    for b in range(B):
        course[b, :, 2] = smooth_yaw_numpy(course[b, :, 2])
    i0 = rng.integers(3, 40, size=B)
    state = np.stack(
        [course[np.arange(B), i0, 0], course[np.arange(B), i0, 1],
         rng.uniform(0.0, 8.0, B), course[np.arange(B), i0, 2]], axis=1
    )
    return (jnp.asarray(state, dtype), jnp.asarray(course, dtype),
            jnp.zeros((B, N_COURSE), dtype), jnp.full((B,), N_COURSE, jnp.int32),
            jnp.full((B,), dl, dtype))


def _chain_timer(run_chain, k_steps, reps=7):
    """Median seconds/step over `reps` timed chains of k_steps dependent
    steps each. Each timing bracket is dispatch..terminal-fetch of ONE
    jitted scan — strictly positive by construction."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run_chain()
        times.append((time.perf_counter() - t0) / k_steps)
    return statistics.median(times), times


def cpu_mesh_rows():
    """Emulated mesh-scaling rows on the 8-virtual-device CPU backend."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from mpc_for_av_at_intersection_tpu.models import bicycle_geometry
    from mpc_for_av_at_intersection_tpu.mpc import MPCConfig, init_controller_state
    from mpc_for_av_at_intersection_tpu.mpc.batch import mpc_step_batched
    from mpc_for_av_at_intersection_tpu.parallel import batch_mesh, host_chip_mesh

    geom = bicycle_geometry()
    cfg = MPCConfig(T=20)
    dtype = jnp.float32
    devices = jax.devices()
    B_per_dev = 64

    def run_row(nd, mesh, label):
        B = B_per_dev * nd
        args = _mk_instances(B, 512, 20, dtype)
        cs = jax.tree.map(
            lambda x: jnp.broadcast_to(x, (B,) + x.shape),
            init_controller_state(cfg, dtype),
        )
        if mesh is not None:
            spec = P(tuple(mesh.axis_names) if len(mesh.axis_names) > 1
                     else mesh.axis_names[0])
            sharding = NamedSharding(mesh, spec)
            args = tuple(jax.device_put(a, sharding) for a in args)
            cs = jax.tree.map(lambda a: jax.device_put(a, sharding), cs)

        stepB = jax.jit(
            lambda s, c, v, n, d, k: mpc_step_batched(
                s, c, v, n, d, k, cfg, geom.wheelbase
            )
        )
        out = stepB(*args, cs)
        jax.block_until_ready(out.accel)
        s_, c_, v_, n_, d_ = args
        K = 5
        t0 = time.perf_counter()
        k = out.state
        for _ in range(K):
            k = stepB(s_, c_, v_, n_, d_, k).state
        jax.block_until_ready(jax.tree.leaves(k)[0])
        dt = (time.perf_counter() - t0) / K
        return {
            "label": label, "devices": nd, "batch": B,
            "solves_per_sec": round(B / dt, 1),
            "solves_per_sec_per_device": round(B / dt / nd, 1),
        }

    rows = [
        run_row(1, None, "1 device"),
        run_row(8, batch_mesh(devices), "1 host x 8 chips (1-D mesh)"),
        run_row(8, host_chip_mesh(2, devices), "2 hosts x 4 chips (2-axis mesh, emulated)"),
    ]
    base = rows[0]["solves_per_sec_per_device"]
    for r in rows[1:]:
        r["scaling_efficiency"] = round(r["solves_per_sec_per_device"] / base, 3)
    return {
        "backend": "cpu (8 virtual devices)",
        "note": ("emulated rows: virtual CPU devices share physical cores; "
                 "these validate the sharded program and give a lower bound, "
                 "not interconnect bandwidth numbers"),
        "rows": rows,
    }


def main():
    if "--cpu-mesh-rows" in sys.argv:
        # child mode: run under JAX_PLATFORMS=cpu + 8 virtual devices
        import jax

        jax.config.update("jax_platforms", "cpu")
        print("CPU_ROWS_JSON:" + json.dumps(cpu_mesh_rows()))
        return

    import jax
    import jax.numpy as jnp

    from mpc_for_av_at_intersection_tpu.backend import (
        enable_compile_cache,
        platform,
    )

    enable_compile_cache()

    from mpc_for_av_at_intersection_tpu.models import bicycle_geometry
    from mpc_for_av_at_intersection_tpu.mpc import (
        MPCConfig,
        init_controller_state,
        mpc_step,
    )
    from mpc_for_av_at_intersection_tpu.mpc.batch import mpc_step_batched

    geom = bicycle_geometry()
    cfg = MPCConfig(T=20)
    dtype = jnp.float32
    on_gpu = platform() == "gpu"
    devices = jax.devices()
    report = {"device": str(devices[0]), "n_devices": len(devices)}

    # --- (a) p50 batch-1 mpc_step latency: K-step scan on device ---
    K1 = 512
    s1, c1, v1, n1, d1 = _mk_instances(1, 512, 20, dtype)
    cs1 = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (1,) + x.shape), init_controller_state(cfg, dtype)
    )

    @jax.jit
    def chain_mpc(s, c, v, n, d, k0):
        def body(k, _):
            out = jax.vmap(lambda *a: mpc_step(*a, cfg, geom.wheelbase))(
                s, c, v, n, d, k
            )
            return out.state, ()
        kf, _ = jax.lax.scan(body, k0, None, length=K1)
        return kf

    kf = chain_mpc(s1, c1, v1, n1, d1, cs1)          # compile
    jax.block_until_ready(jax.tree.leaves(kf)[0])

    def run1():
        out = chain_mpc(s1, c1, v1, n1, d1, cs1)
        jax.block_until_ready(jax.tree.leaves(out)[0])

    p50_mpc, all_mpc = _chain_timer(run1, K1)
    report["p50_mpc_step_batch1_latency_ms"] = round(p50_mpc * 1e3, 3)
    report["mpc_step_chain"] = {"k_steps": K1, "reps": len(all_mpc),
                                "all_ms": [round(t * 1e3, 3) for t in all_mpc]}

    # --- (b) p50 full engine-tick latency on the flagship intersection ---
    from mpc_for_av_at_intersection_tpu import api
    from mpc_for_av_at_intersection_tpu.engine import run_episode

    setup = api.build_intersection()
    K2 = 200

    @jax.jit
    def chain_engine(world, st):
        final, _ = run_episode(world, st, setup.cfg, setup.geom, K2)
        return final

    fin = chain_engine(setup.world, setup.state0)     # compile
    jax.block_until_ready(fin.ego)

    def run2():
        out = chain_engine(setup.world, setup.state0)
        jax.block_until_ready(out.ego)

    p50_eng, all_eng = _chain_timer(run2, K2, reps=5)
    report["p50_engine_tick_latency_ms"] = round(p50_eng * 1e3, 3)
    report["engine_tick_chain"] = {"k_steps": K2, "reps": len(all_eng),
                                   "all_ms": [round(t * 1e3, 3) for t in all_eng]}
    report["realtime_budget_ms"] = 200.0
    report["latency_method"] = "jitted lax.scan of K dependent steps, wall/K"

    # --- single-device throughput (the bench.py instance family) ---
    B = 2048 if on_gpu else 64
    args = _mk_instances(B, 512, 20, dtype)
    cs = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (B,) + x.shape), init_controller_state(cfg, dtype)
    )
    stepB = jax.jit(
        lambda s, c, v, n, d, k: mpc_step_batched(
            s, c, v, n, d, k, cfg, geom.wheelbase
        )
    )
    out = stepB(*args, cs)
    jax.block_until_ready(out.accel)
    s_, c_, v_, n_, d_ = args
    K = 10
    t0 = time.perf_counter()
    k = out.state
    for _ in range(K):
        k = stepB(s_, c_, v_, n_, d_, k).state
    jax.block_until_ready(jax.tree.leaves(k)[0])
    dt = (time.perf_counter() - t0) / K
    report["single_device"] = {
        "devices": 1, "batch": B,
        "solves_per_sec": round(B / dt, 1),
        "solves_per_sec_per_device": round(B / dt, 1),
    }

    # --- emulated mesh scaling rows (CPU subprocess, 8 virtual devices) ---
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8").strip()
    try:
        child = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--cpu-mesh-rows"],
            capture_output=True, text=True, timeout=3600, env=env,
        )
        for line in child.stdout.splitlines():
            if line.startswith("CPU_ROWS_JSON:"):
                report["mesh_scaling_emulated"] = json.loads(line[len("CPU_ROWS_JSON:"):])
                break
        else:
            report["mesh_scaling_emulated"] = {
                "error": f"child produced no rows; stderr tail: {child.stderr[-500:]}"
            }
    except subprocess.TimeoutExpired:
        report["mesh_scaling_emulated"] = {"error": "cpu child timed out"}

    # --- max real-time batch on this device ---
    # descending so the headline batch lands first; each size guarded: a
    # size that does not fit the device records its error and the sweep
    # goes on
    if on_gpu:
        rt_rows = []
        for B in (24576, 20480, 16384, 8192, 4096, 2048, 1024):
            try:
                args = _mk_instances(B, 512, 20, dtype)
                cs = jax.tree.map(
                    lambda x: jnp.broadcast_to(x, (B,) + x.shape),
                    init_controller_state(cfg, dtype),
                )
                stepB = jax.jit(
                    lambda s, c, v, n, d, k: mpc_step_batched(
                        s, c, v, n, d, k, cfg, geom.wheelbase
                    )
                )
                out = stepB(*args, cs)
                jax.block_until_ready(out.accel)
                s_, c_, v_, n_, d_ = args
                K = 10
                t0 = time.perf_counter()
                k = out.state
                for _ in range(K):
                    k = stepB(s_, c_, v_, n_, d_, k).state
                jax.block_until_ready(jax.tree.leaves(k)[0])
                ms = (time.perf_counter() - t0) / K * 1e3
                rt_rows.append({"batch": B, "tick_ms": round(ms, 1),
                                "realtime": ms < 200.0})
            except Exception as exc:  # noqa: BLE001 — record and move on
                rt_rows.append({"batch": B,
                                "error": str(exc).splitlines()[0][:200]})
        report["realtime_batch_sweep"] = rt_rows
        ok = [r["batch"] for r in rt_rows if r.get("realtime")]
        report["max_realtime_batch_per_device"] = max(ok) if ok else 0

    out_js = json.dumps(report, indent=2)
    print(out_js)
    paths = [a for a in sys.argv[1:] if not a.startswith("--")]
    if paths:
        with open(paths[0], "w") as f:
            f.write(out_js + "\n")


if __name__ == "__main__":
    main()
