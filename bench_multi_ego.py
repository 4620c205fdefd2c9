"""Multi-ego performance harness (BASELINE config 4).

The reference *intended* interactive multi-ego MPC and never ran it
(``main/scenarios/interactive_mpc.py:117-190`` — undefined names, SURVEY
§2.11); this rebuild has it working and correctness-tested. This harness
commits the missing performance numbers (VERDICT r3 item 3):

- p50/p95 single-junction tick latency at E=8 (every ego running the full
  bi-level stack against peer predictions),
- fleet throughput: S independent 8-ego junctions per tick via
  ``multi_ego_fleet_tick`` (all S*E QPs in one batched solve),
  swept S in powers of two to the largest that still meets the dt=200 ms
  realtime budget,
- a zero-ego-ego-collision check over a full episode (outcome parity with
  tests/test_prius_and_fleet.py::test_eight_ego_intersection).

Prints one JSON object; pass a path to persist it.
"""

import json
import statistics
import sys
import time

import numpy as np

E = 8
N_STEPS = 300
REALTIME_MS = 200.0


def main():
    import jax

    from mpc_for_av_at_intersection_tpu.backend import enable_compile_cache

    enable_compile_cache()

    import jax.numpy as jnp

    from mpc_for_av_at_intersection_tpu.agents import stack_agents
    from mpc_for_av_at_intersection_tpu.engine import (
        EngineConfig,
        init_multi_ego_state,
        make_multi_ego_world,
        run_multi_ego_episode,
    )
    from mpc_for_av_at_intersection_tpu.engine.multi_ego import (
        multi_ego_fleet_tick,
        multi_ego_tick_batched,
    )
    from mpc_for_av_at_intersection_tpu.lattice import (
        MotionPrimitiveSearch,
        SearchWeights,
        primitive_table,
    )
    from mpc_for_av_at_intersection_tpu.models import bicycle_geometry
    from mpc_for_av_at_intersection_tpu.worlds import intersection_multi_lanes

    geom = bicycle_geometry()
    table = primitive_table(geom)
    cfg = EngineConfig(n_agents=2)

    # the correctness-tested 8-ego configuration: 2 lanes x 4 arms
    combos = [
        (1, 2, 1), (1, 3, 2), (2, 2, 1), (2, 3, 2),
        (3, 2, 1), (3, 3, 2), (4, 2, 1), (4, 3, 2),
    ]
    trajs = []
    for start, turn, lane in combos:
        sc = intersection_multi_lanes(
            turn_indicator=turn, start_pos=start, start_lane=lane,
            goal_lane=lane, number_of_lanes=2,
        )
        s = MotionPrimitiveSearch(sc, geom, table, margin=geom.radius,
                                  weights=SearchWeights.modified())
        _, _, t = s.run()
        trajs.append(t)

    params, ag = stack_agents([], n_slots=cfg.n_agents)
    world = make_multi_ego_world(trajs, params, cfg)
    st0 = init_multi_ego_state(world, ag, cfg, N_STEPS)

    report = {"device": str(jax.devices()[0]), "E": E, "n_steps": N_STEPS,
              "dt_ms": cfg.mpc.dt * 1e3}

    # ---- outcome check: full episode, goals + zero ego-ego collision ----
    run = jax.jit(
        lambda w, s: run_multi_ego_episode(w, s, cfg, geom, N_STEPS))
    final, tel = run(world, st0)
    tel = jax.tree.map(np.asarray, tel)
    n_done = int(np.sum(np.asarray(final.done)))
    cc = np.asarray(geom.circle_centers)
    x, y, yaw = tel.x, tel.y, tel.yaw
    cth, sth = np.cos(yaw), np.sin(yaw)                  # (T, E)
    px = x[:, :, None] + cth[:, :, None] * cc[None, None, :, 0] \
        - sth[:, :, None] * cc[None, None, :, 1]          # (T, E, C)
    py = y[:, :, None] + sth[:, :, None] * cc[None, None, :, 0] \
        + cth[:, :, None] * cc[None, None, :, 1]
    min_clear = np.inf
    for a in range(E):
        for b in range(a + 1, E):
            d = np.hypot(px[:, a, :, None] - px[:, b, None, :],
                         py[:, a, :, None] - py[:, b, None, :]).min()
            min_clear = min(min_clear, float(d))
    report["episode"] = {
        "egos_done": n_done,
        "min_ego_ego_clearance_m": round(min_clear, 3),
        "collision_free": bool(min_clear > 2 * geom.radius * 0.7),
        "all_solved": bool(tel.solved.all()),
    }
    print(f"episode: {n_done}/{E} done, clearance {min_clear:.2f} m",
          file=sys.stderr, flush=True)

    # ---- p50/p95 single-junction tick latency (E=8) ----
    tick1 = jax.jit(
        lambda s: multi_ego_tick_batched(world, s, cfg, geom))
    st = st0
    st, _ = tick1(st)
    jax.tree.map(lambda a: a.block_until_ready(), st)
    lats = []
    for _ in range(50):
        t0 = time.perf_counter()
        st, tel_t = tick1(st)
        jax.block_until_ready(tel_t.accel)
        lats.append(time.perf_counter() - t0)
    lats_ms = sorted(v * 1e3 for v in lats)
    report["tick_latency_ms"] = {
        "p50": round(statistics.median(lats_ms), 3),
        "p95": round(lats_ms[int(0.95 * len(lats_ms)) - 1], 3),
    }
    print(f"p50 tick {report['tick_latency_ms']['p50']} ms",
          file=sys.stderr, flush=True)

    # ---- fleet throughput sweep: S junctions x E egos per tick ----
    K = 8
    sweep = []
    best = None
    S = 16
    while True:
        worldS = jax.tree.map(lambda a: jnp.broadcast_to(a, (S,) + a.shape),
                              world)
        stS = jax.tree.map(lambda a: jnp.broadcast_to(a, (S,) + a.shape), st0)

        @jax.jit
        def chain(w, s):
            def body(s_, _):
                s2, _tel = multi_ego_fleet_tick(w, s_, cfg, geom)
                return s2, ()
            sf, _ = jax.lax.scan(body, s, None, length=K)
            return sf.egos

        out = chain(worldS, stS)
        jax.block_until_ready(out)             # compile + first exec
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = chain(worldS, stS)
            jax.block_until_ready(out)
            ts.append((time.perf_counter() - t0) / K)
        tick_ms = statistics.median(ts) * 1e3
        row = {"S": S, "egos": S * E, "tick_ms": round(tick_ms, 2),
               "junction_ticks_per_s": round(S / (tick_ms / 1e3), 1),
               "ego_solves_per_s": round(S * E / (tick_ms / 1e3), 1)}
        sweep.append(row)
        print(f"S={S:4d} ({S*E:5d} egos) tick {tick_ms:8.2f} ms "
              f"-> {row['ego_solves_per_s']:9.1f} ego-solves/s",
              file=sys.stderr, flush=True)
        if tick_ms <= REALTIME_MS:
            best = row
        if tick_ms > REALTIME_MS or S >= 1024:
            break
        S *= 2

    report["fleet_sweep"] = sweep
    report["max_realtime"] = best
    report["metric"] = "multi_ego_e8"

    out_s = json.dumps(report, indent=2)
    print(out_s)
    paths = [a for a in sys.argv[1:] if not a.startswith("--")]
    if paths:
        with open(paths[0], "w") as f:
            f.write(out_s + "\n")


if __name__ == "__main__":
    main()
