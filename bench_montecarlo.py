"""BASELINE config 5 at its stated scale: 10,000-scenario Monte-Carlo fleet.

Samples 10k intersection scenarios (start arm x turn x stochastic arrival
schedule, ``api.sample_intersection_fleet_batched`` — the vectorized
builder; the per-scenario loop builder cost 83 s at this scale, VERDICT r4
weak #4), runs each closed-loop for N_STEPS ticks on ONE device in memory-sized
chunks, and reports the fleet outcome: done rate, unsolved-tick rate, warm
steady-state ticks/s, and a BREAKDOWN of the non-done tail:

  yield_locked  conflict cutoff still active at the final tick — the ego
                is (correctly) waiting behind scripted traffic
  en_route      no active cutoff, still driving toward the goal
  near_goal     within goal distance but not yet satisfying the full goal
                test (stop speed / localization window)
  anomalous     none of the above (stationary far from goal, no cutoff)

Chunks after the first reuse the compiled executable, so their timing is
steady state; chunk 1 carries the compile + first execution and is
reported separately. When only one chunk runs, it is re-run once and the
second (warm) execution is timed — the first execution otherwise leaks
into ``warm_scenario_ticks_per_s``.
"""

import json
import os
import sys
import time

import numpy as np

N_SCENARIOS = int(os.environ.get("MC_N", 10_000))
CHUNK = int(os.environ.get("MC_CHUNK", 2048))
N_STEPS = int(os.environ.get("MC_STEPS", 128))
# MC_GEOM=1: sample per-scenario junction GEOMETRY (road/median/corner
# radius) and plan every scenario on the device planner — no shared plans
GEOM_MODE = os.environ.get("MC_GEOM", "0") == "1" 


def main():
    import jax

    from mpc_for_av_at_intersection_tpu.backend import enable_compile_cache

    enable_compile_cache()

    import jax.numpy as jnp

    from mpc_for_av_at_intersection_tpu import api
    from mpc_for_av_at_intersection_tpu.engine import EngineConfig
    from mpc_for_av_at_intersection_tpu.parallel import run_batch_episodes

    rng = np.random.default_rng(2026)
    t0 = time.time()
    if GEOM_MODE:
        geom, world_b, state_b, _meta = api.sample_intersection_fleet_geom(
            N_SCENARIOS, rng, n_steps=N_STEPS, planner="device"
        )
    else:
        geom, world_b, state_b, _meta = api.sample_intersection_fleet_batched(
            N_SCENARIOS, rng, n_steps=N_STEPS
        )
    t_build = time.time() - t0
    print(f"built {N_SCENARIOS} scenarios in {t_build:.1f}s",
          file=sys.stderr, flush=True)

    cfg = EngineConfig()
    mpc_cfg = cfg.mpc

    # pad the last chunk by repeating scenario 0 so every chunk hits the
    # same compiled executable (padded rows are excluded from the stats)
    n_chunks = (N_SCENARIOS + CHUNK - 1) // CHUNK
    totals = {"n_done": 0, "n_unsolved_ticks": 0, "ticks_to_goal_sum": 0}
    breakdown = {"yield_locked": 0, "en_route": 0, "near_goal": 0,
                 "anomalous": 0}
    chunk_times = []
    anomalous_idx = []

    def take(tree, idx):
        return jax.tree.map(lambda a: a[idx], tree)

    def run_chunk(wb, sb):
        t0 = time.time()
        final, tel, _summary = run_batch_episodes(
            wb, sb, cfg, geom, N_STEPS
        )
        done = np.asarray(final.done)
        dt_chunk = time.time() - t0
        return final, tel, done, dt_chunk

    for ci in range(n_chunks):
        lo = ci * CHUNK
        hi = min(lo + CHUNK, N_SCENARIOS)
        n_real = hi - lo
        idx = np.concatenate(
            [np.arange(lo, hi), np.zeros(CHUNK - n_real, np.int64)])
        wb = take(world_b, idx)
        sb = take(state_b, idx)
        final, tel, done_all, dt_chunk = run_chunk(wb, sb)
        if n_chunks == 1:
            # single-chunk run: the only timing includes compile +
            # first-exec; re-run warm for an honest steady-state number
            final, tel, done_all, warm_dt = run_chunk(wb, sb)
            chunk_times.append(dt_chunk)
            chunk_times.append(warm_dt)
        else:
            chunk_times.append(dt_chunk)
        done = done_all[:n_real]
        unsolved = (~np.asarray(tel.solved))[:n_real].sum()
        ttg = np.asarray(final.ticks_to_goal)[:n_real]
        totals["n_done"] += int(done.sum())
        totals["n_unsolved_ticks"] += int(unsolved)
        totals["ticks_to_goal_sum"] += int(ttg.sum())

        # --- non-done breakdown (VERDICT r4 #4) ---
        nd = ~done
        if nd.any():
            ego = np.asarray(final.ego)[:n_real]
            cut = np.asarray(final.cutoff_len)[:n_real]
            n_course = np.asarray(wb.n_course)[:n_real]
            goal = np.asarray(wb.goal_xy)[:n_real]
            dist = np.hypot(ego[:, 0] - goal[:, 0], ego[:, 1] - goal[:, 1])
            v = np.abs(ego[:, 2])
            yield_locked = nd & (cut < n_course)
            near_goal = nd & ~yield_locked & (dist <= mpc_cfg.goal_dist)
            en_route = (nd & ~yield_locked & ~near_goal
                        & (v > mpc_cfg.stop_speed))
            anomalous = nd & ~yield_locked & ~near_goal & ~en_route
            breakdown["yield_locked"] += int(yield_locked.sum())
            breakdown["near_goal"] += int(near_goal.sum())
            breakdown["en_route"] += int(en_route.sum())
            breakdown["anomalous"] += int(anomalous.sum())
            anomalous_idx.extend((lo + np.nonzero(anomalous)[0]).tolist())

        print(f"chunk {ci + 1}/{n_chunks}: {n_real} scen, "
              f"{int(done.sum())} done, {int(unsolved)} unsolved ticks, "
              f"{dt_chunk:.1f}s", file=sys.stderr, flush=True)

    # re-run the anomalous bucket with a 4x tick budget to see whether the
    # scenarios are merely slow or genuinely stuck
    anomalous_resolved = None
    if anomalous_idx:
        ext_steps = 4 * N_STEPS
        idx = np.asarray(anomalous_idx[:CHUNK])
        wb = take(world_b, idx)
        sb = take(state_b, idx)
        final, _tel, _s = run_batch_episodes(wb, sb, cfg, geom, ext_steps)
        anomalous_resolved = int(np.asarray(final.done).sum())

    n_ticks = N_SCENARIOS * N_STEPS
    warm = chunk_times[1:]
    warm_ticks_per_s = (len(warm) * CHUNK * N_STEPS) / sum(warm)
    report = {
        "metric": ("montecarlo_geom_fleet_10k" if GEOM_MODE
                   else "montecarlo_fleet_10k"),
        "n_scenarios": N_SCENARIOS,
        "n_steps": N_STEPS,
        "fleet_ticks": n_ticks,
        "n_done": totals["n_done"],
        "done_rate": round(totals["n_done"] / N_SCENARIOS, 4),
        "unsolved_ticks": totals["n_unsolved_ticks"],
        "unsolved_rate": totals["n_unsolved_ticks"] / n_ticks,
        "mean_ticks_to_goal": round(
            totals["ticks_to_goal_sum"] / N_SCENARIOS, 1),
        "non_done_breakdown": breakdown,
        "anomalous_resolved_at_4x_budget": anomalous_resolved,
        "build_s": round(t_build, 1),
        "chunk": CHUNK,
        "chunk_times_s": [round(t, 1) for t in chunk_times],
        "first_chunk_s": round(chunk_times[0], 1),
        "warm_scenario_ticks_per_s": round(warm_ticks_per_s, 1),
        "device": str(jax.devices()[0]),
        "dtype": "float32",
    }
    if GEOM_MODE:
        st = dict(_meta["planner_stats"])
        report["sampled_geometry"] = {
            "road_range": [float(_meta["road"].min()),
                           float(_meta["road"].max())],
            "island_range": [float(_meta["island"].min()),
                             float(_meta["island"].max())],
            "corner_radius_range": [float(_meta["corner_radius"].min()),
                                    float(_meta["corner_radius"].max())],
            "n_unique_geometries": N_SCENARIOS,
            "planner": st.get("planner"),
            "n_device": int(st.get("n_device", 0)),
            "n_host_fallback": int(st.get("n_host_fallback", 0)),
        }
    out = json.dumps(report, indent=2)
    print(out)
    paths = [a for a in sys.argv[1:] if not a.startswith("--")]
    if paths:
        with open(paths[0], "w") as f:
            f.write(out + "\n")


if __name__ == "__main__":
    main()
