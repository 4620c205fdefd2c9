"""Solver failure tail: unsolved-tick rate over a large f32 fleet run.

Round-1 observed ~1/25,600 fleet ticks unsolved (controller brakes as
designed, QUIRKS #16); the primal-identified second polish attempt
(mpc/qp.py) was added to kill that tail. This measures the post-fix rate
over >= 100k closed-loop fleet ticks (VERDICT round-1 item 5).

Prints one JSON object; pass a path argument to persist it.
"""

import json
import sys
import time

import numpy as np

N_SCENARIOS = 1024
N_STEPS = 128          # 1024 x 128 = 131,072 fleet ticks


def main():
    import jax

    from mpc_for_av_at_intersection_tpu.backend import enable_compile_cache

    enable_compile_cache()

    from mpc_for_av_at_intersection_tpu import api
    from mpc_for_av_at_intersection_tpu.engine import EngineConfig
    from mpc_for_av_at_intersection_tpu.parallel import (
        run_batch_episodes,
        stack_states,
        stack_worlds,
    )

    rng = np.random.default_rng(42)
    t0 = time.time()
    geom, worlds, states, meta = api.sample_intersection_fleet(
        N_SCENARIOS, rng, n_steps=N_STEPS
    )
    t_build = time.time() - t0
    wb, sb = stack_worlds(worlds), stack_states(states)

    # warm run (compile + first execution); the timed bracket below
    # measures steady state
    t0 = time.time()
    final, tel, summary = run_batch_episodes(
        wb, sb, EngineConfig(), geom, N_STEPS,
    )
    n_unsolved = int(summary["n_unsolved_ticks"])
    t_first = time.time() - t0

    t0 = time.time()
    final, tel, summary = run_batch_episodes(
        wb, sb, EngineConfig(), geom, N_STEPS,
    )
    n_unsolved = int(summary["n_unsolved_ticks"])
    t_run = time.time() - t0

    n_ticks = N_SCENARIOS * N_STEPS
    report = {
        "metric": "unsolved_tick_rate",
        "fleet_ticks": n_ticks,
        "unsolved_ticks": n_unsolved,
        "rate": n_unsolved / n_ticks,
        "n_scenarios": N_SCENARIOS,
        "n_done": int(summary["n_done"]),
        "build_s": round(t_build, 1),
        "first_run_s": round(t_first, 1),
        "run_s": round(t_run, 1),
        "scenario_ticks_per_s": round(n_ticks / t_run, 1),
        "device": str(jax.devices()[0]),
        "dtype": "float32",
    }
    out = json.dumps(report, indent=2)
    print(out)
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            f.write(out + "\n")


if __name__ == "__main__":
    main()
