"""Device planning throughput: batched wavefront lattice searches / s / device.

Complements bench.py (MPC solve throughput) with the planning side of the
bi-level stack (SURVEY section 7.2.3): a batch of full intersection global
plans — frontier expansion x 9 primitives x all half-planes — run as ONE
jitted vmapped search.

Validates the device plans against the exact host search cost band, then
reports steady-state plans/s. Prints one JSON object; pass a path argument
to also write it to a file.
"""

import json
import sys
import time

import numpy as np


def main():
    import jax

    from mpc_for_av_at_intersection_tpu.backend import enable_compile_cache

    enable_compile_cache()

    from mpc_for_av_at_intersection_tpu.api import plan_courses_batch
    from mpc_for_av_at_intersection_tpu.lattice import (
        MotionPrimitiveSearch,
        SearchWeights,
        primitive_table,
    )
    from mpc_for_av_at_intersection_tpu.models import bicycle_geometry
    from mpc_for_av_at_intersection_tpu.worlds import intersection

    geom = bicycle_geometry()
    table = primitive_table(geom)

    # all 12 feasible (start, turn) junction configs, tiled to the batch
    keys = [(s, t) for s in (1, 2, 3, 4) for t in (1, 2, 3)]
    BATCH = 132     # 11 x the 12 junction configs (VERDICT r4: batch >= 128)
    scenarios = [
        intersection(turn_indicator=t, start_pos=s)
        for (s, t) in (keys * ((BATCH + len(keys) - 1) // len(keys)))[:BATCH]
    ]

    # cost-band validation on the unique configs (host search = exact oracle)
    host_costs = {}
    for (s, t) in keys:
        sc = intersection(turn_indicator=t, start_pos=s)
        h = MotionPrimitiveSearch(
            sc, geom, table, margin=geom.radius, weights=SearchWeights.modified()
        )
        host_costs[(s, t)] = h.run()[0]

    t0 = time.time()
    trajs, stats = plan_courses_batch(scenarios, geom, planner="device")
    first_call_s = time.time() - t0

    costs = np.asarray(stats["device_costs"])
    in_band = 0
    for i, (s, t) in enumerate((keys * ((BATCH + len(keys) - 1) // len(keys)))[:BATCH]):
        ch = host_costs[(s, t)]
        if np.isfinite(costs[i]) and 0.85 * ch - 1e-6 <= costs[i] <= 1.10 * ch + 1e-6:
            in_band += 1

    # steady state (plan_courses_batch re-traces only on shape change; the
    # jit cache inside plan_courses_device keys on the same args)
    iters = 5
    t0 = time.time()
    for _ in range(iters):
        trajs, stats = plan_courses_batch(scenarios, geom, planner="device")
    dt = (time.time() - t0) / iters

    report = {
        "metric": "device_plans_per_sec_per_device",
        "value": round(BATCH / dt, 2),
        "unit": "plans/s/device",
        "batch": BATCH,
        "iter_time_s": round(dt, 3),
        "first_call_s": round(first_call_s, 1),
        "cost_band_hit_rate": round(in_band / BATCH, 4),
        "n_host_fallback": int(stats["n_host_fallback"]),
        "device": str(jax.devices()[0]),
    }
    out = json.dumps(report, indent=2)
    print(out)
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            f.write(out + "\n")


if __name__ == "__main__":
    main()
