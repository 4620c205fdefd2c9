"""Command-line interface.

The reference has no CLI at all — every experiment is a script edited by
hand and run with a specific cwd (SURVEY section 5.6). This replaces that
with:

    python -m mpc_for_av_at_intersection_tpu run --driver intersection
    python -m mpc_for_av_at_intersection_tpu plan --env roundabout --start 1 --turn 1
    python -m mpc_for_av_at_intersection_tpu fleet --n 256 --steps 200
    python -m mpc_for_av_at_intersection_tpu sweep --param w_perp --values 1,5,20
    python -m mpc_for_av_at_intersection_tpu bench
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _cmd_run(args):
    import jax
    import numpy as np

    from . import api
    from .engine import run_episode

    builders = {
        "intersection": api.build_intersection,
        "t_intersection": api.build_t_intersection_basic,
        "roundabout": api.build_roundabout,
        "multi_lane": api.build_intersection_multi_lane,
        "speed_ref": api.build_intersection_speed_ref,
        "overtaking": api.build_overtaking_cyclist,
    }
    setup = builders[args.driver]()
    t0 = time.perf_counter()
    if getattr(args, "live", False) or getattr(args, "live_save", None):
        # reference-style frame-by-frame loop (mpc_intersection.py:150):
        # one jitted engine tick per iteration, rendered as it happens
        from .engine import run_episode_live
        from .utils.plotting import LiveView

        view = LiveView(
            setup.scenario, setup.geom, trajectory=setup.trajectory,
            dt=setup.cfg.mpc.dt, save_dir=getattr(args, "live_save", None),
        )
        final, tel = run_episode_live(
            setup.world, setup.state0, setup.cfg, setup.geom, args.steps,
            on_tick=view,
        )
        view.close()
    else:
        run = jax.jit(lambda w, s: run_episode(w, s, setup.cfg, setup.geom, args.steps))
        final, tel = run(setup.world, setup.state0)
        jax.block_until_ready(final)
    tel = jax.tree.map(np.asarray, tel)
    dt = time.perf_counter() - t0

    k = int(final.ticks_to_goal)
    out = {
        "driver": args.driver,
        "done": bool(final.done),
        "ticks_to_goal": k,
        "sim_seconds": k * setup.cfg.mpc.dt,
        "wall_seconds": round(dt, 3),
        "unsolved_ticks": int((~tel.solved).sum()),
        "conflicts_detected": int(tel.collision_found.sum()),
        "max_xref_deviation": float(np.nanmax(tel.xref_dev[: max(k, 1)])),
    }
    print(json.dumps(out, indent=2))

    if args.save_telemetry:
        np.savez(args.save_telemetry, **tel._asdict())
        print(f"telemetry -> {args.save_telemetry}", file=sys.stderr)
    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from .utils import plot_telemetry

        axes = plot_telemetry(tel, dt=setup.cfg.mpc.dt)
        axes[0].figure.savefig(args.plot, dpi=120)
        print(f"plot -> {args.plot}", file=sys.stderr)


def _cmd_plan(args):
    import numpy as np

    from .lattice import MotionPrimitiveSearch, SearchWeights, primitive_table
    from .models import bicycle_geometry, prius_geometry
    from .worlds import (
        arterial_multi_lanes,
        intersection,
        intersection_multi_lanes,
        roundabout,
        roundabout_big,
        t_intersection,
    )

    envs = {
        "intersection": lambda: intersection(args.turn, args.start),
        "t_intersection": lambda: t_intersection(args.turn, args.start),
        "roundabout": lambda: roundabout(args.turn, args.start),
        "roundabout_big": lambda: roundabout_big(args.turn, args.start),
        "multi_lane": lambda: intersection_multi_lanes(args.turn, args.start),
        "arterial": lambda: arterial_multi_lanes(),
    }
    sc = envs[args.env]()
    geom = prius_geometry() if args.vehicle == "prius" else bicycle_geometry()
    table = primitive_table(geom)

    t0 = time.perf_counter()
    if args.backend == "native":
        from .native import NativeMotionPrimitiveSearch, native_available

        if not native_available():
            print("native core unavailable; falling back to python", file=sys.stderr)
            args.backend = "python"
    if args.backend == "native":
        search = NativeMotionPrimitiveSearch(sc, geom, table, margin=geom.radius)
        cost, path, traj = search.run()
        n_exp = search.n_expanded
    else:
        search = MotionPrimitiveSearch(sc, geom, table, margin=geom.radius)
        cost, path, traj = search.run(debug=True)
        n_exp = len(search.debug_data)
    dt = time.perf_counter() - t0

    print(json.dumps({
        "env": args.env, "cost": round(cost, 4), "path_nodes": len(path),
        "trajectory_points": len(traj), "expansions": n_exp,
        "runtime_ms": round(dt * 1e3, 2), "backend": args.backend,
    }, indent=2))


def _cmd_fleet(args):
    import numpy as np

    from . import api
    from .engine import EngineConfig
    from .parallel import batch_mesh, run_batch_episodes

    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    if args.geom:
        geom, wb, sb, meta = api.sample_intersection_fleet_geom(
            args.n, rng, n_steps=args.steps, planner=args.planner
        )
    else:
        geom, wb, sb, meta = api.sample_intersection_fleet_batched(
            args.n, rng, n_steps=args.steps, planner=args.planner
        )
    t_plan = time.perf_counter() - t0

    import jax

    mesh = batch_mesh() if args.shard and len(jax.devices()) > 1 else None
    t0 = time.perf_counter()
    final, tel, summary = run_batch_episodes(
        wb, sb, EngineConfig(), geom, args.steps, mesh=mesh,
    )
    jax.block_until_ready(summary)
    t_run = time.perf_counter() - t0

    print(json.dumps({
        "n_scenarios": args.n,
        "n_done": int(summary["n_done"]),
        "unsolved_ticks": int(summary["n_unsolved_ticks"]),
        "mean_ticks_to_goal": float(summary["ticks_to_goal_sum"]) / args.n,
        "planner": args.planner,
        "plan_seconds": round(t_plan, 2),
        "run_seconds": round(t_run, 2),
        "scenario_ticks_per_second": round(args.n * args.steps / t_run, 1),
        "devices": len(jax.devices()) if mesh else 1,
    }, indent=2))


def _cmd_sweep(args):
    from . import api, sweep

    values = [float(v) for v in args.values.split(",")]
    recs = sweep.mpc_weight_sweep(
        lambda cfg: api.build_intersection(other_vehicles=False, cfg=cfg),
        args.param, values, n_steps=args.steps,
    )
    print(json.dumps([
        {
            "value": r.value, "done": r.done, "ticks_to_goal": r.ticks_to_goal,
            "max_deviation": round(r.max_deviation, 4),
            "mean_abs_accel": round(r.mean_abs_accel, 4),
        }
        for r in recs
    ], indent=2))


def _cmd_bench(args):
    import runpy
    import pathlib

    runpy.run_path(str(pathlib.Path(__file__).parent.parent / "bench.py"),
                   run_name="__main__")


def main(argv=None):
    p = argparse.ArgumentParser(prog="mpc_for_av_at_intersection_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run", help="run one closed-loop driver scenario")
    r.add_argument("--driver", default="intersection",
                   choices=["intersection", "t_intersection", "roundabout",
                            "multi_lane", "speed_ref", "overtaking"])
    r.add_argument("--steps", type=int, default=256)
    r.add_argument("--save-telemetry", default=None)
    r.add_argument("--plot", default=None)
    r.add_argument("--live", action="store_true",
                   help="render every control tick as it runs "
                        "(reference-style live animation; needs a display)")
    r.add_argument("--live-save", default=None, metavar="DIR",
                   help="live per-tick rendering, frames streamed to DIR "
                        "(headless equivalent of --live)")
    r.set_defaults(fn=_cmd_run)

    pl = sub.add_parser("plan", help="global lattice plan only")
    pl.add_argument("--env", default="intersection")
    pl.add_argument("--start", type=int, default=4)
    pl.add_argument("--turn", type=int, default=1)
    pl.add_argument("--vehicle", default="bicycle", choices=["bicycle", "prius"])
    pl.add_argument("--backend", default="native", choices=["native", "python"])
    pl.set_defaults(fn=_cmd_plan)

    f = sub.add_parser("fleet", help="Monte-Carlo batched fleet run")
    f.add_argument("--n", type=int, default=64)
    f.add_argument("--steps", type=int, default=200)
    f.add_argument("--seed", type=int, default=0)
    f.add_argument("--shard", action="store_true", help="shard over devices")
    f.add_argument("--planner", default="native",
                   choices=["native", "device", "host"],
                   help="global planner: host C++ core, batched device "
                        "wavefront, or Python host search")
    f.add_argument("--geom", action="store_true",
                   help="sample per-scenario junction GEOMETRY (road / "
                        "median / corner radius) — every scenario gets a "
                        "unique junction; use --planner device at scale")
    f.set_defaults(fn=_cmd_fleet)

    s = sub.add_parser("sweep", help="MPC weight sensitivity sweep")
    s.add_argument("--param", default="w_perp")
    s.add_argument("--values", default="1,5,20")
    s.add_argument("--steps", type=int, default=200)
    s.set_defaults(fn=_cmd_sweep)

    b = sub.add_parser("bench", help="run the headline benchmark")
    b.set_defaults(fn=_cmd_bench)

    args = p.parse_args(argv)
    from .backend import enable_compile_cache

    enable_compile_cache()
    args.fn(args)


if __name__ == "__main__":
    main()
