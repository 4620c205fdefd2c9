"""Per-process worker for multi-host fleet runs.

Usage (one line per host / emulated host):

    python -m mpc_for_av_at_intersection_tpu.parallel.fleet_worker \
        --coordinator 127.0.0.1:19731 --num-processes 2 --process-id 0 \
        --emulate-local-devices 4 --batch 8 --steps 3

Every process builds the SAME deterministic scenario batch host-side
(seeded), contributes its addressable shards of the global arrays, runs
the shard_map'd fleet over the global ``(hosts, chips)`` mesh, and prints
the psum'd (replicated) fleet summary as one JSON line — identical on all
processes, and identical to a single-process run of the same batch.

On a GPU cluster, omit --emulate-local-devices and point --coordinator at
process 0's host.
"""

from __future__ import annotations

import argparse
import json
import sys


def build_demo_fleet(batch: int, n_steps: int):
    """The deterministic demo fleet shared by the smoke test and the
    single-process oracle: tiny curved courses + one scripted agent each."""
    import numpy as np

    from ..agents import make_t_intersection_agent, stack_agents
    from ..engine import EngineConfig, init_engine_state, make_world
    from ..models import bicycle_geometry
    from ..mpc import MPCConfig
    from .mesh import stack_states, stack_worlds

    cfg = EngineConfig(
        mpc=MPCConfig(admm_rounds=2, admm_iters=8),
        n_traj=64, n_frames=48, n_agents=2, frame_window=4,
    )
    geom = bicycle_geometry()
    t = np.linspace(0.0, 6.0, 60)
    course = np.stack([t, 0.02 * t ** 2, 0.0 * t], axis=1)
    course[:, 2] = np.arctan2(np.gradient(course[:, 1]), np.gradient(course[:, 0]))

    worlds, states = [], []
    for i in range(batch):
        rows = [make_t_intersection_agent(
            direction=1, turning=False, speed=4.0 + i * 0.2, offset=1.0)]
        params, ag = stack_agents(rows, n_slots=cfg.n_agents)
        w = make_world(course, params, cfg)
        worlds.append(w)
        states.append(init_engine_state(w, ag, cfg, n_steps))
    return cfg, geom, stack_worlds(worlds), stack_states(states)


def _globalize(tree, mesh):
    """Lift a (replicated host-side) batch pytree into global arrays
    sharded over every mesh axis flattened; each process contributes only
    its addressable shards."""
    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    spec = P(tuple(mesh.axis_names))

    def put(x):
        x = np.asarray(x)
        sharding = NamedSharding(mesh, spec)
        return jax.make_array_from_callback(x.shape, sharding, lambda idx: x[idx])

    return jax.tree.map(put, tree)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--emulate-local-devices", type=int, default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)

    from .distributed import global_host_chip_mesh, initialize_process

    initialize_process(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
        emulate_local_devices=args.emulate_local_devices,
    )

    import jax

    from .mesh import run_batch_episodes

    cfg, geom, wb, sb = build_demo_fleet(args.batch, args.steps)
    mesh = global_host_chip_mesh()
    wb_g = _globalize(wb, mesh)
    sb_g = _globalize(sb, mesh)

    _, _, summary = run_batch_episodes(wb_g, sb_g, cfg, geom, args.steps, mesh=mesh)
    report = {
        "process_id": jax.process_index(),
        "process_count": jax.process_count(),
        "global_devices": jax.device_count(),
        "mesh": dict(zip(mesh.axis_names, mesh.devices.shape)),
        "n_done": int(summary["n_done"]),
        "ticks_to_goal_sum": int(summary["ticks_to_goal_sum"]),
        "n_unsolved_ticks": int(summary["n_unsolved_ticks"]),
    }
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main(sys.argv[1:])
