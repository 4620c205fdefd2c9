"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

import jax

from mpc_for_av_at_intersection_tpu.parallel import batch_mesh


def test_virtual_mesh_has_8_devices():
    assert len(jax.devices()) == 8


def test_dryrun_multichip_entrypoint():
    import sys

    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_batched_episodes_sharded_equals_vmap():
    """shard_map over the batch axis must agree with plain vmap."""
    import __graft_entry__ as ge
    from mpc_for_av_at_intersection_tpu.agents import (
        make_t_intersection_agent,
        stack_agents,
    )
    from mpc_for_av_at_intersection_tpu.engine import (
        EngineConfig,
        init_engine_state,
        make_world,
    )
    from mpc_for_av_at_intersection_tpu.models import bicycle_geometry
    from mpc_for_av_at_intersection_tpu.mpc import MPCConfig
    from mpc_for_av_at_intersection_tpu.parallel import (
        run_batch_episodes,
        stack_states,
        stack_worlds,
    )

    cfg = EngineConfig(
        mpc=MPCConfig(admm_rounds=2, admm_iters=8),
        n_traj=64, n_frames=48, n_agents=2, frame_window=4,
    )
    geom = bicycle_geometry()
    t = np.linspace(0.0, 6.0, 60)
    course = np.stack([t, 0.02 * t ** 2, 0.0 * t], axis=1)
    course[:, 2] = np.arctan2(np.gradient(course[:, 1]), np.gradient(course[:, 0]))

    worlds, states = [], []
    for i in range(8):
        rows = [make_t_intersection_agent(direction=1, turning=False, speed=4.0 + i * 0.2, offset=1.0)]
        params, ag = stack_agents(rows, n_slots=cfg.n_agents)
        w = make_world(course, params, cfg)
        worlds.append(w)
        states.append(init_engine_state(w, ag, cfg, 3))

    wb, sb = stack_worlds(worlds), stack_states(states)

    f1, t1, s1 = run_batch_episodes(wb, sb, cfg, geom, 3, mesh=None)
    f2, t2, s2 = run_batch_episodes(wb, sb, cfg, geom, 3, mesh=batch_mesh())

    np.testing.assert_allclose(np.asarray(f1.ego), np.asarray(f2.ego), atol=2e-5)
    np.testing.assert_allclose(np.asarray(t1.steer), np.asarray(t2.steer), atol=2e-5)
    assert int(s1["n_done"]) == int(s2["n_done"])
    assert int(s2["n_unsolved_ticks"]) == int(s1["n_unsolved_ticks"])

    # 2-axis (hosts, chips) topology — the emulated >=2-host row (SURVEY
    # §5.8): same program as a real 2-host 2x4 slice, sharded over both
    # axes flattened, psum over the combined axis
    from mpc_for_av_at_intersection_tpu.parallel import host_chip_mesh

    mesh2 = host_chip_mesh(2)
    assert mesh2.devices.shape == (2, 4)
    f3, t3, s3 = run_batch_episodes(wb, sb, cfg, geom, 3, mesh=mesh2)
    np.testing.assert_allclose(np.asarray(f1.ego), np.asarray(f3.ego), atol=2e-5)
    np.testing.assert_allclose(np.asarray(t1.steer), np.asarray(t3.steer), atol=2e-5)
    assert int(s3["n_done"]) == int(s1["n_done"])
    assert int(s3["n_unsolved_ticks"]) == int(s1["n_unsolved_ticks"])


def test_sharded_fleet_matches_one_device_f64():
    """Sampled junctions through the default engine in float64: the run
    sharded over four devices ends in the same per-scenario states as the
    one-device run (1e-4, the on-card four-card criterion), with equal
    summaries. The batch is split 4 ways, so a per-device batch of 4
    differs from the one-device batch of 16 in shape only."""
    from mpc_for_av_at_intersection_tpu import api
    from mpc_for_av_at_intersection_tpu.engine import EngineConfig
    from mpc_for_av_at_intersection_tpu.parallel import run_batch_episodes

    cfg = EngineConfig()
    steps = 24
    geom, wb, sb, _ = api.sample_intersection_fleet_batched(
        16, np.random.default_rng(3), n_steps=steps)
    wb, sb = jax.tree.map(
        lambda a: jax.numpy.asarray(a, jax.numpy.float64)
        if jax.numpy.issubdtype(a.dtype, jax.numpy.floating) else a, (wb, sb))
    assert sb.ego.dtype == jax.numpy.float64
    f1, t1, s1 = run_batch_episodes(wb, sb, cfg, geom, steps)
    f4, t4, s4 = run_batch_episodes(wb, sb, cfg, geom, steps,
                                    mesh=batch_mesh(jax.devices()[:4]))
    np.testing.assert_allclose(np.asarray(f4.ego), np.asarray(f1.ego),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(np.asarray(t4.x), np.asarray(t1.x),
                               atol=1e-4, rtol=0)
    assert {k: int(v) for k, v in s1.items()} == {
        k: int(v) for k, v in s4.items()}


def test_two_process_distributed_smoke():
    """Real multi-process run: 2 CPU processes x 4 virtual devices each,
    joined via jax.distributed (Gloo transport standing in for DCN), fleet
    sharded over the global (hosts, chips) mesh. Both processes must report
    the same psum'd summary, and it must match the single-process oracle."""
    import json
    import os
    import socket
    import subprocess
    import sys

    from mpc_for_av_at_intersection_tpu.parallel import run_batch_episodes
    from mpc_for_av_at_intersection_tpu.parallel.fleet_worker import (
        build_demo_fleet,
    )

    # single-process oracle on the same deterministic demo fleet
    cfg, geom, wb, sb = build_demo_fleet(8, 3)
    _, _, s_ref = run_batch_episodes(wb, sb, cfg, geom, 3, mesh=None)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = []
    for pid in (0, 1):
        procs.append(subprocess.Popen(
            [sys.executable, "-m",
             "mpc_for_av_at_intersection_tpu.parallel.fleet_worker",
             "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", "2", "--process-id", str(pid),
             "--emulate-local-devices", "4", "--batch", "8", "--steps", "3"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ))
    reports = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
        reports.append(json.loads(out.strip().splitlines()[-1]))

    assert all(r["process_count"] == 2 for r in reports)
    assert all(r["global_devices"] == 8 for r in reports)
    assert all(r["mesh"] == {"hosts": 2, "chips": 4} for r in reports)
    for key, ref in (("n_done", int(s_ref["n_done"])),
                     ("ticks_to_goal_sum", int(s_ref["ticks_to_goal_sum"])),
                     ("n_unsolved_ticks", int(s_ref["n_unsolved_ticks"]))):
        assert reports[0][key] == reports[1][key] == ref, (key, reports, ref)
