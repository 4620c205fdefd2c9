"""A/B timings behind the implementation choices the engine makes on a GPU.

    python bench_choices.py [tick] [fleet] [gather] [--out PATH]

Each mode times the variants of one choice in one process, in the order
A B C C B A (so drift shows), and prints one JSON object per mode:

- tick: the controller tick (``mpc_step_batched``, B=4096, T=20, warm
  started) with the ADMM inner loop as the XLA scan and as the Triton
  kernel at 4 and at 8 warps (``backend.stages().admm``,
  ``ops.admm_triton.NUM_WARPS``);
- fleet: 1024 sampled junctions x 32 ticks through the fleet engine with
  either inner loop, and as ``vmap(run_episode)`` (the runner behind
  ``parallel.run_batch_episodes``);
- gather: the two index contractions of the pre stage at the fleet's
  shapes (B=1024) as gathers (the library's) and as one-hot matmuls.

With no mode, runs them all. Times are host wall time of a blocked call,
median of the repetitions.
"""

import json
import statistics
import sys
import time

import numpy as np

REPS = 5


def _median_s(fn, *args, reps=REPS):
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def _abba(variants, reps=REPS):
    """{name: [t_first_pass, t_second_pass]} for variants run A B C C B A;
    each variant is a zero-argument callable returning (fn, args)."""
    built = {name: make() for name, make in variants.items()}
    out = {name: [] for name in variants}
    order = list(variants) + list(variants)[::-1]
    for name in order:
        fn, args = built[name]
        out[name].append(_median_s(fn, *args, reps=reps))
    return out


def mode_tick(B=4096, T=20, warm_ticks=20):
    import jax
    import jax.numpy as jnp

    from chip_smoke import _instances
    from mpc_for_av_at_intersection_tpu import backend
    from mpc_for_av_at_intersection_tpu.models import bicycle_geometry
    from mpc_for_av_at_intersection_tpu.mpc import MPCConfig
    from mpc_for_av_at_intersection_tpu.mpc.batch import mpc_step_batched
    from mpc_for_av_at_intersection_tpu.mpc.controller import (
        init_controller_state,
    )
    from mpc_for_av_at_intersection_tpu.ops import admm_triton

    cfg = MPCConfig(T=T)
    wb = bicycle_geometry().wheelbase
    state, course, dl = _instances(np.random.default_rng(0), B)
    f32 = jnp.float32
    N = course.shape[1]
    args = (jnp.asarray(state, f32), jnp.asarray(course, f32),
            jnp.zeros((B, N), f32), jnp.full((B,), N, jnp.int32),
            jnp.full((B,), dl, f32))
    cs0 = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape),
                       init_controller_state(cfg, f32))

    def variant(admm, warps=admm_triton.NUM_WARPS):
        def make():
            keep = admm_triton.NUM_WARPS
            admm_triton.NUM_WARPS = warps
            with backend.use_stages(admm=admm):
                step = jax.jit(lambda s, c, v, n, d, cs: mpc_step_batched(
                    s, c, v, n, d, cs, cfg, wb).state)
                cs = cs0
                for _ in range(warm_ticks):   # compile, then warm start
                    cs = step(*args, cs)
            admm_triton.NUM_WARPS = keep
            return step, (*args, cs)
        return make

    t = _abba({"xla": variant("xla"), "triton_4_warps": variant("triton", 4),
               "triton_8_warps": variant("triton", 8)})
    return {"mode": "tick", "B": B, "T": T,
            "tick_ms": {k: [v * 1e3 for v in vs] for k, vs in t.items()}}


def mode_fleet(n=1024, steps=32):
    import jax

    from mpc_for_av_at_intersection_tpu import api, backend
    from mpc_for_av_at_intersection_tpu.engine import EngineConfig, run_episode
    from mpc_for_av_at_intersection_tpu.engine.fleet import run_fleet_episodes
    from mpc_for_av_at_intersection_tpu.parallel import (
        stack_states,
        stack_worlds,
    )

    cfg = EngineConfig()
    geom, worlds, states, _ = api.sample_intersection_fleet(
        n, np.random.default_rng(1), n_steps=steps)
    wb, sb = stack_worlds(worlds), stack_states(states)

    def fleet(admm):
        def make():
            with backend.use_stages(admm=admm):
                fn = jax.jit(lambda w, s: run_fleet_episodes(
                    w, s, cfg, geom, steps))
                jax.block_until_ready(fn(wb, sb))
            return fn, (wb, sb)
        return make

    def vmapped():
        fn = jax.jit(jax.vmap(lambda w, s: run_episode(w, s, cfg, geom,
                                                       steps)))
        return fn, (wb, sb)

    t = _abba({"fleet_engine_triton": fleet("triton"),
               "fleet_engine_xla": fleet("xla"),
               "vmap_run_episode": vmapped}, reps=3)
    return {"mode": "fleet", "scenarios": n, "ticks": steps,
            "seconds": t}


def mode_gather(B=1024, K=8):
    import jax
    import jax.numpy as jnp

    from mpc_for_av_at_intersection_tpu.core.curves import compact_by_mask
    from mpc_for_av_at_intersection_tpu.engine import EngineConfig

    cfg = EngineConfig()
    N, F, W = cfg.n_traj, cfg.n_frames, cfg.frame_window
    n_pred = cfg.n_pred
    rng = np.random.default_rng(2)
    f32 = jnp.float32
    points = jnp.asarray(rng.normal(size=(B, N, 3)), f32)
    mask = jnp.asarray(rng.random((B, N)) < 0.4)
    frames = jnp.arange(F)
    shifts = jnp.arange(-W, W + 1)
    S = shifts.shape[0]
    src = jnp.clip(frames[None, :] - shifts[:, None], 0, n_pred - 1)
    n_rows = cfg.n_agents * 3                   # obstacles x circles
    circ = jnp.asarray(rng.normal(size=(B, n_rows, n_pred)), f32)

    def compact_onehot(p, m):
        pos = jnp.cumsum(m.astype(jnp.int32)) - 1
        cols = jnp.arange(F, dtype=pos.dtype)
        Wm = ((pos[None, :] == cols[:, None]) & m[None, :]).astype(p.dtype)
        return Wm @ p

    def expand_gather(a):
        return jnp.take(a, src, axis=1)

    def expand_onehot(a):
        Wm = (src.reshape(-1)[:, None]
              == jnp.arange(n_pred)[None, :]).astype(a.dtype)
        return (a @ Wm.T).reshape(a.shape[0], S, F)

    def chain(fn, x, *rest):
        # K dependent repetitions: the carry feeds the input (no hoisting)
        @jax.jit
        def run(x, *rest):
            def body(c, _):
                out = jax.vmap(lambda a, *r: fn(a + c, *r))(x, *rest)
                return c + 1e-30 * jnp.sum(out[..., 0, 0]), ()
            return jax.lax.scan(body, jnp.zeros((), f32), None, length=K)[0]
        return lambda: (run, (x, *rest))

    with jax.default_matmul_precision("float32"):
        t = _abba({
            "compact_gather": chain(
                lambda p, m: compact_by_mask(p, m, F)[0], points, mask),
            "compact_onehot": chain(compact_onehot, points, mask),
            "expand_gather": chain(expand_gather, circ),
            "expand_onehot": chain(expand_onehot, circ),
        })
    return {"mode": "gather", "B": B, "per_call_ms":
            {k: [v / K * 1e3 for v in vs] for k, vs in t.items()}}


MODES = {"tick": mode_tick, "fleet": mode_fleet, "gather": mode_gather}


def main(argv):
    import subprocess

    import jax

    from mpc_for_av_at_intersection_tpu.backend import enable_compile_cache

    enable_compile_cache()
    out_path = None
    if "--out" in argv:
        i = argv.index("--out")
        out_path = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    modes = argv or list(MODES)
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        card = "not read"
    dev = jax.devices()[0]
    results = []
    for m in modes:
        r = MODES[m]()
        r.update(device=dev.device_kind, card=card)
        print(json.dumps(r), flush=True)
        results.append(r)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main(sys.argv[1:])
