"""Scale-out over the scenario batch axis: mesh + shard_map.

The reference is strictly sequential single-process (SURVEY section 2.a);
parallelism here is first-class new design. Within one scenario all coupling
(vehicle pairs, the condensed QP) fits on one device, so the only
distributed axis is the *scenario batch*: episodes are sharded across
devices with ``shard_map`` and cross-device communication is limited to
``psum`` metric aggregation — the collectives-for-scale-out-only design of
SURVEY section 5.8.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..backend import platform, stages
from ..engine.closed_loop import EngineConfig, EngineState, WorldArrays
from ..engine.fleet import run_fleet_episodes
from ..models import VehicleGeometry


def batch_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or given) devices with a 'batch' axis."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices.reshape(-1), axis_names=("batch",))


def host_chip_mesh(n_hosts: int, devices=None) -> Mesh:
    """2-axis ``(hosts, chips)`` mesh for a multi-host cluster — the SURVEY
    §5.8 topology, whose outer axis crosses hosts. The scenario batch
    shards over both axes flattened, so it runs the same program as the
    flat ``batch`` mesh. Within one host, where every device reaches every
    other at the same rate, use ``batch_mesh``.
    """
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = devices.size
    if n % n_hosts:
        raise ValueError(f"{n} devices not divisible into {n_hosts} hosts")
    return Mesh(devices.reshape(n_hosts, n // n_hosts),
                axis_names=("hosts", "chips"))


def stack_worlds(worlds) -> WorldArrays:
    return jax.tree.map(lambda *xs: jnp.stack(xs), *worlds)


def stack_states(states) -> EngineState:
    return jax.tree.map(lambda *xs: jnp.stack(xs), *states)


def _summarize(final, tel):
    return {
        "n_done": jnp.sum(final.done.astype(jnp.int32)),
        "ticks_to_goal_sum": jnp.sum(final.ticks_to_goal),
        "n_unsolved_ticks": jnp.sum((~tel.solved).astype(jnp.int32)),
    }


@lru_cache(maxsize=16)
def _cached_batch_runner(cfg: EngineConfig, geom: VehicleGeometry,
                         n_steps: int, platform_name: str, stage_set,
                         mesh: Optional[Mesh]):
    """Memoized jitted batch-episode program (episodes + telemetry
    transpose + summary as ONE executable): without it every call
    re-traced the n_steps scan and dispatched the epilogue op by op. All
    key parts are hashable (frozen dataclasses, the mesh); the platform and
    its stages are part of the key because they pick what is traced into
    the program."""

    def vrun(w, s):
        # the fleet engine's (T, B, ...) telemetry, as (B, T, ...)
        final, tel = run_fleet_episodes(w, s, cfg, geom, n_steps)
        return final, jax.tree.map(lambda a: jnp.moveaxis(a, 0, 1), tel)

    if mesh is None:
        def run(w, s):
            final, tel = vrun(w, s)
            return final, tel, _summarize(final, tel)

        return jax.jit(run)

    # the scenario batch axis shards over EVERY mesh axis flattened — a 1-D
    # ('batch',) mesh and the 2-axis ('hosts', 'chips') topology run the
    # same program; the psum reduces over the combined axes
    axes = tuple(mesh.axis_names)
    spec = P(axes if len(axes) > 1 else axes[0])

    def shard_fn(w, s):
        final, tel = vrun(w, s)
        summary = jax.tree.map(lambda x: jax.lax.psum(x, axes),
                               _summarize(final, tel))
        return final, tel, summary

    return jax.jit(jax.shard_map(shard_fn, mesh=mesh, in_specs=(spec, spec),
                                 out_specs=(spec, spec, P())))


def run_batch_episodes(
    world_batch: WorldArrays,
    state_batch: EngineState,
    cfg: EngineConfig,
    geom: VehicleGeometry,
    n_steps: int,
    mesh: Optional[Mesh] = None,
):
    """Run a batch of scenarios in lockstep through the fleet engine
    (batched tick around one batched solve; semantically ``vmap`` of
    ``run_episode``, telemetry as (B, T, ...)). Without a mesh the batch
    runs on one device. With a mesh: shard_map over the mesh axes — the
    per-device fleet engine plus a psum'd fleet summary.

    Returns (final_states, telemetry, summary) where summary is a small
    replicated dict: scenarios finished, ticks-to-goal sum, solve failures.
    """
    run = _cached_batch_runner(cfg, geom, n_steps, platform(), stages(),
                               mesh)
    return run(world_batch, state_batch)
