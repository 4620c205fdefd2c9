"""Multi-process (multi-host) entry path.

The reference has no distributed execution at all (SURVEY §2.a); this is
the scale-out design of SURVEY §5.8: each host process owns its local
devices, ``jax.distributed.initialize`` wires the processes into one
runtime, and the scenario batch shards over the global 2-axis
``(hosts, chips)`` mesh. Collectives over the combined axis cross hosts
(Gloo/TCP when emulating on CPU processes).

On a GPU cluster, run one process per host and give every process the
coordinator's address (``host:port`` of process 0), the number of
processes and its own id: nothing in the environment supplies them. On a
single host the same program is exercised end-to-end by launching N CPU
processes against a localhost coordinator — see
``python -m mpc_for_av_at_intersection_tpu.parallel.fleet_worker``.
"""

from __future__ import annotations

import os
from typing import Optional

__all__ = ["initialize_process", "global_host_chip_mesh"]


def initialize_process(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    emulate_local_devices: Optional[int] = None,
) -> None:
    """Join this process to the distributed runtime through the
    coordinator at ``coordinator_address``.

    With ``emulate_local_devices``: forces that many virtual CPU devices
    per process first, so a single host can execute the exact multi-host
    program (the only difference from a cluster run is the collective
    transport).

    Must be called before any JAX backend initialization.
    """
    if emulate_local_devices is not None:
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags
                + f" --xla_force_host_platform_device_count={emulate_local_devices}"
            ).strip()
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")

    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_host_chip_mesh():
    """The global ``(hosts, chips)`` mesh over every device in the job.

    Axis 0 groups devices by owning process (crossing hosts), axis 1 is
    the process-local devices. Valid only after
    ``initialize_process``.
    """
    import jax
    import numpy as np
    from jax.sharding import Mesh

    n_proc = jax.process_count()
    devices = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    per = len(devices) // n_proc
    grid = np.asarray(devices).reshape(n_proc, per)
    return Mesh(grid, axis_names=("hosts", "chips"))
