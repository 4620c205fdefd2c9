"""The one place that decides each stage's implementation per platform.

One stage has a platform-specific choice, ``admm`` — the QP's inner ADMM
iterations: ``"xla"`` (a ``lax.scan`` of batched matvecs, ``mpc/qp.py``)
or ``"triton"`` (one Pallas program per scenario that keeps its matrices
on chip for a whole check block, ``ops/admm_triton.py``). ``"cpu"`` gets
plain XLA: it is the test path. ``"gpu"`` gets the Triton kernel, measured
on an H100 to halve the controller tick (PERF.md). Any other platform
raises.

The other stages have one implementation on every platform: the QP build
(XLA rollout + linearize + condense), the device planner (XLA beam
wavefront) and the batch-episode runner behind
``parallel.run_batch_episodes`` (the fleet engine, ``engine/fleet.py``,
measured faster than ``vmap(run_episode)`` on the H100).
The platform is that of the default device, so a ``with
jax.default_device(jax.devices("cpu")[0])`` block in a GPU process takes
the CPU path (used by on-card checks that compare with a CPU run).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import pathlib

import jax


@dataclasses.dataclass(frozen=True)
class Stages:
    admm: str      # "xla" | "triton"


_STAGES = {
    "cpu": Stages(admm="xla"),
    "gpu": Stages(admm="triton"),
}


def platform() -> str:
    """Platform of the default device: ``"gpu"`` or ``"cpu"``."""
    dev = jax.config.jax_default_device
    if dev is None:
        name = jax.default_backend()
    elif isinstance(dev, str):
        name = dev
    else:
        name = dev.platform
    name = {"cuda": "gpu"}.get(name, name)
    if name not in _STAGES:
        raise RuntimeError(
            f"unsupported JAX platform {name!r}: this program runs on an "
            "NVIDIA GPU, or on the CPU for tests")
    return name


def stages() -> Stages:
    """Implementation of each stage on the current platform."""
    return _OVERRIDE or _STAGES[platform()]


_OVERRIDE = None


@contextlib.contextmanager
def use_stages(**changes):
    """Trace with some stages replaced, e.g. ``use_stages(admm="xla")`` on
    the GPU (A/B timings in ``bench_choices.py``). Only code traced inside
    the block sees the change; an already compiled program keeps its
    stages."""
    global _OVERRIDE
    prev = _OVERRIDE
    _OVERRIDE = dataclasses.replace(stages(), **changes)
    try:
        yield _OVERRIDE
    finally:
        _OVERRIDE = prev


def fp32_matmuls(fn):
    """Run ``fn`` (traced under jit) with every matmul at full fp32.

    On the GPU an fp32 matmul at default precision may run in TF32 (about
    three decimal digits), which moves controls by more than the 1e-3
    parity budget and breaks the exactness of one-hot contractions. The
    precision is pinned where each jitted stage is traced, so every
    ``dot_general`` in it carries ``HIGHEST``."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("float32"):
            return fn(*args, **kwargs)

    return wrapped


def enable_compile_cache() -> None:
    """Keep JAX's persistent compile cache across processes.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and no
    other directory is set here. Otherwise the cache lives at the fixed
    ``<repo>/.jax_cache``: the path is part of the cache key, so it never
    derives from a temporary name, a process id or the time."""
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        cache = pathlib.Path(__file__).resolve().parent.parent / ".jax_cache"
        cache.mkdir(exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", str(cache))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
