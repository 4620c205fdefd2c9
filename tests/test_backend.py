"""Platform dispatch, compile cache, matmul precision and the GPU smoke
script's refusal to run without a GPU."""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mpc_for_av_at_intersection_tpu import backend

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_dispatch_cpu_picks_xla():
    assert backend.platform() == "cpu"
    assert backend.stages() == backend.Stages(admm="xla")


def test_dispatch_unknown_platform_raises(monkeypatch):
    monkeypatch.setattr(backend.jax, "default_backend", lambda: "metal")
    with pytest.raises(RuntimeError, match="unsupported JAX platform 'metal'"):
        backend.stages()


def test_dispatch_follows_default_device():
    """A default-device scope picks that device's platform (how an on-card
    check runs its CPU comparison in the same process)."""
    with jax.default_device(jax.devices("cpu")[0]):
        assert jax.config.jax_default_device is not None
        assert backend.platform() == "cpu"


def test_use_stages_overrides_then_restores():
    """An A/B override holds inside its block only."""
    with backend.use_stages(admm="triton") as st:
        assert st == backend.Stages(admm="triton")
        assert backend.stages().admm == "triton"
    assert backend.stages() == backend.Stages(admm="xla")


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    backend.enable_compile_cache()
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_fixed_path(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        backend.enable_compile_cache()
        assert jax.config.jax_compilation_cache_dir == str(REPO / ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def _dot_precisions(lowered):
    text = lowered.as_text()
    dots = [ln for ln in text.splitlines() if "dot_general" in ln]
    return dots, [re.search(r"precision = \[(\w+), (\w+)\]", ln) for ln in dots]


@pytest.mark.parametrize("tick", ["single", "fleet"])
def test_every_matmul_in_a_tick_is_highest(tick):
    """Lower the jitted engine tick (single scenario) and fleet tick (the
    batched path) and require HIGHEST on every dot_general: on the GPU a
    default-precision fp32 matmul may run in TF32."""
    from mpc_for_av_at_intersection_tpu import api
    from mpc_for_av_at_intersection_tpu.engine import EngineConfig, engine_tick
    from mpc_for_av_at_intersection_tpu.engine.fleet import engine_tick_fleet
    from mpc_for_av_at_intersection_tpu.parallel import stack_states, stack_worlds

    cfg = EngineConfig()
    geom, worlds, states, _ = api.sample_intersection_fleet(
        2, np.random.default_rng(0), n_steps=4)
    if tick == "single":
        lowered = jax.jit(lambda w, s: engine_tick(w, s, cfg, geom)).lower(
            worlds[0], states[0])
    else:
        lowered = jax.jit(lambda w, s: engine_tick_fleet(w, s, cfg, geom)).lower(
            stack_worlds(worlds), stack_states(states))
    dots, precs = _dot_precisions(lowered)
    assert len(dots) > 10
    bad = [d for d, p in zip(dots, precs)
           if p is None or p.groups() != ("HIGHEST", "HIGHEST")]
    assert not bad, bad[:3]


def test_chip_smoke_refuses_cpu(tmp_path):
    """With no GPU the smoke script exits non-zero and prints no result."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "GPU" in proc.stderr
