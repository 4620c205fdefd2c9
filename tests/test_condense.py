"""The XLA QP build (rollout + linearize + condense) in fp32 vs float64.

``mpc_step_batched`` builds every scenario's condensed QP with vmapped XLA
code at full fp32 matmul precision. The same build in float64 is the
oracle: every QP field must agree to fp32 rounding of its scale.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mpc_for_av_at_intersection_tpu.core.dynamics import SimLimits, plant_rollout
from mpc_for_av_at_intersection_tpu.models import bicycle_geometry
from mpc_for_av_at_intersection_tpu.mpc import MPCConfig
from mpc_for_av_at_intersection_tpu.mpc.condense import condense
from mpc_for_av_at_intersection_tpu.mpc.linearize import linearize_bicycle


def _build(states, oa, od, xref, re, cfg, wheelbase):
    limits = SimLimits(max_steer=cfg.max_steer, max_speed=cfg.max_speed,
                       min_speed=cfg.min_speed)
    controls = jnp.stack([oa, od], axis=-1)
    xbar = jax.vmap(
        lambda s, u: plant_rollout(s, u, cfg.dt, wheelbase, limits)
    )(states, controls)
    A, B_, C = jax.vmap(
        lambda v, p: linearize_bicycle(v, p, jnp.zeros_like(v), cfg.dt,
                                       wheelbase)
    )(xbar[:, :-1, 2], xbar[:, :-1, 3])
    return jax.vmap(
        lambda a, b, c, s, r, e: condense(a, b, c, s, r, e, cfg)
    )(A, B_, C, states, xref, re)


@pytest.mark.parametrize("T", [13, 20])
def test_condense_f32_matches_f64(T):
    geom = bicycle_geometry()
    cfg = MPCConfig(T=T)
    rng = np.random.default_rng(0)
    B = 130
    states = rng.normal(0, 3, (B, 4))
    states[:, 2] = rng.uniform(0, 8, B)
    inputs = (states, rng.normal(0, 1, (B, T)), rng.normal(0, 0.2, (B, T)),
              rng.normal(0, 3, (B, 4, T + 1)))
    re = jnp.asarray(rng.random((B, T + 1)) < 0.3)

    build = jax.jit(lambda *a: _build(*a, re, cfg, geom.wheelbase))
    got = build(*(jnp.asarray(a, jnp.float32) for a in inputs))
    ref = build(*(jnp.asarray(a, jnp.float64) for a in inputs))
    for name in ("P", "q", "G", "lo", "hi", "F", "g"):
        a = np.asarray(getattr(ref, name))
        b = np.asarray(getattr(got, name), np.float64)
        scale = max(1.0, float(np.abs(a).max()))
        np.testing.assert_allclose(b, a, atol=2e-6 * scale,
                                   err_msg=f"field {name}")
