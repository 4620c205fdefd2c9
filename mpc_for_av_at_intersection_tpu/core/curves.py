"""Curve/trajectory operations on fixed-size padded arrays.

Behavioral parity targets in reference ``main/lib/trajectories.py``:
- ``resample_mask``              ~ ``resample_curve`` (:58) — but mask-based:
  instead of returning a shorter array (dynamic shape), we return the boolean
  keep-mask; ``compact_by_mask`` then gathers into a fixed-size buffer.
- ``nearest_index``              ~ ``calc_nearest_index`` (:89)
- ``nearest_index_in_direction`` ~ ``calc_nearest_index_in_direction`` (:100)
  including its quirky 3-nearest-point forward logic. Where the reference
  raises ("something wrong", :120) we fall back to the plain nearest index —
  a documented, graceful divergence (branchless code cannot raise).

All functions are single-scenario; batch with ``jax.vmap``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# Host-side scalar on purpose: a module-level jnp scalar would live on the
# default accelerator and force a device->host fetch during every jit
# lowering that closes over it. np scalars embed as MLIR constants for free.
_BIG = np.float32(1e30)


def arc_positions(points_xy, valid_mask=None):
    """Cumulative arc length per point. points_xy (N, 2) -> (N,)."""
    seg = jnp.linalg.norm(points_xy[1:] - points_xy[:-1], axis=-1)
    seg = jnp.concatenate([jnp.zeros((1,), seg.dtype), seg])
    if valid_mask is not None:
        seg = jnp.where(valid_mask, seg, 0.0)
    return jnp.cumsum(seg)


def resample_mask(points, dl, valid_mask=None, keep_last: bool = True):
    """Keep-mask for arc-length decimation of a padded curve.

    Mirrors reference ``resample_curve``: a point is kept when the integer
    part of (cumulative arc length / dl) steps up relative to the previous
    point; the first point is always kept; optionally the last (valid) point
    is forced kept. ``dl`` may be a scalar or a per-point (N,) array (the
    reference's ego-reachability resampling passes a per-point array,
    ``scenarios/mpc_intersection.py:110-116``).
    """
    n = points.shape[0]
    if valid_mask is None:
        valid_mask = jnp.ones((n,), dtype=bool)

    xy = points[..., :2]
    seg = jnp.linalg.norm(xy[1:] - xy[:-1], axis=-1)
    seg = jnp.concatenate([jnp.zeros((1,), seg.dtype), seg])
    seg = jnp.where(valid_mask, seg, 0.0)
    cum = jnp.cumsum(seg)

    q = jnp.floor(cum / dl)
    step_up = (q[1:] - q[:-1]) >= 1.0
    mask = jnp.concatenate([jnp.ones((1,), dtype=bool), step_up])

    if keep_last:
        n_valid = jnp.sum(valid_mask.astype(jnp.int32))
        last_valid = jnp.maximum(n_valid - 1, 0)
        mask = mask.at[last_valid].set(True)

    return mask & valid_mask


def compact_by_mask(points, mask, out_len: int):
    """Gather masked rows to the front of a fixed-size buffer.

    Tail entries are filled with the last kept row (the padding semantics of
    reference ``collision_avoidance.py:18-22`` `_pad_trajectory`, which
    repeats the final row). Returns (out (out_len, D), n_kept).
    """
    n = points.shape[0]
    mask_i = mask.astype(jnp.int32)
    n_kept = jnp.sum(mask_i)
    cum = jnp.cumsum(mask_i)

    # output row j is the (j+1)-th kept point: the first index whose
    # running kept-count reaches j+1 (a gather, exact; rows past n_kept
    # are overwritten by the fill below)
    src = jnp.searchsorted(cum, jnp.arange(1, out_len + 1, dtype=cum.dtype),
                           side="left")
    out = jnp.take(points, jnp.minimum(src, n - 1), axis=0)

    # forward-fill the tail with the last kept row
    last_idx = (n - 1) - jnp.argmax(mask[::-1])
    last_row = points[jnp.where(n_kept > 0, last_idx, 0)]
    fill = jnp.arange(out_len) >= n_kept
    out = jnp.where(fill[:, None] if points.ndim > 1 else fill, last_row, out)
    return out, n_kept


def _masked_sq_dist(xy, traj_xy, start_idx, valid_len):
    n = traj_xy.shape[0]
    idx = jnp.arange(n)
    d2 = jnp.sum((traj_xy - xy) ** 2, axis=-1)
    in_range = (idx >= start_idx) & (idx < valid_len)
    return jnp.where(in_range, d2, _BIG.astype(d2.dtype))


def nearest_index(xy, traj_xy, start_idx=0, valid_len=None):
    """Index of the nearest trajectory point at or after ``start_idx``."""
    if valid_len is None:
        valid_len = traj_xy.shape[0]
    d2 = _masked_sq_dist(xy, traj_xy, start_idx, valid_len)
    return jnp.argmin(d2).astype(jnp.int32)


def nearest_index_in_direction(xy, traj_xy, start_idx, valid_len, forward: bool = True):
    """Directional nearest-index (reference ``trajectories.py:100-126``).

    Finds the 3 nearest points after ``start_idx`` ordered by distance
    (i0, i1, i2). If i1 and i2 straddle i0 (|i1-i2| == 2) the answer is i0;
    else if i1 is adjacent to i0, the answer is max(i0, i1) when moving
    forward (min when backward). Degenerate windows (n <= 2) reduce to the
    reference's special cases.
    """
    d2 = _masked_sq_dist(xy, traj_xy, start_idx, valid_len)
    n_avail = jnp.maximum(valid_len - start_idx, 0)

    i0 = jnp.argmin(d2)
    d2_1 = d2.at[i0].set(_BIG.astype(d2.dtype))
    i1 = jnp.argmin(d2_1)
    d2_2 = d2_1.at[i1].set(_BIG.astype(d2.dtype))
    i2 = jnp.argmin(d2_2)

    straddle = jnp.abs(i1 - i2) == 2
    adjacent = jnp.abs(i0 - i1) == 1
    pick_adj = jnp.where(forward, jnp.maximum(i0, i1), jnp.minimum(i0, i1))

    res3 = jnp.where(straddle, i0, jnp.where(adjacent, pick_adj, i0))
    res2 = jnp.where(forward, start_idx + 1, start_idx)

    return jnp.where(
        n_avail >= 3, res3, jnp.where(n_avail == 2, res2, start_idx)
    ).astype(jnp.int32)
