"""Frame-windowed conflict detection + reference-trajectory cutoff.

Masked, fixed-shape twin of reference ``main/lib/collision_avoidance.py``:

1. every obstacle prediction is time-shifted by every offset in
   [-frame_window, +frame_window] (robustness to timing misalignment);
2. ego and obstacle collision-circle centers are compared frame-aligned
   (ego frame k vs shifted obstacle frame k) over
   n_iter = max(len(ego), len(pred)) frames, trajectories padded by
   repeating their last pose (phantom tail frames DO count, as in the
   reference's `_pad_trajectory`, :18-29);
3. the FIRST hit in (frame, ego-circle, obstacle, shift, obstacle-circle)
   lexicographic order picks the colliding obstacle-circle position —
   replicating the row ordering produced by `_combine_rowwise_repeat`
   (:10-15) + `np.argmax` (:81);
4. that position is re-localized on the detailed path by scanning circle
   trajectories circle-major and taking argmax % path_len (:92-98).

Instead of returning a truncated array (dynamic shape), the cutoff helper
returns an index; the engine masks the course length.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class CollisionScan(NamedTuple):
    found: jnp.ndarray       # () bool
    xy: jnp.ndarray          # (2,) collision point on the detailed path
    frame_idx: jnp.ndarray   # () int32 index into the detailed path


def _circle_points_soa(x, y, th, circle_centers):
    """Structure-of-arrays circle centers: (F,) pose components x (n_c, 2)
    offsets -> px, py each (n_c, F).

    SoA with the frame axis LAST on purpose: the long frame axis is the
    minor (contiguous) one, and no (..., 2, 2)-shaped minor tile is ever
    materialized when batched."""
    c, s = jnp.cos(th), jnp.sin(th)
    ox, oy = circle_centers[:, 0:1], circle_centers[:, 1:2]   # (n_c, 1)
    px = x[..., None, :] + c[..., None, :] * ox - s[..., None, :] * oy
    py = y[..., None, :] + s[..., None, :] * ox + c[..., None, :] * oy
    return px, py


def check_collision_moving_cars(
    ego_traj,          # (N_F, 3) padded resampled ego future trajectory
    n_ego,             # () int32
    detail_traj,       # (N_T, 3) padded detailed path
    n_detail,          # () int32
    obs_trajs,         # (n_obs, n_pred, 3) predicted obstacle trajectories
    obs_active,        # (n_obs,) bool
    circle_centers,    # (n_c, 2)
    radius: float,
    frame_window: int,
    n_frames: int,     # static frame buffer (>= any max(n_ego, n_pred))
) -> CollisionScan:
    n_obs, n_pred, _ = obs_trajs.shape
    min_d2 = (2.0 * radius) ** 2
    n_c = circle_centers.shape[0]

    # the lexicographic first-hit key below is encoded in int32; all factors
    # are static Python ints, so guard the encoding range host-side (safe at
    # the reference config n_frames=128, n_c=2, S=41, small n_obs; silently
    # wrong ordering if it ever overflowed)
    n_shifts = 2 * frame_window + 1
    max_key = n_frames * n_c * n_obs * n_shifts * n_c
    if max_key >= jnp.iinfo(jnp.int32).max:
        raise ValueError(
            "collision first-hit key would overflow int32: "
            f"n_frames*n_c^2*n_obs*(2*frame_window+1) = {max_key} >= 2^31-1"
        )

    frames = jnp.arange(n_frames)
    n_iter = jnp.maximum(n_ego, n_pred)
    frame_valid = frames < n_iter

    # ego circle points per frame (padded by repeating the last valid pose)
    ego_idx = jnp.minimum(frames, jnp.maximum(n_ego - 1, 0))
    ego_pose = ego_traj[ego_idx]                                   # (N_F, 3)
    ego_px, ego_py = _circle_points_soa(
        ego_pose[:, 0], ego_pose[:, 1], ego_pose[:, 2], circle_centers
    )                                                              # (n_c, N_F)

    # shifted obstacle poses: shift s delays by s frames (s<0 advances).
    # Circle points are computed once per PREDICTION frame (n_pred) and
    # expanded to the (S, N_F) shift table by a gather whose indices `src`
    # depend only on compile-time constants (no per-shift trig).
    shifts = jnp.arange(-frame_window, frame_window + 1)           # (S,)
    S = shifts.shape[0]
    src = jnp.clip(frames[None, :] - shifts[:, None], 0, n_pred - 1)  # (S, N_F)
    opx, opy = _circle_points_soa(
        obs_trajs[:, :, 0], obs_trajs[:, :, 1], obs_trajs[:, :, 2],
        circle_centers,
    )                                                              # (n_obs, n_c, n_pred)

    def expand(a):
        return jnp.take(a, src, axis=2).transpose(0, 2, 1, 3)

    obs_px = expand(opx)
    obs_py = expand(opy)
    # (n_obs, S, n_c, N_F)

    # frame-aligned pairwise hit test, laid out (n_obs, S, n_c_e, n_c_o, N_F)
    dx = ego_px[None, None, :, None, :] - obs_px[:, :, None, :, :]
    dy = ego_py[None, None, :, None, :] - obs_py[:, :, None, :, :]
    hit = dx * dx + dy * dy <= min_d2
    hit = hit & frame_valid[None, None, None, None, :]
    hit = hit & obs_active[:, None, None, None, None]

    # FIRST hit in (frame, ego-circle, obstacle, shift, obstacle-circle)
    # lexicographic order — reference row order, see module docstring. The
    # compute layout above keeps frames in the minor dimension, so the
    # ordering is recovered by min-reducing an encoded index key instead of
    # transposing/materializing the (frame-major) boolean tensor.
    f_ix = frames[None, None, None, None, :]
    ce_ix = jnp.arange(n_c)[None, None, :, None, None]
    o_ix = jnp.arange(n_obs)[:, None, None, None, None]
    s_ix = jnp.arange(S)[None, :, None, None, None]
    co_ix = jnp.arange(n_c)[None, None, None, :, None]
    key = (((f_ix * n_c + ce_ix) * n_obs + o_ix) * S + s_ix) * n_c + co_ix
    big = jnp.iinfo(jnp.int32).max
    first = jnp.min(jnp.where(hit, key.astype(jnp.int32), big))
    found = first < big
    first = jnp.where(found, first, 0)

    # decode the colliding (obstacle, shift, frame, obstacle-circle) and
    # recompute that single circle point (nothing big is kept alive)
    co = first % n_c
    s_i = (first // n_c) % S
    o_i = (first // (n_c * S)) % n_obs
    f_i = first // (n_c * S * n_obs * n_c)
    src_f = jnp.clip(f_i - shifts[s_i], 0, n_pred - 1)
    pose = obs_trajs[o_i, src_f]                                   # (3,)
    ox = circle_centers[co, 0]
    oy = circle_centers[co, 1]
    c2, s2 = jnp.cos(pose[2]), jnp.sin(pose[2])
    obs_pos = jnp.stack(
        [pose[0] + c2 * ox - s2 * oy, pose[1] + s2 * ox + c2 * oy]
    )

    # re-localize on the detailed path: circle-major scan, argmax % N_T
    N_T = detail_traj.shape[0]
    det_px, det_py = _circle_points_soa(
        detail_traj[:, 0], detail_traj[:, 1], detail_traj[:, 2], circle_centers
    )                                                              # (n_c, N_T)
    ddx = det_px - obs_pos[0]
    ddy = det_py - obs_pos[1]
    hit2 = ddx * ddx + ddy * ddy <= min_d2
    hit2 = hit2 & (jnp.arange(N_T) < n_detail)[None, :]
    first2 = jnp.argmax(hit2.reshape(-1))
    frame_idx = (first2 % N_T).astype(jnp.int32)

    xy = detail_traj[frame_idx, :2]
    return CollisionScan(found=found, xy=xy, frame_idx=frame_idx)


def cutoff_index_by_position(points, n_valid, xy, radius: float = 0.001):
    """First index of `points` within `radius` of `xy`
    (reference ``collision_avoidance.py:107-119``). Returns (found, idx)."""
    N = points.shape[0]
    d = jnp.linalg.norm(points[:, :2] - xy, axis=-1)
    near = (d <= radius) & (jnp.arange(N) < n_valid)
    idx = jnp.argmax(near)
    return near[idx], idx.astype(jnp.int32)
