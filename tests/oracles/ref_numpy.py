"""Float64 NumPy oracle implementations of the reference semantics.

These are *fresh* implementations of the behaviors documented in SURVEY.md
(with reference file:line cites), written sequentially/scalar the way the
original research code behaves, used as golden oracles for the vectorized
JAX implementations. They intentionally keep the reference's quirks
(velocity-then-accel plant splitting, two-phase yaw unwrap, floor-mask
resampling, 3-point directional nearest index).
"""

from __future__ import annotations

import math

import numpy as np


def normalize_angle(theta: float) -> float:
    # main/lib/maths.py:4
    theta = theta % math.tau
    if theta >= math.pi:
        theta -= math.tau
    return theta


def smooth_yaw(yaw: np.ndarray) -> np.ndarray:
    # main/lib/mpc.py:43-55 — two sequential (non-alternating) while phases
    yaw = yaw.astype(np.float64).copy()
    for i in range(len(yaw) - 1):
        d = yaw[i + 1] - yaw[i]
        while d >= math.pi / 2.0:
            yaw[i + 1] -= math.tau
            d = yaw[i + 1] - yaw[i]
        while d <= -math.pi / 2.0:
            yaw[i + 1] += math.tau
            d = yaw[i + 1] - yaw[i]
    return yaw


def bicycle_step(pose, v, delta, dt, wheelbase):
    # main/bicycle/main.py:28-41
    x, y, th = pose
    return np.array(
        [
            x + v * math.cos(th) * dt,
            y + v * math.sin(th) * dt,
            th + (v / wheelbase) * math.tan(delta) * dt,
        ]
    )


def plant_step(state, a, delta, dt, wheelbase, max_steer, max_speed, min_speed):
    # main/lib/simulation.py:35-47 — position uses pre-update v
    x, y, v, yaw = state
    delta = max(min(delta, max_steer), -max_steer)
    x += v * math.cos(yaw) * dt
    y += v * math.sin(yaw) * dt
    yaw += (v / wheelbase) * math.tan(delta) * dt
    v = max(min(v + a * dt, max_speed), min_speed)
    return np.array([x, y, v, yaw])


def resample_curve(points: np.ndarray, dl, keep_last: bool = True) -> np.ndarray:
    # main/lib/trajectories.py:58-86 — floor-mask arc-length decimation
    seg = np.linalg.norm(points[1:, :2] - points[:-1, :2], axis=1)
    seg = np.append(0.0, seg)
    q = np.floor(seg.cumsum() / dl).astype(int)
    mask = (q[1:] - q[:-1]) >= 1
    mask = np.append(True, mask)
    if keep_last:
        mask[-1] = True
    return points[mask].copy()


def nearest_index_in_direction(
    xy, cx, cy, start_index: int = 0, forward: bool = True
) -> int:
    # main/lib/trajectories.py:100-126 — 3-nearest-point directional logic
    dist = np.linalg.norm([cx[start_index:] - xy[0], cy[start_index:] - xy[1]], axis=0)

    if len(dist) >= 3:
        if len(dist) > 3:
            ind = np.argpartition(dist, 3)[:3]
            ind = ind[np.argsort(dist[ind])]
        else:
            ind = np.argsort(dist)

        if abs(ind[1] - ind[2]) == 2:
            return int(ind[0]) + start_index
        if abs(ind[0] - ind[1]) == 1:
            pick = max(ind[0], ind[1]) if forward else min(ind[0], ind[1])
            return int(pick) + start_index
        raise ValueError("ambiguous directional nearest index")

    if len(dist) == 2:
        return start_index + 1 if forward else start_index
    return start_index


def transform_poses(frame_pose, local_poses):
    # main/lib/linalg.py — rotate+translate xy, add theta
    x, y, th = frame_pose
    c, s = math.cos(th), math.sin(th)
    out = np.empty_like(local_poses, dtype=np.float64)
    out[:, 0] = c * local_poses[:, 0] - s * local_poses[:, 1] + x
    out[:, 1] = s * local_poses[:, 0] + c * local_poses[:, 1] + y
    if local_poses.shape[1] == 3:
        out[:, 2] = local_poses[:, 2] + th
    return out
