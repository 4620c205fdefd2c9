"""Batched lattice search on device: iteration-bounded wavefront expansion.

The host A* (``search.py`` / the C++ core) is inherently sequential and
heap-based; this is the data-parallel replacement (SURVEY section 7.2.3):
every iteration expands the top-F frontier cells x 9 primitives x all
half-planes as one fused batch of transforms + einsum collision masks, with
a quantized (x, y, theta) closed-set grid for deduplication. Thousands of
scenarios' searches run in lockstep under ``vmap``.

Design guarantees:
- **Geometric exactness.** Quantization only decides which continuous nodes
  may merge/prune; expansion always proceeds from the exact stored pose,
  and a cell's record is FROZEN once expanded (closed-set semantics), so a
  backtracked path is an exact, continuous primitive chain from the start —
  no drift, no cell-snapping.
- **Bounded suboptimality.** Unlike exact A*, the top-F beam and the grid
  merge can prune the optimal node; the returned cost is therefore >= the
  exact optimum and is validated against the host search within tolerance
  in tests. Expansion order is NOT the reference's (documented divergence;
  SURVEY 7.4).

Supported cost models: the full ``SearchWeights`` family (the unified form
of the reference's five search variants, motion_primitive_search_multi_lane
.py:21-25): point- or area-goal heuristics, plus optional steering /
obstacle-proximity / center-distance heuristic and edge-cost terms. Weight
values are compile-time constants, so zero-weight terms cost nothing (the
reference computes them lazily iff weight != 0, multi_lane.py:169-175).
"""

from __future__ import annotations

import dataclasses
import functools as _functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models import VehicleGeometry
from .primitives import PrimitiveTable
from .search import SearchWeights, _resample_host

# np, not jnp: a module-level jnp scalar lives on the default accelerator
# and is fetched device->host at every jit lowering that captures it.
_INF = np.float32(np.inf)


@dataclasses.dataclass(frozen=True)
class WavefrontConfig:
    x0: float = -48.0
    y0: float = -48.0
    nx: int = 96
    ny: int = 96
    ntheta: int = 32
    cell: float = 1.0
    frontier: int = 256      # beam width per iteration
    iters: int = 40
    max_edges: int = 32      # max primitives in a path
    h_theta: float = 2.7     # heuristic theta weight (modified preset)

    @property
    def n_cells(self) -> int:
        return self.nx * self.ny * self.ntheta

    @staticmethod
    def for_scenarios(
        scenarios,
        cell: float = 1.0,
        ntheta: int = 32,
        frontier: int = 256,
        pad: float = 8.0,
        prim_len: float = 4.98,
        iters: int | None = None,
        max_edges: int | None = None,
        **kw,
    ) -> "WavefrontConfig":
        """Size the grid from the scenario geometry instead of the
        intersection-shaped defaults (which cannot fit e.g. the 100 m
        arterial): the (x, y) extent is the union bounding box of all
        obstacles (boxes by corners, circles by center+-radius) plus every
        start/goal pose, padded by ``pad`` metres; the edge/iteration
        budgets scale with the box diameter in primitive lengths. Accepts
        one scenario or a batch (the grid must be shared under vmap)."""
        import math as _m

        if not isinstance(scenarios, (list, tuple)):
            scenarios = [scenarios]
        lo = np.array([np.inf, np.inf])
        hi = np.array([-np.inf, -np.inf])

        def take(x, y):
            lo[0] = min(lo[0], x); lo[1] = min(lo[1], y)
            hi[0] = max(hi[0], x); hi[1] = max(hi[1], y)

        for sc in scenarios:
            take(sc.start[0], sc.start[1])
            take(sc.goal_point[0], sc.goal_point[1])
            x1, y1, x2, y2 = sc.goal_area.corners
            take(x1, y1); take(x2, y2)
            for o in sc.obstacles:
                if hasattr(o, "corners"):
                    x1, y1, x2, y2 = o.corners
                    take(x1, y1); take(x2, y2)
                else:
                    (cx, cy), r = o.center, o.radius
                    take(cx - r, cy - r); take(cx + r, cy + r)

        x0, y0 = float(lo[0] - pad), float(lo[1] - pad)
        nx = int(_m.ceil((hi[0] + pad - x0) / cell))
        ny = int(_m.ceil((hi[1] + pad - y0) / cell))
        diam = _m.hypot(nx * cell, ny * cell)
        if max_edges is None:
            max_edges = max(24, int(_m.ceil(1.2 * diam / prim_len)) + 4)
        if iters is None:
            iters = max_edges + 12
        return WavefrontConfig(
            x0=x0, y0=y0, nx=nx, ny=ny, ntheta=ntheta, cell=cell,
            frontier=frontier, iters=iters, max_edges=max_edges, **kw,
        )


class PrimitiveDeviceData(NamedTuple):
    """Host (numpy) arrays on purpose: they are compile-time constants of a
    search (embedded as free MLIR constants under jit). Device-resident
    members would break tracing (TracerArrayConversionError) and force
    device->host fetches at lowering time."""

    ends: np.ndarray       # (P, 3) endpoint pose in the parent frame
    lengths: np.ndarray    # (P,)
    cc: np.ndarray         # (P, C, 2) collision-check points (padded)
    cc_mask: np.ndarray    # (P, C)
    points: np.ndarray     # (P, K, 3) full arcs for trajectory replay


def prepare_primitives(table: PrimitiveTable, geom: VehicleGeometry, dtype=jnp.float32):
    """Pad the per-primitive collision points to a fixed count."""
    blocks = []
    centers = geom.circle_centers
    for p in range(table.n_primitives):
        pts = _resample_host(table.points[p], geom.radius)
        th = pts[:, 2]
        c, s = np.cos(th), np.sin(th)
        b = [
            np.stack([pts[:, 0] + c * ox - s * oy, pts[:, 1] + s * ox + c * oy], axis=1)
            for ox, oy in centers
        ]
        blocks.append(np.concatenate(b))
    C = max(len(b) for b in blocks)
    cc = np.zeros((table.n_primitives, C, 2))
    mask = np.zeros((table.n_primitives, C), bool)
    for p, b in enumerate(blocks):
        cc[p, : len(b)] = b
        mask[p, : len(b)] = True
    np_dtype = np.dtype(dtype)
    return PrimitiveDeviceData(
        ends=np.asarray(table.points[:, -1, :], np_dtype),
        lengths=np.asarray(table.lengths, np_dtype),
        cc=np.asarray(cc, np_dtype),
        cc_mask=np.asarray(mask, bool),
        points=np.asarray(table.points, np_dtype),
    )


class WavefrontResult(NamedTuple):
    found: jnp.ndarray       # () bool
    cost: jnp.ndarray        # ()
    trajectory: jnp.ndarray  # (max_edges*(K-1)+1... padded, 3)
    n_points: jnp.ndarray    # () int32 valid length
    n_edges: jnp.ndarray     # () int32
    oob: jnp.ndarray         # () int32 — collision-free expansions pruned
    #                          for falling OUTSIDE the grid; a nonzero value
    #                          with found=False is the out-of-grid telltale
    #                          (enlarge WavefrontConfig / use for_scenarios)


def _cell_index(pose, cfg: WavefrontConfig):
    ix = jnp.clip(jnp.floor((pose[..., 0] - cfg.x0) / cfg.cell), 0, cfg.nx - 1)
    iy = jnp.clip(jnp.floor((pose[..., 1] - cfg.y0) / cfg.cell), 0, cfg.ny - 1)
    th = jnp.mod(pose[..., 2] + jnp.pi, 2 * jnp.pi)
    it = jnp.clip(jnp.floor(th / (2 * jnp.pi / cfg.ntheta)), 0, cfg.ntheta - 1)
    return (ix * cfg.ny * cfg.ntheta + iy * cfg.ntheta + it).astype(jnp.int32)


def _normalize(theta):
    t = jnp.mod(theta, 2 * jnp.pi)
    return jnp.where(t >= jnp.pi, t - 2 * jnp.pi, t)


def frontier_collision(ep, cc, cc_mask, halfplanes, obstacle_valid):
    """(F, P) bool: does primitive p, expanded from frontier pose ep[f],
    put any of its collision-check points inside any valid obstacle?

    ep (F, 3) poses; cc (P, C, 2) / cc_mask (P, C) check points in the
    parent frame; halfplanes (O, Hh, 3) rows [a, b, c] of a*x + b*y + c <= 0
    (a point is inside an obstacle when every row holds). A direct 5-D
    broadcast + fused reduces: no reshape between the compare and the
    reduction, so XLA can avoid materializing the (F, P, C, O, Hh) tensor.
    """
    hp = halfplanes
    c, s = jnp.cos(ep[:, 2]), jnp.sin(ep[:, 2])
    wx = (ep[:, None, None, 0] + c[:, None, None] * cc[None, :, :, 0]
          - s[:, None, None] * cc[None, :, :, 1])
    wy = (ep[:, None, None, 1] + s[:, None, None] * cc[None, :, :, 0]
          + c[:, None, None] * cc[None, :, :, 1])
    vals = (wx[:, :, :, None, None] * hp[None, None, None, :, :, 0]
            + wy[:, :, :, None, None] * hp[None, None, None, :, :, 1]
            + hp[None, None, None, :, :, 2])              # (F, P, C, O, Hh)
    inside_obs = jnp.all(vals <= 0.0, axis=-1)            # all rows of obstacle
    pt_valid = cc_mask[None, :, :, None]
    return jnp.any(
        inside_obs & pt_valid & obstacle_valid[None, None, None, :],
        axis=(2, 3),
    )


def wavefront_search(
    halfplanes,     # (O, Hh, 3) padded (compile_scenario convention)
    obstacle_valid,  # (O,)
    start,          # (3,)
    goal,           # (3,)
    goal_box,       # (4,) x1,y1,x2,y2
    theta_tol,      # ()
    prims: PrimitiveDeviceData,
    cfg: WavefrontConfig,
    weights: SearchWeights | None = None,
) -> WavefrontResult:
    """Beam-limited wavefront search of one scenario (vmap to batch)."""
    P = prims.cc.shape[0]
    K = prims.points.shape[1]
    F = cfg.frontier
    N = cfg.n_cells
    dtype = start.dtype

    hp = halfplanes                                     # (O, Hh, 3)
    w = weights if weights is not None else SearchWeights(h_theta=cfg.h_theta)

    # cc/cc_mask stay numpy (free MLIR constants); fields indexed by traced
    # values must be jnp — as numpy constants they convert for free under
    # trace, no device closure
    prims = prims._replace(
        ends=jnp.asarray(prims.ends, dtype),
        lengths=jnp.asarray(prims.lengths, dtype),
        points=jnp.asarray(prims.points, dtype),
    )

    def wrap_pi(a):
        return jnp.mod(a + jnp.pi, 2 * jnp.pi) - jnp.pi

    # 1 / (min distance to any half-plane boundary), multi_lane.py:78-108.
    # Padded rows ([0,0,+-1]) have zero normal and are masked out.
    hp_f = hp.reshape(-1, 3)
    hp_nrm = jnp.hypot(hp_f[:, 0], hp_f[:, 1])
    hp_live = hp_nrm > 1e-9

    def obstacle_proximity(x, y):
        d = jnp.abs(x[..., None] * hp_f[:, 0] + y[..., None] * hp_f[:, 1]
                    + hp_f[:, 2]) / jnp.where(hp_live, hp_nrm, 1.0)
        dmin = jnp.min(jnp.where(hp_live, d, jnp.inf), axis=-1)
        return 1.0 / jnp.maximum(dmin, 1e-9)

    def goal_box_distance(pose):
        dx = jnp.maximum(jnp.maximum(goal_box[0] - pose[..., 0], 0.0),
                         pose[..., 0] - goal_box[2])
        dy = jnp.maximum(jnp.maximum(goal_box[1] - pose[..., 1], 0.0),
                         pose[..., 1] - goal_box[3])
        return jnp.sqrt(dx * dx + dy * dy)

    def heuristic(pose):
        adth = jnp.abs(pose[..., 2] - goal[2])
        if w.heuristic_mode == "area":
            # base preset: goal-AREA distance + 2.7 * theta excess
            h = goal_box_distance(pose) + 2.7 * jnp.maximum(adth - theta_tol, 0.0)
        else:
            d = jnp.hypot(pose[..., 0] - goal[0], pose[..., 1] - goal[1])
            dth = jnp.minimum(adth, adth - theta_tol / 2.0)
            h = w.h_dist * d + w.h_theta * dth
        if w.h_steering:
            h = h + w.h_steering * jnp.abs(wrap_pi(goal[2] - pose[..., 2]))
        if w.h_obstacle:
            h = h + w.h_obstacle * obstacle_proximity(pose[..., 0], pose[..., 1])
        if w.h_center:
            h = h + w.h_center * jnp.hypot(pose[..., 0], pose[..., 1])
        return h

    def in_goal(pose):
        dx = jnp.maximum(jnp.maximum(goal_box[0] - pose[..., 0], 0.0),
                         pose[..., 0] - goal_box[2])
        dy = jnp.maximum(jnp.maximum(goal_box[1] - pose[..., 1], 0.0),
                         pose[..., 1] - goal_box[3])
        near = jnp.sqrt(dx * dx + dy * dy) <= 1e-5
        return near & (jnp.abs(pose[..., 2] - goal[2]) <= theta_tol)

    # grid state
    g0 = jnp.full((N,), jnp.inf, dtype)
    pose0 = jnp.zeros((N, 3), dtype)
    parent0 = jnp.full((N,), -1, jnp.int32)
    prim0 = jnp.full((N,), -1, jnp.int32)
    closed0 = jnp.zeros((N,), bool)

    sc = _cell_index(start, cfg)
    g0 = g0.at[sc].set(0.0)
    pose0 = pose0.at[sc].set(start)

    # best goal record: (g, pose, parent_cell, prim)
    bg0 = (jnp.asarray(jnp.inf, dtype), jnp.zeros((3,), dtype),
           jnp.asarray(-1, jnp.int32), jnp.asarray(-1, jnp.int32))

    def body(carry, _):
        g, pose, parent, prim, closed, bg, oob = carry

        # --- select ~top-F open cells by f = g + h ---
        # approx_min_k: a partial reduction where the backend has one
        # (elsewhere it lowers to an exact top-k); occasional recall misses
        # just delay a cell by an iteration
        score = jnp.where(jnp.isfinite(g) & ~closed, g + heuristic(pose), jnp.inf)
        vals, idxs = jax.lax.approx_min_k(score, F)
        active = jnp.isfinite(vals)
        closed = closed.at[idxs].set(closed[idxs] | active)

        ep = pose[idxs]                                  # (F, 3)
        eg = g[idxs]

        # --- generate F x P candidates ---
        c, s = jnp.cos(ep[:, 2]), jnp.sin(ep[:, 2])
        ex, ey, et = prims.ends[:, 0], prims.ends[:, 1], prims.ends[:, 2]
        nxp = ep[:, None, 0] + c[:, None] * ex - s[:, None] * ey
        nyp = ep[:, None, 1] + s[:, None] * ex + c[:, None] * ey
        nth = _normalize(et[None, :] + ep[:, None, 2])
        cand = jnp.stack([nxp, nyp, nth], axis=-1)        # (F, P, 3)
        # edge cost terms (multi_lane.py:228-234). The steering change
        # wrap_pi(nth - th0) == wrap_pi(end_theta) is constant per primitive.
        edge = w.c_dist * prims.lengths
        if w.c_steering:
            edge = edge + w.c_steering * jnp.abs(wrap_pi(prims.ends[:, 2]))
        cand_g = eg[:, None] + edge[None, :]
        # quirk kept: edge obstacle term gated on the HEURISTIC obstacle
        # weight in the multi-lane variant (multi_lane.py:230)
        if w.c_obstacle and ((not w.gate_edge_obstacle_on_h) or w.h_obstacle):
            cand_g = cand_g + w.c_obstacle * obstacle_proximity(nxp, nyp)
        if w.c_center:
            cand_g = cand_g + w.c_center * jnp.hypot(nxp, nyp)

        # --- collision: cc points in world frame vs all half-planes ---
        collide = frontier_collision(ep, prims.cc, prims.cc_mask, hp,
                                     obstacle_valid)      # (F, P)

        # out-of-grid telltale: a collision-free expansion landing outside
        # the (x, y) grid is pruned but COUNTED, so a failed search can be
        # distinguished from a too-small grid
        inb = (
            (cand[..., 0] >= cfg.x0)
            & (cand[..., 0] < cfg.x0 + cfg.nx * cfg.cell)
            & (cand[..., 1] >= cfg.y0)
            & (cand[..., 1] < cfg.y0 + cfg.ny * cfg.cell)
        )
        free = active[:, None] & ~collide
        oob = oob + jnp.sum(free & ~inb).astype(jnp.int32)
        valid = free & inb

        # --- goal tracking ---
        goal_ok = valid & in_goal(cand)
        gg = jnp.where(goal_ok, cand_g, jnp.inf)
        flat = jnp.argmin(gg.reshape(-1))
        fi, pi = flat // P, flat % P
        better_goal = gg.reshape(-1)[flat] < bg[0]
        bg = (
            jnp.where(better_goal, gg.reshape(-1)[flat], bg[0]),
            jnp.where(better_goal, cand[fi, pi], bg[1]),
            jnp.where(better_goal, idxs[fi], bg[2]).astype(jnp.int32),
            jnp.where(better_goal, pi, bg[3]).astype(jnp.int32),
        )

        # --- dedup + scatter winners into the grid ---
        keys = _cell_index(cand, cfg)                    # (F, P)
        keys_f = keys.reshape(-1)
        cand_f = cand.reshape(-1, 3)
        candg_f = cand_g.reshape(-1)
        ok = (valid.reshape(-1) & ~closed[keys_f]
              & (candg_f < g[keys_f] - 1e-6))

        g_try = jnp.where(ok, candg_f, jnp.inf)
        g_min = jnp.full((N,), jnp.inf, dtype).at[keys_f].min(g_try)
        win = ok & (candg_f <= g_min[keys_f])
        big = jnp.iinfo(jnp.int32).max
        cand_idx = jnp.arange(F * P, dtype=jnp.int32)
        upd = jnp.full((N,), big, jnp.int32).at[keys_f].min(
            jnp.where(win, cand_idx, big)
        )
        touched = upd < big
        safe = jnp.minimum(upd, F * P - 1)
        g = jnp.where(touched, candg_f[safe], g)
        pose = jnp.where(touched[:, None], cand_f[safe], pose)
        parent = jnp.where(touched, idxs[safe // P], parent)
        prim = jnp.where(touched, (safe % P).astype(jnp.int32), prim)

        return (g, pose, parent, prim, closed, bg, oob), None

    carry0 = (g0, pose0, parent0, prim0, closed0, bg0, jnp.asarray(0, jnp.int32))
    (g, pose, parent, prim, closed, bg, oob), _ = jax.lax.scan(
        body, carry0, None, length=cfg.iters
    )
    bg_g, bg_pose, bg_parent, bg_prim = bg
    found = jnp.isfinite(bg_g)

    # --- backtrack the primitive sequence through frozen cell records ---
    E = cfg.max_edges

    def back(carry, _):
        cell, k, seq = carry
        has = cell >= 0
        p_here = jnp.where(has, prim[jnp.maximum(cell, 0)], -1)
        seq = jnp.where(has & (p_here >= 0), seq.at[k].set(p_here), seq)
        k = jnp.where(has & (p_here >= 0), k + 1, k)
        nxt = jnp.where(has, parent[jnp.maximum(cell, 0)], -1)
        return (nxt, k, seq), None

    seq0 = jnp.full((E,), -1, jnp.int32).at[0].set(jnp.where(found, bg_prim, -1))
    k0 = jnp.where(found & (bg_prim >= 0), 1, 0).astype(jnp.int32)
    (_, k_rev, seq_rev), _ = jax.lax.scan(back, (bg_parent, k0, seq0), None, length=E)
    # seq_rev holds [goal_prim, ..., first_prim]; reverse the filled prefix
    n_edges = jnp.where(found, k_rev, 0)
    idx = jnp.clip(n_edges - 1 - jnp.arange(E), 0, E - 1)
    seq_fwd = jnp.where(jnp.arange(E) < n_edges, seq_rev[idx], -1)

    # --- forward replay: exact continuous trajectory from the start ---
    Km1 = K - 1

    def replay(carry, e):
        pose_c, out = carry
        p = seq_fwd[e]
        use = p >= 0
        pts = prims.points[jnp.maximum(p, 0)]             # (K, 3)
        cth, sth = jnp.cos(pose_c[2]), jnp.sin(pose_c[2])
        world = jnp.stack(
            [
                pose_c[0] + cth * pts[:, 0] - sth * pts[:, 1],
                pose_c[1] + sth * pts[:, 0] + cth * pts[:, 1],
                pts[:, 2] + pose_c[2],
            ],
            axis=1,
        )
        out = jnp.where(
            use,
            jax.lax.dynamic_update_slice(out, world[:Km1], (e * Km1, 0)),
            out,
        )
        nxt = jnp.stack([world[-1, 0], world[-1, 1], _normalize(world[-1, 2])])
        pose_c = jnp.where(use, nxt, pose_c)
        return (pose_c, out), None

    out0 = jnp.zeros((E * Km1 + 1, 3), dtype)
    (end_pose, traj), _ = jax.lax.scan(
        replay, (start, out0), jnp.arange(E)
    )
    # like the reference's path_to_full_trajectory, each edge contributes its
    # first K-1 points (edge endpoints are the next edge's first point)
    n_points = n_edges * Km1
    cost = jnp.where(found, bg_g, jnp.inf)
    return WavefrontResult(found, cost, traj, n_points, n_edges, oob)


def plan_courses_device(
    scenarios,
    geom: VehicleGeometry,
    weights: SearchWeights | None = None,
    cfg: WavefrontConfig | None = None,
    margin: float | None = None,
    dtype=jnp.float32,
):
    """Batch-plan many scenarios' global courses ON DEVICE — the production
    planning path (SURVEY section 7.2.3 "run thousands of scenarios'
    searches as one batched kernel"): one jitted, vmapped beam wavefront
    search with its grid sized from the batch geometry. The host C++
    search stays the exact oracle / fallback.
    """
    from ..worlds.scenario import compile_scenario, stack_scenario_arrays

    if not isinstance(scenarios, (list, tuple)):
        scenarios = [scenarios]
    if margin is None:
        margin = geom.radius
    w = weights if weights is not None else SearchWeights.modified()
    if cfg is None:
        cfg = WavefrontConfig.for_scenarios(scenarios)

    arrs = stack_scenario_arrays(
        [compile_scenario(s, margin=margin) for s in scenarios]
    )
    run = _planner_fn(cfg, w, geom, jnp.dtype(dtype).name)
    return run(
        jnp.asarray(arrs.halfplanes, dtype),
        jnp.asarray(arrs.obstacle_valid),
        jnp.asarray(arrs.start, dtype),
        jnp.asarray(arrs.goal_point, dtype),
        jnp.asarray(arrs.goal_area_corners, dtype),
        jnp.asarray(arrs.goal_theta_tol, dtype),
    )


@_functools.lru_cache(maxsize=32)
def _planner_fn(cfg: WavefrontConfig, w: SearchWeights,
                geom: VehicleGeometry, dtype_name: str):
    """Memoized jitted batch planner: repeated ``plan_courses_device`` calls
    with the same (grid, weights, vehicle) hit one compiled executable
    instead of re-tracing (all key parts are frozen dataclasses, hashable).
    The primitive table is a compile-time constant of the search, so it is
    closed over as numpy rather than passed as a traced argument."""
    from .primitives import primitive_table

    dtype = jnp.dtype(dtype_name)
    prims = prepare_primitives(primitive_table(geom), geom, dtype)

    @jax.jit
    def run(hp, ov, st, gp, gb, tt):
        return jax.vmap(
            lambda h, o, s, g, b, t: wavefront_search(
                h, o, s, g, b, t, prims, cfg, weights=w
            )
        )(hp, ov, st, gp, gb, tt)

    return run
