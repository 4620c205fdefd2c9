"""The device planner (beam wavefront) vs the native C++ planner.

``plan_courses_device`` is the one device planning path. Its top-F beam and
grid merge make it a bounded-suboptimality search, so its cost must land
within the repo's cost band of the exact host search, here the native C++
core (0.85-1.10 x, as in test_wavefront.py): the band admits a cheaper
path because the reference heuristic is inadmissible.
"""

import numpy as np
import pytest

from mpc_for_av_at_intersection_tpu.lattice import SearchWeights, primitive_table
from mpc_for_av_at_intersection_tpu.lattice.wavefront import (
    WavefrontConfig,
    plan_courses_device,
)
from mpc_for_av_at_intersection_tpu.models import bicycle_geometry
from mpc_for_av_at_intersection_tpu.native import (
    NativeMotionPrimitiveSearch,
    native_available,
)
from mpc_for_av_at_intersection_tpu.worlds import free_area, intersection


@pytest.fixture(scope="module")
def geom():
    if not native_available():
        pytest.skip("native planner needs a g++ toolchain")
    return bicycle_geometry()


def native_cost(sc, geom, weights=None):
    w = weights or SearchWeights.modified()
    s = NativeMotionPrimitiveSearch(sc, geom, primitive_table(geom),
                                    margin=geom.radius, weights=w)
    return s.run()[0]


def in_band(cost, ref):
    return 0.85 * ref - 1e-6 <= cost <= 1.10 * ref + 1e-6


def test_beam_free_area_matches_native(geom):
    sc = free_area(goal_distance=15.0)
    res = plan_courses_device([sc], geom)
    assert bool(np.asarray(res.found)[0])
    cost = float(np.asarray(res.cost)[0])
    assert in_band(cost, native_cost(sc, geom)), cost
    # the replayed trajectory reaches the goal area
    npts = int(np.asarray(res.n_points)[0])
    traj = np.asarray(res.trajectory)[0, :npts]
    assert npts > 0
    assert sc.goal_area.distance_to_point(traj[-1, :2]) < 1.0


def test_beam_matches_native_on_intersections(geom):
    configs = [(1, 1), (2, 3), (3, 2), (4, 1)]
    scenarios = [intersection(turn_indicator=t, start_pos=s)
                 for (s, t) in configs]
    cfg = WavefrontConfig.for_scenarios(scenarios)
    res = plan_courses_device(scenarios, geom, cfg=cfg)
    found = np.asarray(res.found)
    costs = np.asarray(res.cost)
    assert found.all(), f"beam missed: {found}"
    n_points = np.asarray(res.n_points)
    trajs = np.asarray(res.trajectory)
    for i, sc in enumerate(scenarios):
        ref = native_cost(sc, geom)
        assert in_band(costs[i], ref), (i, costs[i], ref)
        tr = trajs[i, : int(n_points[i])]
        assert len(tr) > 50
        assert sc.goal_area.distance_to_point(tr[-1, :2]) < 1.0


def test_beam_weighted_variant_matches_native(geom):
    """A non-default SearchWeights preset (steering / obstacle terms)
    through both planners."""
    sc = intersection(turn_indicator=2, start_pos=1)
    w = SearchWeights.single_lane()
    res = plan_courses_device([sc], geom, weights=w)
    assert bool(np.asarray(res.found)[0])
    cost = float(np.asarray(res.cost)[0])
    assert in_band(cost, native_cost(sc, geom, weights=w)), cost
