"""Sweep subsystem + offline visualization smoke/behavior tests."""

import pytest

# plotting is an optional dependency (imported lazily by the package)
matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")

import numpy as np

from mpc_for_av_at_intersection_tpu import api, sweep
from mpc_for_av_at_intersection_tpu.lattice import SearchWeights
from mpc_for_av_at_intersection_tpu.models import bicycle_geometry
from mpc_for_av_at_intersection_tpu.worlds import intersection


def test_planner_weight_sweep_effort_tradeoff():
    geom = bicycle_geometry()
    sc = intersection(turn_indicator=1, start_pos=4)
    recs = sweep.planner_weight_sweep(
        sc, geom,
        weight_grid={"h_dist": [1.0, 2.0]},
        base=SearchWeights.modified(),
    )
    assert len(recs) == 2
    for r in recs:
        assert r.cost > 0 and r.n_expanded > 0 and len(r.trajectory) > 100
    # a heavier (inadmissible) distance heuristic is greedier: fewer expansions
    assert recs[1].n_expanded <= recs[0].n_expanded


def test_mpc_weight_sweep_tracks_tighter_with_w_perp():
    recs = sweep.mpc_weight_sweep(
        lambda cfg: api.build_intersection(other_vehicles=False, cfg=cfg),
        "w_perp", [1.0, 20.0], n_steps=200,
    )
    assert all(r.done for r in recs)
    # stronger perpendicular weight -> tighter tracking
    assert recs[1].max_deviation <= recs[0].max_deviation + 1e-6


def test_plotting_smoke(tmp_path):
    import jax
    import matplotlib.pyplot as plt

    from mpc_for_av_at_intersection_tpu.engine import run_episode
    from mpc_for_av_at_intersection_tpu.lattice import (
        MotionPrimitiveSearch,
        primitive_table,
    )
    from mpc_for_av_at_intersection_tpu.utils import (
        animate_episode,
        draw_car,
        draw_scenario,
        draw_search_points,
        plot_telemetry,
        plot_trajectories,
    )

    geom = bicycle_geometry()
    sc = intersection(turn_indicator=1, start_pos=4)
    table = primitive_table(geom)
    search = MotionPrimitiveSearch(sc, geom, table, margin=geom.radius)
    _, _, traj = search.run(debug=True)

    setup = api.build_intersection(other_vehicles=False, n_steps=64)
    run = jax.jit(lambda w, s: run_episode(w, s, setup.cfg, setup.geom, 64))
    _, tel = run(setup.world, setup.state0)
    tel = jax.tree.map(np.asarray, tel)

    fig, ax = plt.subplots()
    draw_scenario(sc, ax, show_hidden=True)
    draw_car((0.0, 0.0, 0.5), geom, ax, steer=0.2, draw_circles=True)
    assert draw_search_points(search, ax) is not None
    fig.savefig(tmp_path / "scenario.png")

    axes = plot_telemetry(tel)
    axes[0].figure.savefig(tmp_path / "telemetry.png")

    fig2, ax2 = plt.subplots()
    plot_trajectories(tel, ax2)
    fig2.savefig(tmp_path / "traj.png")

    anim = animate_episode(sc, geom, tel)
    anim._draw_frame(3)  # render a frame without writing a video
    plt.close("all")
    assert (tmp_path / "scenario.png").stat().st_size > 1000


def test_overlay_telemetry_sweep_figures(tmp_path):
    """The reference's cumulative-sensitivity comparison figure family
    (mpc_sensitivity_analysis_comulative.py:268-438: overlaid trajectories
    + speed/accel/deviation across sweep values) via overlay_telemetry."""
    import matplotlib.pyplot as plt

    from mpc_for_av_at_intersection_tpu.utils import overlay_telemetry
    from mpc_for_av_at_intersection_tpu.worlds import intersection

    recs = sweep.mpc_weight_sweep(
        lambda cfg: api.build_intersection(other_vehicles=False, cfg=cfg),
        "w_perp", [1.0, 20.0], n_steps=160,
    )
    setup = api.build_intersection(other_vehicles=False, n_steps=8)
    fig, axes = overlay_telemetry(
        recs, trajectory=setup.trajectory,
        scenario=intersection(turn_indicator=1, start_pos=4),
    )
    assert len(axes) == 4
    # one labeled line per sweep value on every panel
    for ax in axes[1:]:
        labels = [ln.get_label() for ln in ax.get_lines()]
        assert "w_perp=1" in labels and "w_perp=20" in labels
    out = tmp_path / "overlay.png"
    fig.savefig(out)
    plt.close("all")
    assert out.stat().st_size > 5000


def test_primitive_fanout_matches_reference_recurrence():
    """The vectorized fan-out demo (utils.plotting) vs the reference
    generate_MPs_multiple.py recurrence, re-implemented literally."""
    import numpy as np

    from mpc_for_av_at_intersection_tpu.utils.plotting import (
        primitive_fanout_trajectories,
    )

    def ref_traj(delta, x0, y0, th0, L, v, dt, total):
        n = int(total / dt)
        x, y, th = x0, y0, th0
        out = [(x, y, th)]
        for _ in range(n):
            x += v * np.cos(th) * dt
            y += v * np.sin(th) * dt
            th += (v / L) * np.tan(delta) * dt
            out.append((x, y, th))
        return np.array(out)

    deltas = np.deg2rad(np.linspace(-45, 45, 5))
    init = [(0.0, 0.0, 0.0)]
    ref = []
    for _ in range(3):
        new = []
        for (x0, y0, t0) in init:
            for d in deltas:
                t = ref_traj(d, x0, y0, t0, 1.0, 1.0, 0.1, 0.2)
                ref.append(t)
                new.append(tuple(t[-1]))
        init = new

    got = primitive_fanout_trajectories(levels=3)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, atol=1e-5)
