"""Visualizer (#16 parity): marker recording, CoP, hull, figure/JSON export."""
import json
import os

import numpy as np
import pytest

from bipedal_nmpc.runtime.visualizer import (
    Visualizer,
    _convex_hull_2d,
    center_of_pressure,
)


def test_center_of_pressure():
    feet = np.array([[0.1, 0.1, 0.0], [0.1, -0.1, 0.0], [-0.1, 0.1, 0.0], [-0.1, -0.1, 0.0]])
    forces = np.zeros((4, 3))
    forces[:, 2] = [100.0, 100.0, 0.0, 0.0]
    cop = center_of_pressure(feet, forces)
    np.testing.assert_allclose(cop, [0.1, 0.0, 0.0], atol=1e-12)
    # airborne -> nan
    assert np.isnan(center_of_pressure(feet, np.zeros((4, 3)))).all()


def test_convex_hull():
    pts = np.array([[0, 0], [1, 0], [1, 1], [0, 1], [0.5, 0.5]])
    hull = _convex_hull_2d(pts)
    assert len(hull) == 4
    assert not any((h == [0.5, 0.5]).all() for h in hull)


def test_visualizer_records_and_renders(h1_model, h1_info, tmp_path):
    viz = Visualizer(h1_model, h1_info, max_update_frequency=50.0)
    nx = h1_info.state_dim
    nu = h1_info.input_dim
    x = np.zeros(nx)
    x[8] = 0.98
    u = np.zeros(nu)
    u[2] = u[5] = u[8] = u[11] = 120.0  # stance normal forces
    for k in range(100):
        t = k * 0.005  # 200 Hz ticks, throttled to 50 Hz
        x[6] = 0.2 * t  # walk forward
        viz.update(t, x, u, desired_state=x)
    assert 20 <= len(viz.frames) <= 30  # throttling works

    png = tmp_path / "viz.png"
    viz.save_figure(str(png))
    assert png.exists() and png.stat().st_size > 10_000

    js = tmp_path / "viz.json"
    viz.export_json(str(js))
    data = json.loads(js.read_text())
    assert len(data["frames"]) == len(viz.frames)
    f0 = data["frames"][0]
    assert len(f0["foot_positions"]) == 4
    assert np.isfinite(f0["cop"]).all()


def test_visualizer_full_tf(h1_model, h1_info, tmp_path):
    """record_tf=True captures the world placement of every body frame —
    the full joint-TF rendering of the reference visualizer (#16)."""
    import json

    viz = Visualizer(h1_model, h1_info, max_update_frequency=50.0, record_tf=True)
    x = np.zeros(h1_info.state_dim)
    x[8] = 0.98
    u = np.zeros(h1_info.input_dim)
    viz.update(0.0, x, u)
    f = viz.frames[0]
    nb = h1_model.nj + 1
    assert len(f.body_names) == nb
    assert f.body_positions.shape == (nb, 3)
    assert f.body_orientations_zyx.shape == (nb, 3)
    # base body placement matches the state
    np.testing.assert_allclose(f.body_positions[0], x[6:9], atol=1e-12)
    # feet bodies reach near the ground with straight legs
    assert f.body_positions[:, 2].min() < 0.2
    js = tmp_path / "tf.json"
    viz.export_json(str(js))
    data = json.loads(js.read_text())
    assert len(data["frames"][0]["body_positions"]) == nb
