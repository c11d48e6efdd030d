"""OCS2-trajectory import + comparison harness (reference/ocs2_import.py).

Reference OCS2 data cannot be produced in this environment, so the harness
is validated with fabricated recordings: round-trip both file formats, and
feed our OWN solver's trajectory back through the comparator (a recording
that IS the solution must report ~zero deviation; a perturbed one must not).
Format doc in the module docstring; reference output semantics:
BipedalRobotDummyNode.cpp:44-90.
"""
import numpy as np
import pytest

from bipedal_nmpc.reference.ocs2_import import (
    RecordedTrajectory,
    compare_trajectories,
    load_recorded_trajectory,
    save_recorded_trajectory,
)


def _fake(T=9, nx=34, nu=31):
    rng = np.random.default_rng(0)
    return (
        np.linspace(0.0, 1.0, T),
        rng.normal(size=(T, nx)),
        rng.normal(size=(T, nu)),
    )


def test_npz_roundtrip(tmp_path):
    t, x, u = _fake()
    p = str(tmp_path / "traj.npz")
    save_recorded_trajectory(p, t, x, u)
    rec = load_recorded_trajectory(p)
    np.testing.assert_allclose(rec.times, t)
    np.testing.assert_allclose(rec.states, x)
    np.testing.assert_allclose(rec.inputs, u)


def test_csv_roundtrip(tmp_path):
    t, x, u = _fake(T=5, nx=4, nu=3)
    p = str(tmp_path / "traj.csv")
    header = "t," + ",".join(f"x{i}" for i in range(4)) + "," + ",".join(
        f"u{i}" for i in range(3)
    )
    rows = np.concatenate([t[:, None], x, u], axis=1)
    np.savetxt(p, rows, delimiter=",", header=header, comments="")
    rec = load_recorded_trajectory(p)
    np.testing.assert_allclose(rec.times, t)
    np.testing.assert_allclose(rec.states, x)
    np.testing.assert_allclose(rec.inputs, u)


def test_validation_errors(tmp_path):
    t, x, u = _fake()
    with pytest.raises(ValueError, match="length mismatch"):
        RecordedTrajectory(t[:-1], x, u)
    with pytest.raises(ValueError, match="strictly increasing"):
        RecordedTrajectory(np.zeros_like(t), x, u)
    p = str(tmp_path / "bad.npz")
    np.savez(p, times=t, states=x)
    with pytest.raises(ValueError, match="missing arrays"):
        load_recorded_trajectory(p)


def test_compare_interpolates_and_blocks():
    t, x, u = _fake(T=21, nx=34, nu=31)
    rec = RecordedTrajectory(t, x, u)
    # our "solution" = the recording sampled at a finer grid: ~zero deviation
    tn = np.linspace(0.1, 0.9, 15)
    xs = np.stack([rec.state_at(tt) for tt in tn])
    us = np.stack([rec.input_at(tt) for tt in tn[:-1]])
    rep = compare_trajectories(tn, xs, us, rec, nj=22)
    assert rep.max_state_err < 1e-12 and rep.max_input_err < 1e-12
    # a perturbed momentum block shows up in the right bucket
    xs2 = xs.copy()
    xs2[:, 2] += 0.5
    rep2 = compare_trajectories(tn, xs2, us, rec, nj=22)
    assert rep2.state_err_by_block["momentum"] > 0.49
    assert rep2.state_err_by_block["joints"] < 1e-12
    assert "state max|err|" in rep2.summary()


def test_compare_solve_against_self_recording():
    """Record OUR solver's converged trajectory, reload it, and compare a
    fresh solve against it: the deviation must be at solver-tolerance level.
    This is the exact pipeline an external OCS2 recording would follow."""
    import jax.numpy as jnp

    from bipedal_nmpc.interface import make_interface_for
    from bipedal_nmpc.reference.ocs2_import import compare_solve_to_recording
    from bipedal_nmpc.solver.sqp import build_refs, initial_trajectory, sqp_solve

    iface = make_interface_for("g1")
    rm = iface.make_reference_manager()
    rm.set_gait(iface.task.gait_library["trot"], start_time=0.1)
    frozen = rm.freeze(0.0)
    t_nodes = jnp.asarray(frozen.t_nodes)
    refs = build_refs(iface.info, frozen.gait, frozen.swing, frozen.target, t_nodes)
    x0 = jnp.asarray(iface.initial_state)
    xs, us = initial_trajectory(iface.info, refs, x0, iface.settings.num_intervals + 1)
    sol = sqp_solve(
        iface.model, iface.info, iface.settings, iface.Q, iface.R,
        refs, t_nodes, x0, xs, us,
    )
    rec = RecordedTrajectory(
        np.asarray(t_nodes),
        np.asarray(sol.x_traj),
        np.concatenate([np.asarray(sol.u_traj), np.asarray(sol.u_traj)[-1:]], axis=0),
    )
    rep = compare_solve_to_recording(iface, rec, gait="trot", gait_start=0.1)
    # same solver, same refs, same warm start: deviation ~ solver determinism
    assert rep.max_state_err < 1e-6, rep.summary()
