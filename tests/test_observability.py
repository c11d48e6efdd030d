"""Observability module + batched WBC smoke tests."""
import os

import jax.numpy as jnp
import numpy as np
import pytest

from conftest import REFERENCE_ASSETS

pytestmark = pytest.mark.skipif(
    not os.path.exists(os.path.join(REFERENCE_ASSETS, "bipedal_robot_example")),
    reason="reference assets unavailable",
)


@pytest.fixture(scope="module")
def h1_solution():
    import dataclasses

    from bipedal_nmpc.interface import make_interface_for
    from bipedal_nmpc.solver import build_refs, initial_trajectory, sqp_solve
    import jax

    iface = make_interface_for("h1")
    settings = dataclasses.replace(iface.settings, sqp_iterations=1)
    rm = iface.make_reference_manager()
    rm.set_gait(iface.task.gait_library["trot"], start_time=0.2)
    x0 = jnp.asarray(iface.initial_state)
    frozen = rm.freeze(0.0)
    t_nodes = jnp.asarray(frozen.t_nodes)
    refs = build_refs(iface.info, frozen.gait, frozen.swing, frozen.target, t_nodes)
    xs, us = initial_trajectory(iface.info, refs, x0, settings.num_intervals + 1)
    solve = jax.jit(
        lambda refs, t, x, xs, us: sqp_solve(
            iface.model, iface.info, settings, iface.Q, iface.R, refs, t, x, xs, us
        )
    )
    for _ in range(5):
        sol = solve(refs, t_nodes, x0, xs, us)
        xs, us = sol.x_traj, sol.u_traj
    return iface, sol, refs


def test_constraint_observer(h1_solution):
    from bipedal_nmpc.runtime.observability import observe_constraints

    iface, sol, refs = h1_solution
    obs = observe_constraints(iface.model, iface.info, iface.settings, sol, refs)
    flags = np.asarray(refs.contact_flags)
    # friction-cone margins defined exactly on stance nodes, nan on swing
    assert np.all(np.isnan(obs.friction_cone[flags < 0.5]))
    stance_margins = obs.friction_cone[flags > 0.5]
    assert np.nanmin(stance_margins) > -1.0  # soft constraint: small violations only
    # stance zero-velocity residuals small on the converged solution
    assert np.nanmax(obs.zero_velocity[flags > 0.5]) < 0.05


def test_tracking_error_and_report(h1_solution):
    from bipedal_nmpc.model.centroidal import rbd_state_from_centroidal
    from bipedal_nmpc.ocp.problem import weight_compensating_input
    from bipedal_nmpc.runtime.observability import solve_report, tracking_error

    iface, sol, refs = h1_solution
    x_des = sol.x_traj[0]
    u0 = weight_compensating_input(iface.info, jnp.ones(4), iface.info.input_dim)
    rbd = rbd_state_from_centroidal(iface.model, iface.info, x_des, u0)
    err = tracking_error(iface.model, iface.info, x_des, rbd)
    np.testing.assert_allclose(err.base_position_error, 0, atol=1e-9)
    np.testing.assert_allclose(err.foot_position_error, 0, atol=1e-9)
    rep = solve_report(sol)
    assert set(rep) >= {"cost", "defect_l1", "eq_l1", "step_size"}


def test_batched_wbc(h1_solution):
    from bipedal_nmpc.model.centroidal import rbd_state_from_centroidal
    from bipedal_nmpc.ocp.problem import weight_compensating_input
    from bipedal_nmpc.runtime.controller import wbc_config_from_task
    from bipedal_nmpc.wbc.weighted_wbc import wbc_update_batch

    iface, sol, refs = h1_solution
    cfg = wbc_config_from_task(iface.task)
    B = 4
    x = jnp.broadcast_to(sol.x_traj[0][None], (B, iface.info.state_dim))
    u0 = weight_compensating_input(iface.info, jnp.ones(4), iface.info.input_dim)
    u = jnp.broadcast_to(u0[None], (B, iface.info.input_dim))
    rbd = rbd_state_from_centroidal(iface.model, iface.info, sol.x_traj[0], u0)
    rbd_b = jnp.broadcast_to(rbd[None], (B, rbd.shape[0]))
    flags = jnp.ones((B, 4))
    res = wbc_update_batch(iface.model, iface.info, cfg, x, u, rbd_b, flags)
    assert res.torque.shape == (B, iface.info.nj)
    for b in range(1, B):
        np.testing.assert_allclose(
            np.asarray(res.torque[b]), np.asarray(res.torque[0]), atol=1e-9
        )
