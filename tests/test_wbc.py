"""WBC QP solver and task-formulation tests."""
import jax.numpy as jnp
import numpy as np
import pytest

from bipedal_nmpc.wbc import WbcTaskConfig, solve_qp, wbc_update


def test_qp_kkt_on_random_problem():
    """ADMM QP satisfies KKT conditions of an inequality QP (checked directly)."""
    rng = np.random.default_rng(0)
    n, m = 8, 12
    W = rng.normal(size=(n, n))
    H = W @ W.T + np.eye(n)
    g = rng.normal(size=n)
    A = rng.normal(size=(m, n))
    l = -rng.uniform(0.5, 2.0, m)  # noqa: E741
    u = rng.uniform(0.5, 2.0, m)
    # a few equality rows
    l[:3] = u[:3] = rng.normal(size=3) * 0.1
    sol = solve_qp(jnp.asarray(H), jnp.asarray(g), jnp.asarray(A), jnp.asarray(l), jnp.asarray(u),
                   iters=400)
    x = np.asarray(sol.x)
    ax = A @ x
    assert np.all(ax <= u + 1e-5) and np.all(ax >= l - 1e-5)
    # stationarity: H x + g + A^T y = 0
    y = np.asarray(sol.y)
    np.testing.assert_allclose(H @ x + g + A.T @ y, 0, atol=1e-4)
    # complementarity: y_i != 0 only at active bounds (inequality rows)
    for i in range(3, m):
        if abs(y[i]) > 1e-5:
            assert min(abs(ax[i] - u[i]), abs(ax[i] - l[i])) < 1e-4


def test_qp_equality_exact():
    H = jnp.eye(2)
    g = jnp.asarray([-1.0, -1.0])
    A = jnp.asarray([[1.0, 1.0]])
    sol = solve_qp(H, g, A, jnp.asarray([1.0]), jnp.asarray([1.0]), iters=300)
    np.testing.assert_allclose(np.asarray(sol.x), [0.5, 0.5], atol=1e-6)


@pytest.fixture(scope="module")
def h1_wbc_setup(h1_model, h1_info):
    import os

    from conftest import REFERENCE_ASSETS

    if not os.path.exists(os.path.join(REFERENCE_ASSETS, "bipedal_robot_example")):
        pytest.skip("assets unavailable")
    from bipedal_nmpc.interface import make_interface_for
    from bipedal_nmpc.model.centroidal import rbd_state_from_centroidal

    iface = make_interface_for("h1")
    cfg = WbcTaskConfig(
        torque_limit_per_leg=tuple(iface.task.wbc.torque_limits),
        friction_coefficient=iface.task.wbc.friction_coefficient,
        swing_kp=iface.task.wbc.swing_kp,
        swing_kd=iface.task.wbc.swing_kd,
        base_kp=tuple(iface.task.wbc.base_kp),
        base_kd=tuple(iface.task.wbc.base_kd),
        no_contact_motion_tolerance=iface.task.wbc.no_contact_motion_tolerance,
        weight_swing_leg=iface.task.wbc.weight_swing_leg,
        weight_base_accel=iface.task.wbc.weight_base_accel,
        weight_contact_force=iface.task.wbc.weight_contact_force,
    )
    x0 = jnp.asarray(iface.initial_state)
    from bipedal_nmpc.ocp.problem import weight_compensating_input

    u0 = weight_compensating_input(iface.info, jnp.ones(4), iface.info.input_dim)
    rbd = rbd_state_from_centroidal(iface.model, iface.info, x0, u0)
    return iface, cfg, x0, u0, rbd


def test_wbc_stance_equilibrium(h1_wbc_setup):
    """Standing still at the reference: WBC must return ~weight-supporting
    forces, small accelerations, gravity-compensating torques that satisfy
    the EoM row exactly."""
    iface, cfg, x0, u0, rbd = h1_wbc_setup
    res = wbc_update(
        iface.model, iface.info, cfg, x0, u0, rbd, jnp.ones(4), qp_iters=300
    )
    nv = iface.info.generalized_dim
    vdot = np.asarray(res.decision[:nv])
    forces = np.asarray(res.decision[nv : nv + 12]).reshape(4, 3)
    # the reference's weights (baseAccel 1 vs contactForce 0.01) allow the QP
    # to trade a few rad/s^2 of base acceleration against force tracking when
    # the com is not centered over the support polygon; only bound it loosely.
    assert float(res.qp.primal_residual) < 1e-4
    assert np.all(np.isfinite(vdot))
    np.testing.assert_allclose(forces[:, 2].sum(), iface.info.robot_mass * 9.81, rtol=0.05)
    # EoM residual: M vdot + nle - Jc^T F - S^T tau ~ 0
    from bipedal_nmpc.wbc.tasks import compute_wbc_kinematics

    kin = compute_wbc_kinematics(iface.model, iface.info, x0, u0, rbd)
    Jc = np.asarray(kin.Jc).reshape(12, nv)
    S_T = np.concatenate([np.zeros((6, iface.info.nj)), np.eye(iface.info.nj)], axis=0)
    eom = (
        np.asarray(kin.M) @ vdot
        + np.asarray(kin.nle)
        - Jc.T @ forces.reshape(-1)
        - S_T @ np.asarray(res.torque)
    )
    np.testing.assert_allclose(eom, 0, atol=1e-2)
    # torque limits respected
    assert np.all(np.abs(np.asarray(res.torque)) <= 500.0 + 1e-6)


def test_wbc_swing_tracks_accel(h1_wbc_setup):
    """With the left-foot pair swinging, the swing-foot rows should track the
    PD acceleration target and the swing forces must be ~0."""
    iface, cfg, x0, u0, rbd = h1_wbc_setup
    from bipedal_nmpc.ocp.problem import weight_compensating_input

    flags = jnp.asarray([0.0, 0.0, 1.0, 1.0])  # RF mode: left pair swings
    u_rf = weight_compensating_input(iface.info, flags, iface.info.input_dim)
    res = wbc_update(iface.model, iface.info, cfg, x0, u_rf, rbd, flags, qp_iters=300)
    nv = iface.info.generalized_dim
    forces = np.asarray(res.decision[nv : nv + 12]).reshape(4, 3)
    np.testing.assert_allclose(forces[:2], 0, atol=1e-4)  # swing feet
    assert forces[2:, 2].sum() > 0.8 * iface.info.robot_mass * 9.81
