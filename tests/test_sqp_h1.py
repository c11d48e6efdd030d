"""End-to-end SQP solves on the H1 problem (stance + trot)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import REFERENCE_ASSETS
from bipedal_nmpc.solver import sqp_solve

H1_TASK = os.path.join(
    REFERENCE_ASSETS, "bipedal_robot_example/unitree_h1/h1_ocs2_config/config/task/task.info"
)
pytestmark = pytest.mark.skipif(
    not os.path.exists(H1_TASK), reason="reference assets unavailable"
)


@pytest.fixture(scope="module")
def h1_iface():
    from bipedal_nmpc.interface import make_interface_for

    return make_interface_for("h1")


def _solve(iface, rm, t0, x_init, iters=5):
    """Real-time-iteration style: repeated warm-started 1-iteration solves
    (shares a single compiled program across every test)."""
    import dataclasses

    from bipedal_nmpc.solver import build_refs, initial_trajectory

    settings = dataclasses.replace(iface.settings, sqp_iterations=1)
    frozen = rm.freeze(t0)
    t_nodes = jnp.asarray(frozen.t_nodes)
    refs = build_refs(iface.info, frozen.gait, frozen.swing, frozen.target, t_nodes)
    xs, us = initial_trajectory(iface.info, refs, x_init, settings.num_intervals + 1)
    solve = _get_solver(iface, settings)
    for _ in range(iters):
        sol = solve(refs, t_nodes, x_init, xs, us)
        xs, us = sol.x_traj, sol.u_traj
    return sol, refs


_SOLVER_CACHE = {}


def _get_solver(iface, settings):
    key = settings.sqp_iterations
    if key not in _SOLVER_CACHE:
        _SOLVER_CACHE[key] = jax.jit(
            lambda refs, t_nodes, x_init, xs, us: sqp_solve(
                iface.model, iface.info, settings, iface.Q, iface.R, refs, t_nodes, x_init, xs, us
            )
        )
    return _SOLVER_CACHE[key]


def test_h1_stance_solve(h1_iface):
    iface = h1_iface
    rm = iface.make_reference_manager()
    x0 = jnp.asarray(iface.initial_state)
    sol, refs = _solve(iface, rm, 0.0, x0)

    assert float(sol.step_size) > 0.0
    # dynamics defects and equality residuals drive to small values
    assert float(sol.defect_norm) < 1e-2, float(sol.defect_norm)
    assert float(sol.eq_norm) < 1e-2, float(sol.eq_norm)
    # standing: base pose stays near the target over the whole horizon
    base = np.asarray(sol.x_traj[:, 6:12])
    np.testing.assert_allclose(base[:, 2], 0.93, atol=0.02)
    np.testing.assert_allclose(base[:, 3:], 0.0, atol=0.06)
    # vertical forces: all positive, summing to ~mg (the toe/heel split is
    # uneven because the com is not centered over the soles)
    forces = np.asarray(sol.u_traj[:, :12]).reshape(-1, 4, 3)
    mg = iface.info.robot_mass * 9.81
    assert np.all(forces[5:-5, :, 2] > 0)
    np.testing.assert_allclose(forces[5:-5, :, 2].sum(axis=1), mg, rtol=0.1)
    # friction cone satisfied everywhere (mu=0.5)
    tangent = np.linalg.norm(forces[..., :2], axis=-1)
    assert np.all(0.5 * forces[5:, :, 2] - tangent[5:] > -1e-6)


def test_h1_trot_solve(h1_iface):
    iface = h1_iface
    rm = iface.make_reference_manager()
    rm.set_gait(iface.task.gait_library["trot"], start_time=0.2)
    x0 = jnp.asarray(iface.initial_state)
    sol, refs = _solve(iface, rm, 0.0, x0)

    assert float(sol.defect_norm) < 5e-2, float(sol.defect_norm)
    assert float(sol.eq_norm) < 5e-2, float(sol.eq_norm)

    flags = np.asarray(refs.contact_flags)  # (N, 4)
    # the gait actually switches within the horizon
    assert flags.min() == 0.0 and flags.max() == 1.0
    # swing feet z-velocity follows the spline reference (via constraint
    # residual already covered by eq_norm); check swing feet get airborne
    from bipedal_nmpc.model.centroidal import contact_positions

    z_min = []
    z_max_swing = 0.0
    for k in range(0, flags.shape[0], 4):
        p = np.asarray(
            contact_positions(iface.model, iface.info, sol.x_traj[k, 6:])
        )
        z_min.append(p[:, 2].min())
        swing = flags[k] < 0.5
        if swing.any():
            z_max_swing = max(z_max_swing, p[swing, 2].max())
    assert z_max_swing > 0.01, z_max_swing  # feet lift during swing
    # stance feet stay near the ground
    assert min(z_min) > -0.05


def test_h1_warm_start_improves(h1_iface):
    """A second solve warm-started from the first takes the full step and
    keeps residuals small (real-time iteration viability)."""
    import dataclasses

    from bipedal_nmpc.solver import build_refs, sqp_solve, warm_start_from_solution

    iface = h1_iface
    rm = iface.make_reference_manager()
    rm.set_gait(iface.task.gait_library["trot"], start_time=0.2)
    x0 = jnp.asarray(iface.initial_state)
    sol0, _ = _solve(iface, rm, 0.0, x0)

    settings = dataclasses.replace(iface.settings, sqp_iterations=1)
    frozen = rm.freeze(0.02)
    t_nodes = jnp.asarray(frozen.t_nodes)
    refs = build_refs(iface.info, frozen.gait, frozen.swing, frozen.target, t_nodes)
    xs, us = warm_start_from_solution(sol0, t_nodes)
    # next measured state: from the previous solution a replan period later
    x_init = xs[0]
    sol1 = _get_solver(iface, settings)(refs, t_nodes, x_init, xs, us)
    # one warm-started RTI step keeps residuals small and takes the full step
    assert float(sol1.defect_norm) < 0.1
    assert float(sol1.eq_norm) < 0.5
    assert float(sol1.step_size) >= 0.5


def test_g1_trot_solve():
    """G1 (our authored config; BASELINE config 2): gait-switching solve."""
    import dataclasses

    from bipedal_nmpc.interface import make_interface_for
    from bipedal_nmpc.solver import build_refs, initial_trajectory, sqp_solve

    iface = make_interface_for("g1")
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
    for _ in range(8):
        sol = solve(refs, t_nodes, x0, xs, us)
        xs, us = sol.x_traj, sol.u_traj
    assert float(sol.defect_norm) < 5e-2, float(sol.defect_norm)
    assert float(sol.eq_norm) < 5e-2, float(sol.eq_norm)
    base = np.asarray(sol.x_traj[:, 6:12])
    np.testing.assert_allclose(base[:, 2], 0.665, atol=0.05)
