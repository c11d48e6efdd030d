"""Single-Rigid-Body-Dynamics centroidal variant (centroidalModelType 1).

The reference exposes the knob at task.info:1 (every shipped robot uses 0);
the external ocs2_centroidal_model implements type 1 by evaluating the
momentum matrix at the nominal joint configuration with zero joint columns.
These tests pin our implementation to that semantics and check the
structured linearization still matches the pure-AD oracle under SRBD.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from bipedal_nmpc.model.centroidal import (
    centroidal_momentum_matrix,
    centroidal_momentum_matrix_info,
    centroidal_flow_map,
    momentum_coordinates,
)
from bipedal_nmpc.ocp.linearize import linearize_node_structured
from bipedal_nmpc.ocp.problem import (
    NodeRefs,
    OcpSettings,
    linearize_node,
    weight_compensating_input,
)


@pytest.fixture(scope="module")
def srbd_info(h1_info):
    nominal = tuple(0.1 * ((-1.0) ** i) for i in range(h1_info.nj))
    return dataclasses.replace(h1_info, model_type=1, q_j_nominal=nominal)


def _random_state(rng, info):
    return jnp.asarray(
        np.concatenate(
            [
                rng.uniform(-0.3, 0.3, 6),
                [0, 0, 0.9],
                rng.uniform(-0.4, 0.4, 3),
                rng.uniform(-0.6, 0.6, info.nj),
            ]
        )
    )


def test_srbd_cmm_structure(h1_model, h1_info, srbd_info, rng):
    x = _random_state(rng, h1_info)
    q = x[6:]
    A = centroidal_momentum_matrix_info(h1_model, srbd_info, q)
    # no joint momentum columns
    np.testing.assert_array_equal(np.asarray(A[:, 6:]), 0.0)
    # base block is the full CMM evaluated at (base pose, nominal joints)
    A_ref = centroidal_momentum_matrix(h1_model, momentum_coordinates(srbd_info, q))
    np.testing.assert_allclose(np.asarray(A[:, :6]), np.asarray(A_ref[:, :6]), rtol=1e-12)
    # and differs from the full-model CMM at the actual configuration
    A_full = centroidal_momentum_matrix_info(h1_model, h1_info, q)
    assert np.max(np.abs(np.asarray(A_full[:, :6] - A[:, :6]))) > 1e-6


def test_srbd_flow_joint_invariance(h1_model, srbd_info, rng):
    """SRBD base velocity must not depend on joint velocities."""
    x = _random_state(rng, srbd_info)
    u = weight_compensating_input(srbd_info, jnp.ones(4), srbd_info.input_dim)
    u2 = u.at[12:].add(jnp.asarray(rng.uniform(-1, 1, srbd_info.nj)))
    f1 = centroidal_flow_map(h1_model, srbd_info, x, u)
    f2 = centroidal_flow_map(h1_model, srbd_info, x, u2)
    np.testing.assert_allclose(np.asarray(f1[6:12]), np.asarray(f2[6:12]), atol=1e-12)


@pytest.mark.parametrize("flags", [(1.0, 1, 1, 1), (1, 1, 0, 0)])
def test_srbd_structured_matches_ad(h1_model, srbd_info, rng, flags):
    info = srbd_info
    settings = OcpSettings(position_error_gain=0.3, exact_rk2_sensitivity=True)
    Q = jnp.asarray(np.diag(rng.uniform(1, 10, info.state_dim)))
    R = jnp.asarray(np.diag(rng.uniform(0.01, 1, info.input_dim)))
    x = _random_state(rng, info)
    u = weight_compensating_input(info, jnp.asarray(flags, dtype=jnp.float64), info.input_dim)
    u = u + jnp.asarray(rng.uniform(-5, 5, info.input_dim))
    x_next = x + jnp.asarray(rng.uniform(-0.01, 0.01, info.state_dim))
    refs = NodeRefs(
        t=jnp.asarray(0.1),
        dt=jnp.asarray(0.015),
        contact_flags=jnp.asarray(flags, dtype=jnp.float64),
        swing_vref=jnp.asarray(rng.uniform(-0.2, 0.2, 4)),
        swing_pref=jnp.asarray(rng.uniform(0, 0.05, 4)),
        x_nom=x + 0.05,
        u_nom=u * 0.9,
    )
    ad = linearize_node(h1_model, info, settings, Q, R, x, u, x_next, refs)
    st = linearize_node_structured(h1_model, info, settings, Q, R, x, u, x_next, refs)
    for name in ad._fields:
        np.testing.assert_allclose(
            np.asarray(getattr(st, name)),
            np.asarray(getattr(ad, name)),
            atol=1e-9,
            rtol=1e-7,
            err_msg=name,
        )


def test_srbd_rti_solve_converges():
    """Warm-started 1-iteration solves on H1-SRBD stance drive the defect down
    (same RTI usage as the full model, with the real default pose)."""
    from bipedal_nmpc.interface import make_interface_for
    from bipedal_nmpc.solver import build_refs, initial_trajectory, sqp_solve

    try:
        iface = make_interface_for("h1")
    except Exception:
        pytest.skip("H1 reference assets not available")
    info = dataclasses.replace(
        iface.info, model_type=1, q_j_nominal=tuple(float(v) for v in iface.initial_state[12:])
    )
    settings = dataclasses.replace(
        iface.settings, sqp_iterations=1, linesearch_alphas=(1.0, 0.5, 0.25, 0.1)
    )
    rm = iface.make_reference_manager()
    frozen = rm.freeze(0.0)
    t_nodes = jnp.asarray(frozen.t_nodes)
    refs = build_refs(info, frozen.gait, frozen.swing, frozen.target, t_nodes)
    x0 = jnp.asarray(iface.initial_state)
    xs, us = initial_trajectory(info, refs, x0, settings.num_intervals + 1)
    defects = []
    for _ in range(6):
        sol = sqp_solve(iface.model, info, settings, iface.Q, iface.R, refs, t_nodes, x0, xs, us)
        xs, us = sol.x_traj, sol.u_traj
        defects.append(float(sol.defect_norm))
    assert np.isfinite(defects).all()
    assert defects[-1] < 0.2 * defects[0] + 1e-8
