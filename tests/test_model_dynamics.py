"""Dynamics golden tests: energy laws, MuJoCo oracle for M / bias / momentum."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bipedal_nmpc.model import (
    centroidal_momentum_matrix,
    forward_dynamics,
    gravity_vector,
    kinetic_energy,
    mass_matrix,
    nonlinear_effects,
)
from bipedal_nmpc.utils.rotations import euler_rate_map_zyx, rotmat_from_zyx

from test_model_kinematics import _set_mj_state, h1_full_pair  # noqa: F401


def _rand_state(model, rng):
    q = np.concatenate(
        [rng.uniform(-1, 1, 3), rng.uniform(-0.7, 0.7, 3), rng.uniform(-0.8, 0.8, model.nj)]
    )
    v = rng.uniform(-1, 1, model.nv)
    return jnp.asarray(q), jnp.asarray(v)


def test_mass_matrix_symmetric_pd(h1_model, rng):
    q, _ = _rand_state(h1_model, rng)
    M = np.asarray(mass_matrix(h1_model, q))
    np.testing.assert_allclose(M, M.T, atol=1e-10)
    eigs = np.linalg.eigvalsh(M)
    assert eigs.min() > 0


def test_energy_conservation_free_fall(h1_model, rng):
    """Unforced dynamics conserves total energy (symplectic check via RK4)."""
    from bipedal_nmpc.model.dynamics import potential_energy

    model = h1_model
    q, v = _rand_state(model, rng)

    def f(state):
        q, v = state[: model.nq], state[model.nq :]
        return jnp.concatenate([v, forward_dynamics(model, q, v, jnp.zeros(model.nv))])

    @jax.jit
    def rk4_step(s, dt):
        k1 = f(s)
        k2 = f(s + 0.5 * dt * k1)
        k3 = f(s + 0.5 * dt * k2)
        k4 = f(s + dt * k3)
        return s + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)

    s = jnp.concatenate([q, v])
    e0 = kinetic_energy(model, q, v) + potential_energy(model, q)
    for _ in range(20):
        s = rk4_step(s, 1e-3)
    q1, v1 = s[: model.nq], s[model.nq :]
    e1 = kinetic_energy(model, q1, v1) + potential_energy(model, q1)
    np.testing.assert_allclose(float(e1), float(e0), rtol=1e-6)


def test_gravity_vector_zero_velocity_nle(h1_model, rng):
    q, _ = _rand_state(h1_model, rng)
    nle0 = nonlinear_effects(h1_model, q, jnp.zeros(h1_model.nv))
    g = gravity_vector(h1_model, q)
    np.testing.assert_allclose(np.asarray(nle0), np.asarray(g), atol=1e-10)


# ---------------------------------------------------------------- MuJoCo oracle
def _velocity_transform(model, q):
    """T with v_mj = T @ v_ours (mujoco free joint: world linear, local angular)."""
    theta = np.asarray(q[3:6])
    R = np.asarray(rotmat_from_zyx(jnp.asarray(theta)))
    E = np.asarray(euler_rate_map_zyx(jnp.asarray(theta)))
    T = np.eye(model.nv)
    T[3:6, 3:6] = R.T @ E
    return T


def test_h1_kinetic_energy_vs_mujoco(h1_full_pair, rng):
    mujoco, m, d, model = h1_full_pair
    for _ in range(3):
        q, v = _rand_state(model, rng)
        _set_mj_state(mujoco, m, d, model, q, v)
        M_mj = _dense_M(mujoco, m, d)
        # mujoco dof order: free joint then joints in mujoco order == our order here
        T = _velocity_transform(model, q)
        v_mj = T @ np.asarray(v)
        ke_mj = 0.5 * v_mj @ M_mj @ v_mj
        ke_ours = float(kinetic_energy(model, q, v))
        np.testing.assert_allclose(ke_ours, ke_mj, rtol=1e-9)


def test_h1_unforced_acceleration_vs_mujoco(h1_full_pair, rng):
    """Forward dynamics with zero torque must match MuJoCo's, mapped through
    the (time-varying) velocity transform: a_mj = T vdot_ours + Tdot v_ours."""
    mujoco, m, d, model = h1_full_pair
    q, v = _rand_state(model, rng)
    _set_mj_state(mujoco, m, d, model, q, v)
    d.qfrc_applied[:] = 0
    mujoco.mj_forward(m, d)
    a_mj = np.linalg.solve(_dense_M(mujoco, m, d), -d.qfrc_bias)
    vdot_ours = np.asarray(forward_dynamics(model, q, v, jnp.zeros(model.nv)))
    T = _velocity_transform(model, q)
    eps = 1e-6
    T1 = _velocity_transform(model, np.asarray(q) + eps * np.asarray(v))
    T0 = _velocity_transform(model, np.asarray(q) - eps * np.asarray(v))
    Tdot = (T1 - T0) / (2 * eps)
    np.testing.assert_allclose(T @ vdot_ours + Tdot @ np.asarray(v), a_mj, atol=1e-5)


def _dense_M(mujoco, m, d):
    M = np.zeros((m.nv, m.nv))
    mujoco.mj_fullM(m, d, M)
    return M


def test_h1_centroidal_momentum_vs_mujoco(h1_full_pair, rng):
    """A(q) v == [m * v_com ; L about com], via mj subtree momentum."""
    mujoco, m, d, model = h1_full_pair
    q, v = _rand_state(model, rng)
    _set_mj_state(mujoco, m, d, model, q, v)
    mujoco.mj_subtreeVel(m, d)
    A = np.asarray(centroidal_momentum_matrix(model, q))
    h = A @ np.asarray(v)
    mass = float(model.total_mass)
    np.testing.assert_allclose(h[:3], mass * d.subtree_linvel[1], atol=1e-8)
    np.testing.assert_allclose(h[3:], d.subtree_angmom[1], atol=1e-8)
