"""Host (numpy) WBC == JAX WBC (wbc/host_wbc.py, model/host_dynamics.py).

The deployment torque path runs the whole WBC pipeline host-side (the
reference closes its QP on the CPU, WeightedWbc.cpp:53-81); these tests pin
every stage — dynamics, Jacobian time variations, desired-side conversions,
task rows, ADMM iterations — to the jitted JAX implementation in f64.
"""
import numpy as np
import pytest


@pytest.fixture(scope="module")
def g1_iface():
    from bipedal_nmpc.interface import make_interface_for

    return make_interface_for("g1")


@pytest.fixture(scope="module")
def hm(g1_iface):
    from bipedal_nmpc.model.host_model import make_host_model

    return make_host_model(g1_iface.model, g1_iface.info)


def _random_qv(rng, nj):
    q = rng.normal(scale=0.3, size=6 + nj)
    q[2] += 0.95
    v = rng.normal(scale=0.5, size=6 + nj)
    return q, v


def _random_xu(rng, iface):
    nj = iface.info.nj
    x = np.asarray(iface.initial_state).copy()
    x[:6] += rng.normal(scale=0.2, size=6)
    x[6:9] += rng.normal(scale=0.05, size=3)
    x[9:12] += rng.normal(scale=0.1, size=3)
    x[12:] += rng.normal(scale=0.1, size=nj)
    u = rng.normal(scale=20.0, size=iface.info.input_dim)
    u[12:] = rng.normal(scale=0.5, size=nj)
    return x, u


def _random_rbd(rng, nj):
    rbd = rng.normal(scale=0.3, size=2 * (6 + nj))
    rbd[3:6] += np.array([0.0, 0.0, 0.95])
    return rbd


def test_mass_and_nle_parity(g1_iface, hm):
    import jax.numpy as jnp

    from bipedal_nmpc.model.dynamics import mass_matrix, nonlinear_effects
    from bipedal_nmpc.model.host_dynamics import mass_and_nle_np

    rng = np.random.default_rng(3)
    for _ in range(3):
        q, v = _random_qv(rng, g1_iface.info.nj)
        M_ref = np.asarray(mass_matrix(g1_iface.model, jnp.asarray(q)))
        n_ref = np.asarray(nonlinear_effects(g1_iface.model, jnp.asarray(q), jnp.asarray(v)))
        M, n = mass_and_nle_np(hm, q, v)
        np.testing.assert_allclose(M, M_ref, atol=1e-9, rtol=1e-9)
        np.testing.assert_allclose(n, n_ref, atol=1e-9, rtol=1e-9)


def test_frame_jacobian_and_dot_parity(g1_iface, hm):
    import jax.numpy as jnp

    from bipedal_nmpc.model.host_dynamics import (
        frame_jacobians_np,
        host_kinematics_np,
    )
    from bipedal_nmpc.model.kinematics import frame_jacobian, frame_jacobian_dot

    rng = np.random.default_rng(4)
    q, v = _random_qv(rng, g1_iface.info.nj)
    kin = host_kinematics_np(hm, q, v)
    fids = tuple(hm.contact_frame_ids) + (hm.base_frame_id,)
    J, dJ, _, _ = frame_jacobians_np(hm, kin, fids)
    for k, fid in enumerate(fids):
        J_ref = np.asarray(frame_jacobian(g1_iface.model, jnp.asarray(q), fid))
        dJ_ref = np.asarray(
            frame_jacobian_dot(g1_iface.model, jnp.asarray(q), jnp.asarray(v), fid)
        )
        np.testing.assert_allclose(J[k], J_ref, atol=1e-10, rtol=1e-10)
        np.testing.assert_allclose(dJ[k], dJ_ref, atol=1e-9, rtol=1e-9)


def test_cmm_dot_parity(g1_iface, hm):
    import jax
    import jax.numpy as jnp

    from bipedal_nmpc.model.centroidal import centroidal_momentum_matrix
    from bipedal_nmpc.model.host_dynamics import (
        centroidal_momentum_matrix_and_dot_np,
    )

    rng = np.random.default_rng(5)
    q, v = _random_qv(rng, g1_iface.info.nj)
    A_ref, Adot_ref = jax.jvp(
        lambda qq: centroidal_momentum_matrix(g1_iface.model, qq),
        (jnp.asarray(q),),
        (jnp.asarray(v),),
    )
    A, Adot = centroidal_momentum_matrix_and_dot_np(hm, q, v)
    np.testing.assert_allclose(A, np.asarray(A_ref), atol=1e-9, rtol=1e-9)
    np.testing.assert_allclose(Adot, np.asarray(Adot_ref), atol=1e-8, rtol=1e-8)


def test_desired_side_conversions_parity(g1_iface, hm):
    import jax.numpy as jnp

    from bipedal_nmpc.model.centroidal import (
        base_kinematics_from_centroidal,
        generalized_velocity_from_state_input,
        normalized_momentum_rate,
    )
    from bipedal_nmpc.model.host_dynamics import (
        base_kinematics_from_centroidal_np,
        generalized_velocity_from_state_input_np,
        normalized_momentum_rate_np,
    )

    rng = np.random.default_rng(6)
    for _ in range(3):
        x, u = _random_xu(rng, g1_iface)
        v_ref = np.asarray(
            generalized_velocity_from_state_input(
                g1_iface.model, g1_iface.info, jnp.asarray(x), jnp.asarray(u)
            )
        )
        np.testing.assert_allclose(
            generalized_velocity_from_state_input_np(hm, x, u), v_ref, atol=1e-9, rtol=1e-9
        )
        h_ref = np.asarray(
            normalized_momentum_rate(g1_iface.model, g1_iface.info, jnp.asarray(x), jnp.asarray(u))
        )
        np.testing.assert_allclose(
            normalized_momentum_rate_np(hm, x, u), h_ref, atol=1e-10, rtol=1e-10
        )
        pose_r, vel_r, acc_r = base_kinematics_from_centroidal(
            g1_iface.model, g1_iface.info, jnp.asarray(x), jnp.asarray(u),
            jnp.zeros(g1_iface.info.nj),
        )
        pose, vel, acc = base_kinematics_from_centroidal_np(hm, x, u)
        np.testing.assert_allclose(pose, np.asarray(pose_r), atol=1e-10)
        np.testing.assert_allclose(vel, np.asarray(vel_r), atol=1e-9)
        np.testing.assert_allclose(acc, np.asarray(acc_r), atol=1e-7, rtol=1e-7)


def test_wbc_kinematics_parity(g1_iface, hm):
    import jax.numpy as jnp

    from bipedal_nmpc.wbc.host_wbc import compute_wbc_kinematics_np
    from bipedal_nmpc.wbc.tasks import compute_wbc_kinematics

    rng = np.random.default_rng(7)
    x, u = _random_xu(rng, g1_iface)
    rbd = _random_rbd(rng, g1_iface.info.nj)
    ref = compute_wbc_kinematics(
        g1_iface.model, g1_iface.info, jnp.asarray(x), jnp.asarray(u), jnp.asarray(rbd)
    )
    got = compute_wbc_kinematics_np(hm, x, u, rbd)
    for name in got._fields:
        np.testing.assert_allclose(
            np.asarray(getattr(got, name)), np.asarray(getattr(ref, name)),
            atol=1e-8, rtol=1e-8, err_msg=name,
        )


def test_full_wbc_parity(g1_iface):
    """Cold-started host WBC == jitted JAX WBC (identical iterations)."""
    import jax.numpy as jnp

    from bipedal_nmpc.runtime.controller import wbc_config_from_task
    from bipedal_nmpc.wbc.host_wbc import HostWbc
    from bipedal_nmpc.wbc.weighted_wbc import wbc_update

    cfg = wbc_config_from_task(g1_iface.task)
    host = HostWbc(g1_iface.model, g1_iface.info, cfg)
    rng = np.random.default_rng(8)
    for flags in ([1.0, 1.0, 1.0, 1.0], [0.0, 0.0, 1.0, 1.0]):
        x, u = _random_xu(rng, g1_iface)
        rbd = _random_rbd(rng, g1_iface.info.nj)
        ref = wbc_update(
            g1_iface.model, g1_iface.info, cfg,
            jnp.asarray(x), jnp.asarray(u), jnp.asarray(rbd), jnp.asarray(flags),
        )
        host.reset()
        got = host.update(x, u, rbd, flags, warm=False)
        # the two KKT factorizations differ (host LU vs device pivot-free GJ);
        # 120 contractive iterations keep the gap at rounding level
        np.testing.assert_allclose(
            got.decision, np.asarray(ref.decision), atol=1e-7, rtol=1e-6
        )
        np.testing.assert_allclose(got.torque, np.asarray(ref.torque), atol=1e-7, rtol=1e-6)


def test_native_model_parity(g1_iface, hm):
    """C++ kernel (native/host_model.cc) == numpy twin, full kinematics +
    observation, random states (the chain C++ == numpy == JAX)."""
    from bipedal_nmpc.model.host_model import centroidal_state_from_rbd_np
    from bipedal_nmpc.model.native_model import make_native_model
    from bipedal_nmpc.wbc.host_wbc import compute_wbc_kinematics_np

    nm = make_native_model(hm)
    assert nm is not None, "C++ toolchain expected in CI"
    rng = np.random.default_rng(11)
    for _ in range(4):
        x, u = _random_xu(rng, g1_iface)
        rbd = _random_rbd(rng, g1_iface.info.nj)
        np.testing.assert_allclose(
            nm.observation(rbd), centroidal_state_from_rbd_np(hm, rbd),
            atol=1e-12, rtol=1e-12,
        )
        ref = compute_wbc_kinematics_np(hm, x, u, rbd)
        got = nm.wbc_kinematics(x, u, rbd)
        for name in ref._fields:
            np.testing.assert_allclose(
                np.asarray(getattr(got, name)), np.asarray(getattr(ref, name)),
                atol=1e-9, rtol=1e-9, err_msg=name,
            )


def test_warm_start_converges(g1_iface):
    """Warm-started ticks reach the cold-start solution on a slowly varying
    QP (the qpOASES hot-start role)."""
    from bipedal_nmpc.runtime.controller import wbc_config_from_task
    from bipedal_nmpc.wbc.host_wbc import HostWbc

    cfg = wbc_config_from_task(g1_iface.task)
    host = HostWbc(g1_iface.model, g1_iface.info, cfg, warm_iters=40)
    rng = np.random.default_rng(9)
    x, u = _random_xu(rng, g1_iface)
    rbd = _random_rbd(rng, g1_iface.info.nj)
    flags = [1.0, 1.0, 1.0, 1.0]
    cold = host.update(x, u, rbd, flags, warm=False).decision
    # drift the problem slightly and tick twice with warm starts
    x2 = x + 1e-3
    warm = host.update(x2, u, rbd, flags).decision
    host.reset()
    cold2 = host.update(x2, u, rbd, flags, warm=False).decision
    assert np.linalg.norm(warm - cold2) < 5e-2 * max(1.0, np.linalg.norm(cold2))
    assert np.linalg.norm(cold - cold2) < 20.0  # sanity: problems are close
