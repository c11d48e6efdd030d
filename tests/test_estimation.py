"""State estimation tests: cheater rbdState round-trip + contact LKF convergence."""
import jax
import jax.numpy as jnp
import numpy as np

from bipedal_nmpc.estim import (
    KalmanConfig,
    kalman_init,
    kalman_update,
    rbd_state_from_ground_truth,
)
from bipedal_nmpc.model.centroidal import (
    centroidal_state_from_rbd,
    contact_positions,
    rbd_state_from_centroidal,
)
from bipedal_nmpc.ocp.problem import weight_compensating_input
from bipedal_nmpc.utils.rotations import rotmat_from_zyx


def test_cheater_rbd_roundtrip(h1_model, h1_info, rng):
    """centroidal -> rbd -> centroidal is the identity."""
    x = jnp.asarray(
        np.concatenate([rng.uniform(-0.3, 0.3, 6), rng.uniform(-0.5, 0.5, 6), rng.uniform(-0.5, 0.5, 10)])
    )
    u = jnp.asarray(rng.uniform(-20, 20, h1_info.input_dim))
    rbd = rbd_state_from_centroidal(h1_model, h1_info, x, u)
    x2 = centroidal_state_from_rbd(h1_model, h1_info, rbd)
    np.testing.assert_allclose(np.asarray(x2), np.asarray(x), atol=1e-9)


def test_cheater_from_ground_truth(h1_model, h1_info, rng):
    from scipy.spatial.transform import Rotation

    euler = rng.uniform(-0.5, 0.5, 3)
    R = Rotation.from_euler("ZYX", euler).as_matrix()
    q_xyzw = Rotation.from_matrix(R).as_quat()
    quat = np.array([q_xyzw[3], *q_xyzw[:3]])
    rbd = rbd_state_from_ground_truth(
        np.array([1.0, 2, 0.9]), quat, np.array([0.1, 0, 0]), np.array([0, 0, 0.2]),
        np.zeros(10), np.zeros(10),
    )
    np.testing.assert_allclose(np.asarray(rbd[0:3]), euler, atol=1e-9)
    np.testing.assert_allclose(np.asarray(rbd[3:6]), [1, 2, 0.9], atol=1e-12)


def test_kalman_converges_standing(h1_model, h1_info):
    """Standing still with biased initial estimate: the contact LKF must pull
    base position/velocity back to the truth using leg kinematics."""
    x_nom = jnp.asarray(
        np.concatenate([np.zeros(6), [0, 0, 0.93, 0, 0, 0], [0, 0, -0.5, 1.0, -0.5] * 2])
    )
    q = x_nom[6:]
    feet = contact_positions(h1_model, h1_info, q)
    # terrain height consistent with the true foot height at this posture
    cfg = KalmanConfig(dt=0.0025, terrain_height=float(np.asarray(feet)[:, 2].mean()))
    # truth: base at (0,0,0.93), zero velocity; init estimate offset by 5 cm
    state = kalman_init(
        jnp.asarray([0.05, -0.03, 0.95]), jnp.asarray([0.1, 0.0, -0.05]), feet
    )
    R_wb = rotmat_from_zyx(jnp.zeros(3))
    accel_imu = jnp.asarray([0.0, 0.0, 9.81])  # proper acceleration at rest
    step = jax.jit(
        lambda s: kalman_update(
            h1_model, h1_info, cfg, s, R_wb, accel_imu, jnp.zeros(3), jnp.zeros(3),
            q[6:], jnp.zeros(10), jnp.ones(4),
        )
    )
    for _ in range(1200):
        state = step(state)
    # absolute xy is a gauge freedom of leg odometry; observable quantities:
    # base-to-foot relatives, absolute height (terrain pseudo-measurement),
    # and velocity.
    rel_est = np.asarray(state.z[6:]).reshape(4, 3) - np.asarray(state.z[0:3])
    rel_true = np.asarray(feet) - np.array([0.0, 0.0, 0.93])
    np.testing.assert_allclose(rel_est, rel_true, atol=5e-3)
    np.testing.assert_allclose(float(state.z[2]), 0.93, atol=5e-3)
    np.testing.assert_allclose(np.asarray(state.z[3:6]), 0, atol=1e-2)


def test_weight_compensating_input(h1_info):
    u = weight_compensating_input(h1_info, jnp.asarray([1.0, 1, 0, 0]), h1_info.input_dim)
    f = np.asarray(u[:12]).reshape(4, 3)
    mg = h1_info.robot_mass * 9.81
    np.testing.assert_allclose(f[:2, 2], mg / 2, rtol=1e-12)
    np.testing.assert_allclose(f[2:], 0, atol=1e-12)


def test_kalman_estimator_noise_and_chatter(h1_model, h1_info):
    """Sensor-noise robustness (VERDICT r2 item #7): IMU noise + accel bias
    and CHATTERING contact flags, standing truth.  With flag debounce the
    estimator holds base position error < 0.1 m over 3 s; the debouncer
    passes clean flags through untouched after the hold window."""
    from bipedal_nmpc.estim.estimator import KalmanStateEstimator

    x_nom = np.concatenate([np.zeros(6), [0, 0, 0.93, 0, 0, 0], [0, 0, -0.5, 1.0, -0.5] * 2])
    q = jnp.asarray(x_nom[6:])
    feet = contact_positions(h1_model, h1_info, q)
    terrain = float(np.asarray(feet)[:, 2].mean())

    import dataclasses as _dc

    est = KalmanStateEstimator(h1_model, h1_info, dt=1.0 / 500.0, debounce_ticks=3)
    est.cfg = _dc.replace(est.cfg, terrain_height=terrain)
    quat = np.array([1.0, 0, 0, 0])
    jp, jv = x_nom[12:], np.zeros(10)
    est.reset(quat, jp, base_pos_guess=np.array([0.0, 0.0, 0.93]))

    rng = np.random.default_rng(3)
    accel_bias = np.array([0.08, -0.05, 0.12])  # m/s^2, constant
    err_trace = []
    for k in range(1500):  # 3 s at 500 Hz
        accel = np.array([0.0, 0.0, 9.81]) + accel_bias + rng.normal(0, 0.2, 3)
        gyro = rng.normal(0, 0.02, 3)
        flags = np.ones(4)
        # chatter: each tick, ~10% chance a random foot reads a 1-tick dropout
        if rng.random() < 0.4:
            flags[rng.integers(0, 4)] = 0.0
        rbd = est.update(quat, gyro, accel, jp, jv, flags)
        err_trace.append(np.linalg.norm(rbd[3:6] - np.array([0.0, 0.0, 0.93])))
    err = np.asarray(err_trace)
    assert err[-1] < 0.1, err[-1]
    assert err[500:].max() < 0.1, err[500:].max()
    # the debouncer never let a 1-tick dropout through: the accepted flag
    # state stayed all-stance
    assert est._flag_state is not None and est._flag_state.all()


def test_flag_debounce_semantics():
    """A change must persist debounce_ticks consecutive ticks to pass."""
    from bipedal_nmpc.estim.estimator import KalmanStateEstimator

    class _Shim(KalmanStateEstimator):
        def __init__(self):  # skip model setup; only _debounce is under test
            self.debounce_ticks = 3
            self._flag_state = None
            self._flag_count = np.zeros(4, dtype=int)

    d = _Shim()
    assert d._debounce([1, 1, 1, 1]).tolist() == [1, 1, 1, 1]
    # 2-tick dropout: suppressed
    assert d._debounce([0, 1, 1, 1]).tolist() == [1, 1, 1, 1]
    assert d._debounce([0, 1, 1, 1]).tolist() == [1, 1, 1, 1]
    assert d._debounce([1, 1, 1, 1]).tolist() == [1, 1, 1, 1]
    # sustained change: accepted on the 3rd consecutive tick
    assert d._debounce([0, 1, 1, 1]).tolist() == [1, 1, 1, 1]
    assert d._debounce([0, 1, 1, 1]).tolist() == [1, 1, 1, 1]
    assert d._debounce([0, 1, 1, 1]).tolist() == [0, 1, 1, 1]
