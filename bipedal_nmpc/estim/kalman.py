"""Contact-aided linear Kalman filter for base state estimation.

The reference *declares* this estimator but ships an empty implementation
(bipedal_estimation KalmanFilterEstimate, LinearKalmanFilter.h:27-67 with a
0-byte .cpp — SURVEY.md §2 item 21); this is the working JAX version.

Standard legged-robot contact LKF (orientation taken from the IMU as known):

    state  z = [p_base(3), v_base(3), p_foot_i(3) * nc]       (3 + 3 + 3nc)
    predict: p += dt v + 0.5 dt^2 a_w,  v += dt a_w,  feet static
             a_w = R_wb a_imu + g
    update : per contact in stance, measure the leg-kinematics relative foot
             position  (p_foot_i - p_base)  and foot velocity  (-J dq - ...)
             plus a foot-height pseudo-measurement z_foot = terrain height.

Swing feet get their process noise inflated so they re-converge at touchdown,
exactly the classic MIT-Cheetah / ETH formulation.  Pure JAX, jittable,
batched under vmap for scenario sweeps.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax.numpy as jnp

from ..model.kinematics import forward_kinematics, frame_jacobian, frame_position

NUM_CONTACTS = 4


@dataclasses.dataclass(frozen=True)
class KalmanConfig:
    dt: float = 0.0025
    sigma_accel: float = 0.5  # process accel noise
    sigma_foot_process: float = 1e-3  # stance foot random walk
    sigma_foot_swing: float = 1e2  # swing foot (decouples the measurement)
    sigma_kin_meas: float = 1e-3  # relative-position measurement noise
    sigma_vel_meas: float = 1e-2  # leg-odometry velocity measurement noise
    sigma_height_meas: float = 1e-3  # foot-height pseudo measurement
    terrain_height: float = 0.0


class KalmanState(NamedTuple):
    z: jnp.ndarray  # (6 + 3nc,)
    P: jnp.ndarray  # covariance


def _dim():
    return 6 + 3 * NUM_CONTACTS


def kalman_init(p0, v0, foot_positions) -> KalmanState:
    z = jnp.concatenate([p0, v0, foot_positions.reshape(-1)])
    return KalmanState(z=z, P=jnp.eye(_dim()) * 1e-2)


def kalman_update(
    model,
    info,
    cfg: KalmanConfig,
    state: KalmanState,
    R_wb,  # (3,3) base orientation from IMU
    accel_imu,  # (3,) proper acceleration in IMU/base frame
    euler_zyx,  # (3,) base orientation (for kinematics)
    omega_world,  # (3,)
    joint_pos,  # (nj,)
    joint_vel,  # (nj,)
    contact_flags,  # (nc,) float 0/1
) -> KalmanState:
    n = _dim()
    dt = cfg.dt
    g = jnp.array([0.0, 0.0, -9.81])
    a_w = R_wb @ accel_imu + g

    # --- predict
    F = jnp.eye(n).at[0:3, 3:6].set(dt * jnp.eye(3))
    z_pred = state.z
    z_pred = z_pred.at[0:3].add(dt * state.z[3:6] + 0.5 * dt * dt * a_w)
    z_pred = z_pred.at[3:6].add(dt * a_w)
    Qp = jnp.zeros((n, n))
    Qp = Qp.at[0:3, 0:3].set((0.5 * dt * dt * cfg.sigma_accel) ** 2 * jnp.eye(3))
    Qp = Qp.at[3:6, 3:6].set((dt * cfg.sigma_accel) ** 2 * jnp.eye(3))
    for i in range(NUM_CONTACTS):
        s = 6 + 3 * i
        sig = contact_flags[i] * cfg.sigma_foot_process + (1 - contact_flags[i]) * cfg.sigma_foot_swing
        Qp = Qp.at[s : s + 3, s : s + 3].set((dt * sig) ** 2 * jnp.eye(3))
    P_pred = F @ state.P @ F.T + Qp

    # --- measurements: leg kinematics at the *estimated* base pose
    # relative foot position r_i(q_joints) in world axes (base orientation known)
    q_kin = jnp.concatenate([jnp.zeros(3), euler_zyx, joint_pos])
    kin = forward_kinematics(model, q_kin)
    H_rows, y_rows, R_diag = [], [], []
    for i, fid in enumerate(info.contact_frame_ids):
        r_i = frame_position(model, kin, fid)  # base at origin -> relative position
        s = 6 + 3 * i
        # measurement 1: p_foot - p_base = r_i
        H1 = jnp.zeros((3, n)).at[:, 0:3].set(-jnp.eye(3)).at[:, s : s + 3].set(jnp.eye(3))
        y1 = r_i - (z_pred[s : s + 3] - z_pred[0:3])
        sig1 = contact_flags[i] * cfg.sigma_kin_meas + (1 - contact_flags[i]) * 1e3
        # measurement 2: stance foot world velocity == 0 ->
        # v_base = -(J_j dq + omega x r)
        J = frame_jacobian(model, q_kin, fid)
        v_rel = J[:3, 6:] @ joint_vel + jnp.cross(omega_world, r_i)
        H2 = jnp.zeros((3, n)).at[:, 3:6].set(jnp.eye(3))
        y2 = -v_rel - z_pred[3:6]
        sig2 = contact_flags[i] * cfg.sigma_vel_meas + (1 - contact_flags[i]) * 1e3
        # measurement 3: stance foot height == terrain
        H3 = jnp.zeros((1, n)).at[0, s + 2].set(1.0)
        y3 = jnp.array([cfg.terrain_height - z_pred[s + 2]])
        sig3 = contact_flags[i] * cfg.sigma_height_meas + (1 - contact_flags[i]) * 1e3
        H_rows += [H1, H2, H3]
        y_rows += [y1, y2, y3]
        R_diag += [sig1**2 * jnp.ones(3), sig2**2 * jnp.ones(3), sig3**2 * jnp.ones(1)]

    H = jnp.concatenate(H_rows, axis=0)
    y = jnp.concatenate(y_rows)
    Rm = jnp.diag(jnp.concatenate(R_diag))
    S = H @ P_pred @ H.T + Rm
    K = jnp.linalg.solve(S, H @ P_pred).T
    z_new = z_pred + K @ y
    P_new = (jnp.eye(n) - K @ H) @ P_pred
    return KalmanState(z=z_new, P=0.5 * (P_new + P_new.T))
