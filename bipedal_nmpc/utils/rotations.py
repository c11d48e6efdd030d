"""Euler-ZYX rotation utilities (JAX, batch-friendly).

The whole stack parametrizes the floating base with extrinsic-fixed-axis /
intrinsic z-y'-x'' Euler angles stored as ``theta = (yaw_z, pitch_y, roll_x)``,
matching the reference's centroidal-model convention (state layout
``basePose = [xyz, theta_z, theta_y, theta_x]``; see
bipedal_robot_example/unitree_h1/h1_ocs2_config/config/task/task.info:191-197
and bipedal_wbc/src/WbcBase.cpp:58-77).

Crucially, the generalized velocity of the base orientation is the Euler-angle
*time derivative*, not the angular velocity; the maps between the two live
here (reference: ocs2_robotic_tools RotationTransforms used at
WbcBase.cpp:67-77, 239-293).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def rot_x(a):
    c, s = jnp.cos(a), jnp.sin(a)
    return jnp.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])


def rot_y(a):
    c, s = jnp.cos(a), jnp.sin(a)
    return jnp.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def rot_z(a):
    c, s = jnp.cos(a), jnp.sin(a)
    return jnp.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def rotmat_from_zyx(theta):
    """R = Rz(theta[0]) @ Ry(theta[1]) @ Rx(theta[2])."""
    return rot_z(theta[0]) @ rot_y(theta[1]) @ rot_x(theta[2])


def zyx_from_rotmat(R):
    """Inverse of :func:`rotmat_from_zyx` (pitch in (-pi/2, pi/2) branch)."""
    yaw = jnp.arctan2(R[1, 0], R[0, 0])
    pitch = jnp.arctan2(-R[2, 0], jnp.sqrt(R[0, 0] ** 2 + R[1, 0] ** 2))
    roll = jnp.arctan2(R[2, 1], R[2, 2])
    return jnp.stack([yaw, pitch, roll])


def euler_rate_map_zyx(theta):
    """E(theta) with omega_world = E(theta) @ theta_dot.

    Columns are the world-frame rotation axes of each Euler coordinate:
    [z_hat | Rz @ y_hat | Rz @ Ry @ x_hat].
    """
    z, y, _ = theta[0], theta[1], theta[2]
    cz, sz = jnp.cos(z), jnp.sin(z)
    cy, sy = jnp.cos(y), jnp.sin(y)
    return jnp.array(
        [
            [0.0, -sz, cy * cz],
            [0.0, cz, cy * sz],
            [1.0, 0.0, -sy],
        ]
    )


def global_angular_velocity_from_zyx_rates(theta, theta_dot):
    return euler_rate_map_zyx(theta) @ theta_dot


def zyx_rates_from_global_angular_velocity(theta, omega_world):
    """Inverse map; singular at pitch = +-pi/2 (gimbal lock), like the reference."""
    return jnp.linalg.solve(euler_rate_map_zyx(theta), omega_world)


def euler_rate_map_zyx_inv(theta):
    """Closed-form inverse of E(theta)."""
    z, y, _ = theta[0], theta[1], theta[2]
    cz, sz = jnp.cos(z), jnp.sin(z)
    cy, sy = jnp.cos(y), jnp.sin(y)
    ty = sy / cy
    return jnp.array(
        [
            [cz * ty, sz * ty, 1.0],
            [-sz, cz, 0.0],
            [cz / cy, sz / cy, 0.0],
        ]
    )


def skew(v):
    """3-vector -> so(3) matrix such that skew(a) @ b = a x b."""
    return jnp.array(
        [
            [0.0, -v[2], v[1]],
            [v[2], 0.0, -v[0]],
            [-v[1], v[0], 0.0],
        ]
    )


def unskew(S):
    return jnp.stack([S[2, 1], S[0, 2], S[1, 0]])


def rotation_matrix_to_rotation_vector(R):
    """Matrix log of SO(3), Taylor-safe near the identity."""
    trace = R[0, 0] + R[1, 1] + R[2, 2]
    cos_angle = jnp.clip(0.5 * (trace - 1.0), -1.0, 1.0)
    angle = jnp.arccos(cos_angle)
    axis_raw = jnp.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    # sin(angle) ~ angle for small angles: use series 0.5 * (1 + angle^2/6) factor.
    small = angle < 1e-6
    factor = jnp.where(
        small,
        0.5 * (1.0 + angle * angle / 6.0),
        0.5 * angle / jnp.sin(jnp.where(small, 1.0, angle)),
    )
    return factor * axis_raw


def rotation_error_in_world(R_desired, R_measured):
    """World-frame orientation error used by the WBC base-accel PD task
    (reference: WbcBase.cpp:272-276)."""
    return rotation_matrix_to_rotation_vector(R_desired @ R_measured.T)


def wrap_to_pi(a):
    return jnp.mod(a + jnp.pi, 2.0 * jnp.pi) - jnp.pi


def unwrap_near(angle, reference_angle):
    """Shift ``angle`` by multiples of 2*pi to land nearest ``reference_angle``
    (yaw-unwrap semantics of BipedalController.cpp:400-403)."""
    return reference_angle + wrap_to_pi(angle - reference_angle)


def quat_wxyz_to_rotmat(q):
    """Unit quaternion (w, x, y, z) -> rotation matrix."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    return jnp.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def zyx_from_quat_wxyz(q):
    return zyx_from_rotmat(quat_wxyz_to_rotmat(q))


def rpy_to_rotmat(rpy):
    """URDF <origin rpy> fixed-axis XYZ convention: R = Rz(y) @ Ry(p) @ Rx(r)."""
    return rot_z(rpy[2]) @ rot_y(rpy[1]) @ rot_x(rpy[0])
