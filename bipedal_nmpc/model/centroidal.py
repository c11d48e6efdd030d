"""Centroidal model: momentum matrix, dynamics, state conversions.

JAX replacement for the reference's external `ocs2_centroidal_model`
(CentroidalModelInfo / PinocchioCentroidalDynamicsAD / AccessHelperFunctions /
CentroidalModelRbdConversions — see SURVEY.md §2.3), with derivatives by JAX
autodiff instead of CppAD codegen.

Conventions (FullCentroidalDynamics, centroidalModelType 0 in task.info):

    state  x = [h_com/m (6: v_com, L/m), basePose (6: xyz + euler-zyx), q_j (nj)]
    input  u = [F_contact (3*n_c, world frame), v_joints (nj)]
    rbdState = [euler_zyx(3), base pos(3), q_j, omega_world(3), v_base_world(3), dq_j]

The centroidal momentum matrix A(q) maps generalized velocity (Euler-rate
convention) to the centroidal momentum [linear; angular] about the whole-body
com, world-aligned:

    A(q) = sum_b [ m_b Jv_cb ; R_b I_b R_b^T Jw_b + m_b skew(c_b - c) Jv_cb ]
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..utils.rotations import (
    euler_rate_map_zyx,
    global_angular_velocity_from_zyx_rates,
    skew,
    zyx_rates_from_global_angular_velocity,
)
from .kinematics import (
    body_com_positions,
    forward_kinematics,
    frame_position,
    frame_transform,
    point_jacobian,
)
from .robot_model import RobotModel

GRAVITY_VECTOR = (0.0, 0.0, -9.81)


@dataclasses.dataclass(frozen=True)
class CentroidalModelInfo:
    """Static problem-size metadata (reference: CentroidalModelInfo).

    model_type mirrors task.info centroidalModelType: 0 = FullCentroidalDynamics
    (momentum matrix at the actual configuration), 1 = SingleRigidBodyDynamics
    (momentum matrix at the nominal joint configuration ``q_j_nominal`` with
    zero joint columns — the robot's momentum is that of one rigid body whose
    inertia is locked at the default pose, while contact kinematics still use
    the true joint angles).  The reference parses the knob at task.info:1 and
    passes the initial state as the nominal configuration
    (BipedalRobotInterface.cpp:120-123)."""

    nj: int
    contact_frame_ids: tuple[int, ...]  # 3-DoF contact frames
    robot_mass: float
    model_type: int = 0
    q_j_nominal: tuple[float, ...] = ()

    @property
    def num_contacts(self) -> int:
        return len(self.contact_frame_ids)

    @property
    def state_dim(self) -> int:
        return 12 + self.nj

    @property
    def input_dim(self) -> int:
        return 3 * self.num_contacts + self.nj

    @property
    def generalized_dim(self) -> int:
        return 6 + self.nj


def make_info(
    model: RobotModel,
    contact_frame_names: list[str],
    model_type: int = 0,
    q_j_nominal: tuple[float, ...] = (),
) -> CentroidalModelInfo:
    if model_type == 1 and len(q_j_nominal) != model.nj:
        raise ValueError("SingleRigidBodyDynamics needs a nominal joint configuration")
    return CentroidalModelInfo(
        nj=model.nj,
        contact_frame_ids=tuple(model.frame_index(n) for n in contact_frame_names),
        robot_mass=float(model.total_mass),
        model_type=model_type,
        q_j_nominal=tuple(float(v) for v in q_j_nominal),
    )


def momentum_coordinates(info: CentroidalModelInfo, q):
    """Configuration at which momentum quantities (CMM, com) are evaluated:
    q itself for the full model, [basePose, q_j_nominal] for SRBD."""
    if info.model_type == 1:
        return jnp.concatenate([q[..., :6], jnp.asarray(info.q_j_nominal, dtype=q.dtype)])
    return q


def centroidal_momentum_matrix_info(model: RobotModel, info: CentroidalModelInfo, q):
    """Model-type-aware A(q): SRBD locks the inertia at the nominal joint
    pose and carries no joint momentum (zero joint columns)."""
    A = centroidal_momentum_matrix(model, momentum_coordinates(info, q))
    if info.model_type == 1:
        A = jnp.concatenate([A[:, :6], jnp.zeros_like(A[:, 6:])], axis=1)
    return A


# ---------------------------------------------------------------- access
def get_normalized_momentum(x):
    return x[..., 0:6]


def get_base_pose(x):
    return x[..., 6:12]


def get_generalized_coordinates(x):
    """q = [base pos, euler-zyx, q_j] from the centroidal state."""
    return x[..., 6:]


def get_joint_positions(x, info: CentroidalModelInfo):
    return x[..., 12 : 12 + info.nj]


def get_contact_force(u, contact_index: int):
    return u[..., 3 * contact_index : 3 * contact_index + 3]


def get_contact_forces(u, info: CentroidalModelInfo):
    return u[..., : 3 * info.num_contacts].reshape(*u.shape[:-1], info.num_contacts, 3)


def get_joint_velocities(u, info: CentroidalModelInfo):
    return u[..., 3 * info.num_contacts :]


def assemble_state(h_norm, base_pose, q_j):
    return jnp.concatenate([h_norm, base_pose, q_j], axis=-1)


def assemble_input(forces_flat, v_j):
    return jnp.concatenate([forces_flat, v_j], axis=-1)


# ---------------------------------------------------------------- CMM
def rotate_inertia(R, I):
    """R_b I_b R_b^T for stacked bodies via broadcast-reduce (vectorizes over any batch).

    R: (..., nb, 3, 3); I: (nb, 3, 3) -> (..., nb, 3, 3)."""
    tmp = jnp.sum(R[..., :, :, None] * I[..., None, :, :], axis=-2)  # R @ I
    # (R I) R^T: out[b,i,l] = sum_k tmp[b,i,k] R[b,l,k]
    return jnp.sum(tmp[..., :, :, None] * R.swapaxes(-1, -2)[..., None, :, :], axis=-2)


def centroidal_momentum_matrix(model: RobotModel, q):
    """A(q): (6, nv) mapping v -> [p_com_dot * m ; L_world_about_com],
    assembled from stacked body-com Jacobians."""
    from .kinematics import stacked_point_jacobians

    kin = forward_kinematics(model, q)
    coms = body_com_positions(model, kin)
    com = jnp.sum(model.body_mass[:, None] * coms, axis=0) / model.total_mass
    J = stacked_point_jacobians(model, kin, coms, model.ancestor_mask())  # (nb,6,nv)
    Jv, Jw = J[:, :3, :], J[:, 3:, :]
    # contractions over 3/nb-sized axes as broadcast-multiply-reduce: under a
    # scenario-batch vmap, einsum lowers these to batched tiny-dim dot_general
    # (padded per batch element); explicit reduces fuse.
    I_w = rotate_inertia(kin.R, model.body_inertia)
    A_lin = jnp.sum(model.body_mass[:, None, None] * Jv, axis=0)
    rel = coms - com  # (nb, 3)
    cross_term = jnp.cross(rel[:, None, :], Jv.transpose(0, 2, 1)).transpose(0, 2, 1)
    A_ang = jnp.sum(
        I_w[:, :, :, None] * Jw[:, None, :, :], axis=(0, 2)
    ) + jnp.sum(model.body_mass[:, None, None] * cross_term, axis=0)
    return jnp.concatenate([A_lin, A_ang], axis=0)


def centroidal_momentum_matrix_dot(model: RobotModel, q, v):
    """dA/dt along (q, v) — replaces pinocchio::dccrba (WbcBase.cpp:225-232)."""
    _, Adot = jax.jvp(lambda qq: centroidal_momentum_matrix(model, qq), (q,), (v,))
    return Adot


def generalized_velocity_from_state_input(model: RobotModel, info: CentroidalModelInfo, x, u):
    """v = [v_base; v_j] with v_base = A_b^{-1} (m h_norm - A_j v_j)
    (CentroidalModelPinocchioMapping::getPinocchioJointVelocity semantics)."""
    q = get_generalized_coordinates(x)
    h = info.robot_mass * get_normalized_momentum(x)
    v_j = get_joint_velocities(u, info)
    A = centroidal_momentum_matrix_info(model, info, q)
    A_b, A_j = A[:, :6], A[:, 6:]
    # block-Schur closed-form inverse: batched pivoted LU vectorizes poorly
    from ..ops.linalg import inv6_block

    from ..ops.contract import mv

    v_b = mv(inv6_block(A_b), h - mv(A_j, v_j))
    return jnp.concatenate([v_b, v_j])


def normalized_momentum_rate(model: RobotModel, info: CentroidalModelInfo, x, u):
    """d/dt (h/m): gravity + contact forces and torques about the com."""
    q = get_generalized_coordinates(x)
    kin = forward_kinematics(model, q)
    # SRBD: torque arm about the locked-inertia com (nominal joint pose)
    kin_m = kin if info.model_type == 0 else forward_kinematics(model, momentum_coordinates(info, q))
    coms = body_com_positions(model, kin_m)
    com = jnp.sum(model.body_mass[:, None] * coms, axis=0) / model.total_mass
    g = jnp.asarray(GRAVITY_VECTOR)
    forces = get_contact_forces(u, info)  # (nc, 3)
    lin = g + jnp.sum(forces, axis=0) / info.robot_mass
    ang = jnp.zeros(3)
    for i, fid in enumerate(info.contact_frame_ids):
        p_i = frame_position(model, kin, fid)
        ang = ang + jnp.cross(p_i - com, forces[i])
    return jnp.concatenate([lin, ang / info.robot_mass])


def centroidal_flow_map(model: RobotModel, info: CentroidalModelInfo, x, u):
    """Continuous dynamics xdot = f(x, u) of the full centroidal model
    (reference: BipedalRobotDynamicsAD / PinocchioCentroidalDynamicsAD)."""
    h_dot = normalized_momentum_rate(model, info, x, u)
    v = generalized_velocity_from_state_input(model, info, x, u)
    return jnp.concatenate([h_dot, v])


# ---------------------------------------------------------------- rbd conversions
def generalized_from_rbd(info: CentroidalModelInfo, rbd_state):
    """(q, v) generalized coordinates from an rbdState vector."""
    nj = info.nj
    ngen = 6 + nj
    euler = rbd_state[0:3]
    pos = rbd_state[3:6]
    q_j = rbd_state[6 : 6 + nj]
    omega_w = rbd_state[ngen : ngen + 3]
    v_lin = rbd_state[ngen + 3 : ngen + 6]
    dq_j = rbd_state[ngen + 6 :]
    q = jnp.concatenate([pos, euler, q_j])
    euler_rates = zyx_rates_from_global_angular_velocity(euler, omega_w)
    v = jnp.concatenate([v_lin, euler_rates, dq_j])
    return q, v


def centroidal_state_from_rbd(model: RobotModel, info: CentroidalModelInfo, rbd_state):
    """rbdState -> centroidal state x
    (CentroidalModelRbdConversions::computeCentroidalStateFromRbdModel,
    consumed at BipedalController.cpp:402)."""
    q, v = generalized_from_rbd(info, rbd_state)
    A = centroidal_momentum_matrix_info(model, info, q)
    h_norm = (A @ v) / info.robot_mass
    return jnp.concatenate([h_norm, q])


def rbd_state_from_centroidal(model: RobotModel, info: CentroidalModelInfo, x, u):
    """Centroidal (x, u) -> rbdState (inverse of the above)."""
    q = get_generalized_coordinates(x)
    v = generalized_velocity_from_state_input(model, info, x, u)
    euler = q[3:6]
    omega_w = global_angular_velocity_from_zyx_rates(euler, v[3:6])
    return jnp.concatenate([euler, q[0:3], q[6:], omega_w, v[0:3], v[6:]])


def base_kinematics_from_centroidal(model: RobotModel, info: CentroidalModelInfo, x, u, joint_accel):
    """(basePose, baseVelocity, baseAcceleration), all world-frame with angular
    parts as true angular velocity/acceleration
    (CentroidalModelRbdConversions::computeBaseKinematicsFromCentroidalModel,
    used by the WBC base-accel PD task, WbcBase.cpp:254-259)."""
    q = get_generalized_coordinates(x)
    v = generalized_velocity_from_state_input(model, info, x, u)
    base_pose = q[0:6]
    euler, euler_rates = q[3:6], v[3:6]
    omega_w = global_angular_velocity_from_zyx_rates(euler, euler_rates)
    base_velocity = jnp.concatenate([v[0:3], omega_w])

    # differentiate h = A v: A_b vdot_b = m hdot_norm - Adot v - A_j vdot_j
    A = centroidal_momentum_matrix_info(model, info, q)
    Adot = jax.jvp(lambda qq: centroidal_momentum_matrix_info(model, info, qq), (q,), (v,))[1]
    h_dot = info.robot_mass * normalized_momentum_rate(model, info, x, u)
    rhs = h_dot - Adot @ v - A[:, 6:] @ joint_accel
    vdot_b = jnp.linalg.solve(A[:, :6], rhs)
    # angular acceleration from Euler-rate acceleration:
    # omega = E(theta) theta_dot  =>  omega_dot = E theta_ddot + Edot theta_dot
    _, Edot = jax.jvp(lambda th: euler_rate_map_zyx(th), (euler,), (euler_rates,))
    omega_dot = euler_rate_map_zyx(euler) @ vdot_b[3:6] + Edot @ euler_rates
    base_acceleration = jnp.concatenate([vdot_b[0:3], omega_dot])
    return base_pose, base_velocity, base_acceleration


def contact_positions(model: RobotModel, info: CentroidalModelInfo, q):
    """(nc, 3) world positions of the contact frames."""
    kin = forward_kinematics(model, q)
    return jnp.stack([frame_position(model, kin, fid) for fid in info.contact_frame_ids])


def contact_rotations(model: RobotModel, info: CentroidalModelInfo, q):
    kin = forward_kinematics(model, q)
    return jnp.stack([frame_transform(model, kin, fid)[0] for fid in info.contact_frame_ids])
