"""Forward kinematics and frame Jacobians (pure JAX, static shapes).

Replaces Pinocchio FK / getFrameJacobian(LOCAL_WORLD_ALIGNED) /
getFrameJacobianTimeVariation as used by the reference WBC and OCP
(bipedal_wbc/src/WbcBase.cpp:79-133, ocs2_bipedal_robot end-effector
kinematics).  The tree is small (<= ~20 moving bodies), so traversal is an
unrolled Python loop at trace time — XLA sees a flat static graph.

Jacobian convention: rows = [linear(3); angular(3)], world-aligned axes,
taken at the frame origin ("LOCAL_WORLD_ALIGNED").  The time-variation
``frame_jacobian_dot`` is the exact d/dt of that Jacobian along (q, v)
via ``jax.jvp``, so ``a_classical = J @ vdot + Jdot @ v`` holds for the
classical point acceleration — this is the self-consistent JAX
replacement for Pinocchio's frame-Jacobian time variation.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.contract import mm, mv
from ..utils.rotations import euler_rate_map_zyx, rotmat_from_zyx, skew
from .robot_model import RobotModel
from .urdf import JOINT_PRISMATIC, JOINT_REVOLUTE


class BodyKin(NamedTuple):
    """World placement of every body frame, plus base Euler-rate map."""

    R: jnp.ndarray  # (nb,3,3)
    p: jnp.ndarray  # (nb,3)
    E: jnp.ndarray  # (3,3) world angular velocity = E @ theta_dot


def _joint_motion(jtype: int, axis, q_i):
    """Rotation matrix and translation of the joint motion."""
    if jtype == JOINT_REVOLUTE:
        c, s = jnp.cos(q_i), jnp.sin(q_i)
        K = skew(axis)
        R = jnp.eye(3) + s * K + (1.0 - c) * (K @ K)
        return R, jnp.zeros(3)
    elif jtype == JOINT_PRISMATIC:
        return jnp.eye(3), axis * q_i
    raise ValueError(f"bad joint type {jtype}")


def forward_kinematics(model: RobotModel, q: jnp.ndarray) -> BodyKin:
    """World placements of all body frames for configuration q (nq,)."""
    theta = q[3:6]
    R_list = [rotmat_from_zyx(theta)]
    p_list = [q[0:3]]
    for j in range(model.nj):
        parent = model.joint_parent_body[j]
        R_off = model.joint_offset_R[j]
        p_off = model.joint_offset_p[j]
        R_m, p_m = _joint_motion(model.joint_type[j], model.joint_axis[j], q[6 + j])
        R_parent, p_parent = R_list[parent], p_list[parent]
        R_joint = mm(R_parent, R_off)
        p_joint = p_parent + mv(R_parent, p_off)
        R_list.append(mm(R_joint, R_m))
        p_list.append(p_joint + mv(R_joint, p_m))
    return BodyKin(R=jnp.stack(R_list), p=jnp.stack(p_list), E=euler_rate_map_zyx(theta))


def frame_transform(model: RobotModel, kin: BodyKin, frame_id: int):
    b = model.frame_body[frame_id]
    R = mm(kin.R[b], model.frame_R[frame_id])
    p = kin.p[b] + mv(kin.R[b], model.frame_p[frame_id])
    return R, p


def frame_position(model: RobotModel, kin: BodyKin, frame_id: int):
    return frame_transform(model, kin, frame_id)[1]


def _joint_world_axes(model: RobotModel, kin: BodyKin):
    """(nj,3) world axis and (nj,3) world anchor point of each moving joint."""
    axes = jnp.sum(kin.R[1:] * model.joint_axis[:, None, :], axis=-1)
    anchors = kin.p[1:]
    return axes, anchors


def stacked_point_jacobians(model: RobotModel, kin: BodyKin, points, ancestor_mask):
    """(m, 6, nv) world-aligned Jacobians for m points at once.

    points: (m, 3) world positions; ancestor_mask: static (m, nj) bool (joint
    j moves point i).  One shot of batched tensor ops instead of per-column
    scatters — this is what keeps the model evaluation vectorization-friendly under
    vmap over (scenarios x horizon nodes).
    """
    import numpy as np

    nj = model.nj
    axes, anchors = _joint_world_axes(model, kin)
    mask = jnp.asarray(np.asarray(ancestor_mask, dtype=np.float64), dtype=points.dtype)
    rev = jnp.asarray(
        np.asarray([t == JOINT_REVOLUTE for t in model.joint_type], dtype=np.float64),
        dtype=points.dtype,
    )

    rel = points[:, None, :] - anchors[None, :, :]  # (m, nj, 3)
    jv_rev = jnp.cross(axes[None, :, :], rel)  # (m, nj, 3)
    jv_joint = rev[None, :, None] * jv_rev + (1.0 - rev)[None, :, None] * axes[None, :, :]
    jv_joint = jv_joint * mask[:, :, None]  # (m, nj, 3)
    jw_joint = (rev[:, None] * axes)[None, :, :] * mask[:, :, None]

    m = points.shape[0]
    r = points - kin.p[0]  # (m, 3)
    # base Euler columns: col i of Jv = E[:, i] x r  (rotation about base origin)
    jv_base_e = jnp.cross(kin.E.T[None, :, :], r[:, None, :])  # (m, 3cols, 3)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=points.dtype), (m, 3, 3))
    Jv = jnp.concatenate(
        [eye, jv_base_e.transpose(0, 2, 1), jv_joint.transpose(0, 2, 1)], axis=2
    )  # (m, 3, nv)
    Jw = jnp.concatenate(
        [
            jnp.zeros((m, 3, 3), dtype=points.dtype),
            jnp.broadcast_to(kin.E, (m, 3, 3)),
            jw_joint.transpose(0, 2, 1),
        ],
        axis=2,
    )
    return jnp.concatenate([Jv, Jw], axis=1)  # (m, 6, nv)


def point_jacobian(model: RobotModel, kin: BodyKin, body_idx: int, p_world):
    """6 x nv world-aligned Jacobian of the point ``p_world`` rigidly attached
    to body ``body_idx`` (body_idx static)."""
    anc = model.ancestor_mask()[body_idx : body_idx + 1]  # (1, nj)
    return stacked_point_jacobians(model, kin, p_world[None], anc)[0]


def frame_jacobian(model: RobotModel, q, frame_id: int):
    """6 x nv LOCAL_WORLD_ALIGNED Jacobian of a named frame."""
    kin = forward_kinematics(model, q)
    _, p = frame_transform(model, kin, frame_id)
    return point_jacobian(model, kin, model.frame_body[frame_id], p)


def frame_jacobian_dot(model: RobotModel, q, v, frame_id: int):
    """Exact time derivative of :func:`frame_jacobian` along (q, v)."""
    _, jdot = jax.jvp(lambda qq: frame_jacobian(model, qq, frame_id), (q,), (v,))
    return jdot


def frame_velocity(model: RobotModel, q, v, frame_id: int):
    """World linear+angular velocity (6,) of a frame."""
    return frame_jacobian(model, q, frame_id) @ v


def com_position(model: RobotModel, kin: BodyKin):
    """Whole-robot com in world frame."""
    coms = body_com_positions(model, kin)
    return jnp.sum(model.body_mass[:, None] * coms, axis=0) / model.total_mass


def body_com_positions(model: RobotModel, kin: BodyKin):
    # broadcast-reduce instead of einsum: fuses under batch vmap
    return kin.p + jnp.sum(kin.R * model.body_com[:, None, :], axis=-1)
