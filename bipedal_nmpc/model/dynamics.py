"""Joint-space dynamics: mass matrix, nonlinear effects, energies.

Replaces Pinocchio ``crba`` + ``nonLinearEffects`` as used by the reference
WBC (bipedal_wbc/src/WbcBase.cpp:92-103).

Because our generalized coordinates are true Lagrangian coordinates (the
floating base uses Euler-*rate* velocities, i.e. v = dq/dt exactly), the
nonlinear effects follow from the Lagrangian identity

    nle(q, v) = d/dt(M(q)) v  -  grad_q (1/2 v^T M(q) v)  +  grad_q PE(q)

with both directional derivatives taken by autodiff — no spatial-algebra
recursion needed, and the result is exact for our coordinates.  The mass
matrix itself is assembled from body com Jacobians:

    M(q) = sum_b [ m_b Jv_b^T Jv_b  +  Jw_b^T (R_b I_b R_b^T) Jw_b ]
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .kinematics import (
    BodyKin,
    body_com_positions,
    forward_kinematics,
    stacked_point_jacobians,
)
from .robot_model import RobotModel

GRAVITY = 9.81


def _body_com_jacobians(model: RobotModel, kin: BodyKin):
    """(nb, 6, nv) Jacobians at every body's com, one stacked tensor op."""
    coms = body_com_positions(model, kin)
    return stacked_point_jacobians(model, kin, coms, model.ancestor_mask())


def mass_matrix(model: RobotModel, q):
    """(nv, nv) joint-space inertia matrix: two einsums over stacked body
    Jacobians (one batched product instead of a per-body loop)."""
    kin = forward_kinematics(model, q)
    J = _body_com_jacobians(model, kin)  # (nb, 6, nv)
    Jv, Jw = J[:, :3, :], J[:, 3:, :]
    I_w = jnp.einsum("bij,bjk,blk->bil", kin.R, model.body_inertia, kin.R)
    M = jnp.einsum("b,biv,biw->vw", model.body_mass, Jv, Jv)
    M = M + jnp.einsum("biv,bij,bjw->vw", Jw, I_w, Jw)
    return M


def potential_energy(model: RobotModel, q):
    kin = forward_kinematics(model, q)
    coms = body_com_positions(model, kin)
    return GRAVITY * jnp.sum(model.body_mass * coms[:, 2])


def kinetic_energy(model: RobotModel, q, v):
    return 0.5 * v @ mass_matrix(model, q) @ v


def gravity_vector(model: RobotModel, q):
    """g(q) = grad_q PE."""
    return jax.grad(lambda qq: potential_energy(model, qq))(q)


def nonlinear_effects(model: RobotModel, q, v):
    """C(q,v) v + g(q)  (Coriolis/centrifugal + gravity)."""
    _, Mdot_v = jax.jvp(lambda qq: mass_matrix(model, qq) @ v, (q,), (v,))
    dKE_dq = jax.grad(lambda qq: 0.5 * v @ mass_matrix(model, qq) @ v)(q)
    return Mdot_v - dKE_dq + gravity_vector(model, q)


def inverse_dynamics(model: RobotModel, q, v, vdot):
    """tau = M(q) vdot + nle(q, v)."""
    return mass_matrix(model, q) @ vdot + nonlinear_effects(model, q, v)


def forward_dynamics(model: RobotModel, q, v, tau):
    """vdot = M(q)^{-1} (tau - nle)."""
    M = mass_matrix(model, q)
    return jnp.linalg.solve(M, tau - nonlinear_effects(model, q, v))
