"""Optimal-control-problem assembly: node references, costs, masked constraints.

Static-shape re-expression of the reference OCP
(ocs2_bipedal_robot/src/BipedalRobotInterface.cpp:114-204 and the constraint
classes under src/constraint/): the reference activates/deactivates
constraints per mode via virtual ``isActive(t)``; here every node carries a
**static-shape** residual vector with rows masked by the contact flags, so the
whole horizon linearizes under one ``vmap`` and thousands of scenarios batch.

Equality-residual layout per node (nc = 4 contacts -> 16 rows):
  rows 3i..3i+2  : stance_i ? foot velocity (+ z position-error gain)  : F_i
                   (ZeroVelocityConstraintCppAd / ZeroForceConstraint — these
                   two are complementary per contact, so one 3-row slot each)
  rows 12+i      : swing_i ? v_ee_z - vref_i + gain (p_ee_z - zref_i) : 0
                   (NormalVelocityConstraintCppAd + PreComputation configs)

Inequality (soft, relaxed log-barrier in the cost): friction cone per stance
contact, h = mu Fz - sqrt(Fx^2 + Fy^2 + eps) >= 0 (FrictionConeConstraint.cpp).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..model.centroidal import (
    CentroidalModelInfo,
    centroidal_flow_map,
    get_contact_forces,
    get_generalized_coordinates,
    generalized_velocity_from_state_input,
)
from ..model.kinematics import forward_kinematics, frame_position, point_jacobian
from ..model.robot_model import RobotModel

NUM_CONTACTS = 4
NUM_EQ = 3 * NUM_CONTACTS + NUM_CONTACTS  # 16


@dataclasses.dataclass(frozen=True)
class OcpSettings:
    """Solver-relevant knobs mirroring task.info (sqp / frictionCone blocks)."""

    dt: float = 0.015
    horizon: float = 1.0
    sqp_iterations: int = 1
    friction_coefficient: float = 0.5  # frictionConeSoftConstraint.frictionCoefficient
    barrier_mu: float = 0.1  # relaxed barrier mu
    barrier_delta: float = 5.0  # relaxed barrier delta
    cone_regularization: float = 1e-3  # FrictionConeConstraint::Config::regularization
    # Friction-cone handling: "soft" is the reference's default relaxed
    # log-barrier (BipedalRobotInterface.cpp:181-186); "hard" runs an
    # interior-point continuation across the SQP iterations — mu and the
    # relaxed-barrier switch point delta shrink geometrically each iteration
    # toward (cone_mu_final, cone_delta_final), so the final iterations
    # solve against an (almost) true log barrier and the returned forces
    # satisfy the cone to ~cone_delta_final (the hard-inequality path the
    # reference configures via task.info's ipm block and
    # useAnalyticalGradientsConstraints, FrictionConeConstraint.cpp:59-206).
    # "ipm" runs a PRIMAL-DUAL interior point on the friction cones:
    # explicit per-node slack/dual iterates (s, lambda > 0), condensed
    # Newton terms on the stage quadratics, fraction-to-boundary step caps,
    # and a geometric central-path schedule mu_init -> mu_target — the
    # reference's ocs2 ipm solver role (task.info:86-156), driven by the
    # parsed IpmConfig (config/loader.py).
    cone: str = "soft"
    cone_mu_decay: float = 0.25
    cone_mu_final: float = 1e-3
    cone_delta_final: float = 1e-2
    # cone="ipm" knobs (defaults mirror the reference's ipm block)
    ipm_mu_init: float = 1e-2  # ipm.initialBarrierParameter
    ipm_mu_target: float = 1e-4  # ipm.targetBarrierParameter
    ipm_mu_decay: float = 0.2  # ipm.barrierLinearDecreaseFactor
    ipm_fraction_to_boundary: float = 0.995  # ipm.fractionToBoundaryMargin
    # ipm.usePrimalStepSizeForDual — False (OCS2's default) is load-bearing
    # for infeasible starts: the primal step is fraction-to-boundary-capped
    # while the cone gap is open, so the duals must take their own (full,
    # lambda-FTB-capped) steps to grow and push the primal back inside;
    # tying them to the primal step stalls at ~0 step size (measured).
    ipm_dual_step_from_primal: bool = False
    gripper_force: float = 0.0
    position_error_gain: float = 0.0  # model_settings.positionErrorGain
    integrator: str = "rk2"  # euler | rk2 | rk4
    # exact RK2 sensitivity needs a second 16-tangent jacfwd at the midpoint;
    # the O(dt^2) same-point approximation halves linearization cost while the
    # defect *values* stay exact (Gauss-Newton fixed points unchanged).
    exact_rk2_sensitivity: bool = False
    # filter-linesearch step candidates (alpha=0 fallback is implicit); a
    # warm-started RTI deployment can run just (1.0, 0.5) or (1.0,).  The
    # small tail candidates matter at big reference discontinuities (stop
    # commands, gait switch-backs): with the g_max band cap in
    # _filter_accept, they are what lets the solver make bounded progress
    # instead of stalling at alpha=0 (OCS2's armijo backtracking reaches
    # the same small steps).
    linesearch_alphas: tuple = (1.0, 0.5, 0.25, 0.1, 0.05)
    # Riccati backend (backend.py::select_backends resolves and checks it):
    # "auto" (the device's fastest: the Triton kernel on a GPU, "sequential"
    # elsewhere), "sequential" (exact stage-KKT scan), "triton" (the same
    # math as one GPU kernel per sweep, ops/riccati_triton.py), "parallel"
    # (associative scan, O(log N) depth; **f64 only**), or "parallel_sqrt"
    # (square-root associative scan, f32-capable — solver/parallel_riccati.py;
    # the f32 claim needs full-f32 matmul precision, the framework default
    # in utils/precision.py)
    riccati: str = "auto"
    riccati_penalty: float = 1e6  # parallel backends only (use ~1e4 for f32)

    @property
    def num_intervals(self) -> int:
        return max(1, round(self.horizon / self.dt))


class NodeRefs(NamedTuple):
    """Per-node reference data (leading axis = node when stacked)."""

    t: jnp.ndarray  # ()
    dt: jnp.ndarray  # () interval length to the next node
    contact_flags: jnp.ndarray  # (4,) float 0/1
    swing_vref: jnp.ndarray  # (4,) z-velocity reference
    swing_pref: jnp.ndarray  # (4,) z-position reference
    x_nom: jnp.ndarray  # (nx,)
    u_nom: jnp.ndarray  # (nu,)


def weight_compensating_input(info: CentroidalModelInfo, contact_flags, nu: int):
    """Gravity equally split over stance feet, zero joint velocity
    (common/utils.h:63-76). Differentiable in the flags mask."""
    num_stance = jnp.sum(contact_flags)
    fz = info.robot_mass * 9.81 / jnp.maximum(num_stance, 1.0)
    forces = jnp.zeros((NUM_CONTACTS, 3)).at[:, 2].set(fz * contact_flags)
    return jnp.zeros(nu).at[: 3 * NUM_CONTACTS].set(forces.reshape(-1))


def make_node_refs(info: CentroidalModelInfo, gait_table, swing_table, target_table, t, dt):
    """Build one node's references from frozen device tables (vmap over t)."""
    phase = gait_table.phase_index(t)
    flags = gait_table.contacts[phase]
    contacts = jnp.arange(NUM_CONTACTS)
    vref = jnp.stack([swing_table.z_velocity(c, phase, t) for c in range(NUM_CONTACTS)])
    pref = jnp.stack([swing_table.z_position(c, phase, t) for c in range(NUM_CONTACTS)])
    del contacts
    x_nom = target_table.state_at(t)
    u_nom = weight_compensating_input(info, flags, info.input_dim)
    return NodeRefs(
        t=t, dt=dt, contact_flags=flags, swing_vref=vref, swing_pref=pref, x_nom=x_nom, u_nom=u_nom
    )


# ---------------------------------------------------------------- constraints
def contact_kinematics(model: RobotModel, info: CentroidalModelInfo, x, u):
    """(positions (nc,3), velocities (nc,3)) of the contact frames under the
    centroidal mapping (end-effector kinematics of the constraints)."""
    from ..model.kinematics import stacked_point_jacobians

    q = get_generalized_coordinates(x)
    v = generalized_velocity_from_state_input(model, info, x, u)
    kin = forward_kinematics(model, q)
    ps = jnp.stack([frame_position(model, kin, fid) for fid in info.contact_frame_ids])
    anc = model.ancestor_mask()[[model.frame_body[fid] for fid in info.contact_frame_ids]]
    J = stacked_point_jacobians(model, kin, ps, anc)  # (nc, 6, nv)
    vs = jnp.sum(J[:, :3, :] * v[None, None, :], axis=2)
    return ps, vs


def equality_residual(model: RobotModel, info: CentroidalModelInfo, settings: OcpSettings, x, u, refs: NodeRefs):
    """(16,) masked equality constraint residual (see module docstring)."""
    p_ee, v_ee = contact_kinematics(model, info, x, u)
    forces = get_contact_forces(u, info)  # (nc,3)
    gain = settings.position_error_gain
    flags = refs.contact_flags  # (nc,)
    # stance rows: v_ee (+ gain on z); swing rows: F = 0
    zero_vel = v_ee + gain * jnp.concatenate(
        [jnp.zeros((NUM_CONTACTS, 2)), p_ee[:, 2:3]], axis=1
    )
    per_contact = flags[:, None] * zero_vel + (1.0 - flags[:, None]) * forces
    # normal-velocity rows for swing feet
    nvel = (1.0 - flags) * (v_ee[:, 2] - refs.swing_vref + gain * (p_ee[:, 2] - refs.swing_pref))
    return jnp.concatenate([per_contact.reshape(-1), nvel])


def friction_cone_values(settings: OcpSettings, u, info: CentroidalModelInfo):
    """(nc,) cone constraint h_i >= 0 with the reference's sqrt regularization
    (FrictionConeConstraint::coneConstraint; world frame == local frame since
    t_R_w is identity on flat ground)."""
    forces = get_contact_forces(u, info)
    f_tangent = jnp.sqrt(
        forces[:, 0] ** 2 + forces[:, 1] ** 2 + settings.cone_regularization
    )
    return settings.friction_coefficient * (forces[:, 2] + settings.gripper_force) - f_tangent


def friction_cone_grads_u(settings: OcpSettings, u, info: CentroidalModelInfo):
    """(nc, nu) analytic gradient of friction_cone_values wrt the input:
    each cone depends only on its contact's force slots —
    d h_i / d F_i = [-Fx/f_tan, -Fy/f_tan, mu]."""
    forces = get_contact_forces(u, info)
    nc = forces.shape[0]
    f_tan = jnp.sqrt(
        forces[:, 0] ** 2 + forces[:, 1] ** 2 + settings.cone_regularization
    )
    g3 = jnp.stack(
        [
            -forces[:, 0] / f_tan,
            -forces[:, 1] / f_tan,
            jnp.full((nc,), settings.friction_coefficient, forces.dtype),
        ],
        axis=1,
    )  # (nc, 3)
    G = jnp.zeros((nc, u.shape[-1]), u.dtype)
    rows = jnp.repeat(jnp.arange(nc), 3)
    cols = (3 * jnp.arange(nc)[:, None] + jnp.arange(3)[None, :]).reshape(-1)
    return G.at[rows, cols].set(g3.reshape(-1))


def relaxed_barrier(h, mu, delta):
    """OCS2 RelaxedBarrierPenalty: -mu ln(h) for h > delta, quadratic extension
    below (keeps the penalty defined for infeasible iterates)."""
    safe_h = jnp.maximum(h, delta)
    log_part = -mu * jnp.log(safe_h)
    quad_part = mu * (-jnp.log(delta) + 0.5 * ((h - 2.0 * delta) / delta) ** 2 - 0.5)
    return jnp.where(h > delta, log_part, quad_part)


def node_cost(model: RobotModel, info: CentroidalModelInfo, settings: OcpSettings, Q, R, x, u, refs: NodeRefs):
    """Intermediate cost L(x,u) (not yet dt-scaled): quadratic tracking
    (BipedalRobotQuadraticTrackingCost.h:50-58) + soft friction cones."""
    dx = x - refs.x_nom
    du = u - refs.u_nom
    quad = 0.5 * dx @ Q @ dx + 0.5 * du @ R @ du
    cones = friction_cone_values(settings, u, info)
    pen = relaxed_barrier(cones, settings.barrier_mu, settings.barrier_delta)
    return quad + jnp.sum(refs.contact_flags * pen)


# ---------------------------------------------------------------- dynamics
def discrete_dynamics(model: RobotModel, info: CentroidalModelInfo, settings: OcpSettings, x, u, dt):
    """One shooting interval of the centroidal flow under a fixed-step
    integrator (TimeTriggeredRollout + sqp.integratorType RK2 equivalents;
    the flow map is autonomous so no time argument)."""
    f = lambda xx: centroidal_flow_map(model, info, xx, u)
    if settings.integrator == "euler":
        return x + dt * f(x)
    if settings.integrator == "rk2":
        k1 = f(x)
        k2 = f(x + 0.5 * dt * k1)
        return x + dt * k2
    if settings.integrator == "rk4":
        k1 = f(x)
        k2 = f(x + 0.5 * dt * k1)
        k3 = f(x + 0.5 * dt * k2)
        k4 = f(x + dt * k3)
        return x + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
    raise ValueError(settings.integrator)


class LinearizedNode(NamedTuple):
    """Quadratic/linear approximations at one shooting node."""

    A: jnp.ndarray  # (nx,nx) d F / d x
    B: jnp.ndarray  # (nx,nu)
    c: jnp.ndarray  # (nx,) defect F(x_k,u_k) - x_{k+1}
    C: jnp.ndarray  # (ne,nx) equality jacobian
    D: jnp.ndarray  # (ne,nu)
    e: jnp.ndarray  # (ne,) residual
    Qxx: jnp.ndarray  # (nx,nx) dt-scaled cost hessian
    Quu: jnp.ndarray  # (nu,nu)
    Qux: jnp.ndarray  # (nu,nx)
    qx: jnp.ndarray  # (nx,)
    qu: jnp.ndarray  # (nu,)
    cost: jnp.ndarray  # () dt-scaled cost value


def linearize_node(
    model: RobotModel, info: CentroidalModelInfo, settings: OcpSettings, Q, R, x, u, x_next, refs: NodeRefs
):
    """Full Gauss-Newton data for one node (vmap over the horizon).

    Dynamics and equality residuals share one fused jacfwd so XLA reuses the
    FK subgraph across both and all 44 tangents."""
    nx = x.shape[0]

    def fused(xx, uu):
        F = discrete_dynamics(model, info, settings, xx, uu, refs.dt)
        e = equality_residual(model, info, settings, xx, uu, refs)
        return jnp.concatenate([F, e])

    val, (Jx, Ju) = _value_and_jacobians(fused, x, u)
    F, e = val[:nx], val[nx:]
    A, C = Jx[:nx], Jx[nx:]
    B, D = Ju[:nx], Ju[nx:]
    c = F - x_next

    cost_fn = lambda xx, uu: refs.dt * node_cost(model, info, settings, Q, R, xx, uu, refs)
    cost_val = cost_fn(x, u)
    qx = jax.grad(cost_fn, argnums=0)(x, u)
    qu = jax.grad(cost_fn, argnums=1)(x, u)
    # exact Hessian: quadratic part is (Q, R); barrier adds u-u curvature only
    Qxx = refs.dt * Q
    Quu = refs.dt * R + _barrier_hessian_u(settings, info, u, refs)
    Qux = jnp.zeros((u.shape[0], x.shape[0]))
    return LinearizedNode(A=A, B=B, c=c, C=C, D=D, e=e, Qxx=Qxx, Quu=Quu, Qux=Qux, qx=qx, qu=qu, cost=cost_val)


def _value_and_jacobians(fn, x, u):
    val = fn(x, u)
    Jx = jax.jacfwd(fn, argnums=0)(x, u)
    Ju = jax.jacfwd(fn, argnums=1)(x, u)
    return val, (Jx, Ju)


def _barrier_hessian_u(settings: OcpSettings, info: CentroidalModelInfo, u, refs: NodeRefs):
    """dt-scaled exact Hessian of the masked cone barriers w.r.t. u.

    The barrier is separable per contact force, so only 4 dense 3x3 Hessians
    are computed and scattered into the (nu, nu) block-diagonal."""

    def per_contact(f3, flag):
        pen = lambda ff: relaxed_barrier(
            settings.friction_coefficient * (ff[2] + settings.gripper_force)
            - jnp.sqrt(ff[0] ** 2 + ff[1] ** 2 + settings.cone_regularization),
            settings.barrier_mu,
            settings.barrier_delta,
        )
        return flag * jax.hessian(pen)(f3)

    forces = get_contact_forces(u, info)
    blocks = jax.vmap(per_contact)(forces, refs.contact_flags)  # (nc,3,3)
    H = jnp.zeros((u.shape[0], u.shape[0]))
    for i in range(NUM_CONTACTS):
        H = H.at[3 * i : 3 * i + 3, 3 * i : 3 * i + 3].set(blocks[i])
    return refs.dt * H
