"""Structured node linearization: analytic columns + q-only forward AD.

The fused jacfwd in problem.py pushes 44 tangents (nx+nu) through the whole
FK/CMM pipeline.  But the centroidal flow map and the contact constraints
depend on the *model* only through a small set of configuration terms

    T(q) = (p_ee (nc,3), com (3), A (6,nv), J_ee (nc,3,nv))

and on (h, F, v_j) only through cheap linear algebra.  So: one jacfwd of T
over the 16 q-coordinates per evaluation point, then closed-form assembly of
every Jacobian block:

    hdot_lin = g + sum F / m                        (F columns analytic)
    hdot_ang = sum (p_i - com) x F_i / m            (q via dT, F analytic)
    v_b      = A_b^{-1} (m h - A_j v_j)             (h, v_j analytic; q via dA)
    v_ee     = J_ee v                               (dJ/dq . v + J dv/dq)

RK2 sensitivity is chained exactly from the two stage Jacobians:
    x1 = x + dt/2 f(x,u);  F = x + dt f(x1, u)
    A  = I + dt Jx(x1) (I + dt/2 Jx(x));  B = dt (Jx(x1) dt/2 Ju(x) + Ju(x1))

Validated bit-for-bit against the pure-AD path (tests/test_linearize.py).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..model.centroidal import (
    CentroidalModelInfo,
    get_contact_forces,
    get_joint_velocities,
    get_normalized_momentum,
)
from ..model.kinematics import (
    body_com_positions,
    forward_kinematics,
    frame_position,
    stacked_point_jacobians,
)
from ..model.robot_model import RobotModel
from ..ops.contract import mm, mv, quad
from ..ops.linalg import inv6_block
from ..utils.rotations import skew
from .problem import (
    NUM_CONTACTS,
    LinearizedNode,
    NodeRefs,
    OcpSettings,
    _barrier_hessian_u,
    friction_cone_values,
    node_cost,
    relaxed_barrier,
)

GRAVITY = jnp.asarray((0.0, 0.0, -9.81))


class ConfigTerms(NamedTuple):
    p_ee: jnp.ndarray  # (nc, 3)
    com: jnp.ndarray  # (3,)
    A: jnp.ndarray  # (6, nv)
    J_ee: jnp.ndarray  # (nc, 3, nv) linear rows


def config_terms(model: RobotModel, info: CentroidalModelInfo, q) -> ConfigTerms:
    from ..model.centroidal import centroidal_momentum_matrix_info, momentum_coordinates

    kin = forward_kinematics(model, q)
    p_ee = jnp.stack([frame_position(model, kin, fid) for fid in info.contact_frame_ids])
    # momentum quantities (com, A) at the model-type configuration: actual q
    # for FullCentroidalDynamics, nominal joints for SingleRigidBodyDynamics
    kin_m = kin if info.model_type == 0 else forward_kinematics(model, momentum_coordinates(info, q))
    coms = body_com_positions(model, kin_m)
    com = jnp.sum(model.body_mass[:, None] * coms, axis=0) / model.total_mass
    anc = model.ancestor_mask()[[model.frame_body[fid] for fid in info.contact_frame_ids]]
    J_ee = stacked_point_jacobians(model, kin, p_ee, anc)[:, :3, :]
    A = centroidal_momentum_matrix_info(model, info, q)
    return ConfigTerms(p_ee=p_ee, com=com, A=A, J_ee=J_ee)


class FlowJac(NamedTuple):
    f: jnp.ndarray  # (nx,) flow value
    Jx: jnp.ndarray  # (nx, nx)
    Ju: jnp.ndarray  # (nx, nu)
    terms: ConfigTerms
    dterms: ConfigTerms  # d/dq of p_ee/com (A and J_ee slots: see dA_v/fields)
    v: jnp.ndarray  # (nv,) generalized velocity at this point
    Ab_inv: jnp.ndarray  # (6, 6)
    fields: object  # FieldData — dJ_ee.v is contracted on the fly from it
    dA_v: jnp.ndarray  # (6, nv) directional CMM derivative sum_k dA[:,k,:] v_k


def _flow_with_jacobians(model, info: CentroidalModelInfo, x, u) -> FlowJac:
    nx, nu = info.state_dim, info.input_dim
    nv = info.generalized_dim
    nj = info.nj
    m = info.robot_mass
    q = x[6:]
    h = m * get_normalized_momentum(x)
    forces = get_contact_forces(u, info)  # (nc, 3)
    v_j = get_joint_velocities(u, info)

    terms, dterms, fields, kin_m, fields_m = _terms_and_dq(model, info, q)
    p_ee, com, A = terms.p_ee, terms.com, terms.A
    A_b, A_j = A[:, :6], A[:, 6:]
    Ab_inv = inv6_block(A_b)
    v_b = mv(Ab_inv, h - mv(A_j, v_j))
    v = jnp.concatenate([v_b, v_j])

    # directional CMM derivative (6, nv): the only way dA/dq ever enters the
    # Jacobians is contracted with v, so compute d/dq (A v) body-wise
    # (model/second_order.py cmm_v_derivative) — no (6, nv, nv) tensor.
    from ..model.second_order import cmm_v_derivative

    if info.model_type == 1:
        # SRBD: A's joint columns are zero (contract with [v_b, 0]) and A
        # depends on q only through the base coords (zero joint l-columns)
        v_m = jnp.concatenate([v[:6], jnp.zeros(nv - 6, dtype=v.dtype)])
        dA_v = cmm_v_derivative(model, kin_m, fields_m, v_m)
        dA_v = jnp.concatenate(
            [dA_v[:, :6], jnp.zeros((6, nv - 6), dtype=v.dtype)], axis=1
        )
    else:
        dA_v = cmm_v_derivative(model, kin_m, fields_m, v)

    # ---- value
    hdot_lin = GRAVITY + jnp.sum(forces, axis=0) / m
    rel = p_ee - com
    hdot_ang = jnp.sum(jnp.cross(rel, forces), axis=0) / m
    f = jnp.concatenate([hdot_lin, hdot_ang, v_b, v_j])

    # ---- Jx (w.r.t. x = [h/m (6), q (nv)])
    Jx = jnp.zeros((nx, nx))
    # hdot_ang w.r.t. q: sum (dp_i - dcom) x F_i / m
    drel = dterms.p_ee - dterms.com[None]  # (nc, 3, nv)
    cross_dq = jnp.cross(drel.transpose(0, 2, 1), forces[:, None, :])  # (nc, nv, 3)
    Jx = Jx.at[3:6, 6:].set(jnp.sum(cross_dq, axis=0).T / m)
    # x stores h/m, and v_b = Ab_inv (m * x_h - A_j v_j) => dv_b/dx_h = m Ab_inv
    Jx = Jx.at[6:12, 0:6].set(m * Ab_inv)
    # v_b w.r.t. q: -Ab_inv (dA/dq . v)[:6]
    Jx = Jx.at[6:12, 6:].set(-mm(Ab_inv, dA_v))

    # ---- Ju (w.r.t. u = [F (3nc), v_j (nj)])
    Ju = jnp.zeros((nx, nu))
    eye3m = jnp.tile(jnp.eye(3) / m, (1, NUM_CONTACTS))
    Ju = Ju.at[0:3, : 3 * NUM_CONTACTS].set(eye3m)
    skews = jax.vmap(skew)(rel) / m  # (nc, 3, 3)
    Ju = Ju.at[3:6, : 3 * NUM_CONTACTS].set(
        jnp.concatenate([skews[i] for i in range(NUM_CONTACTS)], axis=1)
    )
    Ju = Ju.at[6:12, 3 * NUM_CONTACTS :].set(-mm(Ab_inv, A_j))
    Ju = Ju.at[12:, 3 * NUM_CONTACTS :].set(jnp.eye(nj))
    return FlowJac(
        f=f, Jx=Jx, Ju=Ju, terms=terms, dterms=dterms, v=v, Ab_inv=Ab_inv,
        fields=fields, dA_v=dA_v,
    )


def _terms_and_dq(model, info, q):
    """ConfigTerms and their q-Jacobians via analytic velocity-field algebra
    (model/second_order.py) — no forward-AD tangents through FK.

    Returns (terms, dterms, fields, kin_m, fields_m); dA/dq is NOT formed —
    the caller contracts it against the generalized velocity via
    cmm_v_derivative(kin_m, fields_m, .) (body-wise directional derivative),
    which keeps every intermediate at (nb, nv, 3) instead of the pairwise
    (nv, nv, 3x3) aggregates of cmm_derivative_fast."""
    from ..model.second_order import velocity_fields

    kin = forward_kinematics(model, q)
    p_ee = jnp.stack([frame_position(model, kin, fid) for fid in info.contact_frame_ids])
    anc = model.ancestor_mask()[[model.frame_body[fid] for fid in info.contact_frame_ids]]
    J6 = stacked_point_jacobians(model, kin, p_ee, anc)
    J_ee = J6[:, :3, :]
    from ..model.centroidal import centroidal_momentum_matrix, momentum_coordinates

    # momentum quantities at the model-type configuration (SRBD: nominal
    # joints, zero joint columns, zero joint-coordinate derivatives)
    fields = velocity_fields(model, kin)
    if info.model_type == 1:
        kin_m = forward_kinematics(model, momentum_coordinates(info, q))
        fields_m = velocity_fields(model, kin_m)
        A = centroidal_momentum_matrix(model, momentum_coordinates(info, q))
        A = jnp.concatenate([A[:, :6], jnp.zeros_like(A[:, 6:])], axis=1)
    else:
        kin_m, fields_m = kin, fields
        A = centroidal_momentum_matrix(model, q)
    coms = body_com_positions(model, kin_m)
    com = jnp.sum(model.body_mass[:, None] * coms, axis=0) / model.total_mass
    terms = ConfigTerms(p_ee=p_ee, com=com, A=A, J_ee=J_ee)
    dterms = ConfigTerms(
        p_ee=J_ee,  # dp_ee/dq is the linear Jacobian itself
        com=A[:3, :] / info.robot_mass,  # dcom/dq = A_lin / m
        # dA is never materialized on the hot path: its only consumer is the
        # contraction dA . v (FlowJac.dA_v via cmm_v_derivative)
        A=None,
        # dJ_ee likewise: the contraction dJ_ee . v is computed directly from
        # the velocity fields in _eq_jacobians (saves (nc, 3, nv, nv)/node)
        J_ee=None,
    )
    return terms, dterms, fields, kin_m, fields_m


def _terms_and_dq_ad(model, info, q):
    """jacfwd reference implementation (kept as the test oracle)."""

    def fn(qq):
        return config_terms(model, info, qq)

    return fn(q), jax.jacfwd(fn)(q)


def _eq_jacobians(model, info: CentroidalModelInfo, settings: OcpSettings, x, u, refs: NodeRefs, fj: FlowJac):
    """Equality residual (16,) + Jacobians using the stage-1 flow terms."""
    nx, nu = info.state_dim, info.input_dim
    m = info.robot_mass
    flags = refs.contact_flags
    gain = settings.position_error_gain
    terms, dterms, v, Ab_inv = fj.terms, fj.dterms, fj.v, fj.Ab_inv
    J = terms.J_ee  # (nc, 3, nv)
    forces = get_contact_forces(u, info)

    # contractions over nv/6 as broadcast-reduce instead of einsum
    # (tiny-dim batched dot_general) — see the linalg/profile note in ops/.
    v_ee = jnp.sum(J * v[None, None, :], axis=2)  # (nc, 3)
    # d v_ee / dq = (dJ/dq . v) + J_b dv_b/dq.  The first term is contracted
    # straight from the velocity fields without forming dJ_ee:
    #   sum_k v_k dJ[:,k,l] = sum_k mv_k dv0[k,l] + (sum_k mv_k dw[k,l]) x p
    #                          + (sum_k mv_k w_k) x J[:,l],   mv = move_mask*v
    import numpy as _np

    anc = model.ancestor_mask()[[model.frame_body[fid] for fid in info.contact_frame_ids]]
    move = _np.zeros((len(info.contact_frame_ids), model.nv))
    move[:, :6] = 1.0
    move[:, 6:] = anc
    mv = jnp.asarray(move, dtype=v.dtype) * v[None, :]  # (nc, nv)
    fd = fj.fields
    t1 = jnp.sum(mv[:, :, None, None] * fd.dv0[None], axis=1)  # (nc, nv_l, 3)
    dwv = jnp.sum(mv[:, :, None, None] * fd.dw[None], axis=1)  # (nc, nv_l, 3)
    t2 = jnp.cross(dwv, terms.p_ee[:, None, :])
    wv = jnp.sum(mv[:, :, None] * fd.w[None], axis=1)  # (nc, 3)
    t3 = jnp.cross(wv[:, None, :], J.transpose(0, 2, 1))  # (nc, nv_l, 3)
    dJ_v = (t1 + t2 + t3).transpose(0, 2, 1)  # (nc, 3, nv)
    dv_b_dq = -mm(Ab_inv, fj.dA_v)
    J6 = J[:, :, :6]  # (nc, 3, 6)
    dv_ee_dq = dJ_v + jnp.sum(J6[:, :, :, None] * dv_b_dq[None, None, :, :], axis=2)
    # d v_ee / d(h/m) and / d v_j
    dv_ee_dh = jnp.sum(J6[:, :, :, None] * (m * Ab_inv)[None, None, :, :], axis=2)
    dv_b_dvj = -mm(Ab_inv, terms.A[:, 6:])
    dv_ee_dvj = (
        jnp.sum(J6[:, :, :, None] * dv_b_dvj[None, None, :, :], axis=2) + J[:, :, 6:]
    )

    # residual value
    zsel = jnp.asarray([0.0, 0.0, 1.0])
    zero_vel = v_ee + gain * (terms.p_ee * zsel)  # z-position gain rows
    per_contact = flags[:, None] * zero_vel + (1.0 - flags[:, None]) * forces
    nvel = (1.0 - flags) * (
        v_ee[:, 2] - refs.swing_vref + gain * (terms.p_ee[:, 2] - refs.swing_pref)
    )
    e = jnp.concatenate([per_contact.reshape(-1), nvel])

    # d zero_vel / dq (adds the z-position gain)
    dzv_dq = dv_ee_dq + gain * (dterms.p_ee * zsel[None, :, None])
    # C (16, nx): columns [h/m | q]
    C_pc = jnp.concatenate(
        [flags[:, None, None] * dv_ee_dh, flags[:, None, None] * dzv_dq], axis=2
    ).reshape(3 * NUM_CONTACTS, nx)
    C_nv = jnp.concatenate(
        [
            (1.0 - flags)[:, None] * dv_ee_dh[:, 2, :],
            (1.0 - flags)[:, None] * (dv_ee_dq[:, 2, :] + gain * dterms.p_ee[:, 2, :]),
        ],
        axis=1,
    )
    C = jnp.concatenate([C_pc, C_nv], axis=0)

    # D (16, nu): force rows identity for swing; velocity rows via dv_ee_dvj
    nfc = 3 * NUM_CONTACTS
    eyeF = jnp.eye(nfc).reshape(NUM_CONTACTS, 3, nfc)
    D_pc_F = (1.0 - flags)[:, None, None] * eyeF
    D_pc_vj = flags[:, None, None] * dv_ee_dvj
    D_pc = jnp.concatenate([D_pc_F, D_pc_vj], axis=2).reshape(nfc, nu)
    D_nv = jnp.concatenate(
        [
            jnp.zeros((NUM_CONTACTS, nfc)),
            (1.0 - flags)[:, None] * dv_ee_dvj[:, 2, :],
        ],
        axis=1,
    )
    D = jnp.concatenate([D_pc, D_nv], axis=0)
    return e, C, D


def linearize_node_structured(
    model: RobotModel, info: CentroidalModelInfo, settings: OcpSettings, Q, R, x, u, x_next, refs: NodeRefs
) -> LinearizedNode:
    dt = refs.dt
    nx = info.state_dim

    fj0 = _flow_with_jacobians(model, info, x, u)
    if settings.integrator == "euler":
        F = x + dt * fj0.f
        A = jnp.eye(nx) + dt * fj0.Jx
        B = dt * fj0.Ju
    elif settings.integrator == "rk2":
        x1 = x + 0.5 * dt * fj0.f
        inner = jnp.eye(nx) + 0.5 * dt * fj0.Jx
        if settings.exact_rk2_sensitivity:
            fj1 = _flow_with_jacobians(model, info, x1, u)
            F = x + dt * fj1.f
            A = jnp.eye(nx) + dt * mm(fj1.Jx, inner)
            B = dt * (0.5 * dt * mm(fj1.Jx, fj0.Ju) + fj1.Ju)
        else:
            # exact value, same-point sensitivity (see OcpSettings)
            terms1 = config_terms(model, info, x1[6:])
            f1, _ = _flow_from_terms(info, terms1, x1, u)
            F = x + dt * f1
            A = jnp.eye(nx) + dt * mm(fj0.Jx, inner)
            B = dt * (0.5 * dt * mm(fj0.Jx, fj0.Ju) + fj0.Ju)
    else:
        raise NotImplementedError(f"structured linearization for {settings.integrator}")
    c = F - x_next

    e, C, D = _eq_jacobians(model, info, settings, x, u, refs, fj0)

    # cost terms (no FK involved; same as problem.linearize_node)
    dx_dev = x - refs.x_nom
    du_dev = u - refs.u_nom
    Qxx = dt * Q
    Quu = dt * R + _barrier_hessian_u(settings, info, u, refs)
    Qux = jnp.zeros((u.shape[0], x.shape[0]))
    cones = friction_cone_values(settings, u, info)
    pen = relaxed_barrier(cones, settings.barrier_mu, settings.barrier_delta)
    cost_val = dt * (
        0.5 * quad(dx_dev, Q, dx_dev) + 0.5 * quad(du_dev, R, du_dev) + jnp.sum(refs.contact_flags * pen)
    )
    qx = dt * mv(Q, dx_dev)
    qu = dt * mv(R, du_dev) + _barrier_grad_u(settings, info, u, refs)
    return LinearizedNode(A=A, B=B, c=c, C=C, D=D, e=e, Qxx=Qxx, Quu=Quu, Qux=Qux, qx=qx, qu=qu, cost=cost_val)


def _barrier_grad_u(settings, info, u, refs):
    pen = lambda uu: refs.dt * jnp.sum(
        refs.contact_flags
        * relaxed_barrier(
            friction_cone_values(settings, uu, info), settings.barrier_mu, settings.barrier_delta
        )
    )
    return jax.grad(pen)(u)


# ---------------------------------------------------------------- value path
def _flow_from_terms(info: CentroidalModelInfo, terms: ConfigTerms, x, u):
    """Flow value + generalized velocity from precomputed ConfigTerms."""
    m = info.robot_mass
    h = m * get_normalized_momentum(x)
    forces = get_contact_forces(u, info)
    v_j = get_joint_velocities(u, info)
    A_b, A_j = terms.A[:, :6], terms.A[:, 6:]
    v_b = mv(inv6_block(A_b), h - mv(A_j, v_j))
    hdot_lin = GRAVITY + jnp.sum(forces, axis=0) / m
    hdot_ang = jnp.sum(jnp.cross(terms.p_ee - terms.com, forces), axis=0) / m
    f = jnp.concatenate([hdot_lin, hdot_ang, v_b, v_j])
    return f, jnp.concatenate([v_b, v_j])


def _eq_from_terms(settings: OcpSettings, terms: ConfigTerms, v, u, info, refs: NodeRefs):
    flags = refs.contact_flags
    gain = settings.position_error_gain
    forces = get_contact_forces(u, info)
    v_ee = jnp.sum(terms.J_ee * v[None, None, :], axis=2)
    zsel = jnp.asarray([0.0, 0.0, 1.0])
    zero_vel = v_ee + gain * (terms.p_ee * zsel)
    per_contact = flags[:, None] * zero_vel + (1.0 - flags[:, None]) * forces
    nvel = (1.0 - flags) * (
        v_ee[:, 2] - refs.swing_vref + gain * (terms.p_ee[:, 2] - refs.swing_pref)
    )
    return jnp.concatenate([per_contact.reshape(-1), nvel])


def node_eval(model, info: CentroidalModelInfo, settings: OcpSettings, Q, R, x, u, x_next, refs: NodeRefs):
    """(cost, defect (nx,), masked eq (16,)) with exactly two FK/CMM passes
    per node (RK2 stages; the equality residual reuses the first)."""
    dt = refs.dt
    q = x[6:]
    terms0 = config_terms(model, info, q)
    f0, v0 = _flow_from_terms(info, terms0, x, u)
    if settings.integrator == "euler":
        F = x + dt * f0
    else:  # rk2
        x1 = x + 0.5 * dt * f0
        terms1 = config_terms(model, info, x1[6:])
        f1, _ = _flow_from_terms(info, terms1, x1, u)
        F = x + dt * f1
    defect = F - x_next

    eq = _eq_from_terms(settings, terms0, v0, u, info, refs)
    mask = jnp.concatenate([jnp.ones(12), 1.0 - refs.contact_flags])
    eq = mask * eq

    dx_dev = x - refs.x_nom
    du_dev = u - refs.u_nom
    cones = friction_cone_values(settings, u, info)
    pen = relaxed_barrier(cones, settings.barrier_mu, settings.barrier_delta)
    cost = dt * (
        0.5 * quad(dx_dev, Q, dx_dev)
        + 0.5 * quad(du_dev, R, du_dev)
        + jnp.sum(refs.contact_flags * pen)
    )
    return cost, defect, eq
