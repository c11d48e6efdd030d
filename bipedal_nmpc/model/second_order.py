"""Analytic second-order kinematics: d(Jacobian)/dq and d(CMM)/dq tensors.

Replaces the 16-tangent jacfwd over config_terms in the OCP linearization
with closed-form velocity-field algebra (the role Pinocchio's analytical
derivatives play for the reference's CppAD pipeline).

Every generalized coordinate k defines a rigid velocity field
    v_k(p) = v0_k + w_k x p
with (w_k, v0_k) world-frame field parameters:
    translation   : w = 0,        v0 = e_k
    Euler i       : w = E[:, i],  v0 = -E[:, i] x p_base
    revolute j    : w = a_j,      v0 = -a_j x p_j
    prismatic j   : w = 0,        v0 = a_j

A point-Jacobian column is J[:,k](p, body) = anc(body,k) (v0_k + w_k x p),
and its q-derivative follows from the field derivatives

    dw_k/dq_l  = rot(k,l) (w_l x w_k)
    dv0_k/dq_l = product rule on the anchor point (anchors move with the
                 field of their own ancestors; Euler fields differentiate
                 through E(theta)).

The masks (which coordinate rotates which axis / moves which anchor / moves
which body) are all static, so everything assembles into a handful of
einsums over (coordinate, coordinate, 3) tensors.

Validated against jacfwd of config_terms (tests/test_second_order.py).
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from .kinematics import BodyKin, _joint_world_axes, body_com_positions
from .robot_model import RobotModel
from .urdf import JOINT_REVOLUTE


class FieldData(NamedTuple):
    w: jnp.ndarray  # (nv, 3) angular field direction
    v0: jnp.ndarray  # (nv, 3) linear field at the world origin
    dw: jnp.ndarray  # (nv, nv, 3) dw_k/dq_l  (k, l, 3)
    dv0: jnp.ndarray  # (nv, nv, 3)


def _static_masks(model: RobotModel):
    """(rot_mask (nv,nv), move_mask (nb,nv), body_rot (nb,nv)) static numpy.

    rot_mask[k,l]: coordinate l rotates the axis of coordinate k.
    move_mask[b,l] == ancestor mask extended with base columns: l moves body b.
    body_rot[b,l]: l rotates body b (no translation columns).
    """
    nv, nj, nb = model.nv, model.nj, model.nb
    anc = model.ancestor_mask()  # (nb, nj)
    move = np.zeros((nb, nv), dtype=bool)
    move[:, 0:6] = True  # base translation + rotation move every body
    move[:, 6:] = anc
    body_rot = move.copy()
    body_rot[:, 0:3] = False  # translations do not rotate
    rot = np.zeros((nv, nv), dtype=bool)
    # Euler coordinate i's axis (E column) rotates with earlier Euler coords
    for i in range(3):
        for l in range(i):
            rot[3 + i, 3 + l] = True
    # joint k axis rotates with every coordinate that rotates its body
    for j in range(nj):
        rot[6 + j, :] = body_rot[j + 1, :]
        rot[6 + j, 6 + j] = False  # own rotation leaves the axis fixed
    return rot, move, body_rot


def velocity_fields(model: RobotModel, kin: BodyKin) -> FieldData:
    nv, nj = model.nv, model.nj
    rot_mask, move_mask, _ = _static_masks(model)
    rot_mask = jnp.asarray(rot_mask.astype(kin.p.dtype))
    axes, anchors = _joint_world_axes(model, kin)
    rev = jnp.asarray(
        np.asarray([t == JOINT_REVOLUTE for t in model.joint_type], dtype=np.float64),
        dtype=kin.p.dtype,
    )
    p_b = kin.p[0]
    E = kin.E

    w = jnp.concatenate([jnp.zeros((3, 3)), E.T, rev[:, None] * axes], axis=0)  # (nv,3)
    v0_base_t = jnp.eye(3)
    v0_euler = -jnp.cross(E.T, p_b[None, :])
    v0_joint = rev[:, None] * (-jnp.cross(axes, anchors)) + (1 - rev)[:, None] * axes
    v0 = jnp.concatenate([v0_base_t, v0_euler, v0_joint], axis=0)

    # dw[k, l] = rot(k,l) * (w_l x w_k)
    dw = rot_mask[:, :, None] * jnp.cross(w[None, :, :], w[:, None, :])

    # anchor-point jacobian columns: danchor_k/dq_l
    # anchors: joint k>=6 -> p_{k-6} on body k-5; Euler -> p_base; transl: none
    # danchor for joints: move_mask(body jk+1, l) * v_l(anchor)
    move_j = jnp.asarray(move_mask[1:, :].astype(kin.p.dtype))  # (nj, nv) body j+1
    v_l_at_anchor = v0[None, :, :] + jnp.cross(
        w[None, :, :], anchors[:, None, :]
    )  # (nj, nv, 3): v_l(p_j)
    danchor = move_j[:, :, None] * v_l_at_anchor  # (nj, nv, 3)
    # base origin: d p_b / dq_l = e_l for l < 3
    dp_b = jnp.concatenate([jnp.eye(3), jnp.zeros((nv - 3, 3))], axis=0)  # (nv, 3)

    # dv0:
    dv0 = jnp.zeros((nv, nv, 3))
    # Euler rows k = 3 + i: v0_k = -w_k x p_b
    dw_euler = dw[3:6]  # (3, nv, 3)
    w_euler = w[3:6]
    term = -jnp.cross(dw_euler, p_b[None, None, :]) - jnp.cross(
        w_euler[:, None, :], dp_b[None, :, :]
    )
    dv0 = dv0.at[3:6].set(term)
    # joint rows k = 6 + j:
    #   revolute: v0 = -a_j x p_j  -> -da x p - a x dp
    #   prismatic: v0 = a_j -> dv0 = da (da = dw formula with rot mask of the axis)
    rotj = jnp.asarray(_static_masks(model)[0][6:, :].astype(kin.p.dtype))  # (nj, nv)
    da = rotj[:, :, None] * jnp.cross(w[None, :, :], axes[:, None, :])  # (nj, nv, 3)
    dv0_rev = -jnp.cross(da, anchors[:, None, :]) - jnp.cross(axes[:, None, :], danchor)
    dv0_j = rev[:, None, None] * dv0_rev + (1 - rev)[:, None, None] * da
    dv0 = dv0.at[6:].set(dv0_j)
    return FieldData(w=w, v0=v0, dw=dw, dv0=dv0)


def point_jacobian_derivatives(model: RobotModel, fields: FieldData, points, dpoints, move_masks):
    """d/dq of stacked point Jacobians.

    points: (m, 3); dpoints: (m, 3, nv) = dp/dq (i.e. the linear Jacobian of
    each point); move_masks: static (m, nv) bool "coordinate k moves point".
    Returns (dJv, dJw): (m, 3, nv, nv) with [i, :, k, l] = d J[:,k] / dq_l.
    """
    mask = jnp.asarray(np.asarray(move_masks, dtype=np.float64), dtype=points.dtype)
    # dcol_k/dq_l = dv0[k,l] + dw[k,l] x p + w_k x dp/dq_l
    # fields.dv0/dw: (nv, nv, 3); points: (m, 3)
    term_field = fields.dv0[None] + jnp.cross(fields.dw[None], points[:, None, None, :])
    term_motion = jnp.cross(
        fields.w[None, :, None, :], dpoints.transpose(0, 2, 1)[:, None, :, :]
    )  # (m, nv_k, nv_l, 3)
    dJv = (term_field + term_motion) * mask[:, :, None, None]  # (m, nv, nv, 3)
    dJw = fields.dw[None] * mask[:, :, None, None]
    # reorder to (m, 3, nv_k, nv_l)
    return dJv.transpose(0, 3, 1, 2), dJw.transpose(0, 3, 1, 2)


def cmm_derivative(model: RobotModel, kin: BodyKin, fields: FieldData):
    """dA/dq: (6, nv, nv) with [:, k, l] = d A[:, k] / dq_l."""
    _, move_mask, body_rot = _static_masks(model)
    coms = body_com_positions(model, kin)
    com = jnp.sum(model.body_mass[:, None] * coms, axis=0) / model.total_mass

    from .kinematics import stacked_point_jacobians

    J = stacked_point_jacobians(model, kin, coms, model.ancestor_mask())  # (nb,6,nv)
    Jv, Jw = J[:, :3, :], J[:, 3:, :]
    dJv, dJw = point_jacobian_derivatives(model, fields, coms, Jv, move_mask)
    from .centroidal import rotate_inertia

    # every contraction below runs over 3- or nb-sized axes: spelled as
    # broadcast-multiply-reduce so a scenario-batch vmap keeps them
    # elementwise (einsum lowers them to tiny-dim batched dot_generals)
    I_w = rotate_inertia(kin.R, model.body_inertia)
    body_rot_f = jnp.asarray(body_rot.astype(kin.p.dtype))
    # dI_w/dq_l = rot(b,l) ([w_l] I - I [w_l])
    wtilde = _skew_batch(fields.w)  # (nv, 3, 3)
    # comm[b,l,i,k] = sum_j wt[l,i,j] I_w[b,j,k] - I_w[b,i,j] wt[l,j,k]
    comm = jnp.sum(
        wtilde[None, :, :, :, None] * I_w[:, None, None, :, :], axis=3
    ) - jnp.sum(I_w[:, None, :, :, None] * wtilde[None, :, None, :, :], axis=3)
    dI = body_rot_f[:, :, None, None] * comm  # (nb, nv_l, 3, 3)

    m_b = model.body_mass
    dA_lin = jnp.sum(m_b[:, None, None, None] * dJv, axis=0)  # (3, nv, nv)
    # angular: I_w Jw + m (c_b - c) x Jv
    # term1[i,k,l] = sum_{b,j} dI[b,l,i,j] Jw[b,j,k]
    term1 = jnp.sum(
        dI[:, :, :, :, None] * Jw[:, None, None, :, :], axis=(0, 3)
    ).transpose(1, 2, 0)
    # term2[i,k,l] = sum_{b,j} I_w[b,i,j] dJw[b,j,k,l]
    term2 = jnp.sum(I_w[:, :, :, None, None] * dJw[:, None, :, :, :], axis=(0, 2))
    dA_ang = term1 + term2
    rel = coms - com  # (nb, 3)
    drel = Jv - jnp.sum(m_b[:, None, None] * Jv, axis=0)[None] / model.total_mass
    # d[(rel) x Jv_col_k]/dq_l = drel_l x Jv_k + rel x dJv_kl
    cross1 = jnp.cross(
        drel.transpose(0, 2, 1)[:, None, :, :], Jv.transpose(0, 2, 1)[:, :, None, :]
    )  # (nb, nv_k, nv_l, 3)
    cross2 = jnp.cross(rel[:, None, None, :], dJv.transpose(0, 2, 3, 1))  # (nb, nv_k, nv_l, 3)
    dA_ang = dA_ang + jnp.sum(
        m_b[:, None, None, None] * (cross1 + cross2), axis=0
    ).transpose(2, 0, 1)
    return jnp.concatenate([dA_lin, dA_ang], axis=0)  # (6, nv, nv)


def _pair_tables(mask: np.ndarray):
    """Static (nv, nv) tables for pairwise-masked subtree sums.

    For tree-structured column masks (column k = set of bodies moved/rotated
    by coordinate k), the elementwise AND of two columns is either empty or
    exactly the deeper column.  Returns (idx, valid): pair sum over
    mask[:,k]&mask[:,l] == subtree_sum[idx[k,l]] * valid[k,l].
    """
    mask = np.asarray(mask, dtype=bool)
    nv = mask.shape[1]
    idx = np.zeros((nv, nv), dtype=np.int32)
    valid = np.zeros((nv, nv))
    for k in range(nv):
        for l in range(nv):
            inter = mask[:, k] & mask[:, l]
            if not inter.any():
                continue
            if (inter == mask[:, k]).all():
                idx[k, l], valid[k, l] = k, 1.0
            elif (inter == mask[:, l]).all():
                idx[k, l], valid[k, l] = l, 1.0
            else:  # non-tree masks (never happens for ancestor columns)
                raise ValueError("pair mask is not a subtree column")
    return idx, valid


def cmm_derivative_fast(model: RobotModel, kin: BodyKin, fields: FieldData):
    """dA/dq identical to :func:`cmm_derivative` without any (nb, nv, nv, 3)
    intermediate: every body sum collapses to per-coordinate subtree
    aggregates (masses, mass-weighted com moments, inertia sums), and the
    pairwise-masked sums reduce to static gathers of those aggregates
    (:func:`_pair_tables`).  This is the hot-path version — the body-wise
    formulation moves ~11x more memory per node under a scenario batch.

    Identities used (a, b, c, d three-vectors):
        a x (b x c)        = b (a.c) - c (a.b)
        (a x c) x (b x c)  = c ((a x b) . c)
        sum m rel x (d x c) = d tr(T) - T^T d,   T = sum m rel c^T
    """
    rot_mask, move_mask, body_rot = _static_masks(model)
    nv = model.nv
    m_b = model.body_mass  # (nb,)
    coms = body_com_positions(model, kin)  # (nb, 3)
    com = jnp.sum(m_b[:, None] * coms, axis=0) / model.total_mass
    rel = coms - com
    from .centroidal import rotate_inertia

    I_w = rotate_inertia(kin.R, model.body_inertia)  # (nb,3,3)
    w, v0, dw, dv0 = fields.w, fields.v0, fields.dw, fields.dv0

    move_f = jnp.asarray(move_mask.astype(kin.p.dtype))  # (nb, nv)
    rot_f = jnp.asarray(body_rot.astype(kin.p.dtype))
    mw = m_b[:, None] * move_f  # (nb, nv) mass-weighted move mask

    # ---- per-coordinate subtree aggregates (axis 0 = coordinate k)
    msub = jnp.sum(mw, axis=0)  # (nv,)
    csub = jnp.sum(mw[:, :, None] * coms[:, None, :], axis=0)  # (nv, 3)
    ssub = csub - msub[:, None] * com[None]  # sum m move rel
    Tsub = jnp.sum(
        mw[:, :, None, None] * rel[:, None, :, None] * coms[:, None, None, :], axis=0
    )  # (nv, 3, 3) = sum m move rel c^T
    CCsub = jnp.sum(
        mw[:, :, None, None] * coms[:, None, :, None] * coms[:, None, None, :], axis=0
    )  # (nv, 3, 3) = sum m move c c^T
    Isub_move = jnp.sum(move_f[:, :, None, None] * I_w[:, None], axis=0)  # (nv,3,3)
    Isub_rot = jnp.sum(rot_f[:, :, None, None] * I_w[:, None], axis=0)

    # ---- pairwise gathers (static index tables)
    idx_mv, val_mv = _pair_tables(move_mask)
    idx_rt, val_rt = _pair_tables(body_rot)
    take = lambda X, idx: jnp.take(X, jnp.asarray(idx), axis=0)
    vmv = jnp.asarray(val_mv, dtype=kin.p.dtype)
    vrt = jnp.asarray(val_rt, dtype=kin.p.dtype)
    mpair = take(msub, idx_mv) * vmv  # (k,l)
    cpair = take(csub, idx_mv) * vmv[..., None]  # (k,l,3)
    spair = take(ssub, idx_mv) * vmv[..., None]
    Tpair = take(Tsub, idx_mv) * vmv[..., None, None]  # (k,l,3,3)
    CCpair = take(CCsub, idx_mv) * vmv[..., None, None]
    Irot_pair = take(Isub_rot, idx_rt) * vrt[..., None, None]

    cross = jnp.cross
    dot = lambda a, b: jnp.sum(a * b, axis=-1)
    wk = w[:, None, :]  # (k,1,3)
    wl = w[None, :, :]  # (1,l,3)
    v0l = v0[None, :, :]

    # ---- dA_lin[:, k, l] = msub_k dv0[k,l] + dw[k,l] x csub_k
    #                        + w_k x (mpair v0_l + w_l x cpair)
    dA_lin = (
        msub[:, None, None] * dv0
        + cross(dw, csub[:, None, :])
        + cross(wk, mpair[..., None] * v0l + cross(wl, cpair))
    )  # (k, l, 3)

    # ---- Term A: sum_b dI[b,l] Jw[b,:,k] = w_l x (Irot_pair w_k)
    #                                        - Irot_pair (w_l x w_k)
    Ipw = jnp.sum(Irot_pair * wk[:, :, None, :], axis=-1)  # (k,l,3)
    termA = cross(wl, Ipw) - jnp.sum(Irot_pair * cross(wl, wk)[:, :, None, :], axis=-1)

    # ---- Term B: sum_b I_w[b] dJw[b,:,k,l] = Isub_move[k] dw[k,l]
    termB = jnp.sum(Isub_move[:, None] * dw[:, :, None, :], axis=-1)  # (k,l,3)

    # ---- Term C: sum m drel_l x Jv_k
    #   = mpair v0_l x v0_k + [w_k (v0_l.cpair) - cpair (v0_l.w_k)]
    #     - [w_l (v0_k.cpair) - cpair (v0_k.w_l)]
    #     + CCpair (w_l x w_k) - (A_lin_l / M) x A_lin_k
    v0k = v0[:, None, :]
    E1 = mpair[..., None] * cross(v0l, v0k)
    E2 = wk * dot(v0l, cpair)[..., None] - cpair * dot(v0l, wk)[..., None]
    E3 = -(wl * dot(v0k, cpair)[..., None] - cpair * dot(v0k, wl)[..., None])
    E4 = jnp.sum(CCpair * cross(wl, wk)[:, :, None, :], axis=-1)
    # A_lin columns: sum_b m Jv_b[:,k] = msub_k v0_k + w_k x csub_k
    Acol = msub[:, None] * v0 + cross(w, csub)  # (nv, 3)
    termC = E1 + E2 + E3 + E4 - cross(Acol[None, :, :] / model.total_mass, Acol[:, None, :])

    # ---- Term D: sum m rel x dJv[b,:,k,l]
    trT = jnp.trace(Tsub, axis1=-2, axis2=-1)  # (nv,)
    D1 = cross(ssub[:, None, :], dv0)
    D2 = trT[:, None, None] * dw - jnp.sum(
        Tsub.swapaxes(-1, -2)[:, None] * dw[:, :, None, :], axis=-1
    )
    # rel x (w_k x V), V = v0_l + w_l x c  (pair masked)
    relxc = jnp.stack(
        [
            Tpair[..., 1, 2] - Tpair[..., 2, 1],
            Tpair[..., 2, 0] - Tpair[..., 0, 2],
            Tpair[..., 0, 1] - Tpair[..., 1, 0],
        ],
        axis=-1,
    )  # (k,l,3) = sum m pair (rel x c)
    relV = dot(spair, v0l) - dot(wl, relxc)  # sum m pair rel.V  (k,l)
    TpT_wk = jnp.sum(Tpair * wk[:, :, :, None], axis=-2)  # (k,l,3) = Tpair^T w_k
    sumV_relwk = v0l * dot(spair, wk)[..., None] + cross(wl, TpT_wk)
    D3 = wk * relV[..., None] - sumV_relwk
    termD = D1 + D2 + D3

    dA_ang = termA + termB + termC + termD  # (k, l, 3)
    # reorder (k, l, 3) -> (3, k, l) rows and stack [lin; ang]
    return jnp.concatenate(
        [dA_lin.transpose(2, 0, 1), dA_ang.transpose(2, 0, 1)], axis=0
    )


def cmm_v_derivative(model: RobotModel, kin: BodyKin, fields: FieldData, v):
    """Directional CMM derivative d/dq (A(q) v) at fixed v: (6, nv) with
    [:, l] = sum_k dA[:, k, l] v_k.

    The linearization only ever consumes dA contracted against the current
    generalized velocity (dv_b/dq = -Ab^{-1} (dA.v)), so the full (6, nv, nv)
    tensor — and with it every pairwise-masked (k, l, 3, 3) aggregate of
    :func:`cmm_derivative_fast` — never needs to exist.  Differentiating the
    momentum h(q, v) = [sum m_b cdot_b; sum (I_b w_b + m_b (c_b - c) x cdot_b)]
    body-wise instead keeps every intermediate at (nb, nv, 3):

        d cdot_b / dq_l = P_b[l] + W_b[l] x c_b + omega_b x Jv_b[:, l]
        P_b = (move_b . v) @ dv0,  W_b = (move_b . v) @ dw   (einsum over k)
        d(I_b w_b)/dq_l = rot(b,l) [w_l x (I w_b) - I (w_l x w_b)] + I W_b[l]

    Validated against jacfwd of q -> A(q) v (tests/test_second_order.py).
    """
    _, move_mask, body_rot = _static_masks(model)
    move_f = jnp.asarray(move_mask.astype(kin.p.dtype))  # (nb, nv)
    rot_f = jnp.asarray(body_rot.astype(kin.p.dtype))
    m_b = model.body_mass
    coms = body_com_positions(model, kin)  # (nb, 3)
    com = jnp.sum(m_b[:, None] * coms, axis=0) / model.total_mass
    rel = coms - com
    w, v0, dw, dv0 = fields.w, fields.v0, fields.dw, fields.dv0
    cross = jnp.cross

    # Ancestor-masked sums S_b = sum_k move(b,k) v_k X[k] computed as an
    # unrolled walk down the static tree: S_body = S_parent + v_j X[joint row]
    # — O(nb) work, no (nb, nv, nv, 3) broadcast intermediate and no tiny-dim
    # batched dot_general (both measured slower; see ops/ profile note).
    P_l = [jnp.sum(v[:6, None, None] * dv0[:6], axis=0)]  # base coords 0..5
    W_l = [jnp.sum(v[:6, None, None] * dw[:6], axis=0)]
    om_l = [jnp.sum(v[3:6, None] * w[3:6], axis=0)]  # translation rows have w=0
    v0_l = [jnp.sum(v[:6, None] * v0[:6], axis=0)]
    for b in range(1, model.nb):
        j = b - 1  # body b is driven by joint j
        par = int(model.joint_parent_body[j])
        P_l.append(P_l[par] + v[6 + j] * dv0[6 + j])
        W_l.append(W_l[par] + v[6 + j] * dw[6 + j])
        om_l.append(om_l[par] + v[6 + j] * w[6 + j])
        v0_l.append(v0_l[par] + v[6 + j] * v0[6 + j])
    P = jnp.stack(P_l)  # (nb, nv, 3)
    W = jnp.stack(W_l)  # (nb, nv, 3)
    omega = jnp.stack(om_l)  # (nb, 3)
    cdot = jnp.stack(v0_l) + cross(omega, coms)  # (nb, 3)
    # com-point Jacobian columns Jv[b, l] = move(b,l) (v0_l + w_l x c_b)
    Jv = move_f[:, :, None] * (v0[None] + cross(w[None], coms[:, None, :]))
    dcdot = P + cross(W, coms[:, None, :]) + cross(omega[:, None, :], Jv)

    dp = jnp.sum(m_b[:, None, None] * dcdot, axis=0)  # (nv, 3)
    dcom = jnp.sum(m_b[:, None, None] * Jv, axis=0) / model.total_mass  # (nv, 3)

    from .centroidal import rotate_inertia

    I_w = rotate_inertia(kin.R, model.body_inertia)  # (nb, 3, 3)
    Iom = jnp.sum(I_w * omega[:, None, :], axis=-1)  # (nb, 3)
    wxom = cross(w[None], omega[:, None, :])  # (nb, nv, 3)
    dI_om = rot_f[:, :, None] * (
        cross(w[None], Iom[:, None, :])
        - jnp.sum(I_w[:, None] * wxom[:, :, None, :], axis=-1)
    )
    I_dom = jnp.sum(I_w[:, None] * W[:, :, None, :], axis=-1)
    dL = jnp.sum(
        dI_om
        + I_dom
        + m_b[:, None, None]
        * (cross(Jv - dcom[None], cdot[:, None, :]) + cross(rel[:, None, :], dcdot)),
        axis=0,
    )  # (nv, 3)
    return jnp.concatenate([dp.T, dL.T], axis=0)  # (6, nv)


def _skew_batch(v):
    z = jnp.zeros(v.shape[:-1])
    return jnp.stack(
        [
            jnp.stack([z, -v[..., 2], v[..., 1]], axis=-1),
            jnp.stack([v[..., 2], z, -v[..., 0]], axis=-1),
            jnp.stack([-v[..., 1], v[..., 0], z], axis=-1),
        ],
        axis=-2,
    )
