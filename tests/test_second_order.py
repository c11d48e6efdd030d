"""Analytic second-order kinematics vs jacfwd oracle."""
import jax
import jax.numpy as jnp
import numpy as np

from bipedal_nmpc.model.kinematics import forward_kinematics, stacked_point_jacobians
from bipedal_nmpc.model.second_order import (
    cmm_derivative,
    point_jacobian_derivatives,
    velocity_fields,
    _static_masks,
)
from bipedal_nmpc.model.centroidal import centroidal_momentum_matrix
from bipedal_nmpc.model.kinematics import frame_position


def _rand_q(model, rng):
    return jnp.asarray(
        np.concatenate([rng.uniform(-1, 1, 3), rng.uniform(-0.7, 0.7, 3), rng.uniform(-0.8, 0.8, model.nj)])
    )


def test_contact_jacobian_derivative_matches_ad(h1_model, h1_info, rng):
    model, info = h1_model, h1_info
    q = _rand_q(model, rng)
    anc = model.ancestor_mask()[[model.frame_body[f] for f in info.contact_frame_ids]]
    import numpy as _np
    move = _np.zeros((len(info.contact_frame_ids), model.nv), dtype=bool)
    move[:, :6] = True
    move[:, 6:] = anc

    def J_fn(qq):
        kin = forward_kinematics(model, qq)
        ps = jnp.stack([frame_position(model, kin, f) for f in info.contact_frame_ids])
        return stacked_point_jacobians(model, kin, ps, anc)

    dJ_ad = jax.jacfwd(J_fn)(q)  # (nc, 6, nv, nv)
    kin = forward_kinematics(model, q)
    ps = jnp.stack([frame_position(model, kin, f) for f in info.contact_frame_ids])
    J = J_fn(q)
    fields = velocity_fields(model, kin)
    dJv, dJw = point_jacobian_derivatives(model, fields, ps, J[:, :3, :], move)
    np.testing.assert_allclose(np.asarray(dJv), np.asarray(dJ_ad[:, :3]), atol=1e-10)
    np.testing.assert_allclose(np.asarray(dJw), np.asarray(dJ_ad[:, 3:]), atol=1e-10)


def test_cmm_derivative_matches_ad(h1_model, rng):
    model = h1_model
    q = _rand_q(model, rng)
    dA_ad = jax.jacfwd(lambda qq: centroidal_momentum_matrix(model, qq))(q)
    kin = forward_kinematics(model, q)
    fields = velocity_fields(model, kin)
    dA = cmm_derivative(model, kin, fields)
    np.testing.assert_allclose(np.asarray(dA), np.asarray(dA_ad), atol=1e-9)


def test_cmm_derivative_fast_matches_bodywise(h1_model, rng):
    """Subtree-aggregate dA/dq == body-wise oracle (hot path vs reference)."""
    import jax.numpy as jnp

    from bipedal_nmpc.model.kinematics import forward_kinematics
    from bipedal_nmpc.model.second_order import (
        cmm_derivative,
        cmm_derivative_fast,
        velocity_fields,
    )

    model = h1_model
    for _ in range(3):
        q = jnp.asarray(
            np.concatenate([rng.uniform(-0.5, 0.5, 6), rng.uniform(-0.8, 0.8, model.nj)])
        )
        kin = forward_kinematics(model, q)
        fields = velocity_fields(model, kin)
        np.testing.assert_allclose(
            np.asarray(cmm_derivative_fast(model, kin, fields)),
            np.asarray(cmm_derivative(model, kin, fields)),
            atol=1e-12,
            rtol=1e-10,
        )


def test_cmm_v_derivative_matches_ad(h1_model, rng):
    """Directional d/dq (A(q) v) == jacfwd oracle contracted with v."""
    from bipedal_nmpc.model.second_order import cmm_v_derivative

    model = h1_model
    q = _rand_q(model, rng)
    v = jnp.asarray(rng.normal(size=model.nv))
    dA_ad = jax.jacfwd(lambda qq: centroidal_momentum_matrix(model, qq) @ v)(q)  # (6, nv)
    kin = forward_kinematics(model, q)
    fields = velocity_fields(model, kin)
    dAv = cmm_v_derivative(model, kin, fields, v)
    np.testing.assert_allclose(np.asarray(dAv), np.asarray(dA_ad), atol=1e-9)
