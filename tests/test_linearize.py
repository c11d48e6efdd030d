"""Structured linearization == pure-AD linearization (bit-level agreement)."""
import jax.numpy as jnp
import numpy as np
import pytest

from bipedal_nmpc.ocp.linearize import linearize_node_structured
from bipedal_nmpc.ocp.problem import NodeRefs, linearize_node, weight_compensating_input


@pytest.mark.parametrize("flags", [(1.0, 1, 1, 1), (1, 1, 0, 0), (0, 0, 0, 0)])
def test_structured_matches_ad(h1_model, h1_info, rng, flags):
    model, info = h1_model, h1_info
    from bipedal_nmpc.ocp.problem import OcpSettings

    settings = OcpSettings(position_error_gain=0.3, exact_rk2_sensitivity=True)
    Q = jnp.asarray(np.diag(rng.uniform(1, 10, info.state_dim)))
    R = jnp.asarray(np.diag(rng.uniform(0.01, 1, info.input_dim)))
    x = jnp.asarray(
        np.concatenate([rng.uniform(-0.3, 0.3, 6), [0, 0, 0.9], rng.uniform(-0.4, 0.4, 3),
                        rng.uniform(-0.6, 0.6, info.nj)])
    )
    u = weight_compensating_input(info, jnp.asarray(flags, dtype=jnp.float64), info.input_dim)
    u = u + jnp.asarray(rng.uniform(-5, 5, info.input_dim))
    x_next = x + jnp.asarray(rng.uniform(-0.01, 0.01, info.state_dim))
    refs = NodeRefs(
        t=jnp.asarray(0.1),
        dt=jnp.asarray(0.015),
        contact_flags=jnp.asarray(flags, dtype=jnp.float64),
        swing_vref=jnp.asarray(rng.uniform(-0.2, 0.2, 4)),
        swing_pref=jnp.asarray(rng.uniform(0, 0.05, 4)),
        x_nom=x + 0.05,
        u_nom=u * 0.9,
    )
    ad = linearize_node(model, info, settings, Q, R, x, u, x_next, refs)
    st = linearize_node_structured(model, info, settings, Q, R, x, u, x_next, refs)
    for name in ad._fields:
        np.testing.assert_allclose(
            np.asarray(getattr(st, name)), np.asarray(getattr(ad, name)),
            atol=1e-9, rtol=1e-7, err_msg=name,
        )
