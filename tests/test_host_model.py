"""Numpy host observation path == JAX model path (model/host_model.py).

The RT tick computes its observation host-side; these tests pin it to the
jitted implementation the solver uses (CentroidalModelRbdConversions parity,
BipedalController.cpp:402)."""
import numpy as np
import pytest


@pytest.fixture(scope="module")
def g1_iface():
    from bipedal_nmpc.interface import make_interface_for

    return make_interface_for("g1")


def _random_rbd(rng, nj):
    rbd = rng.normal(scale=0.4, size=2 * (6 + nj))
    rbd[3:6] += np.array([0.1, 0.2, 0.95])  # plausible base position
    return rbd


def test_centroidal_state_from_rbd_parity(g1_iface):
    import jax.numpy as jnp

    from bipedal_nmpc.model.centroidal import centroidal_state_from_rbd
    from bipedal_nmpc.model.host_model import (
        centroidal_state_from_rbd_np,
        make_host_model,
    )

    iface = g1_iface
    hm = make_host_model(iface.model, iface.info)
    rng = np.random.default_rng(42)
    for _ in range(5):
        rbd = _random_rbd(rng, iface.info.nj)
        ref = np.asarray(centroidal_state_from_rbd(iface.model, iface.info, jnp.asarray(rbd)))
        got = centroidal_state_from_rbd_np(hm, rbd)
        np.testing.assert_allclose(got, ref, atol=1e-10, rtol=1e-10)


def test_cmm_parity(g1_iface):
    import jax.numpy as jnp

    from bipedal_nmpc.model.centroidal import centroidal_momentum_matrix
    from bipedal_nmpc.model.host_model import (
        centroidal_momentum_matrix_np,
        make_host_model,
    )

    iface = g1_iface
    hm = make_host_model(iface.model, iface.info)
    rng = np.random.default_rng(7)
    q = rng.normal(scale=0.3, size=6 + iface.info.nj)
    ref = np.asarray(centroidal_momentum_matrix(iface.model, jnp.asarray(q)))
    got = centroidal_momentum_matrix_np(hm, q)
    np.testing.assert_allclose(got, ref, atol=1e-10, rtol=1e-10)


def test_host_observation_speed(g1_iface):
    """The tick-path observation must be comfortably sub-millisecond."""
    import time

    from bipedal_nmpc.model.host_model import (
        centroidal_state_from_rbd_np,
        make_host_model,
    )

    iface = g1_iface
    hm = make_host_model(iface.model, iface.info)
    rbd = _random_rbd(np.random.default_rng(0), iface.info.nj)
    centroidal_state_from_rbd_np(hm, rbd)  # warm numpy caches
    t0 = time.perf_counter()
    n = 200
    for _ in range(n):
        centroidal_state_from_rbd_np(hm, rbd)
    per_call_ms = (time.perf_counter() - t0) / n * 1e3
    assert per_call_ms < 1.0, f"host observation {per_call_ms:.3f} ms/call"
