"""Parallel (associative-scan) Riccati vs the sequential sweep."""
import jax.numpy as jnp
import numpy as np

from bipedal_nmpc.solver.parallel_riccati import solve_lqr_parallel
from bipedal_nmpc.solver.riccati import solve_lqr

from test_riccati import _random_problem


def test_parallel_matches_sequential_unconstrained():
    rng = np.random.default_rng(7)
    nodes, masks = _random_problem(rng, N=12, constrained=False)
    dx0 = jnp.asarray(rng.normal(size=4) * 0.1)
    seq = solve_lqr(nodes, masks, dx0)
    par = solve_lqr_parallel(nodes, masks, dx0)
    np.testing.assert_allclose(np.asarray(par.dx), np.asarray(seq.dx), atol=1e-8)
    np.testing.assert_allclose(np.asarray(par.du), np.asarray(seq.du), atol=1e-8)
    np.testing.assert_allclose(np.asarray(par.K), np.asarray(seq.K), atol=1e-7)


def test_parallel_matches_sequential_constrained():
    """Penalty-folded constraints: agreement to O(1/rho)."""
    rng = np.random.default_rng(8)
    nodes, masks = _random_problem(rng, N=10, constrained=True)
    dx0 = jnp.asarray(rng.normal(size=4) * 0.1)
    seq = solve_lqr(nodes, masks, dx0)
    par = solve_lqr_parallel(nodes, masks, dx0, penalty=1e6)
    np.testing.assert_allclose(np.asarray(par.dx), np.asarray(seq.dx), atol=1e-5)
    np.testing.assert_allclose(np.asarray(par.du), np.asarray(seq.du), atol=1e-5)


def test_sqrt_parallel_matches_sequential_unconstrained():
    from bipedal_nmpc.solver.parallel_riccati import solve_lqr_parallel_sqrt

    rng = np.random.default_rng(9)
    nodes, masks = _random_problem(rng, N=12, constrained=False)
    dx0 = jnp.asarray(rng.normal(size=4) * 0.1)
    seq = solve_lqr(nodes, masks, dx0)
    par = solve_lqr_parallel_sqrt(nodes, masks, dx0)
    np.testing.assert_allclose(np.asarray(par.dx), np.asarray(seq.dx), atol=1e-7)
    np.testing.assert_allclose(np.asarray(par.du), np.asarray(seq.du), atol=1e-7)
    np.testing.assert_allclose(np.asarray(par.K), np.asarray(seq.K), atol=1e-6)


def test_sqrt_parallel_matches_sequential_constrained():
    from bipedal_nmpc.solver.parallel_riccati import solve_lqr_parallel_sqrt

    rng = np.random.default_rng(10)
    nodes, masks = _random_problem(rng, N=10, constrained=True)
    dx0 = jnp.asarray(rng.normal(size=4) * 0.1)
    seq = solve_lqr(nodes, masks, dx0)
    par = solve_lqr_parallel_sqrt(nodes, masks, dx0, penalty=1e6)
    np.testing.assert_allclose(np.asarray(par.dx), np.asarray(seq.dx), atol=1e-5)
    np.testing.assert_allclose(np.asarray(par.du), np.asarray(seq.du), atol=1e-5)


def test_sqrt_parallel_f32_stable():
    """The point of the square-root form: the f32 composition chain stays
    finite and close to the f64 sequential solution at a long horizon (the
    dense scan NaNs/stalls here — module docstring)."""
    import jax

    from bipedal_nmpc.solver.parallel_riccati import solve_lqr_parallel_sqrt

    rng = np.random.default_rng(11)
    nodes, masks = _random_problem(rng, N=64, constrained=True)
    dx0 = jnp.asarray(rng.normal(size=4) * 0.1)
    seq64 = solve_lqr(nodes, masks, dx0)
    to32 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, dtype=jnp.float32), t)
    par32 = solve_lqr_parallel_sqrt(to32(nodes), jnp.asarray(masks, jnp.float32),
                                    jnp.asarray(dx0, jnp.float32), penalty=1e4)
    assert np.all(np.isfinite(np.asarray(par32.dx)))
    assert np.all(np.isfinite(np.asarray(par32.du)))
    # f32 + penalty 1e4: ~1e-2-level agreement with the exact f64 solve
    # (O(1/rho) penalty error + single-precision roundoff)
    np.testing.assert_allclose(np.asarray(par32.dx), np.asarray(seq64.dx), atol=1e-2)
    np.testing.assert_allclose(np.asarray(par32.du), np.asarray(seq64.du), atol=1e-2)


def test_sqp_with_parallel_sqrt_backend():
    """Full H1 stance SQP with riccati="parallel_sqrt" tracks the sequential
    production backend (same warm-started RTI protocol)."""
    import dataclasses
    import os

    import pytest

    from conftest import REFERENCE_ASSETS

    if not os.path.exists(os.path.join(REFERENCE_ASSETS, "bipedal_robot_example")):
        pytest.skip("reference assets unavailable")
    import jax

    from bipedal_nmpc.interface import make_interface_for
    from bipedal_nmpc.solver import build_refs, initial_trajectory, sqp_solve

    iface = make_interface_for("h1")
    rm = iface.make_reference_manager()
    frozen = rm.freeze(0.0)
    t_nodes = jnp.asarray(frozen.t_nodes)
    refs = build_refs(iface.info, frozen.gait, frozen.swing, frozen.target, t_nodes)
    x0 = jnp.asarray(iface.initial_state)
    xs0, us0 = initial_trajectory(iface.info, refs, x0, iface.settings.num_intervals + 1)

    sols = {}
    for backend in ["sequential", "parallel_sqrt"]:
        settings = dataclasses.replace(
            iface.settings, sqp_iterations=1, riccati=backend, riccati_penalty=1e6
        )
        solve = jax.jit(
            lambda xs, us, s=settings: sqp_solve(
                iface.model, iface.info, s, iface.Q, iface.R, refs, t_nodes, x0, xs, us
            )
        )
        xs, us = xs0, us0
        for _ in range(3):
            sol = solve(xs, us)
            xs, us = sol.x_traj, sol.u_traj
        sols[backend] = sol

    seq, par = sols["sequential"], sols["parallel_sqrt"]
    assert float(par.eq_norm) < 2 * float(seq.eq_norm) + 1e-3
    np.testing.assert_allclose(
        np.asarray(par.x_traj), np.asarray(seq.x_traj), atol=1e-3
    )
    np.testing.assert_allclose(
        np.asarray(par.u_traj), np.asarray(seq.u_traj), atol=5e-3
    )
