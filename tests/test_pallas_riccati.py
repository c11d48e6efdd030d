"""Whole-sweep Pallas Riccati kernel (Triton route) vs the XLA stage-KKT scan.

The kernel (ops/riccati_triton.py) must reproduce solver/riccati.py
bit-tolerantly on constrained problems with masked rows, both through the
scenario `vmap` (the production batched path, via custom_vmap) and unbatched.
Runs in Pallas interpret mode on CPU, in float64; the `gpu`-marked case runs
the kernel as compiled for the card.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bipedal_nmpc.solver.riccati import solve_lqr, solve_lqr_triton

from test_riccati import _random_problem

solve_lqr_interp = functools.partial(solve_lqr_triton, interpret=True)


def _batched_problem(seed, B, **kw):
    nodes_l, masks_l = [], []
    for b in range(B):
        rng = np.random.default_rng(seed + b)
        n, m = _random_problem(rng, **kw)
        nodes_l.append(n)
        masks_l.append(m)
    nodes = jax.tree.map(lambda *a: jnp.stack(a), *nodes_l)
    masks = jnp.stack(masks_l)
    return nodes, masks


def test_pallas_matches_xla_batched():
    B, nx = 3, 4
    nodes, masks = _batched_problem(11, B, N=5, nx=nx, nu=3, ne=2, constrained=True)
    rng = np.random.default_rng(99)
    dx0 = jnp.asarray(rng.normal(size=(B, nx)) * 0.1)

    ref = jax.vmap(solve_lqr)(nodes, masks, dx0)
    out = jax.vmap(solve_lqr_interp)(nodes, masks, dx0)

    np.testing.assert_allclose(np.asarray(out.K), np.asarray(ref.K), atol=1e-9)
    np.testing.assert_allclose(np.asarray(out.k), np.asarray(ref.k), atol=1e-9)
    np.testing.assert_allclose(np.asarray(out.dx), np.asarray(ref.dx), atol=1e-9)
    np.testing.assert_allclose(np.asarray(out.du), np.asarray(ref.du), atol=1e-9)
    np.testing.assert_allclose(
        np.asarray(out.expected_decrease), np.asarray(ref.expected_decrease), rtol=1e-8
    )


def test_pallas_unbatched_entry():
    """Unbatched call at widths that need every padding path: state 17 -> 32,
    input 20 -> 32, constraint rows 5 -> 16, KKT rows 25 -> 64."""
    rng = np.random.default_rng(21)
    nodes, masks = _random_problem(rng, N=4, nx=17, nu=20, ne=5, constrained=True)
    dx0 = jnp.asarray(rng.normal(size=17) * 0.1)
    ref = solve_lqr(nodes, masks, dx0)
    out = solve_lqr_interp(nodes, masks, dx0)
    np.testing.assert_allclose(np.asarray(out.du), np.asarray(ref.du), atol=1e-9)
    np.testing.assert_allclose(np.asarray(out.dx), np.asarray(ref.dx), atol=1e-9)
    np.testing.assert_allclose(np.asarray(out.K), np.asarray(ref.K), atol=1e-9)


def test_pallas_in_sqp_jit():
    """The batched entry composes with jit, and broadcasts unbatched inputs."""
    from bipedal_nmpc.solver.riccati import _solve_lqr_triton_batched

    B = 2
    nodes, masks = _batched_problem(31, B, N=4, nx=4, nu=3, ne=2, constrained=True)
    dx0 = jnp.zeros((B, 4))
    out = jax.jit(functools.partial(_solve_lqr_triton_batched, interpret=True))(nodes, masks, dx0)
    ref = jax.jit(jax.vmap(solve_lqr))(nodes, masks, dx0)
    np.testing.assert_allclose(np.asarray(out.du), np.asarray(ref.du), atol=1e-9)
    # shared (unbatched) masks and dx0 under vmap
    out2 = jax.vmap(solve_lqr_interp, in_axes=(0, None, None))(nodes, masks[0], dx0[0])
    ref2 = jax.vmap(solve_lqr, in_axes=(0, None, None))(nodes, masks[0], dx0[0])
    np.testing.assert_allclose(np.asarray(out2.du), np.asarray(ref2.du), atol=1e-9)


def test_pallas_backend_in_full_sqp(monkeypatch):
    """riccati='triton' through the full batched SQP (jit + scenario vmap)
    matches the sequential backend on a short-horizon G1 problem.  On the
    CPU the kernel runs interpreted, which select_backends never chooses:
    the test swaps both in."""
    import dataclasses

    import bipedal_nmpc.solver.riccati as riccati_mod
    import bipedal_nmpc.solver.sqp as sqp_mod
    from bipedal_nmpc.interface import make_interface_for
    from bipedal_nmpc.parallel.batch_solver import batched_sqp_solve
    from bipedal_nmpc.solver import build_refs, initial_trajectory

    iface = make_interface_for("g1")
    base = dataclasses.replace(iface.settings, horizon=0.09, sqp_iterations=1)
    rm = iface.make_reference_manager()
    frozen = rm.freeze(0.0)
    t_nodes = jnp.asarray(frozen.t_nodes)[: base.num_intervals + 1]
    refs = build_refs(iface.info, frozen.gait, frozen.swing, frozen.target, t_nodes)
    x0 = jnp.asarray(iface.initial_state)
    xs, us = initial_trajectory(iface.info, refs, x0, base.num_intervals + 1)

    B = 2
    tile = lambda a: jnp.broadcast_to(a[None], (B,) + a.shape)
    args = (jax.tree.map(tile, refs), tile(t_nodes), tile(x0), tile(xs), tile(us))

    outs = {"sequential": None, "triton": None}
    for backend in outs:
        st = dataclasses.replace(base, riccati=backend)
        if backend == "triton":
            monkeypatch.setattr(riccati_mod, "solve_lqr_triton", solve_lqr_interp)
            monkeypatch.setattr(sqp_mod, "select_backends", lambda s: s)
        outs[backend] = jax.jit(
            lambda *a, st=st: batched_sqp_solve(
                iface.model, iface.info, st, iface.Q, iface.R, *a
            )
        )(*args)
    for field in ("x_traj", "u_traj", "K"):
        np.testing.assert_allclose(
            np.asarray(getattr(outs["triton"], field)),
            np.asarray(getattr(outs["sequential"], field)),
            atol=1e-8,
        )


@pytest.mark.gpu
def test_kernel_on_card_matches_xla(gpu_device):
    """The kernel as compiled for the card, at G1 widths (state/input 24,
    16 constraint rows, 67 stages), against the XLA scan on the same card.
    Both run in float32 at full matmul precision; the tolerance is the
    float32 stage-KKT amplification bound of chip_smoke.py (RTOL_U)."""
    nodes, masks = _batched_problem(5, 4, N=67, nx=24, nu=24, ne=16, constrained=True)
    nodes, masks = jax.device_get((nodes, masks))
    # the production dtype: float32 throughout, whatever conftest's x64 says
    with jax.enable_x64(False), jax.default_matmul_precision("float32"):
        f32 = lambda t: jax.device_put(jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), t), gpu_device)
        nodes, masks = f32(nodes), f32(masks)
        dx0 = jax.device_put(jnp.zeros((4, 24), jnp.float32), gpu_device)
        ref = jax.jit(jax.vmap(solve_lqr))(nodes, masks, dx0)
        out = jax.jit(jax.vmap(solve_lqr_triton))(nodes, masks, dx0)
    for field in ("du", "dx", "k"):
        a, b = np.asarray(getattr(out, field)), np.asarray(getattr(ref, field))
        assert np.all(np.isfinite(a))
        assert np.max(np.abs(a - b)) <= 1e-3 * np.max(np.abs(b)), field
