"""Batched dense QP solver (OSQP-style ADMM) — the qpOASES replacement.

Solves   min 0.5 x^T H x + g^T x   s.t.  l <= A x <= u
(equalities encoded as l == u, like the reference's qpOASES call in
WeightedWbc.cpp:29-64).  Fixed iteration count, one KKT factorization per
solve reused across iterations -> fully jittable, vmappable to thousands of
scenario QPs, and masked rows (0 <= 0 <= 0) are exactly feasible, which is how
contact-mode-dependent constraint counts keep static shapes on the device.

Per-row penalty: rows detected as equalities get a stiffer rho (OSQP's
standard heuristic), which makes the EoM rows behave like qpOASES's
``enableEqualities`` option.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class QpSolution(NamedTuple):
    x: jnp.ndarray
    y: jnp.ndarray  # dual for the row constraints
    primal_residual: jnp.ndarray  # () inf-norm of A x - clip(Ax)
    dual_residual: jnp.ndarray  # () inf-norm of H x + g + A^T y
    solved: jnp.ndarray  # () bool: residuals under tolerance


def solve_qp(
    H,
    g,
    A,
    l,  # noqa: E741
    u,
    iters: int = 120,
    rho: float = 0.1,
    sigma: float = 1e-6,
    alpha: float = 1.6,
    eq_rho_scale: float = 1e3,
    tol: float = 1e-3,
):
    n = H.shape[0]
    m = A.shape[0]
    is_eq = (u - l) < 1e-9
    rho_vec = jnp.where(is_eq, rho * eq_rho_scale, rho)
    kkt = jnp.block(
        [
            [H + sigma * jnp.eye(n), A.T],
            [A, -jnp.diag(1.0 / rho_vec)],
        ]
    )
    # factorize once: quasi-definite KKT -> pivot-free inverse (batch-friendly,
    # batches under vmap); iterations are then pure matvecs.
    from ..ops.linalg import gauss_jordan_solve

    kkt_inv = gauss_jordan_solve(kkt, jnp.eye(n + m))

    def body(_, carry):
        x, z, y = carry
        rhs = jnp.concatenate([sigma * x - g, z - y / rho_vec])
        sol = kkt_inv @ rhs
        x_t, nu = sol[:n], sol[n:]
        z_t = z + (nu - y) / rho_vec
        x_new = alpha * x_t + (1 - alpha) * x
        z_mix = alpha * z_t + (1 - alpha) * z
        z_new = jnp.clip(z_mix + y / rho_vec, l, u)
        y_new = y + rho_vec * (z_mix - z_new)
        return x_new, z_new, y_new

    x0 = jnp.zeros(n)
    z0 = jnp.clip(jnp.zeros(m), l, u)
    y0 = jnp.zeros(m)
    x, z, y = jax.lax.fori_loop(0, iters, body, (x0, z0, y0))

    ax = A @ x
    primal = jnp.max(jnp.abs(ax - jnp.clip(ax, l, u)))
    dual = jnp.max(jnp.abs(H @ x + g + A.T @ y))
    # acceptance mirrors qpOASES' role in WeightedWbc: reject only genuine
    # failures (divergence / NaN), not finite-iteration ADMM residuals --
    # rejecting healthy solves would freeze the controller on a stale torque.
    finite = jnp.logical_and(jnp.all(jnp.isfinite(x)), jnp.isfinite(dual))
    return QpSolution(
        x=x, y=y, primal_residual=primal, dual_residual=dual,
        solved=jnp.logical_and(primal < tol, finite),
    )


def solve_qp_batch(H, g, A, l, u, **kw):  # noqa: E741
    """vmap over a leading batch axis on every argument."""
    return jax.vmap(lambda H_, g_, A_, l_, u_: solve_qp(H_, g_, A_, l_, u_, **kw))(H, g, A, l, u)
