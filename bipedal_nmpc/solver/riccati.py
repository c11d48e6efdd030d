"""Equality-constrained Riccati sweep (the HPIPM replacement).

The reference delegates its QP subproblem to HPIPM after projecting out the
state-input equality constraints (task.info sqp block,
projectStateInputEqualityConstraints=true).  Here the stage-wise
equality-constrained minimization is solved *inside* the Riccati recursion via
a per-node KKT system

    [ H_uu  D^T ] [du]   [-(H_ux dx + h_u)]
    [ D    -Reg ] [la] = [-(C dx + e)     ]

with Reg = diag(eps on active rows, 1 on masked rows): masked constraint rows
(C, D, e identically zero) get multiplier 0 and drop out exactly, so the
recursion keeps **static shapes across contact modes**, in place of OCS2's
mode-dependent projection.  This is algebraically the same
stage-wise equality-constrained QP the projection method solves.

The sweep itself is a `lax.scan`; under `vmap` each stage becomes a batched
(nu+ne)^2 factorization plus (nx)-sized matmuls.  solve_lqr_triton runs the
same math as one GPU kernel per sweep.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ocp.problem import LinearizedNode
from ..ops.linalg import solve_saddle_kkt

def _regs(dtype):
    """Dtype-aware regularization (float64 tests, float32 on the device)."""
    eps = float(jnp.finfo(dtype).eps)
    return max(1e-9, 100.0 * eps), max(1e-9, 100.0 * eps)


class RiccatiSolution(NamedTuple):
    dx: jnp.ndarray  # (N+1, nx)
    du: jnp.ndarray  # (N, nu)
    K: jnp.ndarray  # (N, nu, nx) feedback gains (du = -K dx - k)
    k: jnp.ndarray  # (N, nu)
    expected_decrease: jnp.ndarray  # () predicted cost reduction (1st order)


def _stage_kkt(node: LinearizedNode, eq_mask, S_next, s_next):
    """One backward stage; returns (S, s, K, k)."""
    A, B, c = node.A, node.B, node.c
    Sc = S_next @ c + s_next
    H_xx = node.Qxx + A.T @ (S_next @ A)
    H_uu = node.Quu + B.T @ (S_next @ B)
    H_ux = node.Qux + B.T @ (S_next @ A)
    h_x = node.qx + A.T @ Sc
    h_u = node.qu + B.T @ Sc

    nu = H_uu.shape[0]
    ne = node.e.shape[0]
    dual_eps, huu_reg = _regs(node.A.dtype)
    reg = eq_mask * dual_eps + (1.0 - eq_mask) * 1.0
    rhs_top = jnp.concatenate([H_ux, h_u[:, None]], axis=1)
    rhs_bot = jnp.concatenate([node.C, node.e[:, None]], axis=1)
    # quasi-definite KKT: pivot-free Gauss-Jordan vectorizes across the
    # scenario batch (ops/linalg.py), unlike LAPACK-style LU
    sol = solve_saddle_kkt(H_uu + huu_reg * jnp.eye(nu), node.D, reg, rhs_top, rhs_bot)
    K = sol[:nu, :-1]  # du = -K dx - k
    k = sol[:nu, -1]

    S = H_xx + K.T @ H_uu @ K - K.T @ H_ux - H_ux.T @ K
    s = h_x + K.T @ (H_uu @ k) - K.T @ h_u - H_ux.T @ k
    S = 0.5 * (S + S.T)
    return S, s, K, k


def solve_lqr(nodes: LinearizedNode, eq_masks, dx0) -> RiccatiSolution:
    """Backward Riccati + forward rollout over stacked node data.

    nodes: LinearizedNode with leading axis N; eq_masks: (N, ne);
    dx0: (nx,) initial state deviation (x_measured - x_traj[0]).
    """
    nx = nodes.A.shape[-1]
    S_T = jnp.zeros((nx, nx), nodes.A.dtype)
    s_T = jnp.zeros(nx, nodes.A.dtype)

    def backward(carry, inp):
        S_next, s_next = carry
        node, mask = inp
        S, s, K, k = _stage_kkt(node, mask, S_next, s_next)
        return (S, s), (K, k)

    (_, s0_out), (Ks, ks) = jax.lax.scan(
        backward, (S_T, s_T), (nodes, eq_masks), reverse=True
    )
    del s0_out

    def forward(dx, inp):
        node, K, k = inp
        du = -K @ dx - k
        dx_next = node.A @ dx + node.B @ du + node.c
        return dx_next, (dx, du)

    dx_last, (dxs, dus) = jax.lax.scan(forward, dx0, (nodes, Ks, ks))
    dx_all = jnp.concatenate([dxs, dx_last[None]], axis=0)
    # first-order predicted decrease: sum_k qx.dx + qu.du
    pred = jnp.sum(nodes.qx * dxs) + jnp.sum(nodes.qu * dus)
    return RiccatiSolution(dx=dx_all, du=dus, K=Ks, k=ks, expected_decrease=pred)


def _solve_lqr_triton_batched(nodes, eq_masks, dx0, interpret):
    from ..ops.riccati_triton import riccati_solve_triton

    dual_eps, huu_reg = _regs(nodes.A.dtype)
    Ks, ks, dx_all, dus = riccati_solve_triton(
        nodes, eq_masks, dx0, dual_eps, huu_reg, interpret
    )
    pred = jnp.sum(nodes.qx * dx_all[:, :-1], axis=(1, 2)) + jnp.sum(
        nodes.qu * dus, axis=(1, 2)
    )
    return RiccatiSolution(dx=dx_all, du=dus, K=Ks, k=ks, expected_decrease=pred)


@functools.cache
def _lqr_triton(interpret: bool):
    @jax.custom_batching.custom_vmap
    def solve(nodes, eq_masks, dx0):
        sol = _solve_lqr_triton_batched(
            jax.tree.map(lambda a: a[None], nodes), eq_masks[None], dx0[None], interpret
        )
        return jax.tree.map(lambda a: a[0], sol)

    @solve.def_vmap
    def _vmap(axis_size, in_batched, nodes, eq_masks, dx0):
        nodes_b, masks_b, dx0_b = in_batched
        bcast = lambda a: jnp.broadcast_to(a[None], (axis_size,) + a.shape)
        nodes = jax.tree.map(lambda a, b: a if b else bcast(a), nodes, nodes_b)
        eq_masks = eq_masks if masks_b else bcast(eq_masks)
        dx0 = dx0 if dx0_b else bcast(dx0)
        sol = _solve_lqr_triton_batched(nodes, eq_masks, dx0, interpret)
        return sol, jax.tree.map(lambda _: True, sol)

    return solve


def solve_lqr_triton(nodes: LinearizedNode, eq_masks, dx0, interpret: bool = False) -> RiccatiSolution:
    """Same sweep as :func:`solve_lqr` as two Pallas kernels for the GPU
    (ops/riccati_triton.py).  Under `jax.vmap` the whole scenario batch
    feeds one launch of each kernel, one program per scenario.
    `interpret=True` runs the Pallas interpreter (tests only)."""
    return _lqr_triton(bool(interpret))(nodes, eq_masks, dx0)
