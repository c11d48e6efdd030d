"""Small dense linear algebra that vectorizes over a scenario batch.

`jnp.linalg.solve` lowers to pivoted LU, which serializes badly for
the small (38x38-ish) per-stage KKT systems inside the Riccati scan — and
under a scenario batch it gains nothing from the vector lanes.  Here:

- :func:`gauss_jordan_solve`: pivot-free Gauss-Jordan elimination as a
  fori_loop of rank-1 updates.  Every step is an outer product over the
  (batch, n, n+k) augmented matrix — pure elementwise work that vectorizes across the
  batch.  No pivoting is safe for our KKT: the (1,1) block has a positive
  diagonal (regularized Gauss-Newton Hessian) and the trailing Schur
  complement is negative definite (dual regularization), so pivots never
  vanish (quasi-definite matrix, Vanderbei).

- :func:`solve_saddle_kkt`: convenience wrapper for [[H, D^T], [D, -E]].
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def gauss_jordan_solve(A, B):
    """Solve A X = B for quasi-definite A without pivoting.

    A: (..., n, n); B: (..., n, k) -> X: (..., n, k).
    """
    n = A.shape[-1]
    aug = jnp.concatenate([A, B], axis=-1)  # (..., n, n+k)
    row_ids = jnp.arange(n)

    def step(i, aug):
        pivot_row = aug[..., i, :]  # (..., n+k)
        pivot = jnp.take(pivot_row, i, axis=-1)[..., None]  # (..., 1)
        norm_row = pivot_row / pivot  # (..., n+k)
        col = aug[..., :, i]  # (..., n)
        # single fused rank-1 update that also lands the pivot row on
        # norm_row: row i gets aug_i - (pivot - 1) norm_row = norm_row.
        # (avoids a scatter of .at[i].set per pivot)
        e_i = (row_ids == i).astype(aug.dtype)
        aug = aug - (col - e_i)[..., :, None] * norm_row[..., None, :]
        return aug

    aug = jax.lax.fori_loop(0, n, step, aug)
    return aug[..., :, A.shape[-1] :]


def inv3(A):
    """Closed-form 3x3 inverse via the adjugate — pure elementwise math, no
    pivoting/LU, so it vectorizes perfectly over any batch as elementwise work.

    A: (..., 3, 3).  Safe whenever det(A) is bounded away from 0 (our use:
    well-conditioned inertia-like blocks).
    """
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = e * i - f * h
    c01 = c * h - b * i
    c02 = b * f - c * e
    c10 = f * g - d * i
    c11 = a * i - c * g
    c12 = c * d - a * f
    c20 = d * h - e * g
    c21 = b * g - a * h
    c22 = a * e - b * d
    det = a * c00 + b * c10 + c * c20
    adj = jnp.stack(
        [
            jnp.stack([c00, c01, c02], axis=-1),
            jnp.stack([c10, c11, c12], axis=-1),
            jnp.stack([c20, c21, c22], axis=-1),
        ],
        axis=-2,
    )
    return adj / det[..., None, None]


def inv6_block(A):
    """6x6 inverse by 3x3 block-Schur elimination (no pivoting, no LU).

    A: (..., 6, 6).  Built for the centroidal-momentum base block A_b, whose
    (1,1) block is m*I (trivially invertible) and whose Schur complement is
    the locked angular inertia about the com mapped through the Euler-rate
    map — invertible away from gimbal lock, exactly like the reference's
    direct solve.  Replaces jnp.linalg.inv/solve, whose batched pivoted LU
    serializes per batch element.
    """
    from .contract import mm

    A11 = A[..., :3, :3]
    A12 = A[..., :3, 3:]
    A21 = A[..., 3:, :3]
    A22 = A[..., 3:, 3:]
    A11i = inv3(A11)
    A11i_A12 = mm(A11i, A12)
    S = A22 - mm(A21, A11i_A12)
    Si = inv3(S)
    A21_A11i = mm(A21, A11i)
    top_right = -mm(A11i_A12, Si)
    bottom_left = -mm(Si, A21_A11i)
    top_left = A11i - mm(top_right, A21_A11i)
    top = jnp.concatenate([top_left, top_right], axis=-1)
    bottom = jnp.concatenate([bottom_left, Si], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


def solve_saddle_kkt(H, D, reg, rhs_top, rhs_bot):
    """Solve [[H, D^T], [D, -diag(reg)]] [x; y] = [rhs_top; rhs_bot].

    Shapes: H (..., n, n), D (..., m, n), reg (..., m),
    rhs_top (..., n, k), rhs_bot (..., m, k).
    """
    m = D.shape[-2]
    kkt = jnp.concatenate(
        [
            jnp.concatenate([H, D.swapaxes(-1, -2)], axis=-1),
            jnp.concatenate([D, -_batch_diag(reg, m)], axis=-1),
        ],
        axis=-2,
    )
    rhs = jnp.concatenate([rhs_top, rhs_bot], axis=-2)
    return gauss_jordan_solve(kkt, rhs)


def _batch_diag(v, m):
    return v[..., :, None] * jnp.eye(m)
