"""Broadcast-multiply-reduce contractions for tiny-dim batched linear algebra.

`@` / `jnp.einsum` on small operands (3-22 wide) under a scenario batch
lowers to batched `dot_general`s, one tiny heavily padded matrix product per
batch element.  Expressing the same contractions as broadcast-multiply +
`sum` makes them elementwise work in which the batch dimension vectorizes
(XLA fuses the multiply into the reduction, so the (…, m, k, n) intermediate
is never materialized).

Use these ONLY for small inner dimensions (<~32); large contractions belong
in real matrix products.
"""
from __future__ import annotations

import jax.numpy as jnp


def mv(M, v):
    """(…, m, k) x (…, k) -> (…, m) as elementwise work."""
    return jnp.sum(M * v[..., None, :], axis=-1)


def mm(A, B):
    """(…, m, k) @ (…, k, n) -> (…, m, n) as elementwise work (small k/m/n only)."""
    return jnp.sum(A[..., :, :, None] * B[..., None, :, :], axis=-2)


def quad(v, M, w):
    """v^T M w with batching: (…, m), (…, m, k), (…, k) -> (…,)."""
    return jnp.sum(v * mv(M, w), axis=-1)
