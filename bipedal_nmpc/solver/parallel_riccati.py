"""Parallel-in-time Riccati via associative scan.

The sequential backward sweep (riccati.py) has O(N) depth; this variant runs
the value recursion as a `jax.lax.associative_scan` with O(log N) depth —
the domain's "sequence parallelism" (SURVEY.md §5.7): the 67-node horizon
collapses to ~7 rounds of batched matrix products.

Formulation (Särkkä & García-Fernández, temporal parallelization of LQT):
each stage is a conditional value function

    f(x, z) = 1/2 (z - A x - b)^T C^{-1} (z - A x - b) + 1/2 x^T J x - eta^T x

represented by the quintuple (A, b, C, eta, J) (C == 0 encodes a hard
dynamics constraint off its range); composition

    (f1 (x,y) combined with f2 (y,z)) = min_y f1 + f2

is associative with closed-form combination requiring only
(I + C1 J2)^{-1}.  Stage-wise equality constraints are folded in by a
quadratic penalty (rho) before building elements, so masked rows keep static
shapes; the final feedback gains are then recovered with the *exact*
stage-KKT solve of riccati.py against the scanned value functions.

Penalty choice: R + rho D^T D is inverted per stage, so rho trades constraint
accuracy O(1/rho) against conditioning O(rho * eps): rho ~ 1e6 is the f64
sweet spot (~1e-6 agreement with the exact sequential sweep).

**Dense composition is f64 only.** Measured in f32, the dense chain
(repeated (I + C J)^{-1} products over 67 stages) loses the solution at every
penalty tried (1e3-3e4: zero accepted steps, NaN above) — the scanned value
functions are too ill-conditioned for single precision.
`solve_lqr_parallel` therefore raises on f32 input.

**Square-root composition (f32-capable).** `solve_lqr_parallel_sqrt` keeps
C = U U^T and J = Z Z^T in factor form through the scan.  The f32 claim is
validated in the full on-device closed-loop cascade, with two caveats that
ARE part of the claim (an earlier sweep recorded 0% survival before they
were understood): it needs (a) full-f32 matmul precision — under a
single-pass-bf16 dot lowering the factor QR chain collapses — and
(b) the batch loop's freeze-on-fall guard, without which post-fall
divergence pollutes the whole lane.  With both (the framework defaults
since round 5), randomized-walking survival at standard jitter is 0.625 vs
the sequential backend's 0.531 (B=64, float32 cascade).  Validated at
B<=64; cascade batch 256 is untested on the GPU.  With W = U1^T Z2
and the push-through identity,

    (I + C1 J2)^{-1} C1 = U1 (I + W W^T)^{-1} U1^T
    (I + J2 C1)^{-1} J2 = Z2 (I + W^T W)^{-1} Z2^T
    (I + C1 J2)^{-1} X  = X - U1 (I + W W^T)^{-1} W (Z2^T X)

so every inverse becomes a pair of triangular solves against R_C / R_J from
QR factorizations R^T R = I + W W^T (resp. W^T W) — the Gram products that
destroyed f32 are never formed.  The factor stacks [A2 U1 R_C^{-1} | U2] are
re-triangularized with one more QR per combine (tria()).  This is the
square-root temporal parallelization of LQT in the spirit of the sqrt
parallel Kalman/smoother algorithms (Yaghoobi et al.), adapted to the
penalty-folded constrained stage elements used here.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ocp.problem import LinearizedNode
from .riccati import RiccatiSolution, _stage_kkt


class _Element(NamedTuple):
    A: jnp.ndarray
    b: jnp.ndarray
    C: jnp.ndarray
    eta: jnp.ndarray
    J: jnp.ndarray


def _combine(e1: _Element, e2: _Element) -> _Element:
    """f1 spans [i, j], f2 spans [j, k] -> combined spans [i, k].

    All ops written batched-safe (einsum for mat-vec; leading batch axes from
    associative_scan broadcast through jnp.linalg.solve).
    """
    nx = e1.A.shape[-1]
    I = jnp.eye(nx)
    mv = lambda M, v: jnp.einsum("...ij,...j->...i", M, v)
    mTv = lambda M, v: jnp.einsum("...ji,...j->...i", M, v)
    G1 = I + e1.C @ e2.J  # (.., nx, nx)
    G2 = I + e2.J @ e1.C
    M = jnp.linalg.solve(G1, e1.A)
    N = jnp.linalg.solve(G2, e2.J)
    A = e2.A @ M
    b = mv(e2.A, jnp.linalg.solve(G1, (e1.b + mv(e1.C, e2.eta))[..., None])[..., 0]) + e2.b
    C = e2.A @ jnp.linalg.solve(G1, e1.C) @ e2.A.swapaxes(-1, -2) + e2.C
    eta = mTv(e1.A, jnp.linalg.solve(G2, (e2.eta - mv(e2.J, e1.b))[..., None])[..., 0]) + e1.eta
    J = e1.A.swapaxes(-1, -2) @ N @ e1.A + e1.J
    return _Element(
        A=A, b=b, C=0.5 * (C + C.swapaxes(-1, -2)), eta=eta, J=0.5 * (J + J.swapaxes(-1, -2))
    )


def _stage_elements(nodes: LinearizedNode, eq_masks, penalty: float) -> _Element:
    """Build per-stage elements with constraints folded as a quadratic penalty."""

    def one(node, mask):
        D = mask[:, None] * node.D
        C_ = mask[:, None] * node.C
        e_ = mask * node.e
        R = node.Quu + penalty * D.T @ D
        P = node.Qux + penalty * D.T @ C_
        r = node.qu + penalty * D.T @ e_
        Q = node.Qxx + penalty * C_.T @ C_
        q = node.qx + penalty * C_.T @ e_
        Rinv = jnp.linalg.inv(R)
        A_bar = node.A - node.B @ Rinv @ P
        b_bar = node.c - node.B @ Rinv @ r
        C_bar = node.B @ Rinv @ node.B.T
        J_bar = Q - P.T @ Rinv @ P
        eta_bar = -(q - P.T @ Rinv @ r)
        return _Element(A=A_bar, b=b_bar, C=C_bar, eta=eta_bar, J=J_bar)

    return jax.vmap(one)(nodes, eq_masks)


def value_functions_parallel(nodes: LinearizedNode, eq_masks, penalty: float = 1e6):
    """(S, s) at nodes 1..N (value-to-go of the tail) via associative scan.

    Returns arrays of shape (N, nx, nx) / (N, nx): entry k is the value
    function at node k+1 (what the stage-k KKT needs).
    """
    nx = nodes.A.shape[-1]
    N = nodes.A.shape[0]
    elems = _stage_elements(nodes, eq_masks, penalty)
    # reversed-time scan: combined[k] = f_k x f_{k+1} x ... x f_{N-1}
    rev = jax.tree.map(lambda a: a[::-1], elems)

    def comb(e_later, e_earlier):
        # arguments arrive in reversed-time order: e_earlier precedes e_later
        return _combine(e_earlier, e_later)

    scanned = jax.lax.associative_scan(comb, rev)
    scanned = jax.tree.map(lambda a: a[::-1], scanned)
    # scanned[k] spans [k, N] with terminal value 0: V_k(x) = 1/2 x J x - eta x
    S_all = scanned.J  # (N, nx, nx): value at node k
    s_all = -scanned.eta
    # we need V at nodes 1..N: V_N = 0
    S_next = jnp.concatenate([S_all[1:], jnp.zeros((1, nx, nx))], axis=0)
    s_next = jnp.concatenate([s_all[1:], jnp.zeros((1, nx))], axis=0)
    return S_next, s_next


class _SqrtElement(NamedTuple):
    A: jnp.ndarray
    b: jnp.ndarray
    U: jnp.ndarray  # C = U U^T
    eta: jnp.ndarray
    Z: jnp.ndarray  # J = Z Z^T


def _tria(M):
    """Lower-triangular T with T T^T = M M^T, for M (..., n, m), m >= n."""
    R = jnp.linalg.qr(M.swapaxes(-1, -2), mode="r")  # (..., n, n) upper
    return R.swapaxes(-1, -2)


def _combine_sqrt(e1: _SqrtElement, e2: _SqrtElement) -> _SqrtElement:
    """Square-root composition: same algebra as :func:`_combine`, but every
    (I + C J)^{-1} is applied through QR factors of I + W W^T / I + W^T W
    (W = U1^T Z2), so no Gram matrix is ever formed."""
    from jax.lax.linalg import triangular_solve

    nx = e1.A.shape[-1]
    I = jnp.broadcast_to(jnp.eye(nx, dtype=e1.A.dtype), e1.A.shape)
    mT = lambda M: M.swapaxes(-1, -2)
    W = mT(e1.U) @ e2.Z  # (.., nx, nx)
    # R_C^T R_C = I + W W^T ; R_J^T R_J = I + W^T W  (QR of tall stacks)
    R_C = jnp.linalg.qr(jnp.concatenate([mT(W), I], axis=-2), mode="r")
    R_J = jnp.linalg.qr(jnp.concatenate([W, I], axis=-2), mode="r")

    def solve_RtR(R, X):  # (R^T R)^{-1} X via two triangular solves
        Y = triangular_solve(R, X, left_side=True, lower=False, transpose_a=True)
        return triangular_solve(R, Y, left_side=True, lower=False)

    # (I + C1 J2)^{-1} X = X - U1 (I + W W^T)^{-1} W Z2^T X
    g1inv = lambda X: X - e1.U @ solve_RtR(R_C, W @ (mT(e2.Z) @ X))
    # (I + J2 C1)^{-1} X = X - Z2 (I + W^T W)^{-1} W^T U1^T X
    g2inv = lambda X: X - e2.Z @ solve_RtR(R_J, mT(W) @ (mT(e1.U) @ X))

    A = e2.A @ g1inv(e1.A)
    rhs_b = (e1.b + (e1.U @ (mT(e1.U) @ e2.eta[..., None]))[..., 0])[..., None]
    b = (e2.A @ g1inv(rhs_b))[..., 0] + e2.b
    rhs_eta = (e2.eta - (e2.Z @ (mT(e2.Z) @ e1.b[..., None]))[..., 0])[..., None]
    eta = (mT(e1.A) @ g2inv(rhs_eta))[..., 0] + e1.eta

    # C = (A2 U1 R_C^{-1}) (.)^T + C2 ;  J = (A1^T Z2 R_J^{-1}) (.)^T + J1
    AU = e2.A @ e1.U  # (.., nx, nx); right-divide by R_C: Y R_C = AU
    Y_C = mT(triangular_solve(R_C, mT(AU), left_side=True, lower=False, transpose_a=True))
    AZ = mT(e1.A) @ e2.Z
    Y_J = mT(triangular_solve(R_J, mT(AZ), left_side=True, lower=False, transpose_a=True))
    U = _tria(jnp.concatenate([Y_C, e2.U], axis=-1))
    Z = _tria(jnp.concatenate([Y_J, e1.Z], axis=-1))
    return _SqrtElement(A=A, b=b, U=U, eta=eta, Z=Z)


def _psd_sqrt(M, eps):
    """Factor Z with Z Z^T = PSD(M) via eigh (clipped eigenvalues)."""
    lam, V = jnp.linalg.eigh(0.5 * (M + M.swapaxes(-1, -2)))
    return V * jnp.sqrt(jnp.maximum(lam, eps))[..., None, :]


def _stage_elements_sqrt(nodes: LinearizedNode, eq_masks, penalty: float) -> _SqrtElement:
    """Per-stage sqrt elements: U from Cholesky of R (PD), Z from the PSD
    square root of the Schur complement Q - P^T R^{-1} P (Gauss-Newton =>
    PSD up to roundoff; eigenvalues clipped at 0)."""

    def one(node, mask):
        D = mask[:, None] * node.D
        C_ = mask[:, None] * node.C
        e_ = mask * node.e
        R = node.Quu + penalty * D.T @ D
        P = node.Qux + penalty * D.T @ C_
        r = node.qu + penalty * D.T @ e_
        Q = node.Qxx + penalty * C_.T @ C_
        q = node.qx + penalty * C_.T @ e_
        L = jnp.linalg.cholesky(R)
        Linv_P = jax.scipy.linalg.solve_triangular(L, P, lower=True)
        Linv_r = jax.scipy.linalg.solve_triangular(L, r, lower=True)
        Linv_Bt = jax.scipy.linalg.solve_triangular(L, node.B.T, lower=True)
        A_bar = node.A - Linv_Bt.T @ Linv_P
        b_bar = node.c - Linv_Bt.T @ Linv_r
        # C = B R^{-1} B^T = (B L^{-T})(.)^T; bring the rank-min(nu,nx)
        # factor to exactly nx columns so scan elements have uniform shape
        nx, nu = node.A.shape[0], node.B.shape[1]
        if nu >= nx:
            U = _tria(Linv_Bt.T)  # (nx, nx), same outer product
        else:
            U = jnp.concatenate(
                [Linv_Bt.T, jnp.zeros((nx, nx - nu), dtype=node.A.dtype)], axis=1
            )
        J_bar = Q - Linv_P.T @ Linv_P
        eta_bar = -(q - Linv_P.T @ Linv_r)
        Z = _psd_sqrt(J_bar, 0.0)
        return _SqrtElement(A=A_bar, b=b_bar, U=U, eta=eta_bar, Z=Z)

    return jax.vmap(one)(nodes, eq_masks)


def value_functions_parallel_sqrt(nodes: LinearizedNode, eq_masks, penalty: float = 1e4):
    """(S, s) at nodes 1..N via the square-root associative scan (any dtype)."""
    nx = nodes.A.shape[-1]
    elems = _stage_elements_sqrt(nodes, eq_masks, penalty)
    rev = jax.tree.map(lambda a: a[::-1], elems)
    scanned = jax.lax.associative_scan(lambda e_l, e_e: _combine_sqrt(e_e, e_l), rev)
    scanned = jax.tree.map(lambda a: a[::-1], scanned)
    J_all = scanned.Z @ scanned.Z.swapaxes(-1, -2)
    S_next = jnp.concatenate([J_all[1:], jnp.zeros((1, nx, nx), dtype=J_all.dtype)], axis=0)
    s_next = jnp.concatenate(
        [-scanned.eta[1:], jnp.zeros((1, nx), dtype=J_all.dtype)], axis=0
    )
    return S_next, s_next


def solve_lqr_parallel_sqrt(
    nodes: LinearizedNode, eq_masks, dx0, penalty: float = 1e4
) -> RiccatiSolution:
    """f32-capable parallel-in-time constrained LQR (square-root scan +
    exact per-stage KKT gains + associative-scan forward rollout)."""
    S_next, s_next = value_functions_parallel_sqrt(nodes, eq_masks, penalty)
    return _gains_and_rollout(nodes, eq_masks, S_next, s_next, dx0)


def _gains_and_rollout(nodes, eq_masks, S_next, s_next, dx0) -> RiccatiSolution:
    def gains(node, mask, S, s):
        _, _, K, k = _stage_kkt(node, mask, S, s)
        return K, k

    Ks, ks = jax.vmap(gains)(nodes, eq_masks, S_next, s_next)

    F = nodes.A - jnp.einsum("kij,kjl->kil", nodes.B, Ks)
    f = nodes.c - jnp.einsum("kij,kj->ki", nodes.B, ks)

    def aff_comb(m1, m2):
        F1, f1 = m1
        F2, f2 = m2
        return F2 @ F1, jnp.einsum("kij,kj->ki", F2, f1) + f2

    Fp, fp = jax.lax.associative_scan(lambda a, b: aff_comb(a, b), (F, f))
    dx_tail = jnp.einsum("kij,j->ki", Fp, dx0) + fp
    dx_all = jnp.concatenate([dx0[None], dx_tail], axis=0)
    dus = -jnp.einsum("kij,kj->ki", Ks, dx_all[:-1]) - ks
    pred = jnp.sum(nodes.qx * dx_all[:-1]) + jnp.sum(nodes.qu * dus)
    return RiccatiSolution(dx=dx_all, du=dus, K=Ks, k=ks, expected_decrease=pred)


def solve_lqr_parallel(nodes: LinearizedNode, eq_masks, dx0, penalty: float = 1e6) -> RiccatiSolution:
    """Parallel-in-time constrained LQR: scanned value functions + exact
    per-stage KKT gains + associative-scan forward rollout.  f64 only (see
    module docstring for the measured f32 failure mode)."""
    if nodes.A.dtype != jnp.float64:
        raise NotImplementedError(
            "parallel Riccati requires float64 (f32 composition is unstable; "
            "use the sequential backend, which meets the latency budget)"
        )
    S_next, s_next = value_functions_parallel(nodes, eq_masks, penalty)

    def gains(node, mask, S, s):
        _, _, K, k = _stage_kkt(node, mask, S, s)
        return K, k

    Ks, ks = jax.vmap(gains)(nodes, eq_masks, S_next, s_next)

    # forward rollout as an associative scan over affine maps
    F = nodes.A - jnp.einsum("kij,kjl->kil", nodes.B, Ks)
    f = nodes.c - jnp.einsum("kij,kj->ki", nodes.B, ks)

    def aff_comb(m1, m2):
        # m1 earlier: x -> F1 x + f1; m2 later
        F1, f1 = m1
        F2, f2 = m2
        return F2 @ F1, jnp.einsum("kij,kj->ki", F2, f1) + f2

    # prefix scan of compositions: P_k = F_{k-1} o ... o F_0
    Fp, fp = jax.lax.associative_scan(lambda a, b: aff_comb(a, b), (F, f))
    dx_tail = jnp.einsum("kij,j->ki", Fp, dx0) + fp  # dx at nodes 1..N
    dx_all = jnp.concatenate([dx0[None], dx_tail], axis=0)
    dus = -jnp.einsum("kij,kj->ki", Ks, dx_all[:-1]) - ks
    pred = jnp.sum(nodes.qx * dx_all[:-1]) + jnp.sum(nodes.qu * dus)
    return RiccatiSolution(dx=dx_all, du=dus, K=Ks, k=ks, expected_decrease=pred)
