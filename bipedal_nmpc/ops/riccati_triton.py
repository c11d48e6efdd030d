"""The constrained Riccati sweep as one Pallas kernel for Hopper (Triton route).

The XLA path (solver/riccati.py::solve_lqr) is a `lax.scan` over the N
stages whose stage-KKT solve is itself a `fori_loop` over nu + ne pivots
(ops/linalg.py): about N * (nu + ne) sequential loop iterations per sweep,
each at least one kernel launch on a GPU.  Here the whole backward sweep is
one launch and the forward rollout another:

- one program per scenario (grid = batch), so a scenario batch spreads over
  the SMs and B = 1 is a single program;
- the stage loop is a `fori_loop` over the N stages inside the program; the
  cost-to-go (S, s) is a loop carry held on chip;
- every tile is padded to a power of two (state and input 24 -> 32,
  constraint rows 16, the nu + ne KKT rows 40 -> 64); padded rows are
  decoupled identities that are never pivoted, so they change no real entry;
- the KKT matrix is assembled by products with 0/1 embedding matrices and
  solved by the same pivot-free Gauss-Jordan as ops/linalg.py, in the same
  pivot order (the matrix is quasi-definite, so pivots never vanish);
- every product runs at IEEE float32 (`Precision.HIGHEST`), never TF32.

Stage math is solver/riccati.py::_stage_kkt.  `interpret=True` runs the
kernels in the Pallas interpreter (the CPU tests, in float64).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

# warps per program: the tiles are at most 64 x 64, which 4 warps hold in
# registers without spilling
_NUM_WARPS = 4


def _pow2(n: int) -> int:
    """Smallest power of two >= max(n, 16) (Triton's minimum dot width)."""
    return max(16, 1 << (int(n) - 1).bit_length())


def _dot(a, b, ta: bool = False, tb: bool = False):
    """a @ b (a^T / b^T on request) at full precision, in the operands' dtype."""
    dims = (((0 if ta else 1,), (1 if tb else 0,)), ((), ()))
    return lax.dot_general(
        a, b, dims, precision=lax.Precision.HIGHEST, preferred_element_type=a.dtype
    )


def _mv(m, v):
    """m @ v for a small tile, as a broadcast-multiply-reduce."""
    return jnp.sum(m * v[None, :], axis=1)


def _mtv(m, v):
    """m^T @ v."""
    return jnp.sum(m * v[:, None], axis=0)


def _backward_kernel(
    nu, ne, dual_eps, huu_reg,
    A_ref, B_ref, c_ref, C_ref, D_ref, e_ref, Qxx_ref, Quu_ref, Qux_ref,
    qx_ref, qu_ref, mask_ref, K_ref, k_ref,
):
    N, X, _ = A_ref.shape
    U = B_ref.shape[-1]
    E = D_ref.shape[-2]
    M = _pow2(U + E)
    dt = A_ref.dtype
    rows_m = lax.iota(jnp.int32, M)
    rows_u = lax.iota(jnp.int32, U)
    rows_e = lax.iota(jnp.int32, E)
    rows_x = lax.iota(jnp.int32, X)
    # 0/1 embeddings of the input rows (0..U) and constraint rows (U..U+E)
    # into the M-row KKT tile
    Eu = (rows_m[:, None] == rows_u[None, :]).astype(dt)  # (M, U)
    Ee = (rows_m[:, None] == (rows_e[None, :] + U)).astype(dt)  # (M, E)
    eye_u = (rows_u[:, None] == rows_u[None, :]).astype(dt)
    eye_x = (rows_x[:, None] == rows_x[None, :]).astype(dt)
    diag_m = rows_m[:, None] == rows_m[None, :]

    def stage(j, carry):
        S, s = carry
        t = N - 1 - j
        A, B, c = A_ref[t], B_ref[t], c_ref[t]
        SA = _dot(S, A)
        SB = _dot(S, B)
        Sc = _mv(S, c) + s
        H_xx = Qxx_ref[t] + _dot(A, SA, ta=True)
        H_uu = Quu_ref[t] + _dot(B, SB, ta=True)
        H_ux = Qux_ref[t] + _dot(B, SA, ta=True)
        h_x = qx_ref[t] + _mtv(A, Sc)
        h_u = qu_ref[t] + _mtv(B, Sc)
        D = D_ref[t]
        mask = mask_ref[t]
        reg = mask * dual_eps + (1.0 - mask)

        # [[H_uu + rI, D^T], [D, -diag(reg)]] and its right-hand sides
        EuDt = _dot(Eu, D, tb=True)  # (M, E)
        L = (
            _dot(_dot(Eu, H_uu + huu_reg * eye_u), Eu, tb=True)
            + _dot(EuDt, Ee, tb=True)
            + _dot(Ee, EuDt, tb=True)
            - jnp.where(diag_m, jnp.sum(Ee * reg[None, :], axis=1)[:, None], 0.0)
        )
        R = _dot(Eu, H_ux) + _dot(Ee, C_ref[t])  # (M, X)
        r = jnp.sum(Eu * h_u[None, :], axis=1) + jnp.sum(Ee * e_ref[t][None, :], axis=1)

        def pivot(p, aug):
            L, R, r = aug
            i = jnp.where(p < nu, p, p - nu + U)  # skip the padded input rows
            sel = rows_m == i
            row_L = jnp.sum(jnp.where(sel[:, None], L, 0.0), axis=0)
            row_R = jnp.sum(jnp.where(sel[:, None], R, 0.0), axis=0)
            row_r = jnp.sum(jnp.where(sel, r, 0.0))
            col = jnp.sum(jnp.where(sel[None, :], L, 0.0), axis=1)
            inv = 1.0 / jnp.sum(jnp.where(sel, row_L, 0.0))
            # one rank-1 update that also lands the pivot row on row / pivot
            colm = col - sel.astype(dt)
            L = L - colm[:, None] * (row_L * inv)[None, :]
            R = R - colm[:, None] * (row_R * inv)[None, :]
            r = r - colm * (row_r * inv)
            return L, R, r

        L, R, r = lax.fori_loop(0, nu + ne, pivot, (L, R, r))
        K = _dot(Eu, R, ta=True)  # (U, X): du = -K dx - k
        k = jnp.sum(Eu * r[:, None], axis=0)

        S = H_xx + _dot(K, _dot(H_uu, K), ta=True) - _dot(K, H_ux, ta=True) - _dot(H_ux, K, ta=True)
        S = 0.5 * (S + _dot(eye_x, S, tb=True))
        s = h_x + _mtv(K, _mv(H_uu, k)) - _mtv(K, h_u) - _mtv(H_ux, k)
        K_ref[t] = K
        k_ref[t] = k
        return S, s

    zero_s = jnp.zeros((X,), dt)
    lax.fori_loop(0, N, stage, (jnp.zeros((X, X), dt), zero_s))


def _forward_kernel(A_ref, B_ref, c_ref, K_ref, k_ref, dx0_ref, dxs_ref, dus_ref, dxN_ref):
    N = A_ref.shape[0]

    def stage(t, dx):
        du = -_mv(K_ref[t], dx) - k_ref[t]
        dxs_ref[t] = dx
        dus_ref[t] = du
        return _mv(A_ref[t], dx) + _mv(B_ref[t], du) + c_ref[t]

    dxN_ref[...] = lax.fori_loop(0, N, stage, dx0_ref[...])


def _pad(a, shape):
    return jnp.pad(a, [(0, n - m) for m, n in zip(a.shape, shape)])


def _spec(block):
    """One scenario's whole horizon: batch axis squeezed, every other full."""
    return pl.BlockSpec((None,) + block, lambda b: (b,) + (0,) * len(block))


def riccati_solve_triton(nodes, masks, dx0, dual_eps: float, huu_reg: float, interpret: bool = False):
    """Backward sweep + forward rollout over a scenario batch.

    nodes: LinearizedNode with leading axes (B, N, ...); masks (B, N, ne);
    dx0 (B, nx).  Returns K (B, N, nu, nx), k (B, N, nu), dx (B, N+1, nx),
    du (B, N, nu).
    """
    Bb, N, nx, nu = nodes.B.shape
    ne = nodes.e.shape[-1]
    X, U, E = _pow2(nx), _pow2(nu), _pow2(ne)
    dt = nodes.A.dtype
    mats = dict(
        A=_pad(nodes.A, (Bb, N, X, X)),
        B=_pad(nodes.B, (Bb, N, X, U)),
        c=_pad(nodes.c, (Bb, N, X)),
        C=_pad(nodes.C, (Bb, N, E, X)),
        D=_pad(nodes.D, (Bb, N, E, U)),
        e=_pad(nodes.e, (Bb, N, E)),
        Qxx=_pad(nodes.Qxx, (Bb, N, X, X)),
        Quu=_pad(nodes.Quu, (Bb, N, U, U)),
        Qux=_pad(nodes.Qux, (Bb, N, U, X)),
        qx=_pad(nodes.qx, (Bb, N, X)),
        qu=_pad(nodes.qu, (Bb, N, U)),
        mask=_pad(masks.astype(dt), (Bb, N, E)),
    )
    params = dict(
        grid=(Bb,),
        interpret=interpret,
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=_NUM_WARPS, num_stages=1),
    )
    K, k = pl.pallas_call(
        functools.partial(_backward_kernel, nu, ne, dual_eps, huu_reg),
        out_shape=[
            jax.ShapeDtypeStruct((Bb, N, U, X), dt),
            jax.ShapeDtypeStruct((Bb, N, U), dt),
        ],
        in_specs=[_spec(m.shape[1:]) for m in mats.values()],
        out_specs=[_spec((N, U, X)), _spec((N, U))],
        name="riccati_backward",
        **params,
    )(*mats.values())
    dxs, dus, dxN = pl.pallas_call(
        _forward_kernel,
        out_shape=[
            jax.ShapeDtypeStruct((Bb, N, X), dt),
            jax.ShapeDtypeStruct((Bb, N, U), dt),
            jax.ShapeDtypeStruct((Bb, X), dt),
        ],
        in_specs=[_spec((N, X, X)), _spec((N, X, U)), _spec((N, X)), _spec((N, U, X)),
                  _spec((N, U)), _spec((X,))],
        out_specs=[_spec((N, X)), _spec((N, U)), _spec((X,))],
        name="riccati_forward",
        **params,
    )(mats["A"], mats["B"], mats["c"], K, k, _pad(dx0, (Bb, X)))
    dx_all = jnp.concatenate([dxs, dxN[:, None]], axis=1)[..., :nx]
    return K[..., :nu, :nx], k[..., :nu], dx_all, dus[..., :nu]
