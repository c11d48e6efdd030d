"""Riccati sweep vs a dense KKT oracle on random constrained LQR problems."""
import jax.numpy as jnp
import numpy as np

from bipedal_nmpc.ocp.problem import LinearizedNode
from bipedal_nmpc.solver.riccati import solve_lqr


def _random_problem(rng, N=6, nx=4, nu=3, ne=2, constrained=True):
    nodes = []
    masks = []
    for k in range(N):
        A = rng.normal(size=(nx, nx)) * 0.3 + np.eye(nx)
        B = rng.normal(size=(nx, nu)) * 0.4
        c = rng.normal(size=nx) * 0.1
        Qxx = _spd(rng, nx, 1.0)
        Quu = _spd(rng, nu, 1.0)
        Qux = rng.normal(size=(nu, nx)) * 0.05
        qx = rng.normal(size=nx)
        qu = rng.normal(size=nu)
        if constrained:
            C = rng.normal(size=(ne, nx)) * 0.5
            D = rng.normal(size=(ne, nu)) + np.eye(ne, nu)
            e = rng.normal(size=ne) * 0.2
            mask = np.ones(ne)
            if k % 2 == 1:  # alternate: second row masked out
                C[1] = 0
                D[1] = 0
                e[1] = 0
                mask[1] = 0
        else:
            C = np.zeros((ne, nx))
            D = np.zeros((ne, nu))
            e = np.zeros(ne)
            mask = np.zeros(ne)
        nodes.append((A, B, c, C, D, e, Qxx, Quu, Qux, qx, qu))
        masks.append(mask)
    stacked = LinearizedNode(
        *[jnp.asarray(np.stack([n[i] for n in nodes])) for i in range(11)],
        cost=jnp.zeros(N),
    )
    return stacked, jnp.asarray(np.stack(masks))


def _spd(rng, n, scale):
    W = rng.normal(size=(n, n))
    return W @ W.T * scale / n + np.eye(n)


def _dense_solution(nodes, masks, dx0):
    """Solve the full trajectory QP with numpy KKT (oracle)."""
    N, nx = nodes.A.shape[0], nodes.A.shape[1]
    nu = nodes.B.shape[2]
    A = np.asarray(nodes.A)
    B = np.asarray(nodes.B)
    c = np.asarray(nodes.c)
    C = np.asarray(nodes.C)
    D = np.asarray(nodes.D)
    e = np.asarray(nodes.e)
    masks = np.asarray(masks)

    # variables: dx_0..N (N+1)*nx, du_0..N-1 N*nu
    nvar = (N + 1) * nx + N * nu

    def xi(k):
        return slice(k * nx, (k + 1) * nx)

    def ui(k):
        return slice((N + 1) * nx + k * nu, (N + 1) * nx + (k + 1) * nu)

    H = np.zeros((nvar, nvar))
    g = np.zeros(nvar)
    for k in range(N):
        H[xi(k), xi(k)] += np.asarray(nodes.Qxx[k])
        H[ui(k), ui(k)] += np.asarray(nodes.Quu[k])
        H[ui(k), xi(k)] += np.asarray(nodes.Qux[k])
        H[xi(k), ui(k)] += np.asarray(nodes.Qux[k]).T
        g[xi(k)] += np.asarray(nodes.qx[k])
        g[ui(k)] += np.asarray(nodes.qu[k])

    cons = []  # (row_coeffs, rhs)
    # initial condition dx_0 = dx0
    for i in range(nx):
        row = np.zeros(nvar)
        row[i] = 1.0
        cons.append((row, dx0[i]))
    for k in range(N):
        for i in range(nx):  # dynamics
            row = np.zeros(nvar)
            row[xi(k + 1)] -= np.eye(nx)[i]
            row[xi(k)] += A[k][i]
            row[ui(k)] += B[k][i]
            cons.append((row, -c[k][i]))
        kept = np.zeros((0, nx + nu))
        for j in range(C.shape[1]):  # equality constraints (active rows only)
            if masks[k][j] == 0:
                continue
            # drop a row that depends on the rows kept so far (two contact
            # points on one rigid foot give dependent velocity rows); the
            # solver's dual regularization copes with them, a dense solve
            # cannot
            cand = np.vstack([kept, np.concatenate([C[k][j], D[k][j]])])
            if np.linalg.matrix_rank(cand) == kept.shape[0]:
                continue
            kept = cand
            row = np.zeros(nvar)
            row[xi(k)] = C[k][j]
            row[ui(k)] = D[k][j]
            cons.append((row, -e[k][j]))
    Amat = np.stack([r for r, _ in cons])
    b = np.array([v for _, v in cons])
    ncon = len(cons)
    KKT = np.block([[H, Amat.T], [Amat, np.zeros((ncon, ncon))]])
    rhs = np.concatenate([-g, b])
    sol = np.linalg.solve(KKT, rhs)
    dxs = sol[: (N + 1) * nx].reshape(N + 1, nx)
    dus = sol[(N + 1) * nx : nvar].reshape(N, nu)
    return dxs, dus


def test_unconstrained_lqr_matches_dense():
    rng = np.random.default_rng(3)
    nodes, masks = _random_problem(rng, constrained=False)
    dx0 = jnp.asarray(rng.normal(size=4) * 0.1)
    sol = solve_lqr(nodes, masks, dx0)
    dxs, dus = _dense_solution(nodes, masks, np.asarray(dx0))
    np.testing.assert_allclose(np.asarray(sol.dx), dxs, atol=1e-6)
    np.testing.assert_allclose(np.asarray(sol.du), dus, atol=1e-6)


def test_constrained_lqr_matches_dense():
    rng = np.random.default_rng(4)
    nodes, masks = _random_problem(rng, constrained=True)
    dx0 = jnp.asarray(rng.normal(size=4) * 0.1)
    sol = solve_lqr(nodes, masks, dx0)
    dxs, dus = _dense_solution(nodes, masks, np.asarray(dx0))
    np.testing.assert_allclose(np.asarray(sol.dx), dxs, atol=1e-5)
    np.testing.assert_allclose(np.asarray(sol.du), dus, atol=1e-5)
    # active constraint rows are satisfied along the solution
    for k in range(nodes.A.shape[0]):
        res = np.asarray(nodes.C[k]) @ dxs[k] + np.asarray(nodes.D[k]) @ np.asarray(sol.du[k]) + np.asarray(
            nodes.e[k]
        )
        np.testing.assert_allclose(np.asarray(masks[k]) * res, 0, atol=1e-6)


def test_feedback_gains_reproduce_solution():
    """du_k == -K_k dx_k - k_k along the optimal trajectory."""
    rng = np.random.default_rng(5)
    nodes, masks = _random_problem(rng, constrained=True)
    dx0 = jnp.asarray(rng.normal(size=4) * 0.1)
    sol = solve_lqr(nodes, masks, dx0)
    for k in range(nodes.A.shape[0]):
        du = -np.asarray(sol.K[k]) @ np.asarray(sol.dx[k]) - np.asarray(sol.k[k])
        np.testing.assert_allclose(du, np.asarray(sol.du[k]), atol=1e-8)
