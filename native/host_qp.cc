// Host-side ADMM iteration kernel for the real-time WBC QP.
//
// The reference's 400-500 Hz torque path solves its QP natively on the host
// (qpOASES C++, bipedal_wbc/src/WeightedWbc.cpp:53-81).  Our host solver
// (bipedal_nmpc/wbc/host_wbc.py) assembles the problem in numpy and
// factorizes the small SPD Schur complement once per tick; the fixed-point
// iterations are pure small-matrix arithmetic where numpy's per-call
// overhead (~1.5 us x ~10 calls x 40 iterations) dominates the flops, so
// they run here instead.  Semantics identical to solve_qp_np's python loop.
//
// Build: g++ -O3 -shared -fPIC (driven by wbc/native_qp.py).

#include <cstddef>

namespace {

// y = M x  for row-major M (rows x cols)
inline void gemv(const double* M, const double* x, double* y, int rows, int cols) {
  for (int i = 0; i < rows; ++i) {
    const double* row = M + static_cast<std::size_t>(i) * cols;
    double acc = 0.0;
    for (int j = 0; j < cols; ++j) acc += row[j] * x[j];
    y[i] = acc;
  }
}

}  // namespace

extern "C" {

// One warm-startable ADMM run (OSQP-style, relaxation alpha, per-row rho).
//   P_inv  : (n,n) inverse of H + sigma I + A^T diag(rho) A
//   A      : (m,n)
//   rho_AT : (n,m) = (diag(rho) A)^T
//   x,z,y  : in/out iterates
//   scratch: workspace >= 2n + 2m doubles
void admm_iterate(const double* P_inv, const double* A, const double* rho_AT,
                  const double* g, const double* l, const double* u,
                  const double* rho_vec, const double* inv_rho, double sigma,
                  double alpha, int n, int m, int iters, double* x, double* z,
                  double* y, double* scratch) {
  double* b_rhs = scratch;          // m
  double* rhs = scratch + m;        // n
  double* x_t = scratch + m + n;    // reuse rhs area? keep separate: n
  double* ax = scratch + m + 2 * n; // m
  for (int it = 0; it < iters; ++it) {
    for (int i = 0; i < m; ++i) b_rhs[i] = z[i] - y[i] * inv_rho[i];
    gemv(rho_AT, b_rhs, rhs, n, m);
    for (int i = 0; i < n; ++i) rhs[i] += sigma * x[i] - g[i];
    gemv(P_inv, rhs, x_t, n, n);
    gemv(A, x_t, ax, m, n);
    for (int i = 0; i < n; ++i) x[i] = alpha * x_t[i] + (1.0 - alpha) * x[i];
    for (int i = 0; i < m; ++i) {
      const double nu = rho_vec[i] * (ax[i] - b_rhs[i]);
      const double z_t = z[i] + (nu - y[i]) * inv_rho[i];
      const double z_mix = alpha * z_t + (1.0 - alpha) * z[i];
      double z_new = z_mix + y[i] * inv_rho[i];
      if (z_new < l[i]) z_new = l[i];
      if (z_new > u[i]) z_new = u[i];
      y[i] += rho_vec[i] * (z_mix - z_new);
      z[i] = z_new;
    }
  }
}

}  // extern "C"
