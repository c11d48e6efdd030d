// Native host model for the real-time control tick.
//
// Role: what Pinocchio's C++ is to the reference's 400-500 Hz WBC
// (bipedal_wbc/src/WbcBase.cpp:79-133 — crba, nonLinearEffects, frame
// Jacobians + time variations, centroidal momentum matrix) this file is to
// ours: the per-tick model quantities computed natively on the host, so the
// torque path performs zero accelerator dispatches and almost zero
// interpreter work.  The math mirrors, line for line, the numpy twin in
// bipedal_nmpc/model/host_dynamics.py (which itself is pinned to the
// JAX implementation by tests/test_host_wbc.py); a ctypes parity test pins
// this kernel against the numpy twin to rounding error.
//
// Conventions (CLAUDE.md): q = [p_base(3), euler-zyx(3), q_j]; generalized
// velocities are coordinate rates (Euler rates, not angular velocity);
// x = [h/m(6), basePose(6), q_j]; u = [F(12, world), v_j];
// rbd = [euler, pos, q_j, omega_world, v_world, dq_j].
//
// Build: g++ -O3 -shared -fPIC (driven by model/native_model.py).

#include <cmath>
#include <cstring>
#include <vector>

namespace {

constexpr double kGravity = 9.81;
constexpr int JOINT_REVOLUTE = 0;  // mirrors model/urdf.py constants

struct Vec3 {
  double x, y, z;
};

inline Vec3 v3(const double* p) { return {p[0], p[1], p[2]}; }
inline void store(const Vec3& v, double* p) {
  p[0] = v.x;
  p[1] = v.y;
  p[2] = v.z;
}
inline Vec3 operator+(Vec3 a, Vec3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
inline Vec3 operator-(Vec3 a, Vec3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline Vec3 operator*(double s, Vec3 a) { return {s * a.x, s * a.y, s * a.z}; }
inline Vec3 cross(Vec3 a, Vec3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
inline double dot(Vec3 a, Vec3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

// row-major 3x3
struct Mat3 {
  double m[9];
  Vec3 mul(Vec3 v) const {
    return {m[0] * v.x + m[1] * v.y + m[2] * v.z,
            m[3] * v.x + m[4] * v.y + m[5] * v.z,
            m[6] * v.x + m[7] * v.y + m[8] * v.z};
  }
  Vec3 tmul(Vec3 v) const {  // transpose mul
    return {m[0] * v.x + m[3] * v.y + m[6] * v.z,
            m[1] * v.x + m[4] * v.y + m[7] * v.z,
            m[2] * v.x + m[5] * v.y + m[8] * v.z};
  }
  Mat3 mul(const Mat3& o) const {
    Mat3 r;
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        double acc = 0;
        for (int k = 0; k < 3; ++k) acc += m[i * 3 + k] * o.m[k * 3 + j];
        r.m[i * 3 + j] = acc;
      }
    return r;
  }
  Mat3 mulT(const Mat3& o) const {  // this * o^T
    Mat3 r;
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        double acc = 0;
        for (int k = 0; k < 3; ++k) acc += m[i * 3 + k] * o.m[j * 3 + k];
        r.m[i * 3 + j] = acc;
      }
    return r;
  }
};

Mat3 rotmat_zyx(const double* th) {  // th = [z, y, x]
  const double cz = std::cos(th[0]), sz = std::sin(th[0]);
  const double cy = std::cos(th[1]), sy = std::sin(th[1]);
  const double cx = std::cos(th[2]), sx = std::sin(th[2]);
  // Rz @ Ry @ Rx
  Mat3 r;
  r.m[0] = cz * cy;
  r.m[1] = cz * sy * sx - sz * cx;
  r.m[2] = cz * sy * cx + sz * sx;
  r.m[3] = sz * cy;
  r.m[4] = sz * sy * sx + cz * cx;
  r.m[5] = sz * sy * cx - cz * sx;
  r.m[6] = -sy;
  r.m[7] = cy * sx;
  r.m[8] = cy * cx;
  return r;
}

Mat3 euler_rate_map(const double* th) {
  const double cz = std::cos(th[0]), sz = std::sin(th[0]);
  const double cy = std::cos(th[1]), sy = std::sin(th[1]);
  Mat3 e;
  e.m[0] = 0;
  e.m[1] = -sz;
  e.m[2] = cy * cz;
  e.m[3] = 0;
  e.m[4] = cz;
  e.m[5] = cy * sz;
  e.m[6] = 1;
  e.m[7] = 0;
  e.m[8] = -sy;
  return e;
}

Mat3 euler_rate_map_dot(const double* th, const double* thd) {
  const double cz = std::cos(th[0]), sz = std::sin(th[0]);
  const double cy = std::cos(th[1]), sy = std::sin(th[1]);
  const double dz = thd[0], dy = thd[1];
  Mat3 e;
  e.m[0] = 0;
  e.m[1] = -cz * dz;
  e.m[2] = -cy * sz * dz - sy * cz * dy;
  e.m[3] = 0;
  e.m[4] = -sz * dz;
  e.m[5] = cy * cz * dz - sy * sz * dy;
  e.m[6] = 0;
  e.m[7] = 0;
  e.m[8] = -cy * dy;
  return e;
}

// general small dense solve: A (n x n, row-major, destroyed) x = b (destroyed)
void solve_dense(int n, double* A, double* b, double* x) {
  std::vector<int> piv(n);
  for (int i = 0; i < n; ++i) piv[i] = i;
  for (int k = 0; k < n; ++k) {
    int p = k;
    double best = std::fabs(A[k * n + k]);
    for (int i = k + 1; i < n; ++i) {
      const double v = std::fabs(A[i * n + k]);
      if (v > best) {
        best = v;
        p = i;
      }
    }
    if (p != k) {
      for (int j = 0; j < n; ++j) std::swap(A[k * n + j], A[p * n + j]);
      std::swap(b[k], b[p]);
    }
    const double d = A[k * n + k];
    for (int i = k + 1; i < n; ++i) {
      const double f = A[i * n + k] / d;
      if (f == 0.0) continue;
      for (int j = k; j < n; ++j) A[i * n + j] -= f * A[k * n + j];
      b[i] -= f * b[k];
    }
  }
  for (int i = n - 1; i >= 0; --i) {
    double acc = b[i];
    for (int j = i + 1; j < n; ++j) acc -= A[i * n + j] * x[j];
    x[i] = acc / A[i * n + i];
  }
}

struct HostModelNative {
  int nj, nb, nv, model_type, n_contacts;
  double robot_mass, total_mass;
  std::vector<int> parent, jtype;
  std::vector<double> axis, offR, offp, mass, com, inertia, anc;  // model tables
  std::vector<int> contact_body;
  std::vector<double> contact_R, contact_p;  // frame offsets (per contact)
  int base_body;
  std::vector<double> base_R, base_p;
  std::vector<double> qj_nominal;

  // scratch (resized once; one instance per controller => no races)
  std::vector<Mat3> R;
  std::vector<Vec3> p, axes, axes_dot, omega, v_o, coms, v_coms;
  std::vector<double> J, dJ;     // (nb or m, 6, nv)
  std::vector<double> scratch;
};

// placements + world axes; q = [p(3), th(3), qj]
void fk(HostModelNative& hm, const double* q) {
  hm.R[0] = rotmat_zyx(q + 3);
  hm.p[0] = v3(q);
  for (int j = 0; j < hm.nj; ++j) {
    const int par = hm.parent[j];
    Mat3 Roff;
    std::memcpy(Roff.m, &hm.offR[j * 9], 9 * sizeof(double));
    const Mat3 Rj = hm.R[par].mul(Roff);
    const Vec3 pj = hm.p[par] + hm.R[par].mul(v3(&hm.offp[j * 3]));
    const Vec3 ax = v3(&hm.axis[j * 3]);
    if (hm.jtype[j] == JOINT_REVOLUTE) {
      const double c = std::cos(q[6 + j]), s = std::sin(q[6 + j]);
      // Rodrigues about ax
      Mat3 K{{0, -ax.z, ax.y, ax.z, 0, -ax.x, -ax.y, ax.x, 0}};
      Mat3 K2 = K.mul(K);
      Mat3 Rm;
      for (int i = 0; i < 9; ++i) Rm.m[i] = (i % 4 == 0 ? 1.0 : 0.0) + s * K.m[i] + (1 - c) * K2.m[i];
      hm.R[j + 1] = Rj.mul(Rm);
      hm.p[j + 1] = pj;
    } else {  // prismatic
      hm.R[j + 1] = Rj;
      hm.p[j + 1] = pj + q[6 + j] * Rj.mul(ax);
    }
    hm.axes[j] = hm.R[j + 1].mul(v3(&hm.axis[j * 3]));
  }
}

// body twist fields (host_dynamics.py::vel_pass_np, recursion form)
void vel_pass(HostModelNative& hm, const double* q, const double* v, const Mat3& E) {
  const Vec3 om0 = E.mul(v3(v + 3));
  hm.omega[0] = om0;
  hm.v_o[0] = v3(v);
  for (int j = 0; j < hm.nj; ++j) {
    const int par = hm.parent[j];
    const double qd = v[6 + j];
    if (hm.jtype[j] == JOINT_REVOLUTE) {
      hm.omega[j + 1] = hm.omega[par] + qd * hm.axes[j];
      hm.v_o[j + 1] = hm.v_o[par] + cross(hm.omega[par], hm.p[j + 1] - hm.p[par]);
    } else {
      hm.omega[j + 1] = hm.omega[par];
      hm.v_o[j + 1] =
          hm.v_o[par] + cross(hm.omega[par], hm.p[j + 1] - hm.p[par]) + qd * hm.axes[j];
    }
    hm.axes_dot[j] = cross(hm.omega[j + 1], hm.axes[j]);
  }
}

// J (6 x nv) for a point attached to body b, written to out (row-major 6*nv)
void point_jacobian(const HostModelNative& hm, const Mat3& E, Vec3 pt, int b, double* out) {
  const int nv = hm.nv;
  std::memset(out, 0, sizeof(double) * 6 * nv);
  out[0 * nv + 0] = 1;
  out[1 * nv + 1] = 1;
  out[2 * nv + 2] = 1;
  const Vec3 r = pt - hm.p[0];
  for (int c = 0; c < 3; ++c) {
    const Vec3 ec = {E.m[c], E.m[3 + c], E.m[6 + c]};  // column c
    const Vec3 jc = cross(ec, r);
    out[0 * nv + 3 + c] = jc.x;
    out[1 * nv + 3 + c] = jc.y;
    out[2 * nv + 3 + c] = jc.z;
    out[3 * nv + 3 + c] = ec.x;
    out[4 * nv + 3 + c] = ec.y;
    out[5 * nv + 3 + c] = ec.z;
  }
  const double* mask = &hm.anc[(size_t)b * hm.nj];
  for (int j = 0; j < hm.nj; ++j) {
    if (mask[j] == 0.0) continue;
    Vec3 jv, jw;
    if (hm.jtype[j] == JOINT_REVOLUTE) {
      jv = cross(hm.axes[j], pt - hm.p[j + 1]);
      jw = hm.axes[j];
    } else {
      jv = hm.axes[j];
      jw = {0, 0, 0};
    }
    out[0 * nv + 6 + j] = jv.x;
    out[1 * nv + 6 + j] = jv.y;
    out[2 * nv + 6 + j] = jv.z;
    out[3 * nv + 6 + j] = jw.x;
    out[4 * nv + 6 + j] = jw.y;
    out[5 * nv + 6 + j] = jw.z;
  }
}

// dJ/dt for the same point; vpt = world velocity of the point
void point_jacobian_dot(const HostModelNative& hm, const Mat3& E, const Mat3& Edot,
                        Vec3 pt, Vec3 vpt, int b, double* out) {
  const int nv = hm.nv;
  std::memset(out, 0, sizeof(double) * 6 * nv);
  const Vec3 r = pt - hm.p[0];
  const Vec3 rdot = vpt - hm.v_o[0];
  for (int c = 0; c < 3; ++c) {
    const Vec3 ec = {E.m[c], E.m[3 + c], E.m[6 + c]};
    const Vec3 ecd = {Edot.m[c], Edot.m[3 + c], Edot.m[6 + c]};
    const Vec3 jc = cross(ecd, r) + cross(ec, rdot);
    out[0 * nv + 3 + c] = jc.x;
    out[1 * nv + 3 + c] = jc.y;
    out[2 * nv + 3 + c] = jc.z;
    out[3 * nv + 3 + c] = ecd.x;
    out[4 * nv + 3 + c] = ecd.y;
    out[5 * nv + 3 + c] = ecd.z;
  }
  const double* mask = &hm.anc[(size_t)b * hm.nj];
  for (int j = 0; j < hm.nj; ++j) {
    if (mask[j] == 0.0) continue;
    Vec3 djv, djw;
    if (hm.jtype[j] == JOINT_REVOLUTE) {
      djv = cross(hm.axes_dot[j], pt - hm.p[j + 1]) +
            cross(hm.axes[j], vpt - hm.v_o[j + 1]);
      djw = hm.axes_dot[j];
    } else {
      djv = hm.axes_dot[j];
      djw = {0, 0, 0};
    }
    out[0 * nv + 6 + j] = djv.x;
    out[1 * nv + 6 + j] = djv.y;
    out[2 * nv + 6 + j] = djv.z;
    out[3 * nv + 6 + j] = djw.x;
    out[4 * nv + 6 + j] = djw.y;
    out[5 * nv + 6 + j] = djw.z;
  }
}

inline Vec3 point_velocity(const HostModelNative& hm, int b, Vec3 pt) {
  return hm.v_o[b] + cross(hm.omega[b], pt - hm.p[b]);
}

// world inertia R I R^T of body b
Mat3 world_inertia(const HostModelNative& hm, int b) {
  Mat3 I;
  std::memcpy(I.m, &hm.inertia[(size_t)b * 9], 9 * sizeof(double));
  return hm.R[b].mul(I).mulT(hm.R[b]);
}

// M (nv x nv) and nle (nv) from current fk + vel state
// (projected Newton-Euler; host_dynamics.py::mass_and_nle_np)
void mass_and_nle(HostModelNative& hm, const Mat3& E, const Mat3& Edot, const double* v,
                  double* M, double* nle) {
  const int nv = hm.nv;
  std::memset(M, 0, sizeof(double) * nv * nv);
  std::memset(nle, 0, sizeof(double) * nv);
  double* Jb = hm.J.data();
  double* dJb = hm.dJ.data();
  for (int b = 0; b < hm.nb; ++b) {
    const Vec3 cb = hm.p[b] + hm.R[b].mul(v3(&hm.com[b * 3]));
    const Vec3 vcb = point_velocity(hm, b, cb);
    point_jacobian(hm, E, cb, b, Jb);
    point_jacobian_dot(hm, E, Edot, cb, vcb, b, dJb);
    const double mb = hm.mass[b];
    const Mat3 Iw = world_inertia(hm, b);
    // M += m Jv^T Jv + Jw^T Iw Jw
    for (int i = 0; i < nv; ++i) {
      for (int k = i; k < nv; ++k) {
        double acc = 0;
        for (int r = 0; r < 3; ++r) acc += mb * Jb[r * nv + i] * Jb[r * nv + k];
        // Jw^T Iw Jw
        for (int r = 0; r < 3; ++r) {
          double iwj = 0;
          for (int c = 0; c < 3; ++c) iwj += Iw.m[r * 3 + c] * Jb[(3 + c) * nv + k];
          acc += Jb[(3 + r) * nv + i] * iwj;
        }
        M[i * nv + k] += acc;
      }
    }
    // bias accelerations: a = dJv v, wd = dJw v
    Vec3 a{0, 0, 0}, wd{0, 0, 0};
    for (int c = 0; c < nv; ++c) {
      a.x += dJb[0 * nv + c] * v[c];
      a.y += dJb[1 * nv + c] * v[c];
      a.z += dJb[2 * nv + c] * v[c];
      wd.x += dJb[3 * nv + c] * v[c];
      wd.y += dJb[4 * nv + c] * v[c];
      wd.z += dJb[5 * nv + c] * v[c];
    }
    const Vec3 w = hm.omega[b];
    const Vec3 gyro = Iw.mul(wd) + cross(w, Iw.mul(w));
    const Vec3 f = mb * a;
    for (int c = 0; c < nv; ++c) {
      nle[c] += Jb[0 * nv + c] * f.x + Jb[1 * nv + c] * f.y + Jb[2 * nv + c] * f.z;
      nle[c] += Jb[3 * nv + c] * gyro.x + Jb[4 * nv + c] * gyro.y + Jb[5 * nv + c] * gyro.z;
      nle[c] += kGravity * mb * Jb[2 * nv + c];
    }
  }
  for (int i = 0; i < nv; ++i)
    for (int k = 0; k < i; ++k) M[i * nv + k] = M[k * nv + i];
}

// A (6 x nv) and optionally Adot (host_dynamics.py::centroidal_momentum_matrix_and_dot_np)
// Requires fk(+vel_pass when Adot) done at the momentum coordinates.
void cmm(HostModelNative& hm, const Mat3& E, const Mat3* Edot, const double* v, double* A,
         double* Adot) {
  const int nv = hm.nv;
  std::memset(A, 0, sizeof(double) * 6 * nv);
  if (Adot) std::memset(Adot, 0, sizeof(double) * 6 * nv);
  // whole-robot com (and its velocity)
  Vec3 com{0, 0, 0}, vcom{0, 0, 0};
  for (int b = 0; b < hm.nb; ++b) {
    hm.coms[b] = hm.p[b] + hm.R[b].mul(v3(&hm.com[b * 3]));
    com = com + hm.mass[b] * hm.coms[b];
    if (Adot) {
      hm.v_coms[b] = point_velocity(hm, b, hm.coms[b]);
      vcom = vcom + hm.mass[b] * hm.v_coms[b];
    }
  }
  com = (1.0 / hm.total_mass) * com;
  vcom = (1.0 / hm.total_mass) * vcom;

  double* Jb = hm.J.data();
  double* dJb = hm.dJ.data();
  for (int b = 0; b < hm.nb; ++b) {
    const double mb = hm.mass[b];
    point_jacobian(hm, E, hm.coms[b], b, Jb);
    const Mat3 Iw = world_inertia(hm, b);
    const Vec3 rel = hm.coms[b] - com;
    for (int c = 0; c < nv; ++c) {
      const Vec3 jv = {Jb[0 * nv + c], Jb[1 * nv + c], Jb[2 * nv + c]};
      const Vec3 jw = {Jb[3 * nv + c], Jb[4 * nv + c], Jb[5 * nv + c]};
      const Vec3 lin = mb * jv;
      const Vec3 ang = Iw.mul(jw) + mb * cross(rel, jv);
      A[0 * nv + c] += lin.x;
      A[1 * nv + c] += lin.y;
      A[2 * nv + c] += lin.z;
      A[3 * nv + c] += ang.x;
      A[4 * nv + c] += ang.y;
      A[5 * nv + c] += ang.z;
    }
    if (Adot) {
      point_jacobian_dot(hm, E, *Edot, hm.coms[b], hm.v_coms[b], b, dJb);
      const Vec3 w = hm.omega[b];
      Mat3 Wx{{0, -w.z, w.y, w.z, 0, -w.x, -w.y, w.x, 0}};
      const Mat3 Iwd_a = Wx.mul(Iw);
      Mat3 Iwd;  // [w] Iw - Iw [w]
      {
        const Mat3 t = Iw.mul(Wx);
        for (int i = 0; i < 9; ++i) Iwd.m[i] = Iwd_a.m[i] - t.m[i];
      }
      const Vec3 rel_dot = hm.v_coms[b] - vcom;
      for (int c = 0; c < nv; ++c) {
        const Vec3 jv = {Jb[0 * nv + c], Jb[1 * nv + c], Jb[2 * nv + c]};
        const Vec3 jw = {Jb[3 * nv + c], Jb[4 * nv + c], Jb[5 * nv + c]};
        const Vec3 djv = {dJb[0 * nv + c], dJb[1 * nv + c], dJb[2 * nv + c]};
        const Vec3 djw = {dJb[3 * nv + c], dJb[4 * nv + c], dJb[5 * nv + c]};
        const Vec3 dlin = mb * djv;
        const Vec3 dang = Iwd.mul(jw) + Iw.mul(djw) + mb * cross(rel_dot, jv) +
                          mb * cross(rel, djv);
        Adot[0 * nv + c] += dlin.x;
        Adot[1 * nv + c] += dlin.y;
        Adot[2 * nv + c] += dlin.z;
        Adot[3 * nv + c] += dang.x;
        Adot[4 * nv + c] += dang.y;
        Adot[5 * nv + c] += dang.z;
      }
    }
  }
}

// model-type aware A (+Adot): SRBD evaluates at nominal joints with zeroed
// joint columns and only the base part of v moving the CMM.  fk/vel state is
// clobbered — callers re-run fk afterwards if they need q's placements.
void cmm_info(HostModelNative& hm, const double* q, const double* v_or_null, double* A,
              double* Adot) {
  const int nv = hm.nv;
  std::vector<double>& s = hm.scratch;
  if (hm.model_type == 1) {
    // top-of-scratch slots: callers pass A/Adot views into the bottom
    double* qm = s.data() + 14 * nv;  // nv coords
    double* vm = s.data() + 15 * nv;  // nv rates
    std::memcpy(qm, q, 6 * sizeof(double));
    for (int j = 0; j < hm.nj; ++j) qm[6 + j] = hm.qj_nominal[j];
    fk(hm, qm);
    const Mat3 E = euler_rate_map(qm + 3);
    if (Adot && v_or_null) {
      std::memcpy(vm, v_or_null, 6 * sizeof(double));
      for (int j = 0; j < hm.nj; ++j) vm[6 + j] = 0.0;
      vel_pass(hm, qm, vm, E);
      const Mat3 Edot = euler_rate_map_dot(qm + 3, vm + 3);
      cmm(hm, E, &Edot, vm, A, Adot);
    } else {
      cmm(hm, E, nullptr, nullptr, A, nullptr);
    }
    for (int r = 0; r < 6; ++r)
      for (int j = 0; j < hm.nj; ++j) {
        A[r * nv + 6 + j] = 0.0;
        if (Adot) Adot[r * nv + 6 + j] = 0.0;
      }
    return;
  }
  fk(hm, q);
  const Mat3 E = euler_rate_map(q + 3);
  if (Adot && v_or_null) {
    vel_pass(hm, q, v_or_null, E);
    const Mat3 Edot = euler_rate_map_dot(q + 3, v_or_null + 3);
    cmm(hm, E, &Edot, v_or_null, A, Adot);
  } else {
    cmm(hm, E, nullptr, nullptr, A, nullptr);
  }
}

// v = [v_b; v_j], v_b = A_b^{-1} (m h - A_j v_j)
void gen_velocity(HostModelNative& hm, const double* x, const double* u, const double* A,
                  double* v_out) {
  const int nv = hm.nv;
  double Ab[36], rhs[6];
  for (int r = 0; r < 6; ++r) {
    rhs[r] = hm.robot_mass * x[r];
    for (int c = 0; c < 6; ++c) Ab[r * 6 + c] = A[r * nv + c];
    for (int j = 0; j < hm.nj; ++j) rhs[r] -= A[r * nv + 6 + j] * u[12 + j];
  }
  solve_dense(6, Ab, rhs, v_out);
  for (int j = 0; j < hm.nj; ++j) v_out[6 + j] = u[12 + j];
}

}  // namespace

extern "C" {

void* host_model_create(int nj, int model_type, const int* parent, const int* jtype,
                        const double* axis, const double* offR, const double* offp,
                        const double* mass, const double* com, const double* inertia,
                        const double* anc_mask, int n_contacts, const int* contact_body,
                        const double* contact_R, const double* contact_p, int base_body,
                        const double* base_R, const double* base_p,
                        const double* qj_nominal, double robot_mass, double total_mass) {
  auto* hm = new HostModelNative();
  hm->nj = nj;
  hm->nb = nj + 1;
  hm->nv = 6 + nj;
  hm->model_type = model_type;
  hm->n_contacts = n_contacts;
  hm->robot_mass = robot_mass;
  hm->total_mass = total_mass;
  hm->parent.assign(parent, parent + nj);
  hm->jtype.assign(jtype, jtype + nj);
  hm->axis.assign(axis, axis + 3 * nj);
  hm->offR.assign(offR, offR + 9 * nj);
  hm->offp.assign(offp, offp + 3 * nj);
  hm->mass.assign(mass, mass + hm->nb);
  hm->com.assign(com, com + 3 * hm->nb);
  hm->inertia.assign(inertia, inertia + 9 * hm->nb);
  hm->anc.assign(anc_mask, anc_mask + (size_t)hm->nb * nj);
  hm->contact_body.assign(contact_body, contact_body + n_contacts);
  hm->contact_R.assign(contact_R, contact_R + 9 * n_contacts);
  hm->contact_p.assign(contact_p, contact_p + 3 * n_contacts);
  hm->base_body = base_body;
  hm->base_R.assign(base_R, base_R + 9);
  hm->base_p.assign(base_p, base_p + 3);
  hm->qj_nominal.assign(qj_nominal, qj_nominal + nj);
  hm->R.resize(hm->nb);
  hm->p.resize(hm->nb);
  hm->axes.resize(nj);
  hm->axes_dot.resize(nj);
  hm->omega.resize(hm->nb);
  hm->v_o.resize(hm->nb);
  hm->coms.resize(hm->nb);
  hm->v_coms.resize(hm->nb);
  hm->J.resize(6 * hm->nv);
  hm->dJ.resize(6 * hm->nv);
  hm->scratch.resize(16 * hm->nv + 64);
  return hm;
}

void host_model_destroy(void* h) { delete static_cast<HostModelNative*>(h); }

// rbd -> (q, v) (host_model.py::generalized_from_rbd_np)
void host_model_q_v_from_rbd(void* h, const double* rbd, double* q, double* v) {
  auto& hm = *static_cast<HostModelNative*>(h);
  const int nj = hm.nj, ngen = hm.nv;
  for (int i = 0; i < 3; ++i) {
    q[i] = rbd[3 + i];
    q[3 + i] = rbd[i];
  }
  for (int j = 0; j < nj; ++j) q[6 + j] = rbd[6 + j];
  // euler rates from world angular velocity: solve E rates = omega
  Mat3 E = euler_rate_map(q + 3);
  double Ecopy[9], om[3], rates[3];
  std::memcpy(Ecopy, E.m, sizeof(Ecopy));
  std::memcpy(om, rbd + ngen, 3 * sizeof(double));
  solve_dense(3, Ecopy, om, rates);
  for (int i = 0; i < 3; ++i) {
    v[i] = rbd[ngen + 3 + i];
    v[3 + i] = rates[i];
  }
  for (int j = 0; j < nj; ++j) v[6 + j] = rbd[ngen + 6 + j];
}

// rbd -> centroidal state x (observation path, host_model.py twin)
void host_model_observation(void* h, const double* rbd, double* x_out) {
  auto& hm = *static_cast<HostModelNative*>(h);
  const int nv = hm.nv;
  double* q = hm.scratch.data() + 2 * nv;
  double* v = q + nv;
  double* A = v + nv;  // needs 6*nv
  host_model_q_v_from_rbd(h, rbd, q, v);
  cmm_info(hm, q, nullptr, A, nullptr);
  for (int r = 0; r < 6; ++r) {
    double acc = 0;
    for (int c = 0; c < nv; ++c) acc += A[r * nv + c] * v[c];
    x_out[r] = acc / hm.robot_mass;
  }
  for (int c = 0; c < nv; ++c) x_out[6 + c] = q[c];
}

// The hot call: full WBC kinematics (wbc/host_wbc.py::compute_wbc_kinematics_np).
// Outputs (all row-major doubles):
//   q_m(nv) v_m(nv) M(nv*nv) nle(nv)
//   Jc(nc*3*nv) dJc(nc*3*nv) p_c(nc*3) v_c(nc*3)
//   base_J(6*nv) base_dJ(6*nv)
//   q_d(nv) v_d(nv) p_d(nc*3) v_cd(nc*3)
//   pose_d(6) vel_d(6) acc_d(6)
void host_model_wbc_kinematics(void* h, const double* x_des, const double* u_des,
                               const double* rbd, double* q_m, double* v_m, double* M,
                               double* nle, double* Jc, double* dJc, double* p_c,
                               double* v_c, double* base_J, double* base_dJ, double* q_d,
                               double* v_d, double* p_d, double* v_cd, double* pose_d,
                               double* vel_d, double* acc_d) {
  auto& hm = *static_cast<HostModelNative*>(h);
  const int nv = hm.nv, nc = hm.n_contacts;

  // ---- measured side
  host_model_q_v_from_rbd(h, rbd, q_m, v_m);
  fk(hm, q_m);
  Mat3 E = euler_rate_map(q_m + 3);
  vel_pass(hm, q_m, v_m, E);
  Mat3 Edot = euler_rate_map_dot(q_m + 3, v_m + 3);
  mass_and_nle(hm, E, Edot, v_m, M, nle);
  for (int i = 0; i < nc; ++i) {
    const int b = hm.contact_body[i];
    Mat3 fR;
    std::memcpy(fR.m, &hm.contact_R[i * 9], 9 * sizeof(double));
    const Vec3 pt = hm.p[b] + hm.R[b].mul(v3(&hm.contact_p[i * 3]));
    const Vec3 vpt = point_velocity(hm, b, pt);
    double* J6 = hm.J.data();
    double* dJ6 = hm.dJ.data();
    point_jacobian(hm, E, pt, b, J6);
    point_jacobian_dot(hm, E, Edot, pt, vpt, b, dJ6);
    std::memcpy(&Jc[(size_t)i * 3 * nv], J6, 3 * nv * sizeof(double));
    std::memcpy(&dJc[(size_t)i * 3 * nv], dJ6, 3 * nv * sizeof(double));
    store(pt, &p_c[i * 3]);
    store(vpt, &v_c[i * 3]);
  }
  {
    const int b = hm.base_body;
    const Vec3 pt = hm.p[b] + hm.R[b].mul(v3(hm.base_p.data()));
    const Vec3 vpt = point_velocity(hm, b, pt);
    point_jacobian(hm, E, pt, b, base_J);
    point_jacobian_dot(hm, E, Edot, pt, vpt, b, base_dJ);
  }

  // ---- desired side
  for (int c = 0; c < nv; ++c) q_d[c] = x_des[6 + c];
  double* A = hm.scratch.data();  // 6*nv
  double* Adot = A + 6 * nv;      // 6*nv  (scratch sized >= 8nv+64... need 12nv)
  cmm_info(hm, q_d, nullptr, A, nullptr);
  gen_velocity(hm, x_des, u_des, A, v_d);
  // full pass at (q_d, v_d) for Adot (full model); SRBD re-derives internally
  cmm_info(hm, q_d, v_d, A, Adot);
  // fk/vel state now matches q_d (full) or nominal coords (SRBD); contact
  // kinematics must use the TRUE q_d placements:
  fk(hm, q_d);
  const Mat3 Ed = euler_rate_map(q_d + 3);
  vel_pass(hm, q_d, v_d, Ed);
  for (int i = 0; i < nc; ++i) {
    const int b = hm.contact_body[i];
    const Vec3 pt = hm.p[b] + hm.R[b].mul(v3(&hm.contact_p[i * 3]));
    double* J6 = hm.J.data();
    point_jacobian(hm, Ed, pt, b, J6);
    store(pt, &p_d[i * 3]);
    Vec3 vc{0, 0, 0};
    for (int c = 0; c < nv; ++c) {
      vc.x += J6[0 * nv + c] * v_d[c];
      vc.y += J6[1 * nv + c] * v_d[c];
      vc.z += J6[2 * nv + c] * v_d[c];
    }
    store(vc, &v_cd[i * 3]);
  }
  // base kinematics (host_dynamics.py::base_kinematics_from_centroidal_np)
  for (int i = 0; i < 6; ++i) pose_d[i] = q_d[i];
  const Vec3 om_d = Ed.mul(v3(v_d + 3));
  vel_d[0] = v_d[0];
  vel_d[1] = v_d[1];
  vel_d[2] = v_d[2];
  store(om_d, vel_d + 3);
  // h_dot = m * normalized momentum rate (needs q_d placements — current)
  Vec3 com{0, 0, 0};
  if (hm.model_type == 1) {
    // torque arm about the locked-inertia com: nominal joint pose placements
    double* qm = hm.scratch.data() + 12 * nv;
    std::memcpy(qm, q_d, 6 * sizeof(double));
    for (int j = 0; j < hm.nj; ++j) qm[6 + j] = hm.qj_nominal[j];
    fk(hm, qm);
    for (int b = 0; b < hm.nb; ++b)
      com = com + hm.mass[b] * (hm.p[b] + hm.R[b].mul(v3(&hm.com[b * 3])));
    com = (1.0 / hm.total_mass) * com;
    fk(hm, q_d);  // restore true placements for the contact points
  } else {
    for (int b = 0; b < hm.nb; ++b)
      com = com + hm.mass[b] * (hm.p[b] + hm.R[b].mul(v3(&hm.com[b * 3])));
    com = (1.0 / hm.total_mass) * com;
  }
  Vec3 lin{0, 0, -kGravity * hm.robot_mass};
  Vec3 ang{0, 0, 0};
  for (int i = 0; i < nc; ++i) {
    const int b = hm.contact_body[i];
    const Vec3 pt = hm.p[b] + hm.R[b].mul(v3(&hm.contact_p[i * 3]));
    const Vec3 f = v3(&u_des[i * 3]);
    lin = lin + f;
    ang = ang + cross(pt - com, f);
  }
  // A_b vdot_b = h_dot - Adot v - A_j qddot (qddot = 0)
  double Ab[36], rhs[6], vdotb[6];
  const double hdot[6] = {lin.x, lin.y, lin.z, ang.x, ang.y, ang.z};
  for (int r = 0; r < 6; ++r) {
    double acc = hdot[r];
    for (int c = 0; c < nv; ++c) acc -= Adot[r * nv + c] * v_d[c];
    rhs[r] = acc;
    for (int c = 0; c < 6; ++c) Ab[r * 6 + c] = A[r * nv + c];
  }
  solve_dense(6, Ab, rhs, vdotb);
  const Mat3 Edd = euler_rate_map_dot(q_d + 3, v_d + 3);
  const Vec3 omdot = Ed.mul(v3(vdotb + 3)) + Edd.mul(v3(v_d + 3));
  acc_d[0] = vdotb[0];
  acc_d[1] = vdotb[1];
  acc_d[2] = vdotb[2];
  store(omdot, acc_d + 3);
}

}  // extern "C"
