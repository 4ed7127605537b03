// Host-side boxed-LCP golden solver (native, independent implementation).
//
// Role of the reference's vendored ODE Dantzig solver
// (dart/external/odelcpsolver/lcp.cpp) in OUR test strategy: an
// independent, tightly-converged solver the device PGS kernel is checked
// against. This is a from-scratch projected Gauss-Seidel with friction
// indices (the reference's own fallback algorithm,
// PgsBoxedLcpSolver.cpp, run to much deeper convergence than the device's
// fixed sweep count) plus an active-set polish step that solves the
// clamping subsystem directly for Dantzig-grade accuracy.
//
// Problem: w = A x - b, lo_i(x) <= x_i <= hi_i(x), complementarity;
// friction rows i have bounds -+ fscale[i] * x[findex[i]].

#include <cmath>
#include <cstring>
#include <vector>

namespace {

// Solve dense G y = r with partial-pivot Gaussian elimination.
bool solve_dense(std::vector<double> G, std::vector<double> r, int n,
                 double* y) {
  for (int c = 0; c < n; ++c) {
    int piv = c;
    for (int i = c + 1; i < n; ++i)
      if (std::fabs(G[i * n + c]) > std::fabs(G[piv * n + c])) piv = i;
    if (std::fabs(G[piv * n + c]) < 1e-14) return false;
    if (piv != c) {
      for (int j = 0; j < n; ++j) std::swap(G[c * n + j], G[piv * n + j]);
      std::swap(r[c], r[piv]);
    }
    double d = G[c * n + c];
    for (int i = c + 1; i < n; ++i) {
      double f = G[i * n + c] / d;
      if (f == 0.0) continue;
      for (int j = c; j < n; ++j) G[i * n + j] -= f * G[c * n + j];
      r[i] -= f * r[c];
    }
  }
  for (int i = n - 1; i >= 0; --i) {
    double acc = r[i];
    for (int j = i + 1; j < n; ++j) acc -= G[i * n + j] * y[j];
    y[i] = acc / G[i * n + i];
  }
  return true;
}

}  // namespace

extern "C" {

// Returns the residual max-norm of the complementarity conditions.
double lcp_gold_solve(const double* A, const double* b, const double* lo,
                      const double* hi, const double* fscale,
                      const int* findex, int m, int iters, double* x) {
  // ---- phase 1: deep PGS ----
  for (int it = 0; it < iters; ++it) {
    for (int i = 0; i < m; ++i) {
      double Aii = A[i * m + i];
      if (std::fabs(Aii) < 1e-12) continue;
      double resid = -b[i];
      for (int j = 0; j < m; ++j) resid += A[i * m + j] * x[j];
      double xi = x[i] - resid / Aii;
      double l = lo[i], h = hi[i];
      if (findex[i] >= 0) {
        double f = fscale[i] * std::max(x[findex[i]], 0.0);
        l = -f;
        h = f;
      }
      x[i] = std::min(std::max(xi, l), h);
    }
  }

  // ---- phase 2: active-set polish ----
  // Classify from the PGS solution, then solve the clamping subsystem
  // exactly: (A[C,C] + A[C,U] S) x_C = b_C with friction-upper coupling.
  const double eps = 1e-9;
  std::vector<int> cls(m, 0);  // 0 = free/separating, 1 = clamping, 2 = upper
  std::vector<double> sgn(m, 0.0);
  for (int i = 0; i < m; ++i) {
    if (findex[i] >= 0) {
      double xn = std::max(x[findex[i]], 0.0);
      double f = fscale[i] * xn;
      if (xn <= eps) continue;
      if (std::fabs(std::fabs(x[i]) - f) <= 1e-6 * std::max(1.0, f)) {
        cls[i] = 2;
        sgn[i] = (x[i] >= 0 ? 1.0 : -1.0) * fscale[i];
      } else {
        cls[i] = 1;
      }
    } else {
      bool bounded_hi = hi[i] < 1e19;
      if (x[i] > lo[i] + eps && (!bounded_hi || x[i] < hi[i] - eps))
        cls[i] = (x[i] > eps || lo[i] < -eps) ? 1 : 0;
      if (x[i] > eps && !bounded_hi) cls[i] = 1;
    }
  }
  std::vector<int> C;
  for (int i = 0; i < m; ++i)
    if (cls[i] == 1) C.push_back(i);
  int n = static_cast<int>(C.size());
  if (n > 0) {
    // R maps x_C -> full x (upper rows ride their governing normal).
    std::vector<double> G(n * n, 0.0), r(n), y(n);
    for (int a = 0; a < n; ++a) {
      int i = C[a];
      r[a] = b[i];
      for (int c = 0; c < n; ++c) {
        int j = C[c];
        double g = A[i * m + j];
        for (int u = 0; u < m; ++u)
          if (cls[u] == 2 && findex[u] == j) g += A[i * m + u] * sgn[u];
        G[a * n + c] = g;
      }
    }
    if (solve_dense(G, r, n, y.data())) {
      bool ok = true;
      for (int a = 0; a < n; ++a)
        if (!(std::isfinite(y[a]))) ok = false;
      if (ok) {
        std::vector<double> x2(m, 0.0);
        for (int a = 0; a < n; ++a) x2[C[a]] = y[a];
        for (int u = 0; u < m; ++u)
          if (cls[u] == 2 && findex[u] >= 0)
            x2[u] = sgn[u] * std::max(x2[findex[u]], 0.0);
        // accept the polish only if it stays feasible
        bool feas = true;
        for (int i = 0; i < m; ++i) {
          double l = lo[i], h = hi[i];
          if (findex[i] >= 0) {
            double f = fscale[i] * std::max(x2[findex[i]], 0.0);
            l = -f - 1e-8;
            h = f + 1e-8;
          }
          if (x2[i] < l - 1e-8 || x2[i] > h + 1e-8) feas = false;
        }
        if (feas) std::memcpy(x, x2.data(), sizeof(double) * m);
      }
    }
  }

  // ---- residual ----
  double worst = 0.0;
  for (int i = 0; i < m; ++i) {
    double w = -b[i];
    for (int j = 0; j < m; ++j) w += A[i * m + j] * x[j];
    double l = lo[i], h = hi[i];
    if (findex[i] >= 0) {
      double f = fscale[i] * std::max(x[findex[i]], 0.0);
      l = -f;
      h = f;
    }
    double viol = 0.0;
    if (h - l <= 2 * eps)
      viol = 0.0;                          // pinned variable: no condition
    else if (x[i] <= l + eps)
      viol = std::max(0.0, -w);            // at lower bound: w >= 0
    else if (x[i] >= h - eps)
      viol = std::max(0.0, w);             // at upper bound: w <= 0
    else
      viol = std::fabs(w);                 // interior: w == 0
    worst = std::max(worst, viol);
  }
  return worst;
}

}  // extern "C"
