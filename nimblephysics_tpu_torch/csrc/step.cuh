// The contact-free planning step on the card: ABA forward dynamics plus a
// semi-implicit Euler update, for chains of weld, revolute and prismatic
// joints.
//
// Hopper's answer to the JAX package's LaneFn (nimblephysics_tpu/ops/
// lanevmap.py), which traced the step once and re-emitted it with the world
// batch on the TPU's lanes: here the step is written once by hand, templated
// on the scalar type S (T, or Dual<T> for the linearize kernel) and on the
// compile-time body, dof and action counts, so every per-body array is
// unrolled into registers. Joint types and parents are read at run time
// from the packed model; they are the same for every thread, so the
// branches never diverge, and run-time indices are resolved by unrolled
// selects instead of indexing (which would spill the arrays to local
// memory).
//
// The packed model (written by nimblephysics_tpu_torch/ops/device_step.py):
//   reals, per body (kBody = 69): T_pj R(9) p(3) | T_cj^-1 R(9) p(3) |
//     joint axis(3) | child-frame subspace S(6) | spatial inertia(36);
//   then per dof: damping, stiffness, rest position (3 NQ);
//   per action: tau lower, tau upper (2 NA); gravity (3); dt (1).
//   ints: parents[NB] | joint type[NB] (0 weld, 1 revolute, 2 prismatic) |
//     dof of each body[NB] (-1 for a weld) | dof of each action[NA].
//
// ops/device_step.py step_op_kinds counts this function's operations by
// kind in closed form (for the kernels' least-work bounds);
// tests/test_torch_device_step.py builds it for the host and holds both
// its values and that count.
#pragma once

#include "common.cuh"

// The (bodies, dofs, actions) shapes the step kernels are built for; the
// Python wrappers refuse any other model. cartpole: 2 bodies, 2 dofs, 1 action.
#define NPTT_STEP_SHAPES(X) X(2, 2, 1)

namespace nptt {

enum JointCode { kWeld = 0, kRevolute = 1, kPrismatic = 2 };

template <int NB, int NQ, int NA>
struct StepLayout {
  static constexpr int kBody = 69;
  static constexpr int kRpj = 0, kPpj = 9, kRci = 12, kPci = 21, kAxis = 24,
                       kS = 27, kI = 33;
  static constexpr int kDof = NB * kBody;
  static constexpr int kAct = kDof + 3 * NQ;
  static constexpr int kGrav = kAct + 2 * NA;
  static constexpr int kDt = kGrav + 3;
  static constexpr int kSize = kDt + 1;
  static constexpr int iParent = 0, iType = NB, iDof = 2 * NB, iActDof = 3 * NB;
  static constexpr int kInts = 3 * NB + NA;
};

// out = R x, R row-major 3x3
template <typename M, typename X, typename O>
NPTT_HD void mv3(const M* R, const X* x, O* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = R[3 * i] * x[0] + R[3 * i + 1] * x[1] + R[3 * i + 2] * x[2];
}

// out = R^T x
template <typename M, typename X, typename O>
NPTT_HD void mtv3(const M* R, const X* x, O* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = R[i] * x[0] + R[3 + i] * x[1] + R[6 + i] * x[2];
}

// out = A B, 3x3 row-major
template <typename MA, typename MB, typename O>
NPTT_HD void mm3(const MA* A, const MB* B, O* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
}

template <typename A, typename B, typename O>
NPTT_HD void cross3(const A* a, const B* b, O* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// Ad(T^-1) V = (R^T w; R^T (v - p x w)) — parent-frame motion into the child frame
template <typename S, typename X>
NPTT_HD void ad_inv_apply(const S* R, const S* p, const X* V, S* out) {
  S pxw[3], d[3];
  cross3(p, V, pxw);
  for (int i = 0; i < 3; ++i) d[i] = V[3 + i] - pxw[i];
  mtv3(R, V, out);
  mtv3(R, d, out + 3);
}

// Ad(T^-1)^T F = (R n + p x (R f); R f) — child-frame force into the parent frame
template <typename S>
NPTT_HD void ad_dual_apply(const S* R, const S* p, const S* F, S* out) {
  S Rn[3], Rf[3], pxRf[3];
  mv3(R, F, Rn);
  mv3(R, F + 3, Rf);
  cross3(p, Rf, pxRf);
  for (int i = 0; i < 3; ++i) {
    out[i] = Rn[i] + pxRf[i];
    out[3 + i] = Rf[i];
  }
}

// V x_m W = (w x ww; v x ww + w x wv)
template <typename S>
NPTT_HD void ad_motion(const S* V, const S* W, S* out) {
  S a[3], b[3];
  cross3(V, W, out);
  cross3(V + 3, W, a);
  cross3(V, W + 3, b);
  for (int i = 0; i < 3; ++i) out[3 + i] = a[i] + b[i];
}

// V x_f F = (w x n + v x f; w x f)
template <typename S>
NPTT_HD void ad_dual(const S* V, const S* F, S* out) {
  S a[3], b[3];
  cross3(V, F, a);
  cross3(V + 3, F + 3, b);
  for (int i = 0; i < 3; ++i) out[i] = a[i] + b[i];
  cross3(V, F + 3, out + 3);
}

// out = M x for a 6x6 row-major M
template <typename M, typename X, typename O>
NPTT_HD void mv6(const M* A, const X* x, O* out) {
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    O s = A[6 * i] * x[0];
#pragma unroll
    for (int j = 1; j < 6; ++j) s = s + A[6 * i + j] * x[j];
    out[i] = s;
  }
}

// Rodrigues' formula with the Taylor branch of ops/lie.py below theta^2 = 1e-8.
template <typename T, typename S>
NPTT_HD void expm_so3(const S* w, S* R) {
  S th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  S A, B;
  if (val(th2) < T(1e-8)) {
    A = T(1) - th2 / T(6) + th2 * th2 / T(120);
    B = T(0.5) - th2 / T(24) + th2 * th2 / T(720);
  } else {
    S th = nsqrt(th2);
    A = nsin(th) / th;
    B = (T(1) - ncos(th)) / th2;
  }
  S W[9] = {S(T(0)), -w[2], w[1], w[2], S(T(0)), -w[0], -w[1], w[0], S(T(0))};
  S W2[9];
  mm3(W, W, W2);
  for (int k = 0; k < 9; ++k) R[k] = A * W[k] + B * W2[k];
  R[0] = R[0] + T(1);
  R[4] = R[4] + T(1);
  R[8] = R[8] + T(1);
}

// Forward kinematics and ABA: each body's transform to its parent (R, p)
// and the generalized accelerations qdd at (q, v, u).
template <typename T, typename S, int NB, int NQ, int NA>
NPTT_HD void forward_dynamics(const T* __restrict__ P, const int* __restrict__ I,
                              const S* q, const S* v, const S* u, S (&R)[NB][9],
                              S (&p)[NB][3], S (&qdd)[NQ]) {
  using L = StepLayout<NB, NQ, NA>;
  const T dt = P[L::kDt];

  // generalized force: action on the actuated dofs, implicit spring, damping
  S tau[NQ];
#pragma unroll
  for (int d = 0; d < NQ; ++d) tau[d] = S(T(0));
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    const int da = I[L::iActDof + a];
#pragma unroll
    for (int d = 0; d < NQ; ++d)
      if (d == da) tau[d] = u[a];
  }
#pragma unroll
  for (int d = 0; d < NQ; ++d) {
    const T damp = P[L::kDof + 3 * d], stiff = P[L::kDof + 3 * d + 1], rest = P[L::kDof + 3 * d + 2];
    tau[d] = tau[d] + (-stiff) * (q[d] - rest + v[d] * dt) + (-damp) * v[d];
  }

  // forward sweep: kinematics, velocities, bias forces
  S V[NB][6], c[NB][6], pA[NB][6], IA[NB][36];
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const T* Bp = P + i * L::kBody;
    const int jt = I[L::iType + i], dof = I[L::iDof + i], par = I[L::iParent + i];
    S qi = S(T(0)), vi = S(T(0));
#pragma unroll
    for (int d = 0; d < NQ; ++d)
      if (d == dof) {
        qi = q[d];
        vi = v[d];
      }
    S Rq[9], pq[3];
    for (int k = 0; k < 9; ++k) Rq[k] = S(T((k % 4) == 0 ? 1 : 0));
    for (int k = 0; k < 3; ++k) pq[k] = S(T(0));
    if (jt == kRevolute) {
      S w[3] = {Bp[L::kAxis] * qi, Bp[L::kAxis + 1] * qi, Bp[L::kAxis + 2] * qi};
      expm_so3<T>(w, Rq);
    } else if (jt == kPrismatic) {
      for (int k = 0; k < 3; ++k) pq[k] = Bp[L::kAxis + k] * qi;
    }
    // T_pc = T_pj o Q(q) o T_cj^-1
    S RA[9], pAq[3], tmp[3];
    mm3(Bp + L::kRpj, Rq, RA);
    mv3(Bp + L::kRpj, pq, tmp);
    for (int k = 0; k < 3; ++k) pAq[k] = tmp[k] + Bp[L::kPpj + k];
    mm3(RA, Bp + L::kRci, R[i]);
    mv3(RA, Bp + L::kPci, tmp);
    for (int k = 0; k < 3; ++k) p[i][k] = tmp[k] + pAq[k];

    S vJ[6], Vpar[6];
    for (int k = 0; k < 6; ++k) {
      vJ[k] = Bp[L::kS + k] * vi;
      Vpar[k] = S(T(0));
    }
#pragma unroll
    for (int pp = 0; pp < i; ++pp)
      if (pp == par) ad_inv_apply(R[i], p[i], V[pp], Vpar);
    for (int k = 0; k < 6; ++k) V[i][k] = Vpar[k] + vJ[k];
    ad_motion(V[i], vJ, c[i]);
    S IV[6];
    mv6(Bp + L::kI, V[i], IV);
    ad_dual(V[i], IV, pA[i]);
    for (int k = 0; k < 36; ++k) IA[i][k] = S(Bp[L::kI + k]);
  }

  // backward sweep: articulated inertias and bias forces
  S U[NB][6], Dinv[NB], uu[NB];
#pragma unroll
  for (int i = NB - 1; i >= 0; --i) {
    const T* Sv = P + i * L::kBody + L::kS;
    const int dof = I[L::iDof + i], par = I[L::iParent + i];
    S Ia[36], pa[6], Iac[6];
    if (dof >= 0) {
      mv6(IA[i], Sv, U[i]);
      S D = Sv[0] * U[i][0];
      S sp = Sv[0] * pA[i][0];
      for (int k = 1; k < 6; ++k) {
        D = D + Sv[k] * U[i][k];
        sp = sp + Sv[k] * pA[i][k];
      }
      Dinv[i] = T(1) / D;
      S te = S(T(0));
#pragma unroll
      for (int d = 0; d < NQ; ++d)
        if (d == dof) te = tau[d];
      uu[i] = te - sp;
      for (int r = 0; r < 6; ++r)
        for (int k = 0; k < 6; ++k) Ia[6 * r + k] = IA[i][6 * r + k] - (U[i][r] * Dinv[i]) * U[i][k];
      mv6(Ia, c[i], Iac);
      S Du = Dinv[i] * uu[i];
      for (int k = 0; k < 6; ++k) pa[k] = pA[i][k] + Iac[k] + U[i][k] * Du;
    } else {
      U[i][0] = S(T(0));
      Dinv[i] = S(T(0));
      uu[i] = S(T(0));
      for (int k = 0; k < 36; ++k) Ia[k] = IA[i][k];
      mv6(Ia, c[i], Iac);
      for (int k = 0; k < 6; ++k) pa[k] = pA[i][k] + Iac[k];
    }
#pragma unroll
    for (int pp = 0; pp < i; ++pp) {
      if (pp != par) continue;
      // IA[pp] += X^T Ia X, X = Ad(T_pc^-1), one column of X at a time
      for (int j = 0; j < 6; ++j) {
        S e[6], x[6], y[6], col[6];
        for (int k = 0; k < 6; ++k) e[k] = S(T(k == j ? 1 : 0));
        ad_inv_apply(R[i], p[i], e, x);
        mv6(Ia, x, y);
        ad_dual_apply(R[i], p[i], y, col);
        for (int r = 0; r < 6; ++r) IA[pp][6 * r + j] = IA[pp][6 * r + j] + col[r];
      }
      S f[6];
      ad_dual_apply(R[i], p[i], pa, f);
      for (int k = 0; k < 6; ++k) pA[pp][k] = pA[pp][k] + f[k];
    }
  }

  // forward sweep: accelerations
  const T g[6] = {T(0), T(0), T(0), -P[L::kGrav], -P[L::kGrav + 1], -P[L::kGrav + 2]};
  S a[NB][6];
#pragma unroll
  for (int d = 0; d < NQ; ++d) qdd[d] = S(T(0));
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const T* Sv = P + i * L::kBody + L::kS;
    const int dof = I[L::iDof + i], par = I[L::iParent + i];
    S ap[6];
    if (par < 0) ad_inv_apply(R[i], p[i], g, ap);
#pragma unroll
    for (int pp = 0; pp < i; ++pp)
      if (pp == par) ad_inv_apply(R[i], p[i], a[pp], ap);
    for (int k = 0; k < 6; ++k) ap[k] = ap[k] + c[i][k];
    if (dof >= 0) {
      S Ua = U[i][0] * ap[0];
      for (int k = 1; k < 6; ++k) Ua = Ua + U[i][k] * ap[k];
      S qi = Dinv[i] * (uu[i] - Ua);
#pragma unroll
      for (int d = 0; d < NQ; ++d)
        if (d == dof) qdd[d] = qi;
      for (int k = 0; k < 6; ++k) a[i][k] = ap[k] + Sv[k] * qi;
    } else {
      for (int k = 0; k < 6; ++k) a[i][k] = ap[k];
    }
  }

}

// One step x' = f(x, u) of the planning dynamics (simulation/step.py
// forward_step with the action mapped onto the actuated dofs).
template <typename T, typename S, int NB, int NQ, int NA>
NPTT_HD void device_step(const T* __restrict__ P, const int* __restrict__ I,
                         const S* q, const S* v, const S* u, S* qn, S* vn) {
  using L = StepLayout<NB, NQ, NA>;
  const T dt = P[L::kDt];
  S R[NB][9], p[NB][3], qdd[NQ];
  forward_dynamics<T, S, NB, NQ, NA>(P, I, q, v, u, R, p, qdd);
#pragma unroll
  for (int d = 0; d < NQ; ++d) {
    vn[d] = v[d] + dt * qdd[d];
    qn[d] = q[d] + v[d] * dt;
  }
}

// ---------------------------------------------------------------------------
// Constraint rows (joint limits and Coulomb joint friction) and the two
// constrained steps built on them:
//
//   frozen_step: the smooth step on frozen LCP classes (ops/frozen_contact.py
//     frozen_contact_step with the planner assembly): every row gated on,
//     impulses from solve_frozen (regularised normal equations by Jacobi-
//     preconditioned CG). K2 with classes runs it on T, K4 on Dual<T>,
//     where solve_frozen takes the implicit tangent of the linear solve.
//   class_step: the full step of the class rollout (ops/frozen_contact.py
//     step_with_classes_for_trace): rows gated by the limits, impulses from
//     direct_boxed_solve_lane, then the class of each row. K6 runs it.
//
// The packed model gains, after the step's buffers (ops/device_step.py):
//   reals: per row, its limit position (limit rows) or its impulse bound
//     mu dt (Coulomb rows);
//   ints: per row its dof, then per row its kind (RowKind).
// Rows come in the order of ops/contact.py: lower limit rows, upper limit
// rows, Coulomb rows. None is friction-coupled (findex -1, fscale 0), so
// gov = 0, the frozen solve's R is diag(cmask), and no row is UPPER.
//
// The (bodies, dofs, actions, rows) shapes the constrained kernels are
// built for; the Python wrappers refuse any other model. cartpole with its
// two limited dofs: 2 bodies, 2 dofs, 1 action, 4 rows.
#define NPTT_CONTACT_SHAPES(X) X(2, 2, 1, 4)

enum RowKind { kLowerLimit = 0, kUpperLimit = 1, kCoulomb = 2 };

// ops/lcp.py _BIG and CLAMPING_THRESHOLD, ops/contact.py CFM
constexpr double kBig = 1e20, kClampThreshold = 1e-6, kCfm = 1e-5;

// The dtype-scaled constants of ops/lcp.py and ops/frozen_contact.py: the
// normal equations' regularisation and the boundary tolerance.
template <typename T> struct Prec;
template <> struct Prec<float> {
  static NPTT_HD float eps() { return 1e-5f; }
  static NPTT_HD float tol() { return 1e-6f; }
};
template <> struct Prec<double> {
  static NPTT_HD double eps() { return 1e-10; }
  static NPTT_HD double tol() { return 1e-10; }
};

template <int NB, int NQ, int NA, int M>
struct RowLayout {
  using L = StepLayout<NB, NQ, NA>;
  static constexpr int kRow = L::kSize;
  static constexpr int iRowDof = L::kInts, iRowKind = L::kInts + M;
};

// A[r][c] = v for run-time (r, c), by unrolled selects (no local memory)
template <typename S, int N>
NPTT_HD void set_at(S (&A)[N][N], int r, int c, S v) {
#pragma unroll
  for (int a = 0; a < N; ++a)
#pragma unroll
    for (int b = 0; b < N; ++b)
      if (a == r && b == c) A[a][b] = v;
}

// Composite-rigid-body mass matrix M(q) (ops/dynamics.py mass_matrix) from
// the transforms forward_dynamics left in (R, p).
template <typename T, typename S, int NB, int NQ, int NA>
NPTT_HD void mass_matrix(const T* __restrict__ P, const int* __restrict__ I,
                         const S (&R)[NB][9], const S (&p)[NB][3], S (&Mm)[NQ][NQ]) {
  using L = StepLayout<NB, NQ, NA>;
  S Ic[NB][36];
#pragma unroll
  for (int i = 0; i < NB; ++i)
    for (int k = 0; k < 36; ++k) Ic[i][k] = S(P[i * L::kBody + L::kI + k]);
  // composite inertias: Ic[parent] += X^T Ic X, X = Ad(T_pc^-1), by columns
#pragma unroll
  for (int i = NB - 1; i >= 0; --i) {
    const int par = I[L::iParent + i];
#pragma unroll
    for (int pp = 0; pp < i; ++pp) {
      if (pp != par) continue;
      for (int j = 0; j < 6; ++j) {
        S e[6], x[6], y[6], col[6];
        for (int k = 0; k < 6; ++k) e[k] = S(T(k == j ? 1 : 0));
        ad_inv_apply(R[i], p[i], e, x);
        mv6(Ic[i], x, y);
        ad_dual_apply(R[i], p[i], y, col);
        for (int r = 0; r < 6; ++r) Ic[pp][6 * r + j] = Ic[pp][6 * r + j] + col[r];
      }
    }
  }
#pragma unroll
  for (int a = 0; a < NQ; ++a)
#pragma unroll
    for (int c = 0; c < NQ; ++c) Mm[a][c] = S(T(0));
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const int dof = I[L::iDof + i];
    if (dof < 0) continue;
    const T* Sv = P + i * L::kBody + L::kS;
    S F[6];
    mv6(Ic[i], Sv, F);
    S Mii = Sv[0] * F[0];
    for (int k = 1; k < 6; ++k) Mii = Mii + Sv[k] * F[k];
    set_at(Mm, dof, dof, Mii);
    // carry F = Ic S up the chain of ancestors (parents[j] < j)
    int cur = i;
#pragma unroll
    for (int jj = i; jj >= 1; --jj) {
      if (jj != cur) continue;
      const int par = I[L::iParent + jj];
      if (par < 0) {
        cur = -1;
        continue;
      }
      S G[6];
      ad_dual_apply(R[jj], p[jj], F, G);
      for (int k = 0; k < 6; ++k) F[k] = G[k];
      cur = par;
      const int dp = I[L::iDof + par];
      if (dp >= 0) {
        const T* Sp = P + par * L::kBody + L::kS;
        S mij = Sp[0] * F[0];
        for (int k = 1; k < 6; ++k) mij = mij + Sp[k] * F[k];
        set_at(Mm, dp, dof, mij);
        set_at(Mm, dof, dp, mij);
      }
    }
  }
}

// Pivot-free Gauss-Jordan inverse of an SPD matrix on the augmented rows
// [A | I] (ops/linalg_small.py inv_spd): prow = row_k (1 / pivot),
// row_i -= row_i[k] prow.
template <typename T, typename S, int N>
NPTT_HD void inv_spd(const S (&A)[N][N], S (&Ai)[N][N]) {
  S rows[N][2 * N];
#pragma unroll
  for (int k = 0; k < N; ++k)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      rows[k][j] = A[k][j];
      rows[k][N + j] = S(T(k == j ? 1 : 0));
    }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const S inv = T(1) / rows[k][k];
    S prow[2 * N];
#pragma unroll
    for (int j = 0; j < 2 * N; ++j) prow[j] = rows[k][j] * inv;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i == k) {
#pragma unroll
        for (int j = 0; j < 2 * N; ++j) rows[i][j] = prow[j];
      } else {
        const S f = rows[i][k];
#pragma unroll
        for (int j = 0; j < 2 * N; ++j) rows[i][j] = rows[i][j] - f * prow[j];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) Ai[i][j] = rows[i][N + j];
}

// The boxed LCP of the rows (ops/contact.py build_constraint_system):
// J_r = s_r a_r e_{d_r} (s = -1 on upper limit rows, a the row's
// activation: 1 in the planner form, q <= lower / q >= upper otherwise),
// MJ = M^-1 J^T and A = J MJ + CFM I, both taken from their one nonzero
// term (the dense products add exact zeros to it).
template <typename T, typename S, int NB, int NQ, int NA, int M, bool PLANNER>
NPTT_HD void constraint_rows(const T* __restrict__ P, const int* __restrict__ I, const S* q,
                             const S* vs, const S (&Mi)[NQ][NQ], S (&A)[M][M], S (&b)[M],
                             T (&lo)[M], T (&hi)[M], S (&MJ)[NQ][M]) {
  using RL = RowLayout<NB, NQ, NA, M>;
  T coef[M];
  int dofs[M];
#pragma unroll
  for (int r = 0; r < M; ++r) {
    const int d = I[RL::iRowDof + r], kind = I[RL::iRowKind + r];
    const T lim = P[RL::kRow + r];
    dofs[r] = d;
    S qd = S(T(0)), vd = S(T(0));
#pragma unroll
    for (int e = 0; e < NQ; ++e)
      if (e == d) {
        qd = q[e];
        vd = vs[e];
      }
    T act = T(1);
    if (!PLANNER && kind != kCoulomb) {
      const S gap = qd - lim;
      act = (kind == kLowerLimit ? val(gap) <= T(0) : val(gap) >= T(0)) ? T(1) : T(0);
    }
    coef[r] = (kind == kUpperLimit ? T(-1) : T(1)) * act;
    if (kind == kCoulomb) {
      b[r] = -vd;
      lo[r] = -lim;
      hi[r] = lim;
    } else {
      b[r] = (kind == kLowerLimit ? -act : act) * vd;
      lo[r] = T(0);
      hi[r] = act * T(kBig);
    }
  }
#pragma unroll
  for (int k = 0; k < NQ; ++k)
#pragma unroll
    for (int c = 0; c < M; ++c) {
      S mk = S(T(0));
#pragma unroll
      for (int e = 0; e < NQ; ++e)
        if (e == dofs[c]) mk = Mi[k][e];
      MJ[k][c] = mk * coef[c];
    }
#pragma unroll
  for (int r = 0; r < M; ++r)
#pragma unroll
    for (int c = 0; c < M; ++c) {
      S jr = S(T(0));
#pragma unroll
      for (int e = 0; e < NQ; ++e)
        if (e == dofs[r]) jr = MJ[e][c];
      A[r][c] = coef[r] * jr;
      if (r == c) A[r][c] = A[r][c] + T(kCfm);
    }
}

// Qf = C A R + (I - C) with R = diag(cmask) (gov = 0), C = diag(cmask)
template <typename T, typename S, int M>
NPTT_HD void frozen_system(const S (&A)[M][M], const T* cm, S (&Qf)[M][M]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) {
      Qf[i][j] = (cm[i] * (A[i][j] * cm[j])) * cm[j];
      if (i == j) Qf[i][j] = Qf[i][j] + (T(1) - cm[i]);
    }
}

// Jacobi-preconditioned CG on (Qf^T Qf + reg I) x = bb from x = 0
// (ops/frozen_contact.py _pcg), n_cg iterations.
template <typename T, typename S, int M>
NPTT_HD void pcg(const S (&Qf)[M][M], S reg, const S (&diagM)[M], const S (&bb)[M], int n_cg,
                 S (&x)[M]) {
  const T tiny = T(1e-30);
  S r[M], z[M], p[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    x[i] = S(T(0));
    r[i] = bb[i];
    z[i] = r[i] / diagM[i];
    p[i] = z[i];
  }
  S rz = r[0] * z[0];
#pragma unroll
  for (int i = 1; i < M; ++i) rz = rz + r[i] * z[i];
  for (int it = 0; it < n_cg; ++it) {
    S Qp[M], Ap[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      Qp[i] = Qf[i][0] * p[0];
#pragma unroll
      for (int j = 1; j < M; ++j) Qp[i] = Qp[i] + Qf[i][j] * p[j];
    }
#pragma unroll
    for (int j = 0; j < M; ++j) {
      S s = Qf[0][j] * Qp[0];
#pragma unroll
      for (int i = 1; i < M; ++i) s = s + Qf[i][j] * Qp[i];
      Ap[j] = s + reg * p[j];
    }
    S pAp = p[0] * Ap[0];
#pragma unroll
    for (int i = 1; i < M; ++i) pAp = pAp + p[i] * Ap[i];
    const S alpha = rz / (pAp + tiny);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      x[i] = x[i] + alpha * p[i];
      r[i] = r[i] - alpha * Ap[i];
      z[i] = r[i] / diagM[i];
    }
    S rz_new = r[0] * z[0];
#pragma unroll
    for (int i = 1; i < M; ++i) rz_new = rz_new + r[i] * z[i];
    const S beta = rz_new / (rz + tiny);
#pragma unroll
    for (int i = 0; i < M; ++i) p[i] = z[i] + beta * p[i];
    rz = rz_new;
  }
}

// Impulses on frozen classes (ops/frozen_contact.py solve_frozen):
// x = R x_C, (Qf^T Qf + reg I) x_C = Qf^T (cmask b), reg = eps max(max|Qf|, 1)^2.
template <typename T, typename S, int M>
NPTT_HD void solve_frozen(const S (&A)[M][M], const S (&b)[M], const T* cm, int n_cg,
                          S (&x)[M]) {
  S Qf[M][M], rhs[M], diagM[M], bvec[M], xc[M];
  frozen_system<T>(A, cm, Qf);
#pragma unroll
  for (int i = 0; i < M; ++i) rhs[i] = cm[i] * b[i];
  S qs = S(T(1));
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) qs = pmax(qs, nabs(Qf[i][j]));
  const S reg = (Prec<T>::eps() * qs) * qs;
#pragma unroll
  for (int j = 0; j < M; ++j) {
    S dg = Qf[0][j] * Qf[0][j], bv = Qf[0][j] * rhs[0];
#pragma unroll
    for (int i = 1; i < M; ++i) {
      dg = dg + Qf[i][j] * Qf[i][j];
      bv = bv + Qf[i][j] * rhs[i];
    }
    diagM[j] = dg + reg;
    bvec[j] = bv;
  }
  pcg<T>(Qf, reg, diagM, bvec, n_cg, xc);
#pragma unroll
  for (int i = 0; i < M; ++i) x[i] = cm[i] * (cm[i] * xc[i]);
}

// solve_frozen on dual numbers, with the tangent lax.custom_linear_solve
// gives the JAX package: the primal PCG on the values, then ONE tangent
// PCG with the same iteration count and the primal preconditioner,
//   dx_C = PCG(dbvec - (dQf^T Qf x_C + Qf^T dQf x_C + dreg x_C)).
// Pushing the tangent through the CG iterations would differentiate the
// truncated iteration instead. max|Qf| takes jnp's tangent: the mean over
// tied entries, |.|' = +1 at 0, and half of it where max(., 1) ties.
template <typename T, typename V, int M>
NPTT_HD void solve_frozen(const Dual<V> (&A)[M][M], const Dual<V> (&b)[M], const T* cm, int n_cg,
                          Dual<V> (&x)[M]) {
  Dual<V> Qf[M][M], rhs[M], bvec[M];
  frozen_system<T>(A, cm, Qf);
#pragma unroll
  for (int i = 0; i < M; ++i) rhs[i] = cm[i] * b[i];
  T mx = nabs(val(Qf[0][0].v));
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) mx = pmax(mx, nabs(val(Qf[i][j].v)));
  T cnt = T(0);
  V dsum = V(T(0));
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const T w = nabs(val(Qf[i][j].v)) == mx ? T(1) : T(0);
      cnt = cnt + w;
      dsum = dsum + (w * (val(Qf[i][j].v) >= T(0) ? T(1) : T(-1))) * Qf[i][j].d;
    }
  const T share = mx > T(1) ? T(1) / cnt : (mx == T(1) ? T(0.5) / cnt : T(0));
  const Dual<V> qs(V(pmax(mx, T(1))), dsum * share);
  const Dual<V> reg = (Prec<T>::eps() * qs) * qs;
  V Qv[M][M], diagM[M], bv[M], xc[M], Qx[M], dQx[M], rt[M], dxc[M];
#pragma unroll
  for (int j = 0; j < M; ++j) {
    V dg = Qf[0][j].v * Qf[0][j].v;
    Dual<V> s = Qf[0][j] * rhs[0];
#pragma unroll
    for (int i = 1; i < M; ++i) {
      dg = dg + Qf[i][j].v * Qf[i][j].v;
      s = s + Qf[i][j] * rhs[i];
    }
    diagM[j] = dg + reg.v;
    bvec[j] = s;
    bv[j] = s.v;
#pragma unroll
    for (int i = 0; i < M; ++i) Qv[i][j] = Qf[i][j].v;
  }
  pcg<T>(Qv, reg.v, diagM, bv, n_cg, xc);
#pragma unroll
  for (int i = 0; i < M; ++i) {
    Qx[i] = Qf[i][0].v * xc[0];
    dQx[i] = Qf[i][0].d * xc[0];
#pragma unroll
    for (int j = 1; j < M; ++j) {
      Qx[i] = Qx[i] + Qf[i][j].v * xc[j];
      dQx[i] = dQx[i] + Qf[i][j].d * xc[j];
    }
  }
#pragma unroll
  for (int j = 0; j < M; ++j) {
    V s1 = Qf[0][j].d * Qx[0], s2 = Qf[0][j].v * dQx[0];
#pragma unroll
    for (int i = 1; i < M; ++i) {
      s1 = s1 + Qf[i][j].d * Qx[i];
      s2 = s2 + Qf[i][j].v * dQx[i];
    }
    rt[j] = bvec[j].d - ((s1 + s2) + reg.d * xc[j]);
  }
  pcg<T>(Qv, reg.v, diagM, rt, n_cg, dxc);
#pragma unroll
  for (int i = 0; i < M; ++i) x[i] = cm[i] * (cm[i] * Dual<V>(xc[i], dxc[i]));
}

// Complementarity violation of an in-box iterate, max over rows with an
// initial 0 (ops/lcp.py _comp_residual); NaN propagates.
template <typename T, typename S, int M>
NPTT_HD S comp_residual(const S (&A)[M][M], const S (&b)[M], const T (&lo)[M], const T (&hi)[M],
                        const S (&x)[M]) {
  const T tol = Prec<T>::tol();
  S res = S(T(0));
#pragma unroll
  for (int i = 0; i < M; ++i) {
    S w = A[i][0] * x[0];
#pragma unroll
    for (int j = 1; j < M; ++j) w = w + A[i][j] * x[j];
    w = w - b[i];
    const S nw = -w;
    const bool at_lo = val(x[i]) <= lo[i] + tol, at_hi = val(x[i]) >= hi[i] - tol;
    const S r = at_lo ? pmax(S(T(0)), nw) : (at_hi ? pmax(S(T(0)), w) : nabs(w));
    res = pmax(res, r);
  }
  return res;
}

// One round's interior solve of direct_boxed_solve_lane: A_II x_I =
// b_I - A_IB x_B by regularised normal equations through inv_spd.
template <typename T, typename S, int M>
NPTT_HD void lcp_subsolve(const S (&A)[M][M], const S (&b)[M], const T (&lo)[M], const T (&hi)[M],
                          const T (&im)[M], const S (&x)[M], S (&xn)[M]) {
  S xb[M], rhs[M], Af[M][M], AtA[M][M], Atr[M], Ai[M][M];
#pragma unroll
  for (int i = 0; i < M; ++i) xb[i] = nclip(x[i], lo[i], hi[i]) * (T(1) - im[i]);
#pragma unroll
  for (int i = 0; i < M; ++i) {
    S ax = A[i][0] * xb[0];
#pragma unroll
    for (int j = 1; j < M; ++j) ax = ax + A[i][j] * xb[j];
    rhs[i] = im[i] * (b[i] - ax);
  }
  S sc = S(T(1));
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) {
      Af[i][j] = (im[i] * A[i][j]) * im[j];
      if (i == j) Af[i][j] = Af[i][j] + (T(1) - im[i]);
      sc = pmax(sc, nabs(Af[i][j]));
    }
  const S reg = (Prec<T>::eps() * sc) * sc;
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j < M; ++j) {
      S s = Af[0][i] * Af[0][j];
#pragma unroll
      for (int k = 1; k < M; ++k) s = s + Af[k][i] * Af[k][j];
      AtA[i][j] = i == j ? s + reg : s;
    }
    S t = Af[0][i] * rhs[0];
#pragma unroll
    for (int k = 1; k < M; ++k) t = t + Af[k][i] * rhs[k];
    Atr[i] = t;
  }
  inv_spd<T>(AtA, Ai);
#pragma unroll
  for (int i = 0; i < M; ++i) {
    S xi = Ai[i][0] * Atr[0];
#pragma unroll
    for (int j = 1; j < M; ++j) xi = xi + Ai[i][j] * Atr[j];
    xn[i] = xi * im[i] + xb[i];
  }
}

// ops/lcp.py direct_boxed_solve_lane: 3 active-set rounds keeping the
// best-residual iterate (strict <), then 8 projected Gauss-Seidel sweeps,
// kept when they lower the residual.
template <typename T, typename S, int M>
NPTT_HD void direct_boxed_solve_lane(const S (&A)[M][M], const S (&b)[M], const T (&lo)[M],
                                     const T (&hi)[M], S (&out)[M]) {
  T im[M];
  S x[M], best[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    im[i] = T(1);
    x[i] = S(T(0));
    best[i] = nclip(x[i], lo[i], hi[i]);
  }
  S best_res = comp_residual<T>(A, b, lo, hi, best);
#pragma unroll
  for (int round = 0; round < 3; ++round) {
    S xn[M];
    lcp_subsolve<T>(A, b, lo, hi, im, x, xn);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      S w = A[i][0] * xn[0];
#pragma unroll
      for (int j = 1; j < M; ++j) w = w + A[i][j] * xn[j];
      w = w - b[i];
      const bool below = val(xn[i]) <= lo[i], above = val(xn[i]) >= hi[i];
      x[i] = nclip(xn[i], lo[i], hi[i]);
      const bool want_in = (below && val(w) < T(0)) || (above && val(w) > T(0));
      im[i] = ((!below && !above) || want_in) ? T(1) : T(0);
    }
    const S res = comp_residual<T>(A, b, lo, hi, x);
    if (val(res) < val(best_res)) {
#pragma unroll
      for (int i = 0; i < M; ++i) best[i] = x[i];
      best_res = res;
    }
  }
  S y[M], inv_diag[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    y[i] = best[i];
    const S id = T(1) / A[i][i];
    inv_diag[i] = nabs(val(A[i][i])) > T(1e-12) ? id : S(T(0));
  }
#pragma unroll
  for (int sweep = 0; sweep < 8; ++sweep)
#pragma unroll
    for (int i = 0; i < M; ++i) {
      S rs = A[i][0] * y[0];
#pragma unroll
      for (int j = 1; j < M; ++j) rs = rs + A[i][j] * y[j];
      rs = rs - b[i];
      const S xi = nclip(y[i] - rs * inv_diag[i], lo[i], hi[i]);
      y[i] = y[i] + (xi - y[i]);
    }
  const bool better = val(comp_residual<T>(A, b, lo, hi, y)) < val(best_res);
#pragma unroll
  for (int i = 0; i < M; ++i) out[i] = better ? y[i] : best[i];
}

// ops/lcp.py classify_lane for uncoupled rows: the CLAMPING mask.
template <typename T, typename S, int M>
NPTT_HD void classify_rows(const S (&x)[M], const T (&lo)[M], const T (&hi)[M], T (&cm)[M]) {
  const T thr = T(kClampThreshold), half_big = T(kBig / 2);
#pragma unroll
  for (int r = 0; r < M; ++r) {
    const T xv = val(x[r]);
    const bool normal_clamp = xv > thr && hi[r] > half_big;
    const bool bounded_clamp = hi[r] < half_big && xv > lo[r] + thr && xv < hi[r] - thr;
    const bool bilateral = lo[r] < -half_big && hi[r] > half_big;
    cm[r] = (normal_clamp || bounded_clamp || bilateral) ? T(1) : T(0);
  }
}

// The frozen-class planning step x' = f(x, u; cmask) (planner assembly).
template <typename T, typename S, int NB, int NQ, int NA, int M>
NPTT_HD void frozen_step(const T* __restrict__ P, const int* __restrict__ I, const S* q,
                         const S* v, const S* u, const T* cm, int n_cg, S* qn, S* vn) {
  using L = StepLayout<NB, NQ, NA>;
  const T dt = P[L::kDt];
  S R[NB][9], p[NB][3], qdd[NQ], vs[NQ], Mm[NQ][NQ], Mi[NQ][NQ], A[M][M], b[M], MJ[NQ][M], x[M];
  T lo[M], hi[M];
  forward_dynamics<T, S, NB, NQ, NA>(P, I, q, v, u, R, p, qdd);
#pragma unroll
  for (int d = 0; d < NQ; ++d) {
    vs[d] = v[d] + dt * qdd[d];
    qn[d] = q[d] + v[d] * dt;
  }
  mass_matrix<T, S, NB, NQ, NA>(P, I, R, p, Mm);
  inv_spd<T>(Mm, Mi);
  constraint_rows<T, S, NB, NQ, NA, M, true>(P, I, q, vs, Mi, A, b, lo, hi, MJ);
  solve_frozen<T>(A, b, cm, n_cg, x);
#pragma unroll
  for (int d = 0; d < NQ; ++d) {
    S s = MJ[d][0] * x[0];
#pragma unroll
    for (int c = 1; c < M; ++c) s = s + MJ[d][c] * x[c];
    vn[d] = vs[d] + s;
  }
}

// The full constrained step of the class rollout: x' and each row's class.
template <typename T, typename S, int NB, int NQ, int NA, int M>
NPTT_HD void class_step(const T* __restrict__ P, const int* __restrict__ I, const S* q,
                        const S* v, const S* u, S* qn, S* vn, T (&cm)[M]) {
  using L = StepLayout<NB, NQ, NA>;
  const T dt = P[L::kDt];
  S R[NB][9], p[NB][3], qdd[NQ], vs[NQ], Mm[NQ][NQ], Mi[NQ][NQ], A[M][M], b[M], MJ[NQ][M], x[M];
  T lo[M], hi[M];
  forward_dynamics<T, S, NB, NQ, NA>(P, I, q, v, u, R, p, qdd);
#pragma unroll
  for (int d = 0; d < NQ; ++d) {
    vs[d] = v[d] + dt * qdd[d];
    qn[d] = q[d] + v[d] * dt;
  }
  mass_matrix<T, S, NB, NQ, NA>(P, I, R, p, Mm);
  inv_spd<T>(Mm, Mi);
  constraint_rows<T, S, NB, NQ, NA, M, false>(P, I, q, vs, Mi, A, b, lo, hi, MJ);
  direct_boxed_solve_lane<T>(A, b, lo, hi, x);
#pragma unroll
  for (int d = 0; d < NQ; ++d) {
    S s = MJ[d][0] * x[0];
#pragma unroll
    for (int c = 1; c < M; ++c) s = s + MJ[d][c] * x[c];
    vn[d] = vs[d] + s;
  }
  classify_rows<T>(x, lo, hi, cm);
}

}  // namespace nptt
