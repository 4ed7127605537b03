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

// One step x' = f(x, u) of the planning dynamics (simulation/step.py
// forward_step with the action mapped onto the actuated dofs).
template <typename T, typename S, int NB, int NQ, int NA>
NPTT_HD void device_step(const T* __restrict__ P, const int* __restrict__ I,
                         const S* q, const S* v, const S* u, S* qn, S* vn) {
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
  S R[NB][9], p[NB][3], V[NB][6], c[NB][6], pA[NB][6], IA[NB][36];
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
  S a[NB][6], qdd[NQ];
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

#pragma unroll
  for (int d = 0; d < NQ; ++d) {
    vn[d] = v[d] + dt * qdd[d];
    qn[d] = q[d] + v[d] * dt;
  }
}

}  // namespace nptt
