// The planning step on the card: ABA forward dynamics plus a semi-implicit
// Euler update, for chains of weld, revolute, prismatic and translational2d
// joints.
//
// Hopper's answer to the JAX package's LaneFn (nimblephysics_tpu/ops/
// lanevmap.py), which traced the step once and re-emitted it with the world
// batch on the TPU's lanes: here the step is written once by hand, templated
// on the scalar type S (T, or Dual<T> for the linearize kernels) and on the
// compile-time body, dof and action counts. On small models (StepLayout::
// kUnroll) the loops over bodies and dofs unroll, so every per-body array
// lives in registers; on larger ones they stay rolled. Joint types and
// parents are read at run time from the packed model; they are the same for
// every thread, so the branches never diverge, and run-time indices are
// resolved by selects instead of indexing where the loops unroll.
//
// The packed model (written by nimblephysics_tpu_torch/ops/device_step.py):
//   reals, per body (kBody = 78): T_pj R(9) p(3) | T_cj^-1 R(9) p(3) |
//     joint axis 0 (3) | child-frame subspace column 0 (6) | spatial
//     inertia(36) | joint axis 1 (3) | subspace column 1 (6) (columns a
//     joint does not have are zero);
//   then per dof: damping, stiffness, rest position (3 NQ);
//   per action: tau lower, tau upper (2 NA); gravity (3); dt (1).
//   ints: parents[NB] | joint type[NB] (0 weld, 1 revolute, 2 prismatic,
//     3 translational2d) | first dof of each body[NB] (-1 for a weld) |
//     dof of each action[NA].
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

enum JointCode { kWeld = 0, kRevolute = 1, kPrismatic = 2, kTranslational2d = 3 };

NPTT_HD int joint_ndof(int jt) { return jt == kWeld ? 0 : (jt == kTranslational2d ? 2 : 1); }

template <int NB, int NQ, int NA>
struct StepLayout {
  static constexpr int kBody = 78;
  static constexpr int kRpj = 0, kPpj = 9, kRci = 12, kPci = 21, kAxis = 24,
                       kS = 27, kI = 33, kAxis1 = 69, kS1 = 72;
  static constexpr int kDof = NB * kBody;
  static constexpr int kAct = kDof + 3 * NQ;
  static constexpr int kGrav = kAct + 2 * NA;
  static constexpr int kDt = kGrav + 3;
  static constexpr int kSize = kDt + 1;
  static constexpr int iParent = 0, iType = NB, iDof = 2 * NB, iActDof = 3 * NB;
  static constexpr int kInts = 3 * NB + NA;
  // Whether the loops over bodies, dofs, actions and 3- or 6-vectors, in
  // the step and in the kernels' thread bodies, unroll (unroll_by): for
  // models of up to 2 bodies and 2 dofs, whose arrays then live in
  // registers; not above that, where unrolled they hold the jump worm's K4
  // and K5 at 255 registers and slow them (scripts/torch_unroll_variants.py,
  // PERF.md section 6). The loops over a body's ancestors run to NB and
  // skip pp >= i, so that every such loop has a compile-time trip count:
  // bounded by i under a plain #pragma unroll, inside the rolled loop over
  // the bodies, mass_matrix's gave a K5 with wrong f64 results on the card
  // (nvcc 12.9; right under -G, wrong under -Xptxas -O0; ROADMAP queue C).
  static constexpr bool kUnroll = NB <= 2 && NQ <= 2;
};

// out = R x, R row-major 3x3
template <bool U, typename M, typename X, typename O>
NPTT_HD void mv3(const M* R, const X* x, O* out) {
NPTT_UNROLL(U, 3)
  for (int i = 0; i < 3; ++i) out[i] = R[3 * i] * x[0] + R[3 * i + 1] * x[1] + R[3 * i + 2] * x[2];
}

// out = R^T x
template <bool U, typename M, typename X, typename O>
NPTT_HD void mtv3(const M* R, const X* x, O* out) {
NPTT_UNROLL(U, 3)
  for (int i = 0; i < 3; ++i) out[i] = R[i] * x[0] + R[3 + i] * x[1] + R[6 + i] * x[2];
}

// out = A B, 3x3 row-major
template <bool U, typename MA, typename MB, typename O>
NPTT_HD void mm3(const MA* A, const MB* B, O* out) {
NPTT_UNROLL(U, 3)
  for (int i = 0; i < 3; ++i)
NPTT_UNROLL(U, 3)
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
// (out's type O holds both S and X: the two are the same but in the mixed
// steps of K3, whose transforms may be plain and V dual)
template <bool U, typename S, typename X, typename O>
NPTT_HD void ad_inv_apply(const S* R, const S* p, const X* V, O* out) {
  O pxw[3], d[3];
  cross3(p, V, pxw);
  for (int i = 0; i < 3; ++i) d[i] = V[3 + i] - pxw[i];
  mtv3<U>(R, V, out);
  mtv3<U>(R, d, out + 3);
}

// Ad(T^-1)^T F = (R n + p x (R f); R f) — child-frame force into the parent frame
template <bool U, typename S, typename O>
NPTT_HD void ad_dual_apply(const S* R, const S* p, const O* F, O* out) {
  O Rn[3], Rf[3], pxRf[3];
  mv3<U>(R, F, Rn);
  mv3<U>(R, F + 3, Rf);
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
template <typename S, typename O>
NPTT_HD void ad_dual(const S* V, const S* F, O* out) {
  S a[3], b[3];
  cross3(V, F, a);
  cross3(V + 3, F + 3, b);
  for (int i = 0; i < 3; ++i) out[i] = a[i] + b[i];
  cross3(V, F + 3, out + 3);
}

// out = M x for a 6x6 row-major M
template <bool U, typename M, typename X, typename O>
NPTT_HD void mv6(const M* A, const X* x, O* out) {
NPTT_UNROLL(U, 6)
  for (int i = 0; i < 6; ++i) {
    O s = A[6 * i] * x[0];
NPTT_UNROLL(U, 5)
    for (int j = 1; j < 6; ++j) s = s + A[6 * i + j] * x[j];
    out[i] = s;
  }
}

// Rodrigues' formula with the Taylor branch of ops/lie.py below theta^2 = 1e-8.
template <typename T, bool U, typename S>
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
  mm3<U>(W, W, W2);
  for (int k = 0; k < 9; ++k) R[k] = A * W[k] + B * W2[k];
  R[0] = R[0] + T(1);
  R[4] = R[4] + T(1);
  R[8] = R[8] + T(1);
}

// Pivot-free Gauss-Jordan inverse of an SPD matrix on the augmented rows
// [A | I] (ops/linalg_small.py inv_spd): prow = row_k (1 / pivot),
// row_i -= row_i[k] prow.
template <typename T, bool U, typename S, int N>
NPTT_HD void inv_spd(const S (&A)[N][N], S (&Ai)[N][N]) {
  S rows[N][2 * N];
NPTT_UNROLL(U, N)
  for (int k = 0; k < N; ++k)
NPTT_UNROLL(U, N)
    for (int j = 0; j < N; ++j) {
      rows[k][j] = A[k][j];
      rows[k][N + j] = S(T(k == j ? 1 : 0));
    }
NPTT_UNROLL(U, N)
  for (int k = 0; k < N; ++k) {
    const S inv = T(1) / rows[k][k];
    S prow[2 * N];
NPTT_UNROLL(U, 2 * N)
    for (int j = 0; j < 2 * N; ++j) prow[j] = rows[k][j] * inv;
NPTT_UNROLL(U, N)
    for (int i = 0; i < N; ++i) {
      if (i == k) {
NPTT_UNROLL(U, 2 * N)
        for (int j = 0; j < 2 * N; ++j) rows[i][j] = prow[j];
      } else {
        const S f = rows[i][k];
NPTT_UNROLL(U, 2 * N)
        for (int j = 0; j < 2 * N; ++j) rows[i][j] = rows[i][j] - f * prow[j];
      }
    }
  }
NPTT_UNROLL(U, N)
  for (int i = 0; i < N; ++i)
NPTT_UNROLL(U, N)
    for (int j = 0; j < N; ++j) Ai[i][j] = rows[i][N + j];
}

// The body-indexed work arrays of forward_dynamics and mass_matrix in a
// lane group's shared memory, where one lane runs the dynamics
// (frozen_group.cuh). The one-thread step keeps them as local arrays,
// declared where they were before the group existed, so that its code
// stays as it was (work_array picks one or the other at compile time).
template <typename S, int NB, int NQ>
struct DynWork {
  S tau[NQ], V[NB][6], c[NB][6], pA[NB][6], IA[NB][36], U[NB][2][6], Dinv[NB][2][2], uu[NB][2],
      a[NB][6], Ic[NB][36];
};

template <bool EXT, typename W, typename AM, typename A>
NPTT_HD A& work_array(W* w, AM W::*member, A& local) {
  if constexpr (EXT)
    return w->*member;
  else
    return local;
}

// Forward kinematics and ABA: each body's transform to its parent (R, p)
// and the generalized accelerations qdd at (q, v, u). A body's joint has
// nd = joint_ndof(type) dofs, from its first dof on; the two-dof branch
// (translational2d) inverts its 2x2 joint inertia with inv_spd.
// UR: whether the loops over bodies and dofs unroll (StepLayout::kUnroll;
// a lane group's lane 0 unrolls them at any shape); EXT: the work arrays
// in *wk, else local.
// Three scalar types, each holding the one before it: SQ for what depends
// on q alone (the transforms, the articulated inertias and their U and
// D^-1), SV for what also depends on v (the velocities and their bias
// terms c), S for the rest (the forces, uu, the accelerations). Every step
// but K3's runs them as one type; K3 (linearize_free.cu) keeps plain what
// a direction of v or u leaves fixed.
template <typename T, typename SQ, typename SV, typename S, int NB, int NQ, int NA, bool UR,
          bool EXT>
NPTT_HD void forward_dynamics_impl(DynWork<S, NB, NQ>* wk, const T* __restrict__ P,
                                   const int* __restrict__ I, const SQ* q, const SV* v,
                                   const S* u, SQ (&R)[NB][9], SQ (&p)[NB][3], S (&qdd)[NQ]) {
  static_assert(!EXT || (std::is_same<SQ, S>::value && std::is_same<SV, S>::value),
                "the work arrays in shared memory hold one scalar type");
  using L = StepLayout<NB, NQ, NA>;
  using W = DynWork<S, NB, NQ>;
  const T dt = P[L::kDt];

  // generalized force: action on the actuated dofs, implicit spring, damping
  S tau_l[NQ];
  S(&tau)[NQ] = work_array<EXT>(wk, &W::tau, tau_l);
NPTT_UNROLL(UR, NQ)
  for (int d = 0; d < NQ; ++d) tau[d] = S(T(0));
NPTT_UNROLL(UR, NA)
  for (int a = 0; a < NA; ++a) {
    const int da = I[L::iActDof + a];
NPTT_UNROLL(UR, NQ)
    for (int d = 0; d < NQ; ++d)
      if (d == da) tau[d] = u[a];
  }
NPTT_UNROLL(UR, NQ)
  for (int d = 0; d < NQ; ++d) {
    const T damp = P[L::kDof + 3 * d], stiff = P[L::kDof + 3 * d + 1], rest = P[L::kDof + 3 * d + 2];
    tau[d] = tau[d] + (-stiff) * (q[d] - rest + v[d] * dt) + (-damp) * v[d];
  }

  // forward sweep: kinematics, velocities, bias forces
  SV V_l[NB][6], c_l[NB][6];
  S pA_l[NB][6];
  SQ IA_l[NB][36];
  SV(&V)[NB][6] = work_array<EXT>(wk, &W::V, V_l);
  SV(&c)[NB][6] = work_array<EXT>(wk, &W::c, c_l);
  S(&pA)[NB][6] = work_array<EXT>(wk, &W::pA, pA_l);
  SQ(&IA)[NB][36] = work_array<EXT>(wk, &W::IA, IA_l);
NPTT_UNROLL(UR, NB)
  for (int i = 0; i < NB; ++i) {
    const T* Bp = P + i * L::kBody;
    const int jt = I[L::iType + i], dof = I[L::iDof + i], par = I[L::iParent + i];
    const int nd = joint_ndof(jt);
    SQ qi = SQ(T(0)), qj = SQ(T(0));
    SV vi = SV(T(0)), vj = SV(T(0));
NPTT_UNROLL(UR, NQ)
    for (int d = 0; d < NQ; ++d) {
      if (d == dof) {
        qi = q[d];
        vi = v[d];
      }
      if (nd == 2 && d == dof + 1) {
        qj = q[d];
        vj = v[d];
      }
    }
    SQ Rq[9], pq[3];
    for (int k = 0; k < 9; ++k) Rq[k] = SQ(T((k % 4) == 0 ? 1 : 0));
    for (int k = 0; k < 3; ++k) pq[k] = SQ(T(0));
    if (jt == kRevolute) {
      SQ w[3] = {Bp[L::kAxis] * qi, Bp[L::kAxis + 1] * qi, Bp[L::kAxis + 2] * qi};
      expm_so3<T, UR>(w, Rq);
    } else if (jt == kPrismatic) {
      for (int k = 0; k < 3; ++k) pq[k] = Bp[L::kAxis + k] * qi;
    } else if (jt == kTranslational2d) {
      for (int k = 0; k < 3; ++k) pq[k] = Bp[L::kAxis + k] * qi + Bp[L::kAxis1 + k] * qj;
    }
    // T_pc = T_pj o Q(q) o T_cj^-1
    SQ RA[9], pAq[3], tmp[3];
    mm3<UR>(Bp + L::kRpj, Rq, RA);
    mv3<UR>(Bp + L::kRpj, pq, tmp);
    for (int k = 0; k < 3; ++k) pAq[k] = tmp[k] + Bp[L::kPpj + k];
    mm3<UR>(RA, Bp + L::kRci, R[i]);
    mv3<UR>(RA, Bp + L::kPci, tmp);
    for (int k = 0; k < 3; ++k) p[i][k] = tmp[k] + pAq[k];

    SV vJ[6], Vpar[6];
    for (int k = 0; k < 6; ++k) {
      vJ[k] = Bp[L::kS + k] * vi;
      if (nd == 2) vJ[k] = vJ[k] + Bp[L::kS1 + k] * vj;
      Vpar[k] = SV(T(0));
    }
    // pp < NB, not pp < i: see StepLayout::kUnroll
NPTT_UNROLL(UR, NB)
    for (int pp = 0; pp < NB; ++pp)
      if (pp < i && pp == par) ad_inv_apply<UR>(R[i], p[i], V[pp], Vpar);
    for (int k = 0; k < 6; ++k) V[i][k] = Vpar[k] + vJ[k];
    ad_motion(V[i], vJ, c[i]);
    SV IV[6];
    mv6<UR>(Bp + L::kI, V[i], IV);
    ad_dual(V[i], IV, pA[i]);
    for (int k = 0; k < 36; ++k) IA[i][k] = SQ(Bp[L::kI + k]);
  }

  // backward sweep: articulated inertias and bias forces
  SQ U_l[NB][2][6], Dinv_l[NB][2][2];
  S uu_l[NB][2];
  SQ(&U)[NB][2][6] = work_array<EXT>(wk, &W::U, U_l);
  SQ(&Dinv)[NB][2][2] = work_array<EXT>(wk, &W::Dinv, Dinv_l);
  S(&uu)[NB][2] = work_array<EXT>(wk, &W::uu, uu_l);
NPTT_UNROLL(UR, NB)
  for (int i = NB - 1; i >= 0; --i) {
    const T* Sv = P + i * L::kBody + L::kS;
    const T* Sv1 = P + i * L::kBody + L::kS1;
    const int dof = I[L::iDof + i], par = I[L::iParent + i];
    const int nd = joint_ndof(I[L::iType + i]);
    SQ Ia[36];
    SV Iac[6];
    S pa[6];
    if (nd == 1) {
      mv6<UR>(IA[i], Sv, U[i][0]);
      SQ D = Sv[0] * U[i][0][0];
      S sp = Sv[0] * pA[i][0];
      for (int k = 1; k < 6; ++k) {
        D = D + Sv[k] * U[i][0][k];
        sp = sp + Sv[k] * pA[i][k];
      }
      Dinv[i][0][0] = T(1) / D;
      S te = S(T(0));
NPTT_UNROLL(UR, NQ)
      for (int d = 0; d < NQ; ++d)
        if (d == dof) te = tau[d];
      uu[i][0] = te - sp;
      for (int r = 0; r < 6; ++r)
        for (int k = 0; k < 6; ++k)
          Ia[6 * r + k] = IA[i][6 * r + k] - (U[i][0][r] * Dinv[i][0][0]) * U[i][0][k];
      mv6<UR>(Ia, c[i], Iac);
      S Du = Dinv[i][0][0] * uu[i][0];
      for (int k = 0; k < 6; ++k) pa[k] = pA[i][k] + Iac[k] + U[i][0][k] * Du;
    } else if (nd == 2) {
      // D = S^T IA S (2x2), u = tau - S^T pA, Ia = IA - U D^-1 U^T,
      // pa = pA + Ia c + U D^-1 u
      mv6<UR>(IA[i], Sv, U[i][0]);
      mv6<UR>(IA[i], Sv1, U[i][1]);
      SQ D[2][2];
      S sp[2], te[2] = {S(T(0)), S(T(0))};
NPTT_UNROLL(UR, 2)
      for (int a = 0; a < 2; ++a) {
        const T* Sa = a == 0 ? Sv : Sv1;
NPTT_UNROLL(UR, 2)
        for (int b = 0; b < 2; ++b) {
          D[a][b] = Sa[0] * U[i][b][0];
          for (int k = 1; k < 6; ++k) D[a][b] = D[a][b] + Sa[k] * U[i][b][k];
        }
        sp[a] = Sa[0] * pA[i][0];
        for (int k = 1; k < 6; ++k) sp[a] = sp[a] + Sa[k] * pA[i][k];
      }
      inv_spd<T, UR>(D, Dinv[i]);
NPTT_UNROLL(UR, NQ)
      for (int d = 0; d < NQ; ++d) {
        if (d == dof) te[0] = tau[d];
        if (d == dof + 1) te[1] = tau[d];
      }
      uu[i][0] = te[0] - sp[0];
      uu[i][1] = te[1] - sp[1];
      SQ UD[6][2];
      for (int r = 0; r < 6; ++r)
        for (int b = 0; b < 2; ++b) UD[r][b] = U[i][0][r] * Dinv[i][0][b] + U[i][1][r] * Dinv[i][1][b];
      for (int r = 0; r < 6; ++r)
        for (int k = 0; k < 6; ++k)
          Ia[6 * r + k] = IA[i][6 * r + k] - (UD[r][0] * U[i][0][k] + UD[r][1] * U[i][1][k]);
      mv6<UR>(Ia, c[i], Iac);
      S Du[2];
      for (int a = 0; a < 2; ++a) Du[a] = Dinv[i][a][0] * uu[i][0] + Dinv[i][a][1] * uu[i][1];
      for (int k = 0; k < 6; ++k) pa[k] = pA[i][k] + Iac[k] + (U[i][0][k] * Du[0] + U[i][1][k] * Du[1]);
    } else {
      U[i][0][0] = SQ(T(0));
      Dinv[i][0][0] = SQ(T(0));
      uu[i][0] = S(T(0));
      for (int k = 0; k < 36; ++k) Ia[k] = IA[i][k];
      mv6<UR>(Ia, c[i], Iac);
      for (int k = 0; k < 6; ++k) pa[k] = pA[i][k] + Iac[k];
    }
    // pp < NB, not pp < i: see StepLayout::kUnroll
NPTT_UNROLL(UR, NB)
    for (int pp = 0; pp < NB; ++pp) {
      if (pp >= i || pp != par) continue;
      // IA[pp] += X^T Ia X, X = Ad(T_pc^-1), one column of X at a time
      for (int j = 0; j < 6; ++j) {
        SQ e[6], x[6], y[6], col[6];
        for (int k = 0; k < 6; ++k) e[k] = SQ(T(k == j ? 1 : 0));
        ad_inv_apply<UR>(R[i], p[i], e, x);
        mv6<UR>(Ia, x, y);
        ad_dual_apply<UR>(R[i], p[i], y, col);
        for (int r = 0; r < 6; ++r) IA[pp][6 * r + j] = IA[pp][6 * r + j] + col[r];
      }
      S f[6];
      ad_dual_apply<UR>(R[i], p[i], pa, f);
      for (int k = 0; k < 6; ++k) pA[pp][k] = pA[pp][k] + f[k];
    }
  }

  // forward sweep: accelerations
  const T g[6] = {T(0), T(0), T(0), -P[L::kGrav], -P[L::kGrav + 1], -P[L::kGrav + 2]};
  S a_l[NB][6];
  S(&a)[NB][6] = work_array<EXT>(wk, &W::a, a_l);
NPTT_UNROLL(UR, NQ)
  for (int d = 0; d < NQ; ++d) qdd[d] = S(T(0));
NPTT_UNROLL(UR, NB)
  for (int i = 0; i < NB; ++i) {
    const T* Sv = P + i * L::kBody + L::kS;
    const T* Sv1 = P + i * L::kBody + L::kS1;
    const int dof = I[L::iDof + i], par = I[L::iParent + i];
    const int nd = joint_ndof(I[L::iType + i]);
    S ap[6];
    for (int k = 0; k < 6; ++k) ap[k] = S(T(0));
    if (par < 0) ad_inv_apply<UR>(R[i], p[i], g, ap);
    // pp < NB, not pp < i: see StepLayout::kUnroll
NPTT_UNROLL(UR, NB)
    for (int pp = 0; pp < NB; ++pp)
      if (pp < i && pp == par) ad_inv_apply<UR>(R[i], p[i], a[pp], ap);
    for (int k = 0; k < 6; ++k) ap[k] = ap[k] + c[i][k];
    if (nd == 1) {
      S Ua = U[i][0][0] * ap[0];
      for (int k = 1; k < 6; ++k) Ua = Ua + U[i][0][k] * ap[k];
      S qi = Dinv[i][0][0] * (uu[i][0] - Ua);
NPTT_UNROLL(UR, NQ)
      for (int d = 0; d < NQ; ++d)
        if (d == dof) qdd[d] = qi;
      for (int k = 0; k < 6; ++k) a[i][k] = ap[k] + Sv[k] * qi;
    } else if (nd == 2) {
      S r[2];
      for (int b = 0; b < 2; ++b) {
        S Ua = U[i][b][0] * ap[0];
        for (int k = 1; k < 6; ++k) Ua = Ua + U[i][b][k] * ap[k];
        r[b] = uu[i][b] - Ua;
      }
      S q0 = Dinv[i][0][0] * r[0] + Dinv[i][0][1] * r[1];
      S q1 = Dinv[i][1][0] * r[0] + Dinv[i][1][1] * r[1];
NPTT_UNROLL(UR, NQ)
      for (int d = 0; d < NQ; ++d) {
        if (d == dof) qdd[d] = q0;
        if (d == dof + 1) qdd[d] = q1;
      }
      for (int k = 0; k < 6; ++k) a[i][k] = ap[k] + (Sv[k] * q0 + Sv1[k] * q1);
    } else {
      for (int k = 0; k < 6; ++k) a[i][k] = ap[k];
    }
  }
}

// with the work arrays in w (a lane group's shared memory)
template <typename T, typename S, int NB, int NQ, int NA,
          bool UR = StepLayout<NB, NQ, NA>::kUnroll>
NPTT_HD void forward_dynamics(DynWork<S, NB, NQ>& w, const T* __restrict__ P,
                              const int* __restrict__ I, const S* q, const S* v, const S* u,
                              S (&R)[NB][9], S (&p)[NB][3], S (&qdd)[NQ]) {
  forward_dynamics_impl<T, S, S, S, NB, NQ, NA, UR, true>(&w, P, I, q, v, u, R, p, qdd);
}

// with local work arrays (the one-thread step)
template <typename T, typename S, int NB, int NQ, int NA,
          bool UR = StepLayout<NB, NQ, NA>::kUnroll>
NPTT_HD void forward_dynamics(const T* __restrict__ P, const int* __restrict__ I,
                              const S* q, const S* v, const S* u, S (&R)[NB][9],
                              S (&p)[NB][3], S (&qdd)[NQ]) {
  forward_dynamics_impl<T, S, S, S, NB, NQ, NA, UR, false>(nullptr, P, I, q, v, u, R, p, qdd);
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
NPTT_UNROLL(L::kUnroll, NQ)
  for (int d = 0; d < NQ; ++d) {
    vn[d] = v[d] + dt * qdd[d];
    qn[d] = q[d] + v[d] * dt;
  }
}

// ---------------------------------------------------------------------------
// Constraint rows (contact slots, joint limits and Coulomb joint friction)
// and the two constrained steps built on them:
//
//   frozen_step: the smooth step on frozen LCP classes (ops/frozen_contact.py
//     frozen_contact_step with the planner assembly): every row gated on,
//     impulses from solve_frozen (regularised normal equations by Jacobi-
//     preconditioned CG). K2 with classes runs it on T; on Dual<T>
//     solve_frozen takes the implicit tangent of the linear solve (the
//     host build of tests/test_torch_device_step.py counts it for the
//     plain count of K4's bound); K4 and K5 (linearize.cu) run its inputs
//     on T and Dual<T> and take the solve's tangent or transpose
//     themselves.
//   class_step: the full step of the class rollout (ops/frozen_contact.py
//     step_with_classes_for_trace): rows gated by the limits, impulses from
//     direct_boxed_solve_lane, then the class of each row. K6 runs it, for
//     models without contact slots only.
//
// The LCP has M rows: first 3 NS contact rows (per slot its normal row and
// two friction rows, the friction rows coupled to the normal: findex 3k),
// then MR = M - 3 NS limit and Coulomb rows in the order of ops/contact.py
// (lower limit rows, upper limit rows, Coulomb rows). The packed model
// gains, after the step's buffers (ops/device_step.py):
//   reals: per limit/Coulomb row, its limit position or its impulse bound
//     mu dt; then per slot (kSlotReals = 8): the contact point in its body's
//     frame (3), the world normal of the static halfspace (3), the plane
//     offset (1), the friction coefficient (1);
//   ints: per limit/Coulomb row its dof, then per such row its kind
//     (RowKind); then per slot its body.
// The planner assembly gates every contact row on and drops the bounce, so
// the frozen step reads neither the depth nor the restitution. Friction
// coupling enters the frozen solve through R = (I + diag(us) gov) diag(cm).
//
// The loops over the rows and the slots, and the loops that hold them,
// unroll by row_unroll(M, trips): fully for small LCPs (the limited
// cartpole's 4 rows), whose arrays then live in registers; not at all for
// larger ones (the worm's 28 rows), where unrolled they made the build take
// 330-465 s (60-100 s rolled) and the M-sized arrays live in local memory
// either way, except the dot products over the rows (j = 1 .. M - 1),
// which unroll by 8 there (K2 at m = 28 3.0x, K4 2.5x, K5 1.4x faster than
// with them rolled, scripts/torch_unroll_variants.py). The PCG's iterations are
// always rolled. A build that rolled only the outer row loops gave a K5
// returning NaN on the card; with every row loop rolled or partly unrolled
// every kernel agrees with its plain version (PERF.md section 6, ROADMAP
// queue C).
NPTT_HD constexpr int row_unroll(int m, int trips, int rolled = 1) {
  return m <= 8 ? unroll_by(true, trips) : rolled;
}

// Where the rows stay rolled (more than 8 of them, the worm's 28), K2, K4
// and K5 run the frozen solve on a lane group (frozen_group.cuh) instead
// of one thread; each kernel's layout at other row counts is chosen in
// frozen_group.cuh (k2_lanes, k4_lanes).
NPTT_HD constexpr bool group_layout(int m) { return m > 8; }

// The (bodies, dofs, actions, rows, slots) shapes the constrained kernels
// are built for; the Python wrappers refuse any other model. cartpole with
// its two limited dofs: 2 bodies, 2 dofs, 1 action, 4 rows, no slot (K2
// with classes, K4, K6); the jump worm: 3 bodies, 4 dofs, 2 actions, 8
// box-corner slots and two limited dofs, 28 rows (K2 with classes, K4 and
// K5; class_step is not built for contact slots).
#define NPTT_CONTACT_SHAPES(X) X(2, 2, 1, 4, 0)
#define NPTT_WORM_SHAPES(X) X(3, 4, 2, 28, 8)

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

template <int NB, int NQ, int NA, int M, int NS>
struct RowLayout {
  using L = StepLayout<NB, NQ, NA>;
  static constexpr int MR = M - 3 * NS, kSlotReals = 8;
  static constexpr int kRow = L::kSize, kSlot = kRow + MR;
  static constexpr int iRowDof = L::kInts, iRowKind = L::kInts + MR, iSlotBody = L::kInts + 2 * MR;
};

// A[r][c] = v for run-time (r, c), by selects (no local memory where the
// loops unroll, U = StepLayout::kUnroll)
template <bool U, typename S, int N>
NPTT_HD void set_at(S (&A)[N][N], int r, int c, S v) {
NPTT_UNROLL(U, N)
  for (int a = 0; a < N; ++a)
NPTT_UNROLL(U, N)
    for (int b = 0; b < N; ++b)
      if (a == r && b == c) A[a][b] = v;
}

// Composite-rigid-body mass matrix M(q) (ops/dynamics.py mass_matrix) from
// the transforms forward_dynamics left in (R, p).
template <typename T, typename S, int NB, int NQ, int NA, bool UR, bool EXT>
NPTT_HD void mass_matrix_impl(DynWork<S, NB, NQ>* wk, const T* __restrict__ P,
                              const int* __restrict__ I, const S (&R)[NB][9],
                              const S (&p)[NB][3], S (&Mm)[NQ][NQ]) {
  using L = StepLayout<NB, NQ, NA>;
  S Ic_l[NB][36];
  S(&Ic)[NB][36] = work_array<EXT>(wk, &DynWork<S, NB, NQ>::Ic, Ic_l);
NPTT_UNROLL(UR, NB)
  for (int i = 0; i < NB; ++i)
    for (int k = 0; k < 36; ++k) Ic[i][k] = S(P[i * L::kBody + L::kI + k]);
  // composite inertias: Ic[parent] += X^T Ic X, X = Ad(T_pc^-1), by columns
NPTT_UNROLL(UR, NB)
  for (int i = NB - 1; i >= 0; --i) {
    const int par = I[L::iParent + i];
    // pp < NB, not pp < i: see StepLayout::kUnroll
NPTT_UNROLL(UR, NB)
    for (int pp = 0; pp < NB; ++pp) {
      if (pp >= i || pp != par) continue;
      for (int j = 0; j < 6; ++j) {
        S e[6], x[6], y[6], col[6];
        for (int k = 0; k < 6; ++k) e[k] = S(T(k == j ? 1 : 0));
        ad_inv_apply<UR>(R[i], p[i], e, x);
        mv6<UR>(Ic[i], x, y);
        ad_dual_apply<UR>(R[i], p[i], y, col);
        for (int r = 0; r < 6; ++r) Ic[pp][6 * r + j] = Ic[pp][6 * r + j] + col[r];
      }
    }
  }
NPTT_UNROLL(UR, NQ)
  for (int a = 0; a < NQ; ++a)
NPTT_UNROLL(UR, NQ)
    for (int c = 0; c < NQ; ++c) Mm[a][c] = S(T(0));
NPTT_UNROLL(UR, NB)
  for (int i = 0; i < NB; ++i) {
    const int dof = I[L::iDof + i];
    if (dof < 0) continue;
    const int nd = joint_ndof(I[L::iType + i]);
NPTT_UNROLL(UR, 2)
    for (int ci = 0; ci < 2; ++ci) {
      if (ci >= nd) continue;
      const T* Sv = P + i * L::kBody + (ci == 0 ? L::kS : L::kS1);
      S F[6];
      mv6<UR>(Ic[i], Sv, F);
      // the diagonal block, column dof + ci
NPTT_UNROLL(UR, 2)
      for (int cr = 0; cr < 2; ++cr) {
        if (cr >= nd) continue;
        const T* Sr = P + i * L::kBody + (cr == 0 ? L::kS : L::kS1);
        S Mii = Sr[0] * F[0];
        for (int k = 1; k < 6; ++k) Mii = Mii + Sr[k] * F[k];
        set_at<UR>(Mm, dof + cr, dof + ci, Mii);
      }
      // carry F = Ic S up the chain of ancestors (parents[j] < j)
      int cur = i;
      // from NB - 1, not from i (jj > i never equals cur): see StepLayout::kUnroll
NPTT_UNROLL(UR, NB - 1)
      for (int jj = NB - 1; jj >= 1; --jj) {
        if (jj != cur) continue;
        const int par = I[L::iParent + jj];
        if (par < 0) {
          cur = -1;
          continue;
        }
        S G[6];
        ad_dual_apply<UR>(R[jj], p[jj], F, G);
        for (int k = 0; k < 6; ++k) F[k] = G[k];
        cur = par;
        const int dp = I[L::iDof + par];
        const int ndp = joint_ndof(I[L::iType + par]);
        for (int cp = 0; cp < ndp; ++cp) {
          const T* Sp = P + par * L::kBody + (cp == 0 ? L::kS : L::kS1);
          S mij = Sp[0] * F[0];
          for (int k = 1; k < 6; ++k) mij = mij + Sp[k] * F[k];
          set_at<UR>(Mm, dp + cp, dof + ci, mij);
          set_at<UR>(Mm, dof + ci, dp + cp, mij);
        }
      }
    }
  }
}

template <typename T, typename S, int NB, int NQ, int NA,
          bool UR = StepLayout<NB, NQ, NA>::kUnroll>
NPTT_HD void mass_matrix(DynWork<S, NB, NQ>& w, const T* __restrict__ P,
                         const int* __restrict__ I, const S (&R)[NB][9], const S (&p)[NB][3],
                         S (&Mm)[NQ][NQ]) {
  mass_matrix_impl<T, S, NB, NQ, NA, UR, true>(&w, P, I, R, p, Mm);
}

template <typename T, typename S, int NB, int NQ, int NA,
          bool UR = StepLayout<NB, NQ, NA>::kUnroll>
NPTT_HD void mass_matrix(const T* __restrict__ P, const int* __restrict__ I,
                         const S (&R)[NB][9], const S (&p)[NB][3], S (&Mm)[NQ][NQ]) {
  mass_matrix_impl<T, S, NB, NQ, NA, UR, false>(nullptr, P, I, R, p, Mm);
}

// Each body's transform to the world (Rw, pw) from the parent-relative
// transforms (R, p) of forward_dynamics.
template <typename T, typename S, int NB, int NQ, int NA,
          bool UR = StepLayout<NB, NQ, NA>::kUnroll>
NPTT_HD void world_frames(const int* __restrict__ I, const S (&R)[NB][9], const S (&p)[NB][3],
                          S (&Rw)[NB][9], S (&pw)[NB][3]) {
  using L = StepLayout<NB, NQ, NA>;
NPTT_UNROLL(UR, NB)
  for (int i = 0; i < NB; ++i) {
    const int par = I[L::iParent + i];
    if (par < 0) {
      for (int k = 0; k < 9; ++k) Rw[i][k] = R[i][k];
      for (int k = 0; k < 3; ++k) pw[i][k] = p[i][k];
    }
    // pp < NB, not pp < i: see StepLayout::kUnroll
NPTT_UNROLL(UR, NB)
    for (int pp = 0; pp < NB; ++pp) {
      if (pp >= i || pp != par) continue;
      S tmp[3];
      mm3<UR>(Rw[pp], R[i], Rw[i]);
      mv3<UR>(Rw[pp], p[i], tmp);
      for (int k = 0; k < 3; ++k) pw[i][k] = tmp[k] + pw[pp][k];
    }
  }
}

// Slot s's point Jacobian Jp (3 x NQ): its world point p = R_wa p_local +
// p_wa on its body a, and Jp = v + omega x p over the world Jacobian
// columns Ad(T_wk) S_k of a's ancestors k (ops/dynamics.py world_jacobian).
template <typename T, typename S, int NB, int NQ, int NA, int M, int NS,
          bool UR = StepLayout<NB, NQ, NA>::kUnroll>
NPTT_HD void slot_jacobian(const T* __restrict__ P, const int* __restrict__ I,
                           const S (&Rw)[NB][9], const S (&pw)[NB][3], int s, S (&Jp)[3][NQ]) {
  using L = StepLayout<NB, NQ, NA>;
  using RL = RowLayout<NB, NQ, NA, M, NS>;
  const T* sd = P + RL::kSlot + RL::kSlotReals * s;
  const int ab = I[RL::iSlotBody + s];
  S pk[3];
  bool anc[NB];
NPTT_UNROLL(UR, NB)
  for (int i = 0; i < NB; ++i) {
    anc[i] = false;
    if (i == ab) {
      S tmp[3];
      mv3<UR>(Rw[i], sd, tmp);
      for (int k = 0; k < 3; ++k) pk[k] = tmp[k] + pw[i][k];
    }
  }
  int cur = ab;
NPTT_UNROLL(UR, NB)
  for (int jj = NB - 1; jj >= 0; --jj)
    if (jj == cur) {
      anc[jj] = true;
      cur = I[L::iParent + jj];
    }
  for (int r = 0; r < 3; ++r)
NPTT_UNROLL(UR, NQ)
    for (int e = 0; e < NQ; ++e) Jp[r][e] = S(T(0));
NPTT_UNROLL(UR, NB)
  for (int kb = 0; kb < NB; ++kb) {
    if (!anc[kb]) continue;
    const int dof = I[L::iDof + kb], nd = joint_ndof(I[L::iType + kb]);
    for (int cc = 0; cc < nd; ++cc) {
      const T* Sc = P + kb * L::kBody + (cc == 0 ? L::kS : L::kS1);
      // Ad(T_wk) S = (R w; p x (R w) + R v), then v + omega x p
      S w[3], Rv[3], pxw[3], wxp[3];
      mv3<UR>(Rw[kb], Sc, w);
      mv3<UR>(Rw[kb], Sc + 3, Rv);
      cross3(pw[kb], w, pxw);
      cross3(w, pk, wxp);
NPTT_UNROLL(UR, NQ)
      for (int e = 0; e < NQ; ++e)
        if (e == dof + cc)
          for (int r = 0; r < 3; ++r) Jp[r][e] = (pxw[r] + Rv[r]) + wxp[r];
    }
  }
}

// Direction d of slot s's rows: its halfspace's constant normal n (d = 0)
// or a vector of _tangent_basis(n) (d = 1, 2).
template <typename T, int NB, int NQ, int NA, int M, int NS>
NPTT_HD void slot_direction(const T* __restrict__ P, int s, int d, T (&dir)[3]) {
  using RL = RowLayout<NB, NQ, NA, M, NS>;
  const T* sd = P + RL::kSlot + RL::kSlotReals * s;
  const T n[3] = {sd[3], sd[4], sd[5]};
  const T ez[3] = {T(0), T(0), T(1)}, ex[3] = {T(1), T(0), T(0)};
  T tz[3], tx[3], t1[3], t2[3];
  cross3(ez, n, tz);
  cross3(ex, n, tx);
  const bool use_z = tz[0] * tz[0] + tz[1] * tz[1] + tz[2] * tz[2] > T(1e-12);
  for (int k = 0; k < 3; ++k) t1[k] = use_z ? tz[k] : tx[k];
  T nt = t1[0] * t1[0] + t1[1] * t1[1] + t1[2] * t1[2];
  nt = nsqrt(nt > T(1e-18) ? nt : T(1e-18));
  for (int k = 0; k < 3; ++k) t1[k] = t1[k] / nt;
  cross3(n, t1, t2);
  for (int k = 0; k < 3; ++k) dir[k] = d == 0 ? n[k] : (d == 1 ? t1[k] : t2[k]);
}

// One contact row dir^T Jp (NQ) of a slot.
template <bool U, typename T, typename S, int NQ>
NPTT_HD void slot_row(const T (&dir)[3], const S (&Jp)[3][NQ], S* row) {
NPTT_UNROLL(U, NQ)
  for (int e = 0; e < NQ; ++e) row[e] = (dir[0] * Jp[0][e] + dir[1] * Jp[1][e]) + dir[2] * Jp[2][e];
}

// The contact rows of the planner assembly (ops/contact.py _contact_rows
// with planner=True): per slot k its point Jacobian (slot_jacobian) and the
// rows n^T Jp, t1^T Jp, t2^T Jp with (t1, t2) = _tangent_basis(n);
// b = -J v*. The halfspace is static, so n and the basis are constants.
template <typename T, typename S, int NB, int NQ, int NA, int M, int NS>
NPTT_HD void contact_rows(const T* __restrict__ P, const int* __restrict__ I,
                          const S (&R)[NB][9], const S (&p)[NB][3], const S* vs,
                          S (&Jc)[3 * NS][NQ], S (&b)[M], T (&lo)[M], T (&hi)[M]) {
  using L = StepLayout<NB, NQ, NA>;
  S Rw[NB][9], pw[NB][3];
  world_frames<T, S, NB, NQ, NA>(I, R, p, Rw, pw);
#pragma unroll (row_unroll(M, NS))
  for (int s = 0; s < NS; ++s) {
    S Jp[3][NQ];
    slot_jacobian<T, S, NB, NQ, NA, M, NS>(P, I, Rw, pw, s, Jp);
NPTT_UNROLL(L::kUnroll, 3)
    for (int d = 0; d < 3; ++d) {
      const int row = 3 * s + d;
      T dir[3];
      slot_direction<T, NB, NQ, NA, M, NS>(P, s, d, dir);
      slot_row<L::kUnroll>(dir, Jp, Jc[row]);
      S rel = Jc[row][0] * vs[0];
NPTT_UNROLL(L::kUnroll, NQ - 1)
      for (int e = 1; e < NQ; ++e) rel = rel + Jc[row][e] * vs[e];
      b[row] = -rel;
      lo[row] = T(0);
      hi[row] = d == 0 ? T(kBig) : T(0);
    }
  }
}

// The boxed LCP of the rows (ops/contact.py build_constraint_system): the
// contact rows Jc of contact_rows, then the limit/Coulomb rows J_r = s_r
// a_r e_{d_r} (s = -1 on upper limit rows, a the row's activation: 1 in the
// planner form, q <= lower / q >= upper otherwise). MJ = M^-1 J^T and A =
// J MJ + CFM I: the contact columns and rows by their dense products, the
// limit/Coulomb ones from their one nonzero term (the dense products add
// exact zeros to it). Contact slots exist in the planner form only.
template <typename T, typename S, int NB, int NQ, int NA, int M, int NS, bool PLANNER>
NPTT_HD void constraint_rows(const T* __restrict__ P, const int* __restrict__ I, const S* q,
                             const S* vs, const S (&R)[NB][9], const S (&p)[NB][3],
                             const S (&Mi)[NQ][NQ], S (&A)[M][M], S (&b)[M], T (&lo)[M],
                             T (&hi)[M], S (&MJ)[NQ][M]) {
  static_assert(PLANNER || NS == 0, "contact slots are built in the planner form only");
  using L = StepLayout<NB, NQ, NA>;
  using RL = RowLayout<NB, NQ, NA, M, NS>;
  constexpr int C0 = 3 * NS;
  T coef[M];
  int dofs[M];
  S Jc[C0 > 0 ? C0 : 1][NQ];
  if constexpr (NS > 0) contact_rows<T, S, NB, NQ, NA, M, NS>(P, I, R, p, vs, Jc, b, lo, hi);
#pragma unroll (row_unroll(M, M - C0))
  for (int r = C0; r < M; ++r) {
    const int d = I[RL::iRowDof + r - C0], kind = I[RL::iRowKind + r - C0];
    const T lim = P[RL::kRow + r - C0];
    dofs[r] = d;
    S qd = S(T(0)), vd = S(T(0));
NPTT_UNROLL(L::kUnroll, NQ)
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
#pragma unroll (row_unroll(M, NQ))
  for (int k = 0; k < NQ; ++k)
#pragma unroll (row_unroll(M, M))
    for (int c = 0; c < M; ++c) {
      if (c < C0) {
        S mk = Mi[k][0] * Jc[c][0];
NPTT_UNROLL(L::kUnroll, NQ - 1)
        for (int e = 1; e < NQ; ++e) mk = mk + Mi[k][e] * Jc[c][e];
        MJ[k][c] = mk;
      } else {
        S mk = S(T(0));
NPTT_UNROLL(L::kUnroll, NQ)
        for (int e = 0; e < NQ; ++e)
          if (e == dofs[c]) mk = Mi[k][e];
        MJ[k][c] = mk * coef[c];
      }
    }
#pragma unroll (row_unroll(M, M))
  for (int r = 0; r < M; ++r)
#pragma unroll (row_unroll(M, M))
    for (int c = 0; c < M; ++c) {
      if (r < C0) {
        S ar = Jc[r][0] * MJ[0][c];
NPTT_UNROLL(L::kUnroll, NQ - 1)
        for (int e = 1; e < NQ; ++e) ar = ar + Jc[r][e] * MJ[e][c];
        A[r][c] = ar;
      } else {
        S jr = S(T(0));
NPTT_UNROLL(L::kUnroll, NQ)
        for (int e = 0; e < NQ; ++e)
          if (e == dofs[r]) jr = MJ[e][c];
        A[r][c] = coef[r] * jr;
      }
      if (r == c) A[r][c] = A[r][c] + T(kCfm);
    }
}

// Qf = C A R + (I - C), C = diag(cmask), R = (I + diag(us) gov) C: column
// j of A R is (A[:, j] + sum over the rows l coupled to j of us_l A[:, l])
// cm_j. With NS slots, rows 3k + 1 and 3k + 2 are coupled to 3k; the other
// rows to none (gov = 0 there, and A R = A C).
template <typename T, typename S, int M, int NS>
NPTT_HD void frozen_system(const S (&A)[M][M], const T* cm, const T* us, S (&Qf)[M][M]) {
#pragma unroll (row_unroll(M, M))
  for (int i = 0; i < M; ++i)
#pragma unroll (row_unroll(M, M))
    for (int j = 0; j < M; ++j) {
      S ar = A[i][j];
      if (j < 3 * NS && j % 3 == 0) ar = (ar + us[j + 1] * A[i][j + 1]) + us[j + 2] * A[i][j + 2];
      Qf[i][j] = (cm[i] * (ar * cm[j])) * cm[j];
      if (i == j) Qf[i][j] = Qf[i][j] + (T(1) - cm[i]);
    }
}

// x = R (cm * xc): x_i = cm_i cm_i xc_i, plus us_i cm_f cm_f xc_f on a
// friction row i coupled to f.
template <typename T, typename S, int M, int NS>
NPTT_HD void frozen_impulses(const T* cm, const T* us, const S (&xc)[M], S (&x)[M]) {
#pragma unroll (row_unroll(M, M))
  for (int i = 0; i < M; ++i) {
    x[i] = cm[i] * (cm[i] * xc[i]);
    if (i < 3 * NS && i % 3 != 0) {
      const int f = i - i % 3;
      x[i] = x[i] + us[i] * (cm[f] * (cm[f] * xc[f]));
    }
  }
}

// Jacobi-preconditioned CG on (Qf^T Qf + reg I) x[s] = bb[s] from x = 0
// (ops/frozen_contact.py _pcg), n_cg iterations, for NR right-hand sides
// over the one Qf at once, each with its own alpha and beta (the NR chains
// interleave).
template <typename T, typename S, int M, int NR>
NPTT_HD void pcg_n(const S (&Qf)[M][M], S reg, const S (&diagM)[M], const S (&bb)[NR][M],
                   int n_cg, S (&x)[NR][M]) {
  const T tiny = T(1e-30);
  S r[NR][M], z[NR][M], p[NR][M], rz[NR];
NPTT_UNROLL(true, NR)
  for (int s = 0; s < NR; ++s) {
#pragma unroll (row_unroll(M, M))
    for (int i = 0; i < M; ++i) {
      x[s][i] = S(T(0));
      r[s][i] = bb[s][i];
      z[s][i] = qdiv(r[s][i], diagM[i]);
      p[s][i] = z[s][i];
    }
    rz[s] = r[s][0] * z[s][0];
#pragma unroll (row_unroll(M, M - 1, 8))
    for (int i = 1; i < M; ++i) rz[s] = rz[s] + r[s][i] * z[s][i];
  }
#pragma unroll 1
  for (int it = 0; it < n_cg; ++it) {
NPTT_UNROLL(true, NR)
    for (int s = 0; s < NR; ++s) {
      S Qp[M], Ap[M];
#pragma unroll (row_unroll(M, M))
      for (int i = 0; i < M; ++i) {
        Qp[i] = Qf[i][0] * p[s][0];
#pragma unroll (row_unroll(M, M - 1, 8))
        for (int j = 1; j < M; ++j) Qp[i] = Qp[i] + Qf[i][j] * p[s][j];
      }
#pragma unroll (row_unroll(M, M))
      for (int j = 0; j < M; ++j) {
        S acc = Qf[0][j] * Qp[0];
#pragma unroll (row_unroll(M, M - 1, 8))
        for (int i = 1; i < M; ++i) acc = acc + Qf[i][j] * Qp[i];
        Ap[j] = acc + reg * p[s][j];
      }
      S pAp = p[s][0] * Ap[0];
#pragma unroll (row_unroll(M, M - 1, 8))
      for (int i = 1; i < M; ++i) pAp = pAp + p[s][i] * Ap[i];
      const S alpha = qdiv(rz[s], pAp + tiny);
#pragma unroll (row_unroll(M, M))
      for (int i = 0; i < M; ++i) {
        x[s][i] = x[s][i] + alpha * p[s][i];
        r[s][i] = r[s][i] - alpha * Ap[i];
        z[s][i] = qdiv(r[s][i], diagM[i]);
      }
      S rz_new = r[s][0] * z[s][0];
#pragma unroll (row_unroll(M, M - 1, 8))
      for (int i = 1; i < M; ++i) rz_new = rz_new + r[s][i] * z[s][i];
      const S beta = qdiv(rz_new, rz[s] + tiny);
#pragma unroll (row_unroll(M, M))
      for (int i = 0; i < M; ++i) p[s][i] = z[s][i] + beta * p[s][i];
      rz[s] = rz_new;
    }
  }
}

// pcg_n on one right-hand side.
template <typename T, typename S, int M>
NPTT_HD void pcg(const S (&Qf)[M][M], S reg, const S (&diagM)[M], const S (&bb)[M], int n_cg,
                 S (&x)[M]) {
  S b1[1][M], x1[1][M];
#pragma unroll (row_unroll(M, M))
  for (int i = 0; i < M; ++i) b1[0][i] = bb[i];
  pcg_n<T>(Qf, reg, diagM, b1, n_cg, x1);
#pragma unroll (row_unroll(M, M))
  for (int i = 0; i < M; ++i) x[i] = x1[0][i];
}

// Impulses on frozen classes (ops/frozen_contact.py solve_frozen):
// x = R x_C, (Qf^T Qf + reg I) x_C = Qf^T (cmask b), reg = eps max(max|Qf|, 1)^2.
template <typename T, typename S, int M, int NS>
NPTT_HD void frozen_normal_eqs(const S (&A)[M][M], const S (&b)[M], const T* cm, const T* us,
                               S (&Qf)[M][M], S& reg, S (&diagM)[M], S (&bvec)[M]) {
  S rhs[M];
  frozen_system<T, S, M, NS>(A, cm, us, Qf);
#pragma unroll (row_unroll(M, M))
  for (int i = 0; i < M; ++i) rhs[i] = cm[i] * b[i];
  S qs = S(T(1));
#pragma unroll (row_unroll(M, M))
  for (int i = 0; i < M; ++i)
#pragma unroll (row_unroll(M, M))
    for (int j = 0; j < M; ++j) qs = pmax(qs, nabs(Qf[i][j]));
  reg = (Prec<T>::eps() * qs) * qs;
#pragma unroll (row_unroll(M, M))
  for (int j = 0; j < M; ++j) {
    S dg = Qf[0][j] * Qf[0][j], bv = Qf[0][j] * rhs[0];
#pragma unroll (row_unroll(M, M - 1, 8))
    for (int i = 1; i < M; ++i) {
      dg = dg + Qf[i][j] * Qf[i][j];
      bv = bv + Qf[i][j] * rhs[i];
    }
    diagM[j] = dg + reg;
    bvec[j] = bv;
  }
}

template <int NS, typename T, typename S, int M>
NPTT_HD void solve_frozen(const S (&A)[M][M], const S (&b)[M], const T* cm, const T* us, int n_cg,
                          S (&x)[M]) {
  S Qf[M][M], reg, diagM[M], bvec[M], xc[M];
  frozen_normal_eqs<T, S, M, NS>(A, b, cm, us, Qf, reg, diagM, bvec);
  pcg<T>(Qf, reg, diagM, bvec, n_cg, xc);
  frozen_impulses<T, S, M, NS>(cm, us, xc, x);
}

// The frozen normal equations on dual numbers, as lax.custom_linear_solve
// differentiates them: Qf, reg and bvec carry tangents, the Jacobi
// preconditioner diagM (the solver's, not the problem's) does not. max|Qf|
// takes jnp's tangent: the mean over tied entries, |.|' = +1 at 0, and half
// of it where max(., 1) ties. Qv holds Qf's values.
template <typename T, typename V, int M, int NS>
NPTT_HD void frozen_normal_eqs_dual(const Dual<V> (&A)[M][M], const Dual<V> (&b)[M], const T* cm,
                                    const T* us, Dual<V> (&Qf)[M][M], V (&Qv)[M][M],
                                    Dual<V>& reg, V (&diagM)[M], Dual<V> (&bvec)[M]) {
  Dual<V> rhs[M];
  frozen_system<T, Dual<V>, M, NS>(A, cm, us, Qf);
#pragma unroll (row_unroll(M, M))
  for (int i = 0; i < M; ++i) rhs[i] = cm[i] * b[i];
  T mx = nabs(val(Qf[0][0].v));
#pragma unroll (row_unroll(M, M))
  for (int i = 0; i < M; ++i)
#pragma unroll (row_unroll(M, M))
    for (int j = 0; j < M; ++j) mx = pmax(mx, nabs(val(Qf[i][j].v)));
  T cnt = T(0);
  V dsum = V(T(0));
#pragma unroll (row_unroll(M, M))
  for (int i = 0; i < M; ++i)
#pragma unroll (row_unroll(M, M))
    for (int j = 0; j < M; ++j) {
      const T w = nabs(val(Qf[i][j].v)) == mx ? T(1) : T(0);
      cnt = cnt + w;
      dsum = dsum + (w * (val(Qf[i][j].v) >= T(0) ? T(1) : T(-1))) * Qf[i][j].d;
    }
  const T share = mx > T(1) ? T(1) / cnt : (mx == T(1) ? T(0.5) / cnt : T(0));
  const Dual<V> qs(V(pmax(mx, T(1))), dsum * share);
  reg = (Prec<T>::eps() * qs) * qs;
#pragma unroll (row_unroll(M, M))
  for (int j = 0; j < M; ++j) {
    V dg = Qf[0][j].v * Qf[0][j].v;
    Dual<V> s = Qf[0][j] * rhs[0];
#pragma unroll (row_unroll(M, M - 1, 8))
    for (int i = 1; i < M; ++i) {
      dg = dg + Qf[i][j].v * Qf[i][j].v;
      s = s + Qf[i][j] * rhs[i];
    }
    diagM[j] = dg + reg.v;
    bvec[j] = s;
#pragma unroll (row_unroll(M, M))
    for (int i = 0; i < M; ++i) Qv[i][j] = Qf[i][j].v;
  }
}

// The right-hand side of the linear solve's tangent at its solution xc:
// dbvec - (dQf^T Qf xc + Qf^T dQf xc + dreg xc).
template <typename V, int M>
NPTT_HD void frozen_tangent_rhs(const Dual<V> (&Qf)[M][M], const Dual<V>& reg,
                                const Dual<V> (&bvec)[M], const V (&xc)[M], V (&rt)[M]) {
  V Qx[M], dQx[M];
#pragma unroll (row_unroll(M, M))
  for (int i = 0; i < M; ++i) {
    Qx[i] = Qf[i][0].v * xc[0];
    dQx[i] = Qf[i][0].d * xc[0];
#pragma unroll (row_unroll(M, M - 1, 8))
    for (int j = 1; j < M; ++j) {
      Qx[i] = Qx[i] + Qf[i][j].v * xc[j];
      dQx[i] = dQx[i] + Qf[i][j].d * xc[j];
    }
  }
#pragma unroll (row_unroll(M, M))
  for (int j = 0; j < M; ++j) {
    V s1 = Qf[0][j].d * Qx[0], s2 = Qf[0][j].v * dQx[0];
#pragma unroll (row_unroll(M, M - 1, 8))
    for (int i = 1; i < M; ++i) {
      s1 = s1 + Qf[i][j].d * Qx[i];
      s2 = s2 + Qf[i][j].v * dQx[i];
    }
    rt[j] = bvec[j].d - ((s1 + s2) + reg.d * xc[j]);
  }
}

// solve_frozen on dual numbers, with the tangent lax.custom_linear_solve
// gives the JAX package: the primal PCG on the values, then ONE tangent
// PCG with the same iteration count and the primal preconditioner,
//   dx_C = PCG(dbvec - (dQf^T Qf x_C + Qf^T dQf x_C + dreg x_C)).
// Pushing the tangent through the CG iterations would differentiate the
// truncated iteration instead.
template <int NS, typename T, typename V, int M>
NPTT_HD void solve_frozen(const Dual<V> (&A)[M][M], const Dual<V> (&b)[M], const T* cm,
                          const T* us, int n_cg, Dual<V> (&x)[M]) {
  Dual<V> Qf[M][M], reg, bvec[M], xd[M];
  V Qv[M][M], diagM[M], bv[M], xc[M], rt[M], dxc[M];
  frozen_normal_eqs_dual<T, V, M, NS>(A, b, cm, us, Qf, Qv, reg, diagM, bvec);
#pragma unroll (row_unroll(M, M))
  for (int j = 0; j < M; ++j) bv[j] = bvec[j].v;
  pcg<T>(Qv, reg.v, diagM, bv, n_cg, xc);
  frozen_tangent_rhs<V, M>(Qf, reg, bvec, xc, rt);
  pcg<T>(Qv, reg.v, diagM, rt, n_cg, dxc);
#pragma unroll (row_unroll(M, M))
  for (int i = 0; i < M; ++i) xd[i] = Dual<V>(xc[i], dxc[i]);
  frozen_impulses<T, Dual<V>, M, NS>(cm, us, xd, x);
}

// Complementarity violation of an in-box iterate, max over rows with an
// initial 0 (ops/lcp.py _comp_residual); NaN propagates.
template <typename T, typename S, int M>
NPTT_HD S comp_residual(const S (&A)[M][M], const S (&b)[M], const T (&lo)[M], const T (&hi)[M],
                        const S (&x)[M]) {
  const T tol = Prec<T>::tol();
  S res = S(T(0));
#pragma unroll (row_unroll(M, M))
  for (int i = 0; i < M; ++i) {
    S w = A[i][0] * x[0];
#pragma unroll (row_unroll(M, M - 1, 8))
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
#pragma unroll (row_unroll(M, M))
  for (int i = 0; i < M; ++i) xb[i] = nclip(x[i], lo[i], hi[i]) * (T(1) - im[i]);
#pragma unroll (row_unroll(M, M))
  for (int i = 0; i < M; ++i) {
    S ax = A[i][0] * xb[0];
#pragma unroll (row_unroll(M, M - 1, 8))
    for (int j = 1; j < M; ++j) ax = ax + A[i][j] * xb[j];
    rhs[i] = im[i] * (b[i] - ax);
  }
  S sc = S(T(1));
#pragma unroll (row_unroll(M, M))
  for (int i = 0; i < M; ++i)
#pragma unroll (row_unroll(M, M))
    for (int j = 0; j < M; ++j) {
      Af[i][j] = (im[i] * A[i][j]) * im[j];
      if (i == j) Af[i][j] = Af[i][j] + (T(1) - im[i]);
      sc = pmax(sc, nabs(Af[i][j]));
    }
  const S reg = (Prec<T>::eps() * sc) * sc;
#pragma unroll (row_unroll(M, M))
  for (int i = 0; i < M; ++i) {
#pragma unroll (row_unroll(M, M))
    for (int j = 0; j < M; ++j) {
      S s = Af[0][i] * Af[0][j];
#pragma unroll (row_unroll(M, M - 1, 8))
      for (int k = 1; k < M; ++k) s = s + Af[k][i] * Af[k][j];
      AtA[i][j] = i == j ? s + reg : s;
    }
    S t = Af[0][i] * rhs[0];
#pragma unroll (row_unroll(M, M - 1, 8))
    for (int k = 1; k < M; ++k) t = t + Af[k][i] * rhs[k];
    Atr[i] = t;
  }
  inv_spd<T, 1>(AtA, Ai);
#pragma unroll (row_unroll(M, M))
  for (int i = 0; i < M; ++i) {
    S xi = Ai[i][0] * Atr[0];
#pragma unroll (row_unroll(M, M - 1, 8))
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
#pragma unroll (row_unroll(M, M))
  for (int i = 0; i < M; ++i) {
    im[i] = T(1);
    x[i] = S(T(0));
    best[i] = nclip(x[i], lo[i], hi[i]);
  }
  S best_res = comp_residual<T>(A, b, lo, hi, best);
#pragma unroll (row_unroll(M, 3))
  for (int round = 0; round < 3; ++round) {
    S xn[M];
    lcp_subsolve<T>(A, b, lo, hi, im, x, xn);
#pragma unroll (row_unroll(M, M))
    for (int i = 0; i < M; ++i) {
      S w = A[i][0] * xn[0];
#pragma unroll (row_unroll(M, M - 1, 8))
      for (int j = 1; j < M; ++j) w = w + A[i][j] * xn[j];
      w = w - b[i];
      const bool below = val(xn[i]) <= lo[i], above = val(xn[i]) >= hi[i];
      x[i] = nclip(xn[i], lo[i], hi[i]);
      const bool want_in = (below && val(w) < T(0)) || (above && val(w) > T(0));
      im[i] = ((!below && !above) || want_in) ? T(1) : T(0);
    }
    const S res = comp_residual<T>(A, b, lo, hi, x);
    if (val(res) < val(best_res)) {
#pragma unroll (row_unroll(M, M))
      for (int i = 0; i < M; ++i) best[i] = x[i];
      best_res = res;
    }
  }
  S y[M], inv_diag[M];
#pragma unroll (row_unroll(M, M))
  for (int i = 0; i < M; ++i) {
    y[i] = best[i];
    const S id = T(1) / A[i][i];
    inv_diag[i] = nabs(val(A[i][i])) > T(1e-12) ? id : S(T(0));
  }
#pragma unroll (row_unroll(M, 8))
  for (int sweep = 0; sweep < 8; ++sweep)
#pragma unroll (row_unroll(M, M))
    for (int i = 0; i < M; ++i) {
      S rs = A[i][0] * y[0];
#pragma unroll (row_unroll(M, M - 1, 8))
      for (int j = 1; j < M; ++j) rs = rs + A[i][j] * y[j];
      rs = rs - b[i];
      const S xi = nclip(y[i] - rs * inv_diag[i], lo[i], hi[i]);
      y[i] = y[i] + (xi - y[i]);
    }
  const bool better = val(comp_residual<T>(A, b, lo, hi, y)) < val(best_res);
#pragma unroll (row_unroll(M, M))
  for (int i = 0; i < M; ++i) out[i] = better ? y[i] : best[i];
}

// ops/lcp.py classify_lane for uncoupled rows: the CLAMPING mask.
template <typename T, typename S, int M>
NPTT_HD void classify_rows(const S (&x)[M], const T (&lo)[M], const T (&hi)[M], T (&cm)[M]) {
  const T thr = T(kClampThreshold), half_big = T(kBig / 2);
#pragma unroll (row_unroll(M, M))
  for (int r = 0; r < M; ++r) {
    const T xv = val(x[r]);
    const bool normal_clamp = xv > thr && hi[r] > half_big;
    const bool bounded_clamp = hi[r] < half_big && xv > lo[r] + thr && xv < hi[r] - thr;
    const bool bilateral = lo[r] < -half_big && hi[r] > half_big;
    cm[r] = (normal_clamp || bounded_clamp || bilateral) ? T(1) : T(0);
  }
}

// The inputs of the frozen solve at (q, v, u): q' = q + dt v, v* = v +
// dt qdd, and the planner assembly's A, b and MJ = M^-1 J^T.
template <typename T, typename S, int NB, int NQ, int NA, int M, int NS>
NPTT_HD void frozen_inputs(const T* __restrict__ P, const int* __restrict__ I, const S* q,
                           const S* v, const S* u, S* qn, S (&vs)[NQ], S (&A)[M][M], S (&b)[M],
                           S (&MJ)[NQ][M]) {
  using L = StepLayout<NB, NQ, NA>;
  const T dt = P[L::kDt];
  S R[NB][9], p[NB][3], qdd[NQ], Mm[NQ][NQ], Mi[NQ][NQ];
  T lo[M], hi[M];
  forward_dynamics<T, S, NB, NQ, NA>(P, I, q, v, u, R, p, qdd);
NPTT_UNROLL(L::kUnroll, NQ)
  for (int d = 0; d < NQ; ++d) {
    vs[d] = v[d] + dt * qdd[d];
    qn[d] = q[d] + v[d] * dt;
  }
  mass_matrix<T, S, NB, NQ, NA>(P, I, R, p, Mm);
  inv_spd<T, L::kUnroll>(Mm, Mi);
  constraint_rows<T, S, NB, NQ, NA, M, NS, true>(P, I, q, vs, R, p, Mi, A, b, lo, hi, MJ);
}

// The frozen-class planning step x' = f(x, u; cmask, us) (planner assembly).
template <typename T, typename S, int NB, int NQ, int NA, int M, int NS>
NPTT_HD void frozen_step(const T* __restrict__ P, const int* __restrict__ I, const S* q,
                         const S* v, const S* u, const T* cm, const T* us, int n_cg, S* qn,
                         S* vn) {
  S vs[NQ], A[M][M], b[M], MJ[NQ][M], x[M];
  frozen_inputs<T, S, NB, NQ, NA, M, NS>(P, I, q, v, u, qn, vs, A, b, MJ);
  solve_frozen<NS, T>(A, b, cm, us, n_cg, x);
#pragma unroll (row_unroll(M, NQ))
  for (int d = 0; d < NQ; ++d) {
    S s = MJ[d][0] * x[0];
#pragma unroll (row_unroll(M, M - 1, 8))
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
NPTT_UNROLL(L::kUnroll, NQ)
  for (int d = 0; d < NQ; ++d) {
    vs[d] = v[d] + dt * qdd[d];
    qn[d] = q[d] + v[d] * dt;
  }
  mass_matrix<T, S, NB, NQ, NA>(P, I, R, p, Mm);
  inv_spd<T, L::kUnroll>(Mm, Mi);
  constraint_rows<T, S, NB, NQ, NA, M, 0, false>(P, I, q, vs, R, p, Mi, A, b, lo, hi, MJ);
  direct_boxed_solve_lane<T>(A, b, lo, hi, x);
#pragma unroll (row_unroll(M, NQ))
  for (int d = 0; d < NQ; ++d) {
    S s = MJ[d][0] * x[0];
#pragma unroll (row_unroll(M, M - 1, 8))
    for (int c = 1; c < M; ++c) s = s + MJ[d][c] * x[c];
    vn[d] = vs[d] + s;
  }
  classify_rows<T>(x, lo, hi, cm);
}

}  // namespace nptt
