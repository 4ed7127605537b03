// K4: (fx, fu) of the frozen-class step (step.cuh frozen_step) at every
// point, the class mask of the point read from cm (N, M). Replaces
// nimblephysics_tpu/ops/pallas_linearize.py :: linearize_pallas_split,
// whose primal/tangent kernel split existed only for the TPU compiler's
// kernel-size limit (ops/jvp_split.py); Hopper has no such limit. K3 with
// classes= runs this kernel at the PCG depth m + 6. Its tangent through
// solve_frozen is the implicit one of the JAX package's
// lax.custom_linear_solve, not the derivative of the truncated CG: with
// the normal equations N x_C = Qf^T rhs, N = Qf^T Qf + reg I, and S the
// truncated PCG, direction d has
//   dx_C = S(t_d),  t_d = dQf^T (rhs - Qf x_C) + Qf^T (drhs - dQf x_C)
//                          - dreg x_C.
// The PCG's alphas depend on its right-hand side, so each of the nx + na
// directions runs its own PCG. Bound on this card: arithmetic (the nx +
// na PCGs, then the directions' dual inputs).
//   * Where the rows unroll (the cartpole's m = 4, k4_lanes(M) == 0): one
//     thread per point (linearize_point): the primal once, each
//     direction's tangent right-hand side through the factors of A, and
//     the tangent PCGs over the point's one Qf, all in registers but for
//     what passes between its phases. One thread per (point, direction)
//     running frozen_step on Dual<T>, as first built, repeated the primal
//     in each of a point's threads (1.55 against 0.97 ms in f32 on an
//     NVIDIA H100 80GB HBM3 at 700 W, PERF.md section 6).
//   * Where group_layout(M) holds (the worm's m = 28), one thread per
//     (point, direction) keeps the dense dual A and Qf in local memory
//     (20 KB of stack in f32) and walks them in each PCG iteration (595 ms
//     for the worm's 204,800 points at depth 34, PERF.md section 6).
//     Instead one lane group (frozen_group.cuh) of kK4Group lanes per
//     point, as K5: the primal once (lane 0's dynamics, the rows on the
//     lanes, Qf in shared memory, the primal PCG) and the vectors every
//     direction contracts against, x~ = R x_C, z = C (rhs - Qf x_C), w =
//     MJ x~, pz = M^-T J^T z and v' = v* + w; then lane d < nx + na runs
//     direction d's inputs on Dual<T> (forward_dynamics for dv*; on a
//     direction of q also mass_matrix and the contact rows, streamed slot
//     by slot) and contracts them at once into t_d through the factors of
//     A (dQf = C dA R, dA = dJ MJ + J dMJ, dMJ = M^-1 (dJ^T - dM MJ);
//     jvp_rhs): no dual A, no M-sized dual array, no scratch in device
//     memory; then the nx + na tangent PCGs run as right-hand sides over
//     the one Qf, kK4Rhs per pass, each with its own alpha and beta and
//     the primal's preconditioner; last, dv' = dv* + dMJ x~ + MJ R dx_C
//     and the q' rows [I, dt I] and 0 (q' = q + dt v).
// Least work (chip_smoke.py contact_least_work and slice_least_work):
// (xs, u, cm, us) read and (fx, fu) written once; per point the factored
// form's (ops/device_step.py jvp_point_least_ops), below one plain frozen
// step and nx + na tangents of it (frozen_step_ops).
//
// K5: (fx, fu) of the frozen-class step by row-VJPs of its v' half.
// Replaces nimblephysics_tpu/ops/pallas_linearize.py :: linearize_pallas_vjp,
// whose reverse mode came from jax.vjp of the traced step (through
// lax.custom_linear_solve's transpose) split into primal and row kernels.
// What it computes: the q' rows are analytic ([I, dt I] and 0 under a
// linear position update), and row k of the v' half is the gradient over
// (x, u) of e_k^T v'. With v' = v* + MJ R (cm * x_C) and x_C = S(bvec), S
// the truncated PCG, reverse mode through the linear solve gives
//   row k = d/d(x, u) [ e_k^T v* + e_k^T MJ R (cm * x_C)
//                       + lam_k^T (bvec - Qf^T Qf x_C - reg x_C) ]
// with x_C and lam_k = S(cm * R^T MJ^T e_k) held fixed: the adjoint is the
// same truncated PCG applied to the cotangent, as the transpose rule of
// lax.custom_linear_solve(symmetric=True) runs it. Forward mode with the
// implicit tangent (K4) differs from this where the PCG has not converged.
// Design, tape-free, in one kernel with one lane group (frozen_group.cuh)
// per point:
//   * the primal: the frozen solve's inputs and normal equations on the
//     group, then the primal PCG (x_C) and the nq adjoint PCGs lam_k =
//     PCG(cm * R^T MJ^T e_k) as nq + 1 right-hand sides over the one Qf in
//     shared memory, each with its own alpha and beta (each equals a
//     separate step.cuh pcg but for the order of its scalar sums);
//   * the tangent through the factors of A: cmask, us and so C and R are
//     constants of the point, so dQf = C dA R with dA = dJ MJ + J dMJ and
//     dMJ = -M^-1 dM MJ + M^-1 dJ^T. Every term of row k then contracts
//     against vectors fixed per point: with y = Qf x_C, g_k = Qf lam_k,
//     a1 = C (cm b - y), a2_k = -C g_k, x = R x_C and w_k = R lam_k,
//       row k = <G_k, dJ> + <H_k, dM> + c_k . dv*,
//       G_k[r] = a1_r MJ w_k + w_k[r] pa1 + a2_k[r] (MJ x + v*)
//                + x_r (pa2_k + M^-1[k, :]),
//       H_k = -pa1 (MJ w_k)^T - (pa2_k + M^-1[k, :]) (MJ x)^T,
//       c_k = e_k + J^T a2_k,
//     pa = M^-T J^T a; where entries of C A R attain max|Qf| >= 1, the
//     tangent of reg = eps max(max|Qf|, 1)^2 (jnp's tie rule) adds its
//     terms to G_k and H_k. The group writes G_k, H_k and c_k to shared
//     memory; then lane d < 2 nq + na takes direction d of (x, u): the
//     step's inputs on Dual<T> (forward_dynamics for v*; for a direction
//     of q also mass_matrix and the contact rows, streamed slot by slot),
//     contracted with them, and writes column d. No M-sized dual array, no
//     O(M^2) dual pass and no scratch in device memory.
// Bound on this card: arithmetic (nq + 1 PCGs per point, then 2 nq + na
// dual steps without their LCP). Least work (chip_smoke.py): (xs, u, cm,
// us) read and (fx, fu) written once, vjp_point_least_ops per point
// (ops/device_step.py).
#include "frozen_group.cuh"

namespace nptt {

// K5's shared memory per point: the frozen solve's, with nq + 1
// right-hand sides; the rows of J; and the tangent's coefficients G_k (on
// the rows of J), H_k (on M) and c_k (on v*).
template <typename S, int NB, int NQ, int M>
struct VjpShared {
  FrozenShared<S, NB, NQ, M, NQ + 1> fs;
  S J[M][NQ];
  S G[NQ][M][NQ];
  S H[NQ][NQ][NQ];
  S c[NQ][NQ];
};

// acc = prod at a lane's first owned index, acc + prod at the others
template <typename S>
NPTT_HD void accumulate(S& acc, int o, S prod) {
  acc = o == 0 ? prod : acc + prod;
}

// sign(Qf_ij) where |Qf_ij| attains max|Qf| = mx, else 0
template <typename T, typename R, int M>
NPTT_HD T tie_sign(const R (&Qf)[M][M + 1], int i, int j, T mx) {
  const T q = val(Qf[i][j]);
  return nabs(q) == mx ? (q >= T(0) ? T(1) : T(-1)) : T(0);
}

// K4 where k4_lanes(M) is 0 (the cartpole's m = 4, no contact slot): one
// thread per point, the primal once and the nx + na tangents through the
// factors of A. Every row is a limit or Coulomb row, J = coef e_dof, so
// dJ = 0 and jvp_rhs's right-hand side of direction d is
//   t_d = R^T (MJ^T k) + Qf^T s - dreg x_C,  s = -C J u,  u = dv* + h,
//   h = -M^-1 dM w,  k = -dM pz  (w = MJ x~, pz = M^-T J^T z),
// dM and dreg vanishing on the directions of v and u. In four phases, so
// that no phase holds another's values in registers: (1) each direction's
// dual inputs, dv* and on a direction of q dM, with nothing else live
// (the first direction's values are the primal's qdd and M, bit for bit);
// (2) the primal on values (M^-1, the rows, Qf, the PCG, the fixed
// vectors);
// (3) each direction's t_d and u; (4) the tangent PCGs over the point's
// one Qf, NP per pass (pcg_n, each with its own alpha and beta and the
// primal's preconditioner), and the columns dv' = u + MJ R dx_C. What
// passes between phases lives in the thread's slots (Slots: kPointSlots
// of them, a strided slice of the block's shared memory on the card, a
// local array in the host build). Each value is computed as
// linearize_jvp_group computes it on a group of one lane (R the
// arithmetic type, as K5's), but for the dynamics' values, which the first
// direction's dual inputs carry: ops/device_step.py point_jvp_op_kinds.
template <int NQ, int NA, int M>
constexpr int kPointSlots = (2 * NQ + NA) * (NQ + M) + NQ * NQ * NQ + NQ + NQ * NQ;

template <typename T, typename R, int NB, int NQ, int NA, int M, int NS, int NP, class Slots>
NPTT_HD void linearize_point(Slots& st, long long n, int n_cg, const T* __restrict__ P,
                             const int* __restrict__ I, const T* __restrict__ xs,
                             const T* __restrict__ u, const T* __restrict__ cm_all,
                             const T* __restrict__ us_all, R* __restrict__ fx,
                             R* __restrict__ fu) {
  static_assert(NS == 0, "the one-thread K4 has no contact rows, whose dJ terms the "
                         "lane-group body carries");
  using L = StepLayout<NB, NQ, NA>;
  using RL = RowLayout<NB, NQ, NA, M, NS>;
  constexpr int NX = 2 * NQ, K = NX + NA;
  // the slots: u of each direction (K x NQ), dM of each direction of q
  // (NQ x NQ x NQ), t_d and then dx_C of each direction (K x M), the
  // primal's qdd (NQ) and M (NQ x NQ)
  constexpr int sU = 0, sM = K * NQ, sT = sM + NQ * NQ * NQ, sQ = sT + K * M, sMm = sQ + NQ;
  static_assert(K % NP == 0, "the tangent right-hand sides fill whole passes");
  const T* cm = cm_all + n * M;
  const T* us = us_all + n * M;
  const T dt = P[L::kDt];
  R x[NX], ua[NA];
#pragma unroll (unroll_by(true, NX))
  for (int i = 0; i < NX; ++i) x[i] = R(xs[n * NX + i]);
#pragma unroll (unroll_by(true, NA))
  for (int a = 0; a < NA; ++a) ua[a] = R(u[n * NA + a]);
  // (1) each direction's inputs on Dual<R> seeded with e_d (jvp_rhs)
#pragma unroll 1
  for (int d = 0; d < K; ++d) {
    Dual<R> q[NQ], v[NQ], uu[NA], Rd[NB][9], pd[NB][3], qd[NQ];
#pragma unroll (unroll_by(true, NQ))
    for (int i = 0; i < NQ; ++i) {
      q[i] = Dual<R>(x[i], R(T(d == i ? 1 : 0)));
      v[i] = Dual<R>(x[NQ + i], R(T(d == NQ + i ? 1 : 0)));
    }
#pragma unroll (unroll_by(true, NA))
    for (int a = 0; a < NA; ++a) uu[a] = Dual<R>(ua[a], R(T(d == NX + a ? 1 : 0)));
    forward_dynamics<T, Dual<R>, NB, NQ, NA, true>(P, I, q, v, uu, Rd, pd, qd);
#pragma unroll (unroll_by(true, NQ))
    for (int e = 0; e < NQ; ++e) {
      st[sU + d * NQ + e] = (v[e] + dt * qd[e]).d;
      if (d == 0) st[sQ + e] = qd[e].v;
    }
    if (d < NQ) {
      Dual<R> Mmd[NQ][NQ];
      mass_matrix<T, Dual<R>, NB, NQ, NA, true>(P, I, Rd, pd, Mmd);
#pragma unroll (unroll_by(true, NQ))
      for (int e = 0; e < NQ; ++e)
#pragma unroll (unroll_by(true, NQ))
        for (int f = 0; f < NQ; ++f) {
          st[sM + (d * NQ + e) * NQ + f] = Mmd[e][f].d;
          if (d == 0) st[sMm + e * NQ + f] = Mmd[e][f].v;
        }
    }
  }
  // (2) the primal: qdd and M from (1), M^-1, v* (group_inputs)
  R qdd[NQ], Mm[NQ][NQ], Mi[NQ][NQ], vs[NQ];
#pragma unroll (unroll_by(true, NQ))
  for (int e = 0; e < NQ; ++e) {
    qdd[e] = st[sQ + e];
#pragma unroll (unroll_by(true, NQ))
    for (int f = 0; f < NQ; ++f) Mm[e][f] = st[sMm + e * NQ + f];
  }
  inv_spd<T, true>(Mm, Mi);
#pragma unroll (unroll_by(true, NQ))
  for (int d = 0; d < NQ; ++d) vs[d] = x[NQ + d] + dt * qdd[d];
  // the rows: J = coef e_dof, b = -J v*, the columns of MJ = M^-1 J^T
  R J[M][NQ], b[M], MJ[NQ][M];
  T coef[M];
  int dof[M];
#pragma unroll (unroll_by(true, M))
  for (int r = 0; r < M; ++r) {
    const int d = I[RL::iRowDof + r], kind = I[RL::iRowKind + r];
    dof[r] = d;
    coef[r] = kind == kUpperLimit ? T(-1) : T(1);
    R vd = R(T(0));
#pragma unroll (unroll_by(true, NQ))
    for (int e = 0; e < NQ; ++e) {
      J[r][e] = R(T(0));
      if (e == d) {
        vd = vs[e];
        J[r][e] = R(coef[r]);
      }
    }
    b[r] = kind == kCoulomb ? -vd : (kind == kLowerLimit ? T(-1) : T(1)) * vd;
#pragma unroll (unroll_by(true, NQ))
    for (int k = 0; k < NQ; ++k) {
      R mk = R(T(0));
#pragma unroll (unroll_by(true, NQ))
      for (int e = 0; e < NQ; ++e)
        if (e == d) mk = Mi[k][e];
      MJ[k][r] = mk * coef[r];
    }
  }
  // the normal equations (group_normal_eqs): Qf = C A R + (I - C), A =
  // J MJ + CFM I by entries, rhs = C b, reg, diagM, bvec
  R Qf[M][M], rhs[M], diagM[M], bvec[M], lmx = R(T(0));
#pragma unroll (unroll_by(true, M))
  for (int i = 0; i < M; ++i) {
    const T ci = cm[i];
#pragma unroll (unroll_by(true, M))
    for (int j = 0; j < M; ++j) {
      R mj = R(T(0));
#pragma unroll (unroll_by(true, NQ))
      for (int e = 0; e < NQ; ++e)
        if (e == dof[i]) mj = MJ[e][j];
      R a = coef[i] * mj;
      if (i == j) a = a + T(kCfm);
      R qf = (ci * (a * cm[j])) * cm[j];
      if (i == j) qf = qf + (T(1) - ci);
      Qf[i][j] = qf;
      lmx = pmax(lmx, nabs(qf));
    }
    rhs[i] = ci * b[i];
  }
  const R mx = lmx, qs = pmax(R(T(1)), mx);
  const R reg = (Prec<T>::eps() * qs) * qs;
#pragma unroll (unroll_by(true, M))
  for (int j = 0; j < M; ++j) {
    R dg = Qf[0][j] * Qf[0][j], bv = Qf[0][j] * rhs[0];
#pragma unroll (unroll_by(true, M - 1))
    for (int i = 1; i < M; ++i) {
      dg = dg + Qf[i][j] * Qf[i][j];
      bv = bv + Qf[i][j] * rhs[i];
    }
    diagM[j] = dg + reg;
    bvec[j] = bv;
  }
  R xc[M];
  pcg<T>(Qf, reg, diagM, bvec, n_cg, xc);
  // the fixed vectors: x~ = R x_C, z = C (rhs - Qf x_C), w = MJ x~,
  // pz = M^-T J^T z
  R xt[M], z[M], w[NQ], jz[NQ], pz[NQ];
#pragma unroll (unroll_by(true, M))
  for (int i = 0; i < M; ++i) {
    xt[i] = r_apply<T, R, M, NS>(cm, us, xc, i);
    R y = Qf[i][0] * xc[0];
#pragma unroll (unroll_by(true, M - 1))
    for (int j = 1; j < M; ++j) y = y + Qf[i][j] * xc[j];
    z[i] = cm[i] * (rhs[i] - y);
#pragma unroll (unroll_by(true, NQ))
    for (int e = 0; e < NQ; ++e) {
      accumulate(w[e], i, MJ[e][i] * xt[i]);
      accumulate(jz[e], i, J[i][e] * z[i]);
    }
  }
#pragma unroll (unroll_by(true, NQ))
  for (int f = 0; f < NQ; ++f) {
    R pzf = Mi[0][f] * jz[0];
#pragma unroll (unroll_by(true, NQ - 1))
    for (int e = 1; e < NQ; ++e) pzf = pzf + Mi[e][f] * jz[e];
    pz[f] = pzf;
  }
  // jnp's tie rule for max|Qf| where it is live (tie_share, tie_terms):
  // dreg = <Ht, dM>, Ht = -2 eps qs share M^-T (sum over the tied entries
  // (i, j) of sign_ij cm_i J_i (MJ R)[:, j]^T)
  const T mxv = val(mx);
  T cnt = T(0), live = T(0);
#pragma unroll (unroll_by(true, M))
  for (int i = 0; i < M; ++i)
#pragma unroll (unroll_by(true, M))
    for (int j = 0; j < M; ++j)
      if (nabs(val(Qf[i][j])) == mxv) {
        cnt = cnt + T(1);
        if (cm[i] != T(0) && cm[j] != T(0)) live = T(1);
      }
  const T share = live == T(0) ? T(0)
                               : (mxv > T(1) ? T(1) / cnt : (mxv == T(1) ? T(0.5) / cnt : T(0)));
  const bool tie = share != T(0);
  R Ht[NQ][NQ];
  if (tie) {
    const T qsv = mxv > T(1) ? mxv : T(1);
    const R tc = R(T(2) * Prec<T>::eps() * qsv * share);
    R Hs[NQ][NQ];
#pragma unroll (unroll_by(true, NQ))
    for (int e = 0; e < NQ; ++e)
#pragma unroll (unroll_by(true, NQ))
      for (int f = 0; f < NQ; ++f) Hs[e][f] = R(T(0));
#pragma unroll (unroll_by(true, M))
    for (int i = 0; i < M; ++i) {
      if (cm[i] == T(0)) continue;
      R mw[NQ];
      bool any = false;
#pragma unroll (unroll_by(true, M))
      for (int j = 0; j < M; ++j) {
        const T qv = val(Qf[i][j]);
        const T sij = nabs(qv) == mxv ? (qv >= T(0) ? T(1) : T(-1)) : T(0);
        if (sij == T(0) || cm[j] == T(0)) continue;
#pragma unroll (unroll_by(true, NQ))
        for (int e = 0; e < NQ; ++e) {
          const R term = sij * (cm[j] * (cm[j] * MJ[e][j]));
          mw[e] = any ? mw[e] + term : term;
        }
        any = true;
      }
      if (!any) continue;
#pragma unroll (unroll_by(true, NQ))
      for (int e = 0; e < NQ; ++e) {
        const R cj = cm[i] * J[i][e];
#pragma unroll (unroll_by(true, NQ))
        for (int f = 0; f < NQ; ++f) Hs[e][f] = Hs[e][f] + cj * mw[f];
      }
    }
#pragma unroll (unroll_by(true, NQ))
    for (int e = 0; e < NQ; ++e)
#pragma unroll (unroll_by(true, NQ))
      for (int f = 0; f < NQ; ++f) {
        R ht = Mi[0][e] * Hs[0][f];
#pragma unroll (unroll_by(true, NQ - 1))
        for (int h = 1; h < NQ; ++h) ht = ht + Mi[h][e] * Hs[h][f];
        Ht[e][f] = R(T(0)) - tc * ht;
      }
  }
  // (3) each direction's u (into its slots) and t_d (jvp_rhs)
#pragma unroll 1
  for (int d = 0; d < K; ++d) {
    R uv[NQ], kv[NQ], dreg = R(T(0));
#pragma unroll (unroll_by(true, NQ))
    for (int e = 0; e < NQ; ++e) {
      uv[e] = st[sU + d * NQ + e];
      kv[e] = R(T(0));
    }
    if (d < NQ) {
      R dM[NQ][NQ], g1[NQ];
#pragma unroll (unroll_by(true, NQ))
      for (int e = 0; e < NQ; ++e)
#pragma unroll (unroll_by(true, NQ))
        for (int f = 0; f < NQ; ++f) dM[e][f] = st[sM + (d * NQ + e) * NQ + f];
#pragma unroll (unroll_by(true, NQ))
      for (int e = 0; e < NQ; ++e) {
        R mw = dM[e][0] * w[0], mp = dM[e][0] * pz[0];
#pragma unroll (unroll_by(true, NQ - 1))
        for (int f = 1; f < NQ; ++f) {
          mw = mw + dM[e][f] * w[f];
          mp = mp + dM[e][f] * pz[f];
        }
        g1[e] = R(T(0)) - mw;
        kv[e] = R(T(0)) - mp;
        if (tie) {
#pragma unroll (unroll_by(true, NQ))
          for (int f = 0; f < NQ; ++f) dreg = dreg + Ht[e][f] * dM[e][f];
        }
      }
#pragma unroll (unroll_by(true, NQ))
      for (int e = 0; e < NQ; ++e) {
        R h = Mi[e][0] * g1[0];
#pragma unroll (unroll_by(true, NQ - 1))
        for (int f = 1; f < NQ; ++f) h = h + Mi[e][f] * g1[f];
        uv[e] = uv[e] + h;
        st[sU + d * NQ + e] = uv[e];
      }
    }
    R sv[M];
#pragma unroll (unroll_by(true, M))
    for (int i = 0; i < M; ++i) {
      R si = J[i][0] * uv[0];
#pragma unroll (unroll_by(true, NQ - 1))
      for (int e = 1; e < NQ; ++e) si = si + J[i][e] * uv[e];
      sv[i] = -(cm[i] * si);
    }
#pragma unroll (unroll_by(true, M))
    for (int j = 0; j < M; ++j) {
      R acc = Qf[0][j] * sv[0];
#pragma unroll (unroll_by(true, M - 1))
      for (int i = 1; i < M; ++i) acc = acc + Qf[i][j] * sv[i];
      if (d < NQ) {
        R gr = MJ[0][j] * kv[0];
#pragma unroll (unroll_by(true, NQ - 1))
        for (int e = 1; e < NQ; ++e) gr = gr + MJ[e][j] * kv[e];
        acc = acc + cm[j] * (cm[j] * gr);
      }
      if (tie) acc = acc - dreg * xc[j];
      st[sT + d * M + j] = acc;
    }
  }
  // (4) the tangent PCGs, NP per pass, and the columns (jvp_column)
#pragma unroll 1
  for (int pass = 0; pass < K / NP; ++pass) {
    R t[NP][M], dxc[NP][M];
#pragma unroll (unroll_by(true, NP))
    for (int r = 0; r < NP; ++r)
#pragma unroll (unroll_by(true, M))
      for (int j = 0; j < M; ++j) t[r][j] = st[sT + (pass * NP + r) * M + j];
    pcg_n<T>(Qf, reg, diagM, t, n_cg, dxc);
#pragma unroll (unroll_by(true, NP))
    for (int r = 0; r < NP; ++r) {
      const int d = pass * NP + r;
      R col[NQ];
      const R dx0 = r_apply<T, R, M, NS>(cm, us, dxc[r], 0);
#pragma unroll (unroll_by(true, NQ))
      for (int e = 0; e < NQ; ++e) col[e] = MJ[e][0] * dx0;
#pragma unroll (unroll_by(true, M - 1))
      for (int i = 1; i < M; ++i) {
        const R dx = r_apply<T, R, M, NS>(cm, us, dxc[r], i);
#pragma unroll (unroll_by(true, NQ))
        for (int e = 0; e < NQ; ++e) col[e] = col[e] + MJ[e][i] * dx;
      }
#pragma unroll (unroll_by(true, NQ))
      for (int k = 0; k < NQ; ++k) {
        const R row = st[sU + d * NQ + k] + col[k];
        if (d < NX) {
          fx[(n * NX + NQ + k) * NX + d] = row;
          fx[(n * NX + k) * NX + d] = R(d == k ? T(1) : (d == NQ + k ? dt : T(0)));
        } else {
          fu[(n * NX + NQ + k) * NA + (d - NX)] = row;
          fu[(n * NX + k) * NA + (d - NX)] = R(T(0));
        }
      }
    }
  }
}

// A thread's slots of linearize_point: slot k at base[k * stride] (a
// strided slice of the block's shared memory, so that a warp's threads hit
// distinct banks), or a local array.
template <typename R>
struct StridedSlots {
  R* base;
  int stride;
  NPTT_HD R& operator[](int k) const { return base[k * stride]; }
};
template <typename R, int N>
struct LocalSlots {
  R v[N];
  NPTT_HD R& operator[](int k) { return v[k]; }
};

// The share of each entry of Qf that attains max|Qf| = mx in the tangent
// of max(max|Qf|, 1) under jnp's tie rule: 1 / count (mx > 1), 0.5 / count
// (mx == 1), else 0; also 0 where no tied entry has cmask_i = cmask_j = 1,
// the only entries with a tangent. The group decides alike.
template <typename T, typename R, int M, int G, class Grp>
NPTT_HD T tie_share(const Grp& g, const R (&Qf)[M][M + 1], const T* cm, T mxv) {
  constexpr int kN = Owned<M, G>::kN;
  T cnt = T(0), live = T(0);
#pragma unroll (unroll_by(true, kN))
  for (int o = 0; o < kN; ++o) {
    const int i = g.lane + G * o;
    if (i >= M) continue;
    for (int j = 0; j < M; ++j)
      if (nabs(val(Qf[i][j])) == mxv) {
        cnt = cnt + T(1);
        if (cm[i] != T(0) && cm[j] != T(0)) live = T(1);
      }
  }
  T tie[2] = {cnt, live};
  g.sum(tie);
  const T share = mxv > T(1) ? T(1) / tie[0] : (mxv == T(1) ? T(0.5) / tie[0] : T(0));
  return tie[1] == T(0) ? T(0) : share;
}

// The terms of jnp's tie rule for max|Qf| (see the K5 note above): with
// omega = the sum over the tied entries (i, j) of sign(Qf_ij) dQf_ij, dQf =
// C dA R, Gc[k] (on the contact rows, dJ's coefficients) and Hc[k] (dM's)
// gain coef_k times omega's coefficients. MJR[e][j] = (MJ R)[e][j], J the
// rows of J, both in shared memory; Mi = M^-1.
template <typename T, typename R, int NQ, int M, int NS, int G, int NK, int NPR, class Grp>
NPTT_HD void tie_terms(const Grp& g, const R (&Qf)[M][M + 1], const R (&MJR)[NPR][M],
                       const R (&J)[M][NQ], const T* cm, const T* us, T mxv,
                       const R (&Mi)[NQ][NQ], const R (&coef)[NK], R (&Gc)[NK][M][NQ],
                       R (&Hc)[NK][NQ][NQ]) {
  static_assert(NPR >= NQ, "MJR holds the nq rows of MJ R");
  constexpr int kN = Owned<M, G>::kN, C0 = 3 * NS;
  R Hs[NQ * NQ];
  for (int e = 0; e < NQ * NQ; ++e) Hs[e] = R(T(0));
#pragma unroll (unroll_by(true, kN))
  for (int o = 0; o < kN; ++o) {
    const int i = g.lane + G * o;
    if (i >= M || cm[i] == T(0)) continue;
    // row i: MJ R omega_i = sum over tied j of sign_ij (MJ R)[:, j]
    R mw[NQ];
    bool any = false;
    for (int j = 0; j < M; ++j) {
      const T sij = tie_sign<T>(Qf, i, j, mxv);
      if (sij == T(0) || cm[j] == T(0)) continue;
      for (int e = 0; e < NQ; ++e) {
        const R term = sij * MJR[e][j];
        mw[e] = any ? mw[e] + term : term;
      }
      any = true;
    }
    if (!any) continue;
    for (int e = 0; e < NQ; ++e) {
      const R cj = cm[i] * J[i][e];
      for (int f = 0; f < NQ; ++f) Hs[e * NQ + f] = Hs[e * NQ + f] + cj * mw[f];
      if (i < C0)
        for (int k = 0; k < NK; ++k) Gc[k][i][e] = Gc[k][i][e] + coef[k] * (cm[i] * mw[e]);
    }
  }
#pragma unroll (unroll_by(true, kN))
  for (int o = 0; o < kN; ++o) {
    const int l = g.lane + G * o;
    if (l >= C0) continue;
    // u_l = sum_i cm_i Omega_il J_i, with
    // Omega_il = sign_il cm_l^2 + [l friction] sign_if cm_f^2 us_l
    const int f = l - l % 3;
    R ul[NQ];
    bool any = false;
    for (int i = 0; i < M; ++i) {
      if (cm[i] == T(0)) continue;
      const T om = tie_sign<T>(Qf, i, l, mxv) * (cm[l] * cm[l]) +
                   (l % 3 != 0 ? tie_sign<T>(Qf, i, f, mxv) * (cm[f] * cm[f]) * us[l] : T(0));
      if (om == T(0)) continue;
      for (int e = 0; e < NQ; ++e) {
        const R term = (cm[i] * om) * J[i][e];
        ul[e] = any ? ul[e] + term : term;
      }
      any = true;
    }
    if (!any) continue;
    for (int e = 0; e < NQ; ++e) {
      R mu = Mi[0][e] * ul[0];
      for (int h = 1; h < NQ; ++h) mu = mu + Mi[h][e] * ul[h];
      for (int k = 0; k < NK; ++k) Gc[k][l][e] = Gc[k][l][e] + coef[k] * mu;
    }
  }
  g.sum(Hs);
  for (int L = g.lane; L < NK * NQ; L += G) {
    const int k = L / NQ, e = L % NQ;
    for (int f = 0; f < NQ; ++f) {
      R ht = Mi[0][e] * Hs[f];
      for (int h = 1; h < NQ; ++h) ht = ht + Mi[h][e] * Hs[h * NQ + f];
      Hc[k][e][f] = Hc[k][e][f] - coef[k] * ht;
    }
  }
}

// K5's tie terms: coef_k = -2 eps qs share lam_k . x_C (the tangent of
// -reg lam_k^T x_C in row k), where an entry with cmask_i = cmask_j = 1
// attains max|Qf| >= 1.
template <typename T, typename R, int NB, int NQ, int M, int NS, int G, class Grp>
NPTT_HD void vjp_tie_terms(const Grp& g, VjpShared<R, NB, NQ, M>& sh, const T* cm, const T* us,
                           R mx, const R (&Mi)[NQ][NQ], const R* lamxc) {
  const T mxv = val(mx);
  const T share = tie_share<T, R, M, G>(g, sh.fs.Qf, cm, mxv);
  if (share == T(0)) return;
  const T qs = mxv > T(1) ? mxv : T(1);
  R coef[NQ];
  for (int k = 0; k < NQ; ++k) coef[k] = -(T(2) * Prec<T>::eps() * qs * share) * lamxc[k];
  tie_terms<T, R, NQ, M, NS, G>(g, sh.fs.Qf, sh.fs.p, sh.J, cm, us, mxv, Mi, coef, sh.G, sh.H);
}

// Column d of the v' rows at point n: the step's inputs on Dual<R> seeded
// with e_d contracted with the point's coefficients,
//   row_k = <G_k, dJ> + <H_k, dM> + c_k . dv*
// (dJ and dM vanish on the directions of v and u); and column d of the q'
// rows, [I, dt I] and 0.
template <typename T, typename R, int NB, int NQ, int NA, int M, int NS>
NPTT_HD void vjp_column(const VjpShared<R, NB, NQ, M>& sh, int d, long long n,
                        const T* __restrict__ P, const int* __restrict__ I,
                        const T* __restrict__ xs, const T* __restrict__ u, R* __restrict__ fx,
                        R* __restrict__ fu) {
  using L = StepLayout<NB, NQ, NA>;
  constexpr int NX = 2 * NQ;
  const T dt = P[L::kDt];
  Dual<R> q[NQ], v[NQ], uu[NA], Rd[NB][9], pd[NB][3], qdd[NQ];
  R dvs[NQ], row[NQ];
#pragma unroll (unroll_by(true, NQ))
  for (int i = 0; i < NQ; ++i) {
    q[i] = Dual<R>(R(xs[n * NX + i]), R(T(d == i ? 1 : 0)));
    v[i] = Dual<R>(R(xs[n * NX + NQ + i]), R(T(d == NQ + i ? 1 : 0)));
  }
#pragma unroll (unroll_by(true, NA))
  for (int a = 0; a < NA; ++a) uu[a] = Dual<R>(R(u[n * NA + a]), R(T(d == NX + a ? 1 : 0)));
  // the loops over bodies and dofs unrolled (K5 1.8x faster than rolled,
  // whose arrays in local memory took 63 of its 75 ms)
  constexpr bool UR = true;
  forward_dynamics<T, Dual<R>, NB, NQ, NA, UR>(P, I, q, v, uu, Rd, pd, qdd);
#pragma unroll (unroll_by(true, NQ))
  for (int e = 0; e < NQ; ++e) dvs[e] = (v[e] + dt * qdd[e]).d;
#pragma unroll (unroll_by(true, NQ))
  for (int k = 0; k < NQ; ++k) {
    row[k] = sh.c[k][0] * dvs[0];
#pragma unroll (unroll_by(true, NQ - 1))
    for (int e = 1; e < NQ; ++e) row[k] = row[k] + sh.c[k][e] * dvs[e];
  }
  if (d < NQ) {
    Dual<R> Mm[NQ][NQ], Rw[NB][9], pw[NB][3];
    mass_matrix<T, Dual<R>, NB, NQ, NA, UR>(P, I, Rd, pd, Mm);
#pragma unroll (unroll_by(true, NQ))
    for (int k = 0; k < NQ; ++k)
#pragma unroll (unroll_by(true, NQ))
      for (int e = 0; e < NQ; ++e)
#pragma unroll (unroll_by(true, NQ))
        for (int f = 0; f < NQ; ++f) row[k] = row[k] + sh.H[k][e][f] * Mm[e][f].d;
    world_frames<T, Dual<R>, NB, NQ, NA, UR>(I, Rd, pd, Rw, pw);
#pragma unroll 1
    for (int s = 0; s < NS; ++s) {
      Dual<R> Jp[3][NQ];
      slot_jacobian<T, Dual<R>, NB, NQ, NA, M, NS, UR>(P, I, Rw, pw, s, Jp);
#pragma unroll (unroll_by(true, 3))
      for (int dd = 0; dd < 3; ++dd) {
        T dir[3];
        Dual<R> Jr[NQ];
        slot_direction<T, NB, NQ, NA, M, NS>(P, s, dd, dir);
        slot_row<true>(dir, Jp, Jr);
#pragma unroll (unroll_by(true, NQ))
        for (int k = 0; k < NQ; ++k)
#pragma unroll (unroll_by(true, NQ))
          for (int e = 0; e < NQ; ++e) row[k] = row[k] + sh.G[k][3 * s + dd][e] * Jr[e].d;
      }
    }
  }
#pragma unroll (unroll_by(true, NQ))
  for (int k = 0; k < NQ; ++k) {
    if (d < NX) {
      fx[(n * NX + NQ + k) * NX + d] = row[k];
      fx[(n * NX + k) * NX + d] = R(d == k ? T(1) : (d == NQ + k ? dt : T(0)));
    } else {
      fu[(n * NX + NQ + k) * NA + (d - NX)] = row[k];
      fu[(n * NX + k) * NA + (d - NX)] = R(T(0));
    }
  }
}

// K5's body for point n on one lane group of G (R is the arithmetic type:
// T on the card; the host build also runs it on a counting scalar).
template <typename T, typename R, int NB, int NQ, int NA, int M, int NS, int G, class Grp>
NPTT_HD void linearize_vjp_group(const Grp& g, VjpShared<R, NB, NQ, M>& sh, long long n, int n_cg,
                                 const T* __restrict__ P, const int* __restrict__ I,
                                 const T* __restrict__ xs, const T* __restrict__ u,
                                 const T* __restrict__ cm_all, const T* __restrict__ us_all,
                                 R* __restrict__ fx, R* __restrict__ fu) {
  constexpr int NX = 2 * NQ, K = NX + NA, NR = NQ + 1, C0 = 3 * NS, kN = Owned<M, G>::kN;
  constexpr int kRed = 2 * NQ * NQ + 3 * NQ;
  const T* cm = cm_all + n * M;
  const T* us = us_all + n * M;
  R x[NX], ua[NA], qn[NQ], vs[NQ], Mi[NQ][NQ], mx, reg, diagM[kN], bb[NR][kN], sol[NR][kN];
  LaneRows<T, R, NQ, M, G> rw;
#pragma unroll (unroll_by(true, NX))
  for (int i = 0; i < NX; ++i) x[i] = R(xs[n * NX + i]);
#pragma unroll (unroll_by(true, NA))
  for (int a = 0; a < NA; ++a) ua[a] = R(u[n * NA + a]);
  group_inputs<T, R, NB, NQ, NA, M, NS, G>(g, sh.fs, P, I, x, x + NQ, ua, qn, vs, Mi, rw);
  group_normal_eqs<T, R, NQ, M, NS, G>(g, sh.fs, rw, cm, us, mx, reg, diagM, bb[0]);
  // the adjoint right-hand sides cm * R^T MJ^T e_k
#pragma unroll (unroll_by(true, kN))
  for (int o = 0; o < kN; ++o) {
    const int j = g.lane + G * o;
#pragma unroll (unroll_by(true, NQ))
    for (int k = 0; k < NQ; ++k) {
      bb[1 + k][o] = R(T(0));
      if (j >= M) continue;
      R y = sh.fs.MJ[k][j];
      if (j < C0 && j % 3 == 0)
        y = (y + us[j + 1] * sh.fs.MJ[k][j + 1]) + us[j + 2] * sh.fs.MJ[k][j + 2];
      bb[1 + k][o] = cm[j] * (cm[j] * y);
    }
  }
  group_pcg<T, R, M, NR, G>(g, sh.fs, reg, diagM, bb, n_cg, sol);
  // broadcast x_C, lam_k, J and (MJ R)[k][j] = the adjoint right-hand sides
#pragma unroll (unroll_by(true, kN))
  for (int o = 0; o < kN; ++o) {
    const int i = g.lane + G * o;
    if (i >= M) continue;
#pragma unroll (unroll_by(true, NR))
    for (int s = 0; s < NR; ++s) sh.fs.x[s][i] = sol[s][o];
#pragma unroll (unroll_by(true, NQ))
    for (int k = 0; k < NQ; ++k) {
      sh.fs.p[k][i] = bb[1 + k][o];
      sh.J[i][k] = rw.J[o][k];
    }
  }
  g.sync();
  // per owned row: x = R x_C, w_k = R lam_k, a1 = C (rhs - Qf x_C),
  // a2_k = -C Qf lam_k; then their sums over the rows (red): MJ w_k, MJ x,
  // J^T a1, J^T a2_k and lam_k . x_C
  R xr[kN], w1[NQ][kN], a1[kN], a2[NQ][kN], red[kRed];
  R* MJw = red;                       // [k][e]
  R* MJx = red + NQ * NQ;             // [e]
  R* JTa1 = MJx + NQ;                 // [e]
  R* JTa2 = JTa1 + NQ;                // [k][e]
  R* lamxc = JTa2 + NQ * NQ;          // [k]
#pragma unroll (unroll_by(true, kRed))
  for (int i = 0; i < kRed; ++i) red[i] = R(T(0));
#pragma unroll (unroll_by(true, kN))
  for (int o = 0; o < kN; ++o) {
    const int i = g.lane + G * o;
    if (i >= M) continue;
    xr[o] = r_apply<T, R, M, NS>(cm, us, sh.fs.x[0], i);
#pragma unroll (unroll_by(true, NQ))
    for (int k = 0; k < NQ; ++k) w1[k][o] = r_apply<T, R, M, NS>(cm, us, sh.fs.x[1 + k], i);
    R acc[NR];
#pragma unroll (unroll_by(true, NR))
    for (int s = 0; s < NR; ++s) acc[s] = sh.fs.Qf[i][0] * sh.fs.x[s][0];
#pragma unroll (unroll_by(true, M - 1))
    for (int j = 1; j < M; ++j) {
      const R qv = sh.fs.Qf[i][j];
#pragma unroll (unroll_by(true, NR))
      for (int s = 0; s < NR; ++s) acc[s] = acc[s] + qv * sh.fs.x[s][j];
    }
    a1[o] = cm[i] * (sh.fs.rhs[i] - acc[0]);
#pragma unroll (unroll_by(true, NQ))
    for (int k = 0; k < NQ; ++k) a2[k][o] = -(cm[i] * acc[1 + k]);
#pragma unroll (unroll_by(true, NQ))
    for (int e = 0; e < NQ; ++e) {
#pragma unroll (unroll_by(true, NQ))
      for (int k = 0; k < NQ; ++k) {
        accumulate(MJw[k * NQ + e], o, rw.MJ[o][e] * w1[k][o]);
        accumulate(JTa2[k * NQ + e], o, rw.J[o][e] * a2[k][o]);
      }
      accumulate(MJx[e], o, rw.MJ[o][e] * xr[o]);
      accumulate(JTa1[e], o, rw.J[o][e] * a1[o]);
    }
#pragma unroll (unroll_by(true, NQ))
    for (int k = 0; k < NQ; ++k) accumulate(lamxc[k], o, sol[1 + k][o] * sol[0][o]);
  }
  g.sum(red);
  // every lane: pa1 = M^-T J^T a1, pa2_k = M^-T J^T a2_k + M^-1[k, :],
  // vn = MJ x + v*
  R pa1[NQ], pa2[NQ][NQ], vn[NQ];
#pragma unroll (unroll_by(true, NQ))
  for (int f = 0; f < NQ; ++f) {
    pa1[f] = Mi[0][f] * JTa1[0];
#pragma unroll (unroll_by(true, NQ))
    for (int k = 0; k < NQ; ++k) pa2[k][f] = Mi[0][f] * JTa2[k * NQ];
#pragma unroll (unroll_by(true, NQ - 1))
    for (int e = 1; e < NQ; ++e) {
      pa1[f] = pa1[f] + Mi[e][f] * JTa1[e];
#pragma unroll (unroll_by(true, NQ))
      for (int k = 0; k < NQ; ++k) pa2[k][f] = pa2[k][f] + Mi[e][f] * JTa2[k * NQ + e];
    }
#pragma unroll (unroll_by(true, NQ))
    for (int k = 0; k < NQ; ++k) pa2[k][f] = pa2[k][f] + Mi[k][f];
    vn[f] = MJx[f] + vs[f];
  }
  // G_k on the lane's contact rows; H_k and c_k by lanes L = lane, lane + G, ...
#pragma unroll (unroll_by(true, kN))
  for (int o = 0; o < kN; ++o) {
    const int r = g.lane + G * o;
    if (r >= C0) continue;
#pragma unroll (unroll_by(true, NQ))
    for (int k = 0; k < NQ; ++k)
#pragma unroll (unroll_by(true, NQ))
      for (int e = 0; e < NQ; ++e)
        sh.G[k][r][e] = ((a1[o] * MJw[k * NQ + e] + w1[k][o] * pa1[e]) + a2[k][o] * vn[e]) +
                        xr[o] * pa2[k][e];
  }
  for (int Lk = g.lane; Lk < NQ * NQ; Lk += G) {
    const int k = Lk / NQ, e = Lk % NQ;
#pragma unroll (unroll_by(true, NQ))
    for (int f = 0; f < NQ; ++f)
      sh.H[k][e][f] = -(pa1[e] * MJw[k * NQ + f]) - pa2[k][e] * MJx[f];
    sh.c[k][e] = e == k ? JTa2[k * NQ + e] + T(1) : JTa2[k * NQ + e];
  }
  vjp_tie_terms<T, R, NB, NQ, M, NS, G>(g, sh, cm, us, mx, Mi, lamxc);
  g.sync();
  for (int d = g.lane; d < K; d += G)
    vjp_column<T, R, NB, NQ, NA, M, NS>(sh, d, n, P, I, xs, u, fx, fu);
  g.sync();
}

// K4's shared memory per point where group_layout(M) holds: the frozen
// solve's, with NP right-hand sides; the rows of J; the point's fixed
// vectors; the tie rule's coefficients; per direction d of (x, u) its
// tangent right-hand side t_d (then dx_C), its s_d and u_d, and per
// direction of q the products of its dJ rows with v' and pz.
template <typename S, int NB, int NQ, int NA, int M, int NS, int NP>
struct JvpShared {
  static constexpr int K = 2 * NQ + NA, C0 = 3 * NS;
  FrozenShared<S, NB, NQ, M, NP> fs;
  S J[M][NQ];
  S xc[M], xt[M], z[M];     // x_C, x~ = R x_C, z = C (rhs - Qf x_C)
  S vn[NQ], w[NQ], pz[NQ];  // v' = v* + w, w = MJ x~, pz = M^-T J^T z
  S MJR[NQ][M], Gt[1][M][NQ], Ht[1][NQ][NQ];
  S t[K][M], s[K][M], u[K][NQ];
  S dJv[NQ][C0], dJp[NQ][C0];
};

// Direction d's tangent right-hand side (K4 at the worm's shape, one lane
// per direction): the step's inputs on Dual<R> seeded with e_d (as
// vjp_column: forward_dynamics for dv*; for a direction of q also
// mass_matrix and the contact rows, streamed slot by slot) contracted at
// once with the point's fixed vectors into
//   t_d = R^T (MJ^T k + dJ pz) + Qf^T s - dreg x_C,
//   s = -C (dJ v' + J u),  u = dv* + h,
//   h = M^-1 (dJ^T x~ - dM w),  k = dJ^T z - dM pz,
// t_d into sh.t[d] and u into sh.u[d]. dJ and dM vanish on the directions
// of v and u; dreg = <Gt, dJ> + <Ht, dM> where the tie rule is live.
template <typename T, typename R, int NB, int NQ, int NA, int M, int NS, int NP>
NPTT_HD void jvp_rhs(JvpShared<R, NB, NQ, NA, M, NS, NP>& sh, int d, long long n,
                     const T* __restrict__ P, const int* __restrict__ I,
                     const T* __restrict__ xs, const T* __restrict__ u, const T* cm, const T* us,
                     bool tie) {
  using L = StepLayout<NB, NQ, NA>;
  constexpr int NX = 2 * NQ, C0 = 3 * NS;
  const T dt = P[L::kDt];
  Dual<R> q[NQ], v[NQ], uu[NA], Rd[NB][9], pd[NB][3], qdd[NQ];
  R uv[NQ], kv[NQ], dreg = R(T(0));
#pragma unroll (unroll_by(true, NQ))
  for (int e = 0; e < NQ; ++e) kv[e] = R(T(0));
#pragma unroll (unroll_by(true, NQ))
  for (int i = 0; i < NQ; ++i) {
    q[i] = Dual<R>(R(xs[n * NX + i]), R(T(d == i ? 1 : 0)));
    v[i] = Dual<R>(R(xs[n * NX + NQ + i]), R(T(d == NQ + i ? 1 : 0)));
  }
#pragma unroll (unroll_by(true, NA))
  for (int a = 0; a < NA; ++a) uu[a] = Dual<R>(R(u[n * NA + a]), R(T(d == NX + a ? 1 : 0)));
  constexpr bool UR = true;
  forward_dynamics<T, Dual<R>, NB, NQ, NA, UR>(P, I, q, v, uu, Rd, pd, qdd);
#pragma unroll (unroll_by(true, NQ))
  for (int e = 0; e < NQ; ++e) uv[e] = (v[e] + dt * qdd[e]).d;
  if (d < NQ) {
    Dual<R> Mm[NQ][NQ], Rw[NB][9], pw[NB][3];
    mass_matrix<T, Dual<R>, NB, NQ, NA, UR>(P, I, Rd, pd, Mm);
    world_frames<T, Dual<R>, NB, NQ, NA, UR>(I, Rd, pd, Rw, pw);
    R e1[NQ], e2[NQ];
#pragma unroll (unroll_by(true, NQ))
    for (int e = 0; e < NQ; ++e) e1[e] = e2[e] = R(T(0));
#pragma unroll 1
    for (int s = 0; s < NS; ++s) {
      Dual<R> Jp[3][NQ];
      slot_jacobian<T, Dual<R>, NB, NQ, NA, M, NS, UR>(P, I, Rw, pw, s, Jp);
#pragma unroll (unroll_by(true, 3))
      for (int dd = 0; dd < 3; ++dd) {
        const int r = 3 * s + dd;
        T dir[3];
        Dual<R> Jr[NQ];
        slot_direction<T, NB, NQ, NA, M, NS>(P, s, dd, dir);
        slot_row<true>(dir, Jp, Jr);
        R jv = Jr[0].d * sh.vn[0], jp = Jr[0].d * sh.pz[0];
#pragma unroll (unroll_by(true, NQ - 1))
        for (int e = 1; e < NQ; ++e) {
          jv = jv + Jr[e].d * sh.vn[e];
          jp = jp + Jr[e].d * sh.pz[e];
        }
        sh.dJv[d][r] = jv;
        sh.dJp[d][r] = jp;
#pragma unroll (unroll_by(true, NQ))
        for (int e = 0; e < NQ; ++e) {
          e1[e] = e1[e] + sh.xt[r] * Jr[e].d;
          e2[e] = e2[e] + sh.z[r] * Jr[e].d;
        }
        if (tie) {
#pragma unroll (unroll_by(true, NQ))
          for (int e = 0; e < NQ; ++e) dreg = dreg + sh.Gt[0][r][e] * Jr[e].d;
        }
      }
    }
    R g1[NQ];
#pragma unroll (unroll_by(true, NQ))
    for (int e = 0; e < NQ; ++e) {
      R mw = Mm[e][0].d * sh.w[0], mp = Mm[e][0].d * sh.pz[0];
#pragma unroll (unroll_by(true, NQ - 1))
      for (int f = 1; f < NQ; ++f) {
        mw = mw + Mm[e][f].d * sh.w[f];
        mp = mp + Mm[e][f].d * sh.pz[f];
      }
      g1[e] = e1[e] - mw;
      kv[e] = e2[e] - mp;
      if (tie) {
#pragma unroll (unroll_by(true, NQ))
        for (int f = 0; f < NQ; ++f) dreg = dreg + sh.Ht[0][e][f] * Mm[e][f].d;
      }
    }
#pragma unroll (unroll_by(true, NQ))
    for (int e = 0; e < NQ; ++e) {
      R h = sh.fs.Mi[e][0] * g1[0];
#pragma unroll (unroll_by(true, NQ - 1))
      for (int f = 1; f < NQ; ++f) h = h + sh.fs.Mi[e][f] * g1[f];
      uv[e] = uv[e] + h;
    }
  }
#pragma unroll (unroll_by(true, NQ))
  for (int e = 0; e < NQ; ++e) sh.u[d][e] = uv[e];
#pragma unroll (unroll_by(true, M))
  for (int i = 0; i < M; ++i) {
    R si = sh.J[i][0] * uv[0];
#pragma unroll (unroll_by(true, NQ - 1))
    for (int e = 1; e < NQ; ++e) si = si + sh.J[i][e] * uv[e];
    if (d < NQ && i < C0) si = si + sh.dJv[d][i];
    sh.s[d][i] = -(cm[i] * si);
  }
  // g_l = MJ[:, l] . k + dJ_l . pz (directions of q)
  auto g_at = [&](int l) {
    R gl = sh.fs.MJ[0][l] * kv[0];
#pragma unroll (unroll_by(true, NQ - 1))
    for (int e = 1; e < NQ; ++e) gl = gl + sh.fs.MJ[e][l] * kv[e];
    return l < C0 ? gl + sh.dJp[d][l] : gl;
  };
#pragma unroll (unroll_by(true, M))
  for (int j = 0; j < M; ++j) {
    R acc = sh.fs.Qf[0][j] * sh.s[d][0];
#pragma unroll (unroll_by(true, M - 1))
    for (int i = 1; i < M; ++i) acc = acc + sh.fs.Qf[i][j] * sh.s[d][i];
    if (d < NQ) {
      R gr = g_at(j);
      if (j < C0 && j % 3 == 0) gr = (gr + us[j + 1] * g_at(j + 1)) + us[j + 2] * g_at(j + 2);
      acc = acc + cm[j] * (cm[j] * gr);
    }
    if (tie) acc = acc - dreg * sh.xc[j];
    sh.t[d][j] = acc;
  }
}

// Column d at point n: the v' rows dv' = u_d + MJ R dx_C,d, the q' rows
// [I, dt I] and 0 (q' = q + dt v).
template <typename T, typename R, int NB, int NQ, int NA, int M, int NS, int NP>
NPTT_HD void jvp_column(const JvpShared<R, NB, NQ, NA, M, NS, NP>& sh, int d, long long n,
                        const T* __restrict__ P, const T* cm, const T* us, R* __restrict__ fx,
                        R* __restrict__ fu) {
  using L = StepLayout<NB, NQ, NA>;
  constexpr int NX = 2 * NQ;
  const T dt = P[L::kDt];
  R col[NQ];
  const R dx0 = r_apply<T, R, M, NS>(cm, us, sh.t[d], 0);
#pragma unroll (unroll_by(true, NQ))
  for (int e = 0; e < NQ; ++e) col[e] = sh.fs.MJ[e][0] * dx0;
#pragma unroll (unroll_by(true, M - 1))
  for (int r = 1; r < M; ++r) {
    const R dx = r_apply<T, R, M, NS>(cm, us, sh.t[d], r);
#pragma unroll (unroll_by(true, NQ))
    for (int e = 0; e < NQ; ++e) col[e] = col[e] + sh.fs.MJ[e][r] * dx;
  }
#pragma unroll (unroll_by(true, NQ))
  for (int k = 0; k < NQ; ++k) {
    const R row = sh.u[d][k] + col[k];
    if (d < NX) {
      fx[(n * NX + NQ + k) * NX + d] = row;
      fx[(n * NX + k) * NX + d] = R(d == k ? T(1) : (d == NQ + k ? dt : T(0)));
    } else {
      fu[(n * NX + NQ + k) * NA + (d - NX)] = row;
      fu[(n * NX + k) * NA + (d - NX)] = R(T(0));
    }
  }
}

// K4's body for point n on one lane group of G where group_layout(M)
// holds, NP tangent right-hand sides per pass over Qf (R the arithmetic
// type, as K5's).
template <typename T, typename R, int NB, int NQ, int NA, int M, int NS, int G, int NP, class Grp>
NPTT_HD void linearize_jvp_group(const Grp& g, JvpShared<R, NB, NQ, NA, M, NS, NP>& sh,
                                 long long n, int n_cg, const T* __restrict__ P,
                                 const int* __restrict__ I, const T* __restrict__ xs,
                                 const T* __restrict__ u, const T* __restrict__ cm_all,
                                 const T* __restrict__ us_all, R* __restrict__ fx,
                                 R* __restrict__ fu) {
  constexpr int NX = 2 * NQ, K = NX + NA, C0 = 3 * NS, kN = Owned<M, G>::kN;
  static_assert(K % NP == 0, "the tangent right-hand sides fill whole passes");
  const T* cm = cm_all + n * M;
  const T* us = us_all + n * M;
  R x[NX], ua[NA], qn[NQ], vs[NQ], Mi[NQ][NQ], mx, reg, diagM[kN], bb[1][kN], sol[1][kN];
  LaneRows<T, R, NQ, M, G> rw;
#pragma unroll (unroll_by(true, NX))
  for (int i = 0; i < NX; ++i) x[i] = R(xs[n * NX + i]);
#pragma unroll (unroll_by(true, NA))
  for (int a = 0; a < NA; ++a) ua[a] = R(u[n * NA + a]);
  // the primal: x_C as group_frozen_step solves it
  group_inputs<T, R, NB, NQ, NA, M, NS, G>(g, sh.fs, P, I, x, x + NQ, ua, qn, vs, Mi, rw);
  group_normal_eqs<T, R, NQ, M, NS, G>(g, sh.fs, rw, cm, us, mx, reg, diagM, bb[0]);
  group_pcg<T, R, M, 1, G>(g, sh.fs, reg, diagM, bb, n_cg, sol);
#pragma unroll (unroll_by(true, kN))
  for (int o = 0; o < kN; ++o) {
    const int i = g.lane + G * o;
    if (i >= M) continue;
    sh.xc[i] = sol[0][o];
#pragma unroll (unroll_by(true, NQ))
    for (int e = 0; e < NQ; ++e) sh.J[i][e] = rw.J[o][e];
  }
  g.sync();
  // per owned row: x~ = R x_C, z = C (rhs - Qf x_C); then their sums over
  // the rows (red): w = MJ x~ and J^T z
  R red[2 * NQ];
#pragma unroll (unroll_by(true, 2 * NQ))
  for (int e = 0; e < 2 * NQ; ++e) red[e] = R(T(0));
#pragma unroll (unroll_by(true, kN))
  for (int o = 0; o < kN; ++o) {
    const int i = g.lane + G * o;
    if (i >= M) continue;
    const R xt = r_apply<T, R, M, NS>(cm, us, sh.xc, i);
    R y = sh.fs.Qf[i][0] * sh.xc[0];
#pragma unroll (unroll_by(true, M - 1))
    for (int j = 1; j < M; ++j) y = y + sh.fs.Qf[i][j] * sh.xc[j];
    const R zi = cm[i] * (sh.fs.rhs[i] - y);
    sh.xt[i] = xt;
    sh.z[i] = zi;
#pragma unroll (unroll_by(true, NQ))
    for (int e = 0; e < NQ; ++e) {
      accumulate(red[e], o, rw.MJ[o][e] * xt);
      accumulate(red[NQ + e], o, rw.J[o][e] * zi);
    }
  }
  g.sum(red);
  if (g.lane == 0) {
#pragma unroll (unroll_by(true, NQ))
    for (int f = 0; f < NQ; ++f) {
      R pz = Mi[0][f] * red[NQ];
#pragma unroll (unroll_by(true, NQ - 1))
      for (int e = 1; e < NQ; ++e) pz = pz + Mi[e][f] * red[NQ + e];
      sh.pz[f] = pz;
      sh.w[f] = red[f];
      sh.vn[f] = vs[f] + red[f];
    }
  }
  // jnp's tie rule for max|Qf|, where it is live: dreg's coefficients
  // 2 eps qs share (Gt on dJ, Ht on dM)
  const T mxv = val(mx);
  const T share = tie_share<T, R, M, G>(g, sh.fs.Qf, cm, mxv);
  const bool tie = share != T(0);
  if (tie) {
    const T qs = mxv > T(1) ? mxv : T(1);
    const R coef[1] = {R(T(2) * Prec<T>::eps() * qs * share)};
#pragma unroll (unroll_by(true, kN))
    for (int o = 0; o < kN; ++o) {
      const int j = g.lane + G * o;
      if (j >= M) continue;
#pragma unroll (unroll_by(true, NQ))
      for (int e = 0; e < NQ; ++e) {
        R y = sh.fs.MJ[e][j];
        if (j < C0 && j % 3 == 0)
          y = (y + us[j + 1] * sh.fs.MJ[e][j + 1]) + us[j + 2] * sh.fs.MJ[e][j + 2];
        sh.MJR[e][j] = cm[j] * (cm[j] * y);
        sh.Gt[0][j][e] = R(T(0));
      }
    }
    for (int e = g.lane; e < NQ; e += G)
      for (int f = 0; f < NQ; ++f) sh.Ht[0][e][f] = R(T(0));
    g.sync();
    tie_terms<T, R, NQ, M, NS, G>(g, sh.fs.Qf, sh.MJR, sh.J, cm, us, mxv, Mi, coef, sh.Gt, sh.Ht);
  }
  g.sync();
  // the tangent right-hand sides, one lane per direction of (x, u)
  for (int d = g.lane; d < K; d += G) jvp_rhs<T, R, NB, NQ, NA, M, NS>(sh, d, n, P, I, xs, u, cm, us, tie);
  g.sync();
  // the nx + na tangent PCGs over the one Qf, NP per pass, each with its
  // own alpha and beta and the primal's preconditioner: dx_C into sh.t
#pragma unroll 1
  for (int pass = 0; pass < K / NP; ++pass) {
    R tb[NP][kN], dxc[NP][kN];
#pragma unroll (unroll_by(true, NP))
    for (int r = 0; r < NP; ++r)
#pragma unroll (unroll_by(true, kN))
      for (int o = 0; o < kN; ++o) {
        const int i = g.lane + G * o;
        tb[r][o] = i < M ? sh.t[pass * NP + r][i] : R(T(0));
      }
    group_pcg<T, R, M, NP, G>(g, sh.fs, reg, diagM, tb, n_cg, dxc);
#pragma unroll (unroll_by(true, NP))
    for (int r = 0; r < NP; ++r)
#pragma unroll (unroll_by(true, kN))
      for (int o = 0; o < kN; ++o)
        if (g.lane + G * o < M) sh.t[pass * NP + r][g.lane + G * o] = dxc[r][o];
  }
  g.sync();
  for (int d = g.lane; d < K; d += G) jvp_column<T, R, NB, NQ, NA, M, NS>(sh, d, n, P, cm, us, fx, fu);
  g.sync();
}

#ifdef __CUDACC__
template <typename T, int NB, int NQ, int NA, int M, int NS>
__global__ void linearize_point_kernel(long long n_points, int n_cg, const T* __restrict__ P,
                                       const int* __restrict__ I, const T* __restrict__ xs,
                                       const T* __restrict__ u, const T* __restrict__ cm,
                                       const T* __restrict__ ucl, T* __restrict__ fx,
                                       T* __restrict__ fu) {
  __shared__ T slots[kPointSlots<NQ, NA, M> * kK4PointThreads];
  StridedSlots<T> st{slots + threadIdx.x, kK4PointThreads};
  const long long n = (long long)blockIdx.x * kK4PointThreads + threadIdx.x;
  if (n < n_points)
    linearize_point<T, T, NB, NQ, NA, M, NS, kK4PointRhs>(st, n, n_cg, P, I, xs, u, cm, ucl, fx,
                                                          fu);
}

template <typename T, int NB, int NQ, int NA, int M, int NS, int G, int NP>
__global__ void linearize_jvp_group_kernel(long long n_points, int n_cg, const T* __restrict__ P,
                                           const int* __restrict__ I, const T* __restrict__ xs,
                                           const T* __restrict__ u, const T* __restrict__ cm,
                                           const T* __restrict__ ucl, T* __restrict__ fx,
                                           T* __restrict__ fu) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long n = (long long)blockIdx.x * kGroupsPerBlock + threadIdx.x / G;
  if (n >= n_points) return;  // a whole group leaves: its lanes' mask holds only them
  auto* sh = reinterpret_cast<JvpShared<T, NB, NQ, NA, M, NS, NP>*>(smem) + threadIdx.x / G;
  linearize_jvp_group<T, T, NB, NQ, NA, M, NS, G, NP>(warp_group<G>(), *sh, n, n_cg, P, I, xs, u,
                                                      cm, ucl, fx, fu);
}

// K4: one lane group of k4_lanes(M) per point, kGroupsPerBlock groups per
// block, each with its JvpShared in dynamic shared memory (the worm's
// m = 28); where k4_lanes(M) is 0 (the cartpole's m = 4), one thread per
// point (linearize_point).
template <typename T, int NB, int NQ, int NA, int M, int NS>
static int launch_linearize_split(long long n_points, int n_cg, const void* P, const void* I,
                                  const void* xs, const void* u, const void* cm, const void* ucl,
                                  void* fx, void* fu, cudaStream_t stream) {
  if constexpr (k4_lanes(M) > 0) {
    constexpr int G = k4_lanes(M), NP = kK4Rhs;
    const size_t smem = kGroupsPerBlock * sizeof(JvpShared<T, NB, NQ, NA, M, NS, NP>);
    auto kernel = linearize_jvp_group_kernel<T, NB, NQ, NA, M, NS, G, NP>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const long long blocks = (n_points + kGroupsPerBlock - 1) / kGroupsPerBlock;
    kernel<<<(unsigned)blocks, kGroupsPerBlock * G, smem, stream>>>(
        n_points, n_cg, (const T*)P, (const int*)I, (const T*)xs, (const T*)u, (const T*)cm,
        (const T*)ucl, (T*)fx, (T*)fu);
  } else {
    const int threads = kK4PointThreads;
    const long long blocks = (n_points + threads - 1) / threads;
    linearize_point_kernel<T, NB, NQ, NA, M, NS><<<(unsigned)blocks, threads, 0, stream>>>(
        n_points, n_cg, (const T*)P, (const int*)I, (const T*)xs, (const T*)u, (const T*)cm,
        (const T*)ucl, (T*)fx, (T*)fu);
  }
  return (int)cudaGetLastError();
}

template <typename T, int NB, int NQ, int NA, int M, int NS, int G>
__global__ void linearize_vjp_group_kernel(long long n_points, int n_cg, const T* __restrict__ P,
                                           const int* __restrict__ I, const T* __restrict__ xs,
                                           const T* __restrict__ u, const T* __restrict__ cm,
                                           const T* __restrict__ ucl, T* __restrict__ fx,
                                           T* __restrict__ fu) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long n = (long long)blockIdx.x * kGroupsPerBlock + threadIdx.x / G;
  if (n >= n_points) return;  // a whole group leaves: its lanes' mask holds only them
  auto* sh = reinterpret_cast<VjpShared<T, NB, NQ, M>*>(smem) + threadIdx.x / G;
  linearize_vjp_group<T, T, NB, NQ, NA, M, NS, G>(warp_group<G>(), *sh, n, n_cg, P, I, xs, u, cm,
                                                  ucl, fx, fu);
}

// K5: one lane group of kK5Group per point, kGroupsPerBlock groups per
// block, each with its VjpShared in dynamic shared memory.
template <typename T, int NB, int NQ, int NA, int M, int NS>
static int launch_linearize_vjp(long long n_points, int n_cg, const void* P, const void* I,
                                const void* xs, const void* u, const void* cm, const void* ucl,
                                void* fx, void* fu, cudaStream_t stream) {
  static_assert(group_layout(M), "K5 runs on lane groups, where the rows stay rolled");
  constexpr int G = kK5Group;
  const size_t smem = kGroupsPerBlock * sizeof(VjpShared<T, NB, NQ, M>);
  auto kernel = linearize_vjp_group_kernel<T, NB, NQ, NA, M, NS, G>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n_points + kGroupsPerBlock - 1) / kGroupsPerBlock;
  kernel<<<(unsigned)blocks, kGroupsPerBlock * G, smem, stream>>>(
      n_points, n_cg, (const T*)P, (const int*)I, (const T*)xs, (const T*)u, (const T*)cm,
      (const T*)ucl, (T*)fx, (T*)fu);
  return (int)cudaGetLastError();
}
#endif

}  // namespace nptt

#ifdef __CUDACC__
// K4. Returns 0, a cudaError_t, or -1 for a (dtype, nb, nq, na, m) without
// an instance.
extern "C" int nptt_linearize_split(int is_double, int nb, int nq, int na, int m,
                                    long long n_points, int n_cg, const void* P, const void* I,
                                    const void* xs, const void* u, const void* cm,
                                    const void* ucl, void* fx, void* fu, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define NPTT_SPLIT_CASE(NB, NQ, NA, M, NS)                                                      \
  if (m == M && nb == NB && nq == NQ && na == NA)                                               \
    return is_double ? nptt::launch_linearize_split<double, NB, NQ, NA, M, NS>(                 \
                           n_points, n_cg, P, I, xs, u, cm, ucl, fx, fu, s)                     \
                     : nptt::launch_linearize_split<float, NB, NQ, NA, M, NS>(                  \
                           n_points, n_cg, P, I, xs, u, cm, ucl, fx, fu, s);
  NPTT_CONTACT_SHAPES(NPTT_SPLIT_CASE)
  NPTT_WORM_SHAPES(NPTT_SPLIT_CASE)
#undef NPTT_SPLIT_CASE
  return -1;
}

// K5. Returns 0, a cudaError_t, or -1 for a (dtype, nb, nq, na, m, ns)
// without an instance.
extern "C" int nptt_linearize_vjp(int is_double, int nb, int nq, int na, int m, int ns,
                                  long long n_points, int n_cg, const void* P, const void* I,
                                  const void* xs, const void* u, const void* cm, const void* ucl,
                                  void* fx, void* fu, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define NPTT_VJP_CASE(NB, NQ, NA, M, NS)                                                        \
  if (m == M && ns == NS && nb == NB && nq == NQ && na == NA)                                   \
    return is_double ? nptt::launch_linearize_vjp<double, NB, NQ, NA, M, NS>(                   \
                           n_points, n_cg, P, I, xs, u, cm, ucl, fx, fu, s)                     \
                     : nptt::launch_linearize_vjp<float, NB, NQ, NA, M, NS>(                    \
                           n_points, n_cg, P, I, xs, u, cm, ucl, fx, fu, s);
  NPTT_WORM_SHAPES(NPTT_VJP_CASE)
#undef NPTT_VJP_CASE
  return -1;
}

// K5's lane-group layout at the worm's shape: out = (lanes per group,
// groups per block, shared bytes per block).
extern "C" int nptt_linearize_vjp_group_shape(int is_double, long long* out) {
#define NPTT_SHAPE(NB, NQ, NA, M, NS)                                                 \
  out[0] = nptt::kK5Group;                                                           \
  out[1] = nptt::kGroupsPerBlock;                                                    \
  out[2] = nptt::kGroupsPerBlock * (is_double ? sizeof(nptt::VjpShared<double, NB, NQ, M>) \
                                              : sizeof(nptt::VjpShared<float, NB, NQ, M>));
  NPTT_WORM_SHAPES(NPTT_SHAPE)
#undef NPTT_SHAPE
  return 0;
}
#endif

#ifdef __CUDACC__
namespace nptt {
// K4's layout at an instance: (lanes per group, 0 for one thread per
// point; groups or threads per block; shared bytes per block).
template <typename T, int NB, int NQ, int NA, int M, int NS>
void linearize_split_layout(long long* out) {
  constexpr int G = k4_lanes(M);
  out[0] = G;
  if constexpr (G > 0) {
    out[1] = kGroupsPerBlock;
    out[2] = kGroupsPerBlock * sizeof(JvpShared<T, NB, NQ, NA, M, NS, kK4Rhs>);
  } else {
    out[1] = kK4PointThreads;
    out[2] = kK4PointThreads * kPointSlots<NQ, NA, M> * sizeof(T);
  }
}
}  // namespace nptt

// K4's layout (nptt::linearize_split_layout) at the instance with m rows;
// -1 for an m without an instance.
extern "C" int nptt_linearize_split_layout(int is_double, int m, long long* out) {
#define NPTT_LAYOUT(NB, NQ, NA, M, NS)                                            \
  if (m == M) {                                                                  \
    if (is_double)                                                               \
      nptt::linearize_split_layout<double, NB, NQ, NA, M, NS>(out);              \
    else                                                                         \
      nptt::linearize_split_layout<float, NB, NQ, NA, M, NS>(out);               \
    return 0;                                                                    \
  }
  NPTT_CONTACT_SHAPES(NPTT_LAYOUT)
  NPTT_WORM_SHAPES(NPTT_LAYOUT)
#undef NPTT_LAYOUT
  return -1;
}
#endif
