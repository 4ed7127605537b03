// The lane-group frozen solve of K2 (rollout.cu), K4 and K5 (linearize.cu)
// where the LCP's rows stay rolled (step.cuh group_layout: the jump worm's
// m = 28).
//
// One thread per solve, as step.cuh frozen_step runs it, keeps A, Qf, MJ
// and the PCG's vectors in local memory and walks Qf twice per PCG
// iteration from there, one dependent load after another. Here a group of
// G lanes of one warp owns one frozen solve (ops/frozen_contact.py
// solve_frozen on the planner assembly):
//
//   * the step's dynamics (forward_dynamics, mass_matrix, inv_spd) are
//     serial and small: lane 0 runs them with their loops over bodies and
//     dofs unrolled and their body-indexed arrays in the group's shared
//     memory, and the lanes read v*, M^-1 and the world frames from there
//     (rolled, those arrays live in local memory: run on every lane, as
//     first built, their copies streamed through L2, PERF.md section 6);
//   * lane r owns rows r, r + G, ... < M. It builds their Jacobian rows
//     (contact_rows' arithmetic for one slot direction, or a limit row's
//     one nonzero term), their b = -J v* and their columns of MJ = M^-1 J^T
//     (to shared memory), then their rows of Qf = C A R + (I - C), one
//     entry of A = J MJ + CFM I at a time as constraint_rows and
//     frozen_system compute it: A is never stored;
//   * Qf lives in shared memory as [M][M + 1]: with a row stride of M + 1
//     words the lanes walking their rows down one column hit distinct
//     banks (with M = 28 they would hit them 4 ways);
//   * in the normal equations lane j forms diag(Qf^T Qf)_j and
//     (Qf^T rhs)_j down column j; in each PCG iteration lane i forms
//     (Qf p)_i along row i and, after a sync, lane j forms (Qf^T Qf p)_j
//     down column j. Every such dot product runs j = 0 .. M - 1 as step.cuh
//     pcg runs it; x, r, z and p stay in the owning lanes' registers. The
//     scalar sums rz and pAp and the sums MJ x of v' also run in
//     pcg's and frozen_step's order: the owners write the vectors to shared
//     memory and lane s sums right-hand side s, then broadcasts it. The
//     frictional cone points amplify any change of order past rel 1e-9 in
//     f64 (ROADMAP queue C), so the group solve repeats the one-thread
//     solve's arithmetic operation for operation;
//   * several right-hand sides share one pass over Qf (K5's primal and nq
//     adjoint solves, K4's nx + na tangent solves), each with its own alpha
//     and beta.
//
// The group is a template parameter (lane_group.cuh: WarpGroup on the
// card, HostGroup in the host build of tests/test_torch_device_step.py).
#pragma once

#include "lane_group.cuh"
#include "step.cuh"

namespace nptt {

// The lanes of each group, and the groups of one block: on the H100 K2's
// worm instance ran fastest at 8 lanes and K5 at 16, of 8, 16 and 32
// (scripts/torch_group_variants.py, PERF.md section 6).
constexpr int kK2Group = 8, kK5Group = 16, kGroupsPerBlock = 4;
// K4's worm instance: the lanes of its group per point, and the tangent
// right-hand sides per pass over Qf (nx + na of them in all). On the H100
// 16 lanes with two passes of 5 ran K3 classes= in 62.9 ms, 32 lanes with
// one pass of 10 in 93.9 and 16 with one of 10 (more spills) in 122.6
// (scripts/torch_group_variants.py, PERF.md section 6).
constexpr int kK4Group = 16, kK4Rhs = 5;
// Where the rows unroll (the cartpole's m = 4), K4 runs one thread per
// point (linearize.cu linearize_point), kK4PointThreads per block, its
// tangent PCGs kK4PointRhs per pass.
constexpr int kK4PointRhs = 1, kK4PointThreads = 128;

// Each kernel's layout at a row count m, in one place: the lanes of its
// group per (alpha, world) or point, 0 for one thread. K5 runs on groups
// only, where the rows stay rolled (step.cuh group_layout).
NPTT_HD constexpr int k2_lanes(int m) { return group_layout(m) ? kK2Group : 0; }
NPTT_HD constexpr int k4_lanes(int m) { return group_layout(m) ? kK4Group : 0; }

// The rows a lane owns: r = lane + G o < M for o < kN.
template <int M, int G>
struct Owned {
  static constexpr int kN = (M + G - 1) / G;
};

// A group's shared memory for one frozen step with NR right-hand sides.
template <typename S, int NB, int NQ, int M, int NR>
struct FrozenShared {
  DynWork<S, NB, NQ> w;  // lane 0's work arrays for the dynamics
  S Rb[NB][9], pb[NB][3], Rw[NB][9], pw[NB][3], qdd[NQ], Mm[NQ][NQ], Mi[NQ][NQ];
  S Qf[M][M + 1];  // Qf, rows padded by one word
  S MJ[NQ][M];     // M^-1 J^T
  S rhs[M];        // cmask * b
  S p[NR][M];      // the PCG's search directions
  S Qp[NR][M];     // Qf p
  S Ap[NR][M];     // (Qf^T Qf + reg I) p, then the impulses R x_C
  S r[NR][M];      // the residuals
  S z[NR][M];      // the preconditioned residuals
  S x[NR][M];      // the solutions
};

// A lane's rows: J (a limit or Coulomb row: its sign at its dof), b = -J v*
// and MJ's columns; coef and dof of a limit or Coulomb row (dof -1 on a
// contact row and past M).
template <typename T, typename S, int NQ, int M, int G>
struct LaneRows {
  static constexpr int kN = Owned<M, G>::kN;
  S J[kN][NQ], b[kN], MJ[kN][NQ];
  T coef[kN];
  int dof[kN];
};

// Lane 0: the dynamics at (q, v, u) (qdd, M, M^-1 and the world frames)
// into shared memory; then every lane: q' = q + dt v, v* = v + dt qdd and
// M^-1 (Mi), and its rows (LaneRows), their columns of MJ also into sh.MJ.
// The arithmetic of each value is step.cuh frozen_inputs'.
template <typename T, typename S, int NB, int NQ, int NA, int M, int NS, int G, class Grp,
          class Sh>
NPTT_HD void group_inputs(const Grp& g, Sh& sh, const T* __restrict__ P,
                          const int* __restrict__ I, const S* q, const S* v, const S* u, S* qn,
                          S (&vs)[NQ], S (&Mi)[NQ][NQ], LaneRows<T, S, NQ, M, G>& rw) {
  using L = StepLayout<NB, NQ, NA>;
  using RL = RowLayout<NB, NQ, NA, M, NS>;
  constexpr int C0 = 3 * NS, kN = Owned<M, G>::kN;
  const T dt = P[L::kDt];
  if (g.lane == 0) {
    // the loops over bodies and dofs unrolled: the arrays are in shared
    // memory either way, and unrolled K2 worm ran 2.4x faster than rolled
    forward_dynamics<T, S, NB, NQ, NA, true>(sh.w, P, I, q, v, u, sh.Rb, sh.pb, sh.qdd);
    mass_matrix<T, S, NB, NQ, NA, true>(sh.w, P, I, sh.Rb, sh.pb, sh.Mm);
    inv_spd<T, true>(sh.Mm, sh.Mi);
    if constexpr (NS > 0) world_frames<T, S, NB, NQ, NA, true>(I, sh.Rb, sh.pb, sh.Rw, sh.pw);
  }
  g.sync();
#pragma unroll (unroll_by(true, NQ))
  for (int d = 0; d < NQ; ++d) {
    vs[d] = v[d] + dt * sh.qdd[d];
    qn[d] = q[d] + v[d] * dt;
#pragma unroll (unroll_by(true, NQ))
    for (int e = 0; e < NQ; ++e) Mi[d][e] = sh.Mi[d][e];
  }
#pragma unroll (unroll_by(true, kN))
  for (int o = 0; o < kN; ++o) {
    const int r = g.lane + G * o;
    rw.dof[o] = -1;
    rw.coef[o] = T(0);
    for (int e = 0; e < NQ; ++e) rw.J[o][e] = rw.MJ[o][e] = S(T(0));
    rw.b[o] = S(T(0));
    if (r >= M) continue;
    if (r < C0) {
      const int s = r / 3;
      S Jp[3][NQ];
      T dir[3];
      slot_jacobian<T, S, NB, NQ, NA, M, NS, true>(P, I, sh.Rw, sh.pw, s, Jp);
      slot_direction<T, NB, NQ, NA, M, NS>(P, s, r - 3 * s, dir);
      slot_row<true>(dir, Jp, rw.J[o]);
      S rel = rw.J[o][0] * vs[0];
#pragma unroll (unroll_by(true, NQ - 1))
      for (int e = 1; e < NQ; ++e) rel = rel + rw.J[o][e] * vs[e];
      rw.b[o] = -rel;
#pragma unroll (unroll_by(true, NQ))
      for (int k = 0; k < NQ; ++k) {
        S mk = Mi[k][0] * rw.J[o][0];
#pragma unroll (unroll_by(true, NQ - 1))
        for (int e = 1; e < NQ; ++e) mk = mk + Mi[k][e] * rw.J[o][e];
        rw.MJ[o][k] = mk;
      }
    } else {
      const int d = I[RL::iRowDof + r - C0], kind = I[RL::iRowKind + r - C0];
      rw.dof[o] = d;
      rw.coef[o] = kind == kUpperLimit ? T(-1) : T(1);
      S vd = S(T(0));
#pragma unroll (unroll_by(true, NQ))
      for (int e = 0; e < NQ; ++e)
        if (e == d) {
          vd = vs[e];
          rw.J[o][e] = S(rw.coef[o]);
        }
      rw.b[o] = kind == kCoulomb ? -vd : (kind == kLowerLimit ? T(-1) : T(1)) * vd;
#pragma unroll (unroll_by(true, NQ))
      for (int k = 0; k < NQ; ++k) {
        S mk = S(T(0));
#pragma unroll (unroll_by(true, NQ))
        for (int e = 0; e < NQ; ++e)
          if (e == d) mk = Mi[k][e];
        rw.MJ[o][k] = mk * rw.coef[o];
      }
    }
#pragma unroll (unroll_by(true, NQ))
    for (int k = 0; k < NQ; ++k) sh.MJ[k][r] = rw.MJ[o][k];
  }
  g.sync();
}

// A[i][c] = J_i MJ[:, c] + CFM [i == c] of a lane's row i = lane + G o,
// as step.cuh constraint_rows computes it.
template <typename T, typename S, int NQ, int M, int G, class Sh>
NPTT_HD S a_entry(const LaneRows<T, S, NQ, M, G>& rw, const Sh& sh, int o, int i, int c) {
  S a;
  if (rw.dof[o] < 0) {
    a = rw.J[o][0] * sh.MJ[0][c];
#pragma unroll (unroll_by(true, NQ - 1))
    for (int e = 1; e < NQ; ++e) a = a + rw.J[o][e] * sh.MJ[e][c];
  } else {
    a = rw.coef[o] * sh.MJ[rw.dof[o]][c];
  }
  return i == c ? a + T(kCfm) : a;
}

// The normal equations (step.cuh frozen_normal_eqs): the lane's rows of Qf
// and rhs = cmask b into shared memory; max|Qf| (mx, for K5's tie rule)
// and reg = eps max(mx, 1)^2 on every lane; then per owned column j,
// diagM_j = diag(Qf^T Qf)_j + reg and bvec_j = (Qf^T rhs)_j.
template <typename T, typename S, int NQ, int M, int NS, int G, class Grp, class Sh>
NPTT_HD void group_normal_eqs(const Grp& g, Sh& sh, const LaneRows<T, S, NQ, M, G>& rw,
                              const T* cm, const T* us, S& mx, S& reg,
                              S (&diagM)[Owned<M, G>::kN], S (&bvec)[Owned<M, G>::kN]) {
  constexpr int C0 = 3 * NS, kN = Owned<M, G>::kN;
  S lmx = S(T(0));
#pragma unroll (unroll_by(true, kN))
  for (int o = 0; o < kN; ++o) {
    const int i = g.lane + G * o;
    if (i >= M) continue;
    const T ci = cm[i];
#pragma unroll 1
    for (int s = 0; s < NS; ++s) {
      const int j = 3 * s;
      const S a0 = a_entry(rw, sh, o, i, j), a1 = a_entry(rw, sh, o, i, j + 1),
              a2 = a_entry(rw, sh, o, i, j + 2);
      const S ar[3] = {(a0 + us[j + 1] * a1) + us[j + 2] * a2, a1, a2};
#pragma unroll (unroll_by(true, 3))
      for (int d = 0; d < 3; ++d) {
        S qf = (ci * (ar[d] * cm[j + d])) * cm[j + d];
        if (i == j + d) qf = qf + (T(1) - ci);
        sh.Qf[i][j + d] = qf;
        lmx = pmax(lmx, nabs(qf));
      }
    }
#pragma unroll (unroll_by(true, M - C0))
    for (int j = C0; j < M; ++j) {
      S qf = (ci * (a_entry(rw, sh, o, i, j) * cm[j])) * cm[j];
      if (i == j) qf = qf + (T(1) - ci);
      sh.Qf[i][j] = qf;
      lmx = pmax(lmx, nabs(qf));
    }
    sh.rhs[i] = ci * rw.b[o];
  }
  mx = g.max(lmx);
  const S qs = pmax(S(T(1)), mx);
  reg = (Prec<T>::eps() * qs) * qs;
  g.sync();
#pragma unroll (unroll_by(true, kN))
  for (int o = 0; o < kN; ++o) {
    const int j = g.lane + G * o;
    if (j >= M) continue;
    S dg = sh.Qf[0][j] * sh.Qf[0][j], bv = sh.Qf[0][j] * sh.rhs[0];
#pragma unroll (unroll_by(true, M - 1))
    for (int i = 1; i < M; ++i) {
      dg = dg + sh.Qf[i][j] * sh.Qf[i][j];
      bv = bv + sh.Qf[i][j] * sh.rhs[i];
    }
    diagM[o] = dg + reg;
    bvec[o] = bv;
  }
}

// sum[s] = a[s][0] b[s][0] + ... + a[s][M - 1] b[s][M - 1] in that order
// (step.cuh pcg's and frozen_step's), a and b in shared memory (their first
// N rows), NBV = 1 taking b[0] for every s: lane s % G sums s, then every
// lane gets the sums.
template <typename T, typename S, int M, int N, int NBV, int G, class Grp, int NA_, int NB_>
NPTT_HD void group_seq_dot(const Grp& g, const S (&a)[NA_][M], const S (&b)[NB_][M],
                           S (&sum)[N]) {
  static_assert(NBV == N || NBV == 1, "b holds one vector, or one per sum");
  static_assert(NA_ >= N && NB_ >= NBV, "a and b hold at least the summed rows");
  constexpr int kPer = (N + G - 1) / G;
  S mine[kPer];
#pragma unroll (unroll_by(true, kPer))
  for (int k = 0; k < kPer; ++k) {
    const int s = g.lane + G * k, sb = NBV == 1 ? 0 : s;
    mine[k] = S(T(0));
    if (s >= N) continue;
    mine[k] = a[s][0] * b[sb][0];
#pragma unroll (unroll_by(true, M - 1))
    for (int j = 1; j < M; ++j) mine[k] = mine[k] + a[s][j] * b[sb][j];
  }
#pragma unroll (unroll_by(true, N))
  for (int s = 0; s < N; ++s) sum[s] = g.bcast(mine[s / G], s % G);
}

// Jacobi-preconditioned CG on (Qf^T Qf + reg I) x = bb[s] from x = 0, for
// NR right-hand sides at once (step.cuh pcg on each), n_cg iterations;
// x and bb hold the lane's owned indices.
template <typename T, typename S, int M, int NR, int G, class Grp, class Sh>
NPTT_HD void group_pcg(const Grp& g, Sh& sh, S reg, const S (&diagM)[Owned<M, G>::kN],
                       const S (&bb)[NR][Owned<M, G>::kN], int n_cg,
                       S (&x)[NR][Owned<M, G>::kN]) {
  constexpr int kN = Owned<M, G>::kN;
  const T tiny = T(1e-30);
  S r[NR][kN], z[NR][kN], p[NR][kN], Ap[NR][kN], rz[NR], pAp[NR], rzn[NR];
#pragma unroll (unroll_by(true, NR))
  for (int s = 0; s < NR; ++s)
#pragma unroll (unroll_by(true, kN))
    for (int o = 0; o < kN; ++o) {
      const int i = g.lane + G * o;
      x[s][o] = r[s][o] = z[s][o] = p[s][o] = Ap[s][o] = S(T(0));
      if (i >= M) continue;
      r[s][o] = bb[s][o];
      z[s][o] = r[s][o] / diagM[o];
      p[s][o] = z[s][o];
      sh.r[s][i] = r[s][o];
      sh.z[s][i] = z[s][o];
    }
  g.sync();
  group_seq_dot<T, S, M, NR, NR, G>(g, sh.r, sh.z, rz);
#pragma unroll 1
  for (int it = 0; it < n_cg; ++it) {
#pragma unroll (unroll_by(true, kN))
    for (int o = 0; o < kN; ++o) {
      const int i = g.lane + G * o;
      if (i >= M) continue;
#pragma unroll (unroll_by(true, NR))
      for (int s = 0; s < NR; ++s) sh.p[s][i] = p[s][o];
    }
    g.sync();
#pragma unroll (unroll_by(true, kN))
    for (int o = 0; o < kN; ++o) {
      const int i = g.lane + G * o;
      if (i >= M) continue;
      S acc[NR];
#pragma unroll (unroll_by(true, NR))
      for (int s = 0; s < NR; ++s) acc[s] = sh.Qf[i][0] * sh.p[s][0];
#pragma unroll (unroll_by(true, M - 1))
      for (int j = 1; j < M; ++j) {
        const S q = sh.Qf[i][j];
#pragma unroll (unroll_by(true, NR))
        for (int s = 0; s < NR; ++s) acc[s] = acc[s] + q * sh.p[s][j];
      }
#pragma unroll (unroll_by(true, NR))
      for (int s = 0; s < NR; ++s) sh.Qp[s][i] = acc[s];
    }
    g.sync();
#pragma unroll (unroll_by(true, kN))
    for (int o = 0; o < kN; ++o) {
      const int j = g.lane + G * o;
      if (j >= M) continue;
      S acc[NR];
#pragma unroll (unroll_by(true, NR))
      for (int s = 0; s < NR; ++s) acc[s] = sh.Qf[0][j] * sh.Qp[s][0];
#pragma unroll (unroll_by(true, M - 1))
      for (int i = 1; i < M; ++i) {
        const S q = sh.Qf[i][j];
#pragma unroll (unroll_by(true, NR))
        for (int s = 0; s < NR; ++s) acc[s] = acc[s] + q * sh.Qp[s][i];
      }
#pragma unroll (unroll_by(true, NR))
      for (int s = 0; s < NR; ++s) {
        Ap[s][o] = acc[s] + reg * p[s][o];
        sh.Ap[s][j] = Ap[s][o];
      }
    }
    g.sync();
    group_seq_dot<T, S, M, NR, NR, G>(g, sh.p, sh.Ap, pAp);
#pragma unroll (unroll_by(true, NR))
    for (int s = 0; s < NR; ++s) {
      const S alpha = rz[s] / (pAp[s] + tiny);
#pragma unroll (unroll_by(true, kN))
      for (int o = 0; o < kN; ++o) {
        const int i = g.lane + G * o;
        if (i >= M) continue;
        x[s][o] = x[s][o] + alpha * p[s][o];
        r[s][o] = r[s][o] - alpha * Ap[s][o];
        z[s][o] = r[s][o] / diagM[o];
        sh.r[s][i] = r[s][o];
        sh.z[s][i] = z[s][o];
      }
    }
    g.sync();
    group_seq_dot<T, S, M, NR, NR, G>(g, sh.r, sh.z, rzn);
#pragma unroll (unroll_by(true, NR))
    for (int s = 0; s < NR; ++s) {
      const S beta = rzn[s] / (rz[s] + tiny);
#pragma unroll (unroll_by(true, kN))
      for (int o = 0; o < kN; ++o)
        if (g.lane + G * o < M) p[s][o] = z[s][o] + beta * p[s][o];
      rz[s] = rzn[s];
    }
  }
}

// Row i of R w for w broadcast in shared memory (step.cuh frozen_impulses:
// R = (I + diag(us) gov) diag(cmask)^2 as x = R x_C applies it).
template <typename T, typename S, int M, int NS>
NPTT_HD S r_apply(const T* cm, const T* us, const S* w, int i) {
  S xi = cm[i] * (cm[i] * w[i]);
  if (i < 3 * NS && i % 3 != 0) {
    const int f = i - i % 3;
    xi = xi + us[i] * (cm[f] * (cm[f] * w[f]));
  }
  return xi;
}

// The lane-group frozen step x' = f(x, u; cmask, us) (step.cuh frozen_step):
// group_inputs, group_normal_eqs, group_pcg, then x = R (cmask x_C) and
// v' = v* + MJ x, a sum over the rows by the group. Every lane returns the
// same (q', v').
template <typename T, int NB, int NQ, int NA, int M, int NS, int G, class Grp>
NPTT_HD void group_frozen_step(const Grp& g, FrozenShared<T, NB, NQ, M, 1>& sh,
                               const T* __restrict__ P, const int* __restrict__ I, const T* q,
                               const T* v, const T* u, const T* cm, const T* us, int n_cg, T* qn,
                               T* vn) {
  constexpr int kN = Owned<M, G>::kN;
  T vs[NQ], Mi[NQ][NQ], mx, reg, diagM[kN], bb[1][kN], xc[1][kN], mjx[NQ];
  LaneRows<T, T, NQ, M, G> rw;
  group_inputs<T, T, NB, NQ, NA, M, NS, G>(g, sh, P, I, q, v, u, qn, vs, Mi, rw);
  group_normal_eqs<T, T, NQ, M, NS, G>(g, sh, rw, cm, us, mx, reg, diagM, bb[0]);
  group_pcg<T, T, M, 1, G>(g, sh, reg, diagM, bb, n_cg, xc);
#pragma unroll (unroll_by(true, kN))
  for (int o = 0; o < kN; ++o)
    if (g.lane + G * o < M) sh.x[0][g.lane + G * o] = xc[0][o];
  g.sync();
#pragma unroll (unroll_by(true, kN))
  for (int o = 0; o < kN; ++o) {
    const int i = g.lane + G * o;
    if (i < M) sh.Ap[0][i] = r_apply<T, T, M, NS>(cm, us, sh.x[0], i);
  }
  g.sync();
  group_seq_dot<T, T, M, NQ, 1, G>(g, sh.MJ, sh.Ap, mjx);
#pragma unroll (unroll_by(true, NQ))
  for (int d = 0; d < NQ; ++d) vn[d] = vs[d] + mjx[d];
  g.sync();
}

}  // namespace nptt
