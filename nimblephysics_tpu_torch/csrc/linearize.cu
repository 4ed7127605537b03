// K3: (fx, fu) = d step / d(x, u) at every point of a batch of trajectories.
//
// Replaces nimblephysics_tpu/ops/pallas_linearize.py :: linearize_pallas,
// which folded the nx + na basis directions of a JVP into the TPU's lane
// batch and evaluated the traced step with ops/lanevmap.py.
//
// Bound on this card: arithmetic. Each (point, direction) pair runs one
// forward-mode step (a few thousand flops) and moves only nx + na values
// in and nx values out. Design: the same fold as the TPU lanes, one thread
// per (point, direction); the thread runs the device step of step.cuh on
// Dual<T> (value plus one tangent) seeded with its basis direction, so the
// Jacobian column needs no hand-derived derivative. Neighbouring threads
// share a point, so their loads hit the same cache lines and their column
// writes fall next to each other.
//
// Least work per call (chip_smoke.py least_work): (xs, u) read and (fx, fu)
// written once; per point one plain step and nx + na tangents
// (ops/device_step.py step_ops: 2383 + 5 x 4282 operations on cartpole).
// This kernel repeats the plain step in each of a point's nx + na threads.
//
// K4: (fx, fu) of the frozen-class step (step.cuh frozen_step) at every
// point, the class mask of the point read from cm (N, M). Replaces
// nimblephysics_tpu/ops/pallas_linearize.py :: linearize_pallas_split,
// whose primal/tangent kernel split existed only for the TPU compiler's
// kernel-size limit (ops/jvp_split.py); Hopper has no such limit, so K4
// keeps K3's layout: one thread per (point, direction) on Dual<T>. Its
// tangent through solve_frozen is the implicit one of the JAX package's
// lax.custom_linear_solve (the Dual overload of solve_frozen), not the
// derivative of the truncated CG. Bound on this card: arithmetic. Least
// work (chip_smoke.py least_work): (xs, u, cm) read and (fx, fu) written
// once; per point one plain frozen step and nx + na tangents
// (ops/device_step.py frozen_step_ops). Like K3 it repeats the primal in
// each of a point's threads.
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
// Design, tape-free, in two kernels (the JAX kernel's primal/row split,
// here for parallelism): one thread per point runs the frozen solve's
// inputs on T, its PCG (x_C) and the nq adjoint PCGs lam_k, into a scratch
// buffer; then one thread per (point, direction of (x, u)) runs the inputs
// on Dual<T>, which gives the tangents of v*, MJ, Qf, reg and bvec, and
// writes its column: row k's entry is e_k^T dv* + e_k^T dMJ R (cm * x_C) +
// lam_k^T (dbvec - (dQf^T Qf + Qf^T dQf + dreg) x_C). Bound on this card:
// arithmetic (nq + 1 PCGs per point, nx + na dual assemblies of the M-row
// LCP); M = 28 arrays live in local memory. Least work (chip_smoke.py):
// (xs, u, cm, us) read and (fx, fu) written once, vjp_point_ops per point
// (ops/device_step.py), the scratch round trip not counted.
#include "step.cuh"

namespace nptt {

template <typename T, int NB, int NQ, int NA>
NPTT_HD void linearize_thread(long long tid, const T* __restrict__ P, const int* __restrict__ I,
                              const T* __restrict__ xs, const T* __restrict__ u,
                              T* __restrict__ fx, T* __restrict__ fu) {
  using L = StepLayout<NB, NQ, NA>;
  constexpr int NX = 2 * NQ, K = NX + NA;
  const long long n = tid / K;
  const int k = (int)(tid % K);
  Dual<T> q[NQ], v[NQ], ua[NA], qn[NQ], vn[NQ];
#pragma unroll (unroll_by(L::kUnroll, NQ))
  for (int i = 0; i < NQ; ++i) {
    q[i] = Dual<T>(xs[n * NX + i], T(k == i ? 1 : 0));
    v[i] = Dual<T>(xs[n * NX + NQ + i], T(k == NQ + i ? 1 : 0));
  }
#pragma unroll (unroll_by(L::kUnroll, NA))
  for (int a = 0; a < NA; ++a) ua[a] = Dual<T>(u[n * NA + a], T(k == NX + a ? 1 : 0));
  device_step<T, Dual<T>, NB, NQ, NA>(P, I, q, v, ua, qn, vn);
  if (k < NX) {
#pragma unroll (unroll_by(L::kUnroll, NQ))
    for (int i = 0; i < NQ; ++i) {
      fx[(n * NX + i) * NX + k] = qn[i].d;
      fx[(n * NX + NQ + i) * NX + k] = vn[i].d;
    }
  } else {
#pragma unroll (unroll_by(L::kUnroll, NQ))
    for (int i = 0; i < NQ; ++i) {
      fu[(n * NX + i) * NA + (k - NX)] = qn[i].d;
      fu[(n * NX + NQ + i) * NA + (k - NX)] = vn[i].d;
    }
  }
}

template <typename T, int NB, int NQ, int NA, int M, int NS>
NPTT_HD void linearize_split_thread(long long tid, int n_cg, const T* __restrict__ P,
                                    const int* __restrict__ I, const T* __restrict__ xs,
                                    const T* __restrict__ u, const T* __restrict__ cm,
                                    const T* __restrict__ ucl, T* __restrict__ fx,
                                    T* __restrict__ fu) {
  using L = StepLayout<NB, NQ, NA>;
  constexpr int NX = 2 * NQ, K = NX + NA;
  const long long n = tid / K;
  const int k = (int)(tid % K);
  Dual<T> q[NQ], v[NQ], ua[NA], qn[NQ], vn[NQ];
#pragma unroll (unroll_by(L::kUnroll, NQ))
  for (int i = 0; i < NQ; ++i) {
    q[i] = Dual<T>(xs[n * NX + i], T(k == i ? 1 : 0));
    v[i] = Dual<T>(xs[n * NX + NQ + i], T(k == NQ + i ? 1 : 0));
  }
#pragma unroll (unroll_by(L::kUnroll, NA))
  for (int a = 0; a < NA; ++a) ua[a] = Dual<T>(u[n * NA + a], T(k == NX + a ? 1 : 0));
  frozen_step<T, Dual<T>, NB, NQ, NA, M, NS>(P, I, q, v, ua, cm + n * M, ucl + n * M, n_cg, qn,
                                              vn);
  if (k < NX) {
#pragma unroll (unroll_by(L::kUnroll, NQ))
    for (int i = 0; i < NQ; ++i) {
      fx[(n * NX + i) * NX + k] = qn[i].d;
      fx[(n * NX + NQ + i) * NX + k] = vn[i].d;
    }
  } else {
#pragma unroll (unroll_by(L::kUnroll, NQ))
    for (int i = 0; i < NQ; ++i) {
      fu[(n * NX + i) * NA + (k - NX)] = qn[i].d;
      fu[(n * NX + NQ + i) * NA + (k - NX)] = vn[i].d;
    }
  }
}

// K5's scratch per point: x_C (M), x = R (cm * x_C) (M), lam_k (NQ M).
template <int NQ, int M>
struct VjpScratch {
  static constexpr int kXc = 0, kXr = M, kLam = 2 * M, kSize = 2 * M + NQ * M;
};

// K5's first thread body, one per point: the frozen solve's primal on T
// (its PCG gives x_C) and the nq adjoint PCGs lam_k = PCG(cm * R^T MJ^T e_k),
// into the point's scratch. R is the arithmetic type (T on the card; the
// host build also runs it on a counting scalar).
template <typename T, typename R, int NB, int NQ, int NA, int M, int NS>
NPTT_HD void linearize_vjp_primal(long long n, int n_cg, const T* __restrict__ P,
                                  const int* __restrict__ I, const T* __restrict__ xs,
                                  const T* __restrict__ u, const T* __restrict__ cm_all,
                                  const T* __restrict__ us_all, R* __restrict__ scratch) {
  using L = StepLayout<NB, NQ, NA>;
  using SC = VjpScratch<NQ, M>;
  constexpr int NX = 2 * NQ;
  const T* cm = cm_all + n * M;
  const T* us = us_all + n * M;
  R* sc = scratch + n * SC::kSize;
  R x[NX], ua[NA], qn[NQ], vs[NQ], A[M][M], b[M], MJ[NQ][M], Qf[M][M], reg, diagM[M], bvec[M],
      xc[M], xr[M];
#pragma unroll (unroll_by(L::kUnroll, NX))
  for (int i = 0; i < NX; ++i) x[i] = R(xs[n * NX + i]);
#pragma unroll (unroll_by(L::kUnroll, NA))
  for (int a = 0; a < NA; ++a) ua[a] = R(u[n * NA + a]);
  frozen_inputs<T, R, NB, NQ, NA, M, NS>(P, I, x, x + NQ, ua, qn, vs, A, b, MJ);
  frozen_normal_eqs<T, R, M, NS>(A, b, cm, us, Qf, reg, diagM, bvec);
  pcg<T>(Qf, reg, diagM, bvec, n_cg, xc);
  frozen_impulses<T, R, M, NS>(cm, us, xc, xr);
#pragma unroll (row_unroll(M, M))
  for (int i = 0; i < M; ++i) {
    sc[SC::kXc + i] = xc[i];
    sc[SC::kXr + i] = xr[i];
  }
#pragma unroll (row_unroll(M, NQ))
  for (int k = 0; k < NQ; ++k) {
    // cm * R^T MJ^T e_k: R^T y = cm * (y + the coupled rows' us y)
    R xbar[M], lam[M];
#pragma unroll (row_unroll(M, M))
    for (int j = 0; j < M; ++j) {
      R y = MJ[k][j];
      if (j < 3 * NS && j % 3 == 0) y = (y + us[j + 1] * MJ[k][j + 1]) + us[j + 2] * MJ[k][j + 2];
      xbar[j] = cm[j] * (cm[j] * y);
    }
    pcg<T>(Qf, reg, diagM, xbar, n_cg, lam);
#pragma unroll (row_unroll(M, M))
    for (int j = 0; j < M; ++j) sc[SC::kLam + k * M + j] = lam[j];
  }
}

// K5's second thread body, one per (point, direction d of (x, u)): the
// solve's inputs on Dual<R> seeded with e_d, then column d of the v' rows,
//   e_k^T dv* + e_k^T dMJ x + lam_k^T (dbvec - (dQf^T Qf + Qf^T dQf + dreg) x_C),
// from the point's scratch; direction 0 also writes the analytic q' rows,
// [I, dt I] and 0.
template <typename T, typename R, int NB, int NQ, int NA, int M, int NS>
NPTT_HD void linearize_vjp_column(long long tid, const T* __restrict__ P,
                                  const int* __restrict__ I, const T* __restrict__ xs,
                                  const T* __restrict__ u, const T* __restrict__ cm_all,
                                  const T* __restrict__ us_all, const R* __restrict__ scratch,
                                  R* __restrict__ fx, R* __restrict__ fu) {
  using L = StepLayout<NB, NQ, NA>;
  using SC = VjpScratch<NQ, M>;
  constexpr int NX = 2 * NQ, K = NX + NA;
  const long long n = tid / K;
  const int d = (int)(tid % K);
  const T* cm = cm_all + n * M;
  const T* us = us_all + n * M;
  const R* sc = scratch + n * SC::kSize;
  Dual<R> q[NQ], v[NQ], uu[NA], qn[NQ], vs[NQ], A[M][M], b[M], MJ[NQ][M], Qf[M][M], reg,
      bvec[M];
  R Qv[M][M], diagM[M], xc[M], rt[M];
#pragma unroll (unroll_by(L::kUnroll, NQ))
  for (int i = 0; i < NQ; ++i) {
    q[i] = Dual<R>(R(xs[n * NX + i]), R(T(d == i ? 1 : 0)));
    v[i] = Dual<R>(R(xs[n * NX + NQ + i]), R(T(d == NQ + i ? 1 : 0)));
  }
#pragma unroll (unroll_by(L::kUnroll, NA))
  for (int a = 0; a < NA; ++a) uu[a] = Dual<R>(R(u[n * NA + a]), R(T(d == NX + a ? 1 : 0)));
#pragma unroll (row_unroll(M, M))
  for (int i = 0; i < M; ++i) xc[i] = sc[SC::kXc + i];
  frozen_inputs<T, Dual<R>, NB, NQ, NA, M, NS>(P, I, q, v, uu, qn, vs, A, b, MJ);
  frozen_normal_eqs_dual<T, R, M, NS>(A, b, cm, us, Qf, Qv, reg, diagM, bvec);
  frozen_tangent_rhs<R, M>(Qf, reg, bvec, xc, rt);
#pragma unroll (row_unroll(M, NQ))
  for (int k = 0; k < NQ; ++k) {
    R g = vs[k].d;
#pragma unroll (row_unroll(M, M))
    for (int i = 0; i < M; ++i) g = g + MJ[k][i].d * sc[SC::kXr + i];
#pragma unroll (row_unroll(M, M))
    for (int j = 0; j < M; ++j) g = g + sc[SC::kLam + k * M + j] * rt[j];
    if (d < NX)
      fx[(n * NX + NQ + k) * NX + d] = g;
    else
      fu[(n * NX + NQ + k) * NA + (d - NX)] = g;
  }
  if (d == 0) {
    const T dt = P[StepLayout<NB, NQ, NA>::kDt];
#pragma unroll (unroll_by(L::kUnroll, NQ))
    for (int i = 0; i < NQ; ++i) {
#pragma unroll (unroll_by(L::kUnroll, NX))
      for (int j = 0; j < NX; ++j)
        fx[(n * NX + i) * NX + j] = R(j == i ? T(1) : (j == NQ + i ? dt : T(0)));
#pragma unroll (unroll_by(L::kUnroll, NA))
      for (int a = 0; a < NA; ++a) fu[(n * NX + i) * NA + a] = R(T(0));
    }
  }
}

#ifdef __CUDACC__
template <typename T, int NB, int NQ, int NA>
__global__ void linearize_kernel(long long n_threads, const T* __restrict__ P,
                                 const int* __restrict__ I, const T* __restrict__ xs,
                                 const T* __restrict__ u, T* __restrict__ fx,
                                 T* __restrict__ fu) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid < n_threads) linearize_thread<T, NB, NQ, NA>(tid, P, I, xs, u, fx, fu);
}

template <typename T, int NB, int NQ, int NA>
static int launch_linearize(long long n_points, const void* P, const void* I, const void* xs,
                            const void* u, void* fx, void* fu, cudaStream_t stream) {
  const long long n_threads = n_points * (2 * NQ + NA);
  const int threads = 128;
  const long long blocks = (n_threads + threads - 1) / threads;
  linearize_kernel<T, NB, NQ, NA><<<(unsigned)blocks, threads, 0, stream>>>(
      n_threads, (const T*)P, (const int*)I, (const T*)xs, (const T*)u, (T*)fx, (T*)fu);
  return (int)cudaGetLastError();
}

template <typename T, int NB, int NQ, int NA, int M, int NS>
__global__ void linearize_split_kernel(long long n_threads, int n_cg, const T* __restrict__ P,
                                       const int* __restrict__ I, const T* __restrict__ xs,
                                       const T* __restrict__ u, const T* __restrict__ cm,
                                       const T* __restrict__ ucl, T* __restrict__ fx,
                                       T* __restrict__ fu) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid < n_threads)
    linearize_split_thread<T, NB, NQ, NA, M, NS>(tid, n_cg, P, I, xs, u, cm, ucl, fx, fu);
}

template <typename T, int NB, int NQ, int NA, int M, int NS>
static int launch_linearize_split(long long n_points, int n_cg, const void* P, const void* I,
                                  const void* xs, const void* u, const void* cm, const void* ucl,
                                  void* fx, void* fu, cudaStream_t stream) {
  const long long n_threads = n_points * (2 * NQ + NA);
  const int threads = 128;
  const long long blocks = (n_threads + threads - 1) / threads;
  linearize_split_kernel<T, NB, NQ, NA, M, NS><<<(unsigned)blocks, threads, 0, stream>>>(
      n_threads, n_cg, (const T*)P, (const int*)I, (const T*)xs, (const T*)u, (const T*)cm,
      (const T*)ucl, (T*)fx, (T*)fu);
  return (int)cudaGetLastError();
}

template <typename T, int NB, int NQ, int NA, int M, int NS>
__global__ void linearize_vjp_primal_kernel(long long n_points, int n_cg, const T* __restrict__ P,
                                            const int* __restrict__ I,
                                            const T* __restrict__ xs, const T* __restrict__ u,
                                            const T* __restrict__ cm, const T* __restrict__ ucl,
                                            T* __restrict__ scratch) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n < n_points)
    linearize_vjp_primal<T, T, NB, NQ, NA, M, NS>(n, n_cg, P, I, xs, u, cm, ucl, scratch);
}

template <typename T, int NB, int NQ, int NA, int M, int NS>
__global__ void linearize_vjp_column_kernel(long long n_threads, const T* __restrict__ P,
                                            const int* __restrict__ I,
                                            const T* __restrict__ xs, const T* __restrict__ u,
                                            const T* __restrict__ cm, const T* __restrict__ ucl,
                                            const T* __restrict__ scratch, T* __restrict__ fx,
                                            T* __restrict__ fu) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid < n_threads)
    linearize_vjp_column<T, T, NB, NQ, NA, M, NS>(tid, P, I, xs, u, cm, ucl, scratch, fx, fu);
}

// K5: the primal kernel, then the column kernel, on one stream; scratch
// holds VjpScratch<NQ, M>::kSize values per point.
template <typename T, int NB, int NQ, int NA, int M, int NS>
static int launch_linearize_vjp(long long n_points, int n_cg, const void* P, const void* I,
                                const void* xs, const void* u, const void* cm, const void* ucl,
                                void* scratch, void* fx, void* fu, cudaStream_t stream) {
  const int threads = 128;
  const long long n_cols = n_points * (2 * NQ + NA);
  linearize_vjp_primal_kernel<T, NB, NQ, NA, M, NS>
      <<<(unsigned)((n_points + threads - 1) / threads), threads, 0, stream>>>(
          n_points, n_cg, (const T*)P, (const int*)I, (const T*)xs, (const T*)u, (const T*)cm,
          (const T*)ucl, (T*)scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  linearize_vjp_column_kernel<T, NB, NQ, NA, M, NS>
      <<<(unsigned)((n_cols + threads - 1) / threads), threads, 0, stream>>>(
          n_cols, (const T*)P, (const int*)I, (const T*)xs, (const T*)u, (const T*)cm,
          (const T*)ucl, (const T*)scratch, (T*)fx, (T*)fu);
  return (int)cudaGetLastError();
}
#endif

}  // namespace nptt

#ifdef __CUDACC__
// Returns 0, a cudaError_t, or -1 for a (dtype, nb, nq, na) without an instance.
extern "C" int nptt_linearize(int is_double, int nb, int nq, int na, long long n_points,
                              const void* P, const void* I, const void* xs, const void* u,
                              void* fx, void* fu, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define NPTT_LINEARIZE_CASE(NB, NQ, NA)                                                  \
  if (nb == NB && nq == NQ && na == NA)                                                  \
    return is_double ? nptt::launch_linearize<double, NB, NQ, NA>(n_points, P, I, xs, u, fx, fu, s) \
                     : nptt::launch_linearize<float, NB, NQ, NA>(n_points, P, I, xs, u, fx, fu, s);
  NPTT_STEP_SHAPES(NPTT_LINEARIZE_CASE)
#undef NPTT_LINEARIZE_CASE
  return -1;
}
#endif

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
                                  void* scratch, void* fx, void* fu, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define NPTT_VJP_CASE(NB, NQ, NA, M, NS)                                                        \
  if (m == M && ns == NS && nb == NB && nq == NQ && na == NA)                                   \
    return is_double ? nptt::launch_linearize_vjp<double, NB, NQ, NA, M, NS>(                   \
                           n_points, n_cg, P, I, xs, u, cm, ucl, scratch, fx, fu, s)            \
                     : nptt::launch_linearize_vjp<float, NB, NQ, NA, M, NS>(                    \
                           n_points, n_cg, P, I, xs, u, cm, ucl, scratch, fx, fu, s);
  NPTT_WORM_SHAPES(NPTT_VJP_CASE)
#undef NPTT_VJP_CASE
  return -1;
}
#endif
