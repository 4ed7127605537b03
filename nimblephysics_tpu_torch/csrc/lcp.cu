// K7: batched boxed-LCP projected Gauss-Seidel with friction coupling.
//
// Replaces nimblephysics_tpu/ops/pallas_lcp.py :: pallas_pgs_batched (kernel
// _pgs_kernel), which kept a tile of worlds batch-last in VMEM and ran all
// sweeps as (block,)-wide vector ops. What it computes: ops/lcp.py
// pgs_solve for every LCP of the batch: `iters` sweeps over the rows in
// order, x_i <- clip(x_i - (A_i x - b_i) inv_diag_i, lo_i, hi_i) with
// inv_diag = 1 / A_ii where |A_ii| > 1e-12 (else 0), a friction row i
// (findex_i = f >= 0) bounded by +-fscale_i max(x_f, 0).
//
// Bound on this card: the sweeps' arithmetic and their latency. Each LCP
// needs iters * m * m multiply-adds in a chain of iters * m dependent row
// updates. With one thread per LCP each row update is an m-long dependent
// chain of FMAs over the LCP's matrix, which at m = 28 fills shared memory
// at 2 warps per SM (31.5 ms for the worm's 204,800 LCPs, PERF.md section
// 6). Design: a lane group (lane_group.cuh) of kK7Group lanes per LCP.
// Lane l owns rows r = l + G o < m and keeps, in registers, row r of A
// (loaded once), x_r and the residual w_r = (A x - b)_r, kept current
// instead of recomputed:
//   1. w = A x0 - b, each lane its own rows (in pgs_solve's order);
//   2. row i: its owner forms x_i' = clip(x_i - w_i inv_diag_i, lo, hi);
//      on a friction row the coupled x_f comes from its owner by one
//      shuffle (findex is the same for every LCP, so the branch is
//      uniform);
//   3. the owner broadcasts delta = x_i' - x_i (one shuffle);
//   4. every lane updates w_r += A(r, i) delta.
// That is 1-2 shuffles and a few instructions per row instead of an m-long
// chain: the same Gauss-Seidel iteration in exact arithmetic, rounded
// otherwise (the residual is updated, not recomputed: in f64 the
// solutions stay within rel 1e-13 of pgs_solve's on the worm's LCPs,
// tests/test_torch_device_step.py). The row updates of one LCP stay a
// dependent chain through the shuffles, so the card needs many LCPs in
// flight. pgs_lcp, the one-thread body, stays for the host tests.
//
// Least work per call (chip_smoke.py): (A, b, lo, hi, fscale, x0, findex)
// read and x written once; per LCP and sweep, m dot products of length m
// and the row update (pgs_sweep_ops in chip_smoke.py).
#include "lane_group.cuh"

// The LCP sizes the kernel is built for, at most one row per lane
// (wider LCPs take csrc/lcp_wide.cu's shared-memory body); the wrapper
// refuses any other. The jump worm: 8 contact slots and 2 limited dofs, 28
// rows.
#define NPTT_PGS_SIZES(X) X(28)

namespace nptt {

// The lanes of K7's group per LCP: on the H100 32 lanes (72 registers in
// f32) took 7.6 ms for the worm's LCPs, 16 (128 registers) 8.8 and 8 (221)
// 9.8 (scripts/torch_group_variants.py, PERF.md section 6).
constexpr int kK7Group = 32;

// One LCP's sweeps; its A(i, j) is As[(i M + j) stride].
template <typename T, int M>
NPTT_HD void pgs_lcp(const T* __restrict__ As, int stride, const T* __restrict__ b,
                     const T* __restrict__ lo, const T* __restrict__ hi, const T* __restrict__ fs,
                     const T* __restrict__ x0, const int* __restrict__ findex, int iters,
                     T* __restrict__ out) {
  auto A = [&](int i, int j) { return As[(i * M + j) * stride]; };
  T x[M], inv_diag[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    x[i] = x0[i];
    const T d = A(i, i);
    const T id = T(1) / d;
    inv_diag[i] = nabs(d) > T(1e-12) ? id : T(0);
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < M; ++i) {
      T r = A(i, 0) * x[0];
#pragma unroll
      for (int j = 1; j < M; ++j) r = r + A(i, j) * x[j];
      r = r - b[i];
      const T xi = x[i] - r * inv_diag[i];
      const int f = findex[i];
      T lo_i = lo[i], hi_i = hi[i];
      if (f >= 0) {
        T xf = T(0);
#pragma unroll
        for (int j = 0; j < M; ++j)
          if (j == f) xf = x[j];
        const T f_hi = fs[i] * pmax(xf, T(0));
        lo_i = -f_hi;
        hi_i = f_hi;
      }
      x[i] = nclip(xi, lo_i, hi_i);
    }
  }
#pragma unroll
  for (int i = 0; i < M; ++i) out[i] = x[i];
}

// K7's body for one LCP on a lane group of G (see the note above); A
// (M x M, row-major), b, lo, hi, fs, x0 and out the LCP's own.
template <typename T, int M, int G, class Grp>
NPTT_HD void pgs_group(const Grp& g, const T* __restrict__ A, const T* __restrict__ b,
                       const T* __restrict__ lo, const T* __restrict__ hi,
                       const T* __restrict__ fs, const T* __restrict__ x0,
                       const int* __restrict__ findex, int iters, T* __restrict__ out) {
  constexpr int kN = (M + G - 1) / G;
  T a[kN][M], x[kN], w[kN], inv_diag[kN], lo_r[kN], hi_r[kN], fs_r[kN];
#pragma unroll (unroll_by(true, kN))
  for (int o = 0; o < kN; ++o) {
    const int r = g.lane + G * o;
    x[o] = w[o] = inv_diag[o] = lo_r[o] = hi_r[o] = fs_r[o] = T(0);
#pragma unroll (unroll_by(true, M))
    for (int j = 0; j < M; ++j) a[o][j] = T(0);
    if (r >= M) continue;
#pragma unroll (unroll_by(true, M))
    for (int j = 0; j < M; ++j) a[o][j] = A[r * M + j];
    x[o] = x0[r];
    lo_r[o] = lo[r];
    hi_r[o] = hi[r];
    fs_r[o] = fs[r];
    const T d = A[r * M + r];
    const T id = T(1) / d;
    inv_diag[o] = nabs(d) > T(1e-12) ? id : T(0);
    T acc = a[o][0] * x0[0];
#pragma unroll (unroll_by(true, M - 1))
    for (int j = 1; j < M; ++j) acc = acc + a[o][j] * x0[j];
    w[o] = acc - b[r];
  }
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
#pragma unroll (unroll_by(true, M))
    for (int i = 0; i < M; ++i) {
      const int oi = i / G, li = i % G;  // row i's owner: lane li, its slot oi
      T lo_i = lo_r[oi], hi_i = hi_r[oi];
      const int f = findex[i];
      if (f >= 0) {
        T mine = x[0];
#pragma unroll (unroll_by(true, kN))
        for (int o = 1; o < kN; ++o)
          if (o == f / G) mine = x[o];
        const T f_hi = fs_r[oi] * pmax(g.bcast(mine, f % G), T(0));
        lo_i = -f_hi;
        hi_i = f_hi;
      }
      const T xi = nclip(x[oi] - w[oi] * inv_diag[oi], lo_i, hi_i);
      const T delta = g.bcast(xi - x[oi], li);
      if (g.lane == li) x[oi] = xi;
#pragma unroll (unroll_by(true, kN))
      for (int o = 0; o < kN; ++o) w[o] = w[o] + a[o][i] * delta;
    }
  }
#pragma unroll (unroll_by(true, kN))
  for (int o = 0; o < kN; ++o)
    if (g.lane + G * o < M) out[g.lane + G * o] = x[o];
}

#ifdef __CUDACC__
template <typename T, int M, int G>
__global__ void pgs_group_kernel(long long n, int iters, const T* __restrict__ A,
                                 const T* __restrict__ b, const T* __restrict__ lo,
                                 const T* __restrict__ hi, const T* __restrict__ fs,
                                 const T* __restrict__ x0, const int* __restrict__ findex,
                                 T* __restrict__ out) {
  const long long l = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (l >= n) return;  // a whole group leaves: its lanes' mask holds only them
  pgs_group<T, M, G>(warp_group<G>(), A + l * M * M, b + l * M, lo + l * M, hi + l * M,
                     fs + l * M, x0 + l * M, findex, iters, out + l * M);
}

// K7: one lane group of kK7Group per LCP, 128 threads per block.
template <typename T, int M>
static int launch_pgs(long long n, int iters, const void* A, const void* b, const void* lo,
                      const void* hi, const void* fs, const void* x0, const void* findex,
                      void* out, cudaStream_t stream) {
  constexpr int G = kK7Group, threads = 128;
  const long long blocks = (n * G + threads - 1) / threads;
  pgs_group_kernel<T, M, G><<<(unsigned)blocks, threads, 0, stream>>>(
      n, iters, (const T*)A, (const T*)b, (const T*)lo, (const T*)hi, (const T*)fs, (const T*)x0,
      (const int*)findex, (T*)out);
  return (int)cudaGetLastError();
}
#endif

}  // namespace nptt

#ifdef __CUDACC__
// Returns 0, a cudaError_t, or -1 for a (dtype, m) without an instance.
// A (n, m, m), b/lo/hi/fs/x0/out (n, m), findex (m,) int32.
extern "C" int nptt_pgs(int is_double, int m, long long n, int iters, const void* A, const void* b,
                        const void* lo, const void* hi, const void* fs, const void* x0,
                        const void* findex, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 0) return 0;
#define NPTT_PGS_CASE(M)                                                                       \
  if (m == M)                                                                                  \
    return is_double ? nptt::launch_pgs<double, M>(n, iters, A, b, lo, hi, fs, x0, findex, out, s) \
                     : nptt::launch_pgs<float, M>(n, iters, A, b, lo, hi, fs, x0, findex, out, s);
  NPTT_PGS_SIZES(NPTT_PGS_CASE)
#undef NPTT_PGS_CASE
  return -1;
}
#endif

#ifdef __CUDACC__
extern "C" int nptt_pgs_wide_group_shape(int is_double, int m, long long* out);

// The layout of K7's instance that runs at m rows: out = (lanes per group,
// groups per block, shared bytes per block); lcp_wide.cu's for its sizes;
// -1 without an instance.
extern "C" int nptt_pgs_group_shape(int is_double, int m, long long* out) {
#define NPTT_PGS_SHAPE(M)             \
  if (m == M) {                       \
    out[0] = nptt::kK7Group;          \
    out[1] = 128 / nptt::kK7Group;    \
    out[2] = 0;                       \
    return 0;                         \
  }
  NPTT_PGS_SIZES(NPTT_PGS_SHAPE)
#undef NPTT_PGS_SHAPE
  return nptt_pgs_wide_group_shape(is_double, m, out);
}
#endif
