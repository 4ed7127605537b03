// K7 for wide LCPs: batched boxed-LCP projected Gauss-Seidel with friction
// coupling, A in shared memory.
//
// Replaces nimblephysics_tpu/ops/pallas_lcp.py :: pallas_pgs_batched at the
// LCP sizes too wide for csrc/lcp.cu's register body: the catapult's 41
// contact slots (25 box/box, 8 and 8 box/floor) and 3 limited tails give
// m = 129 rows. It computes what lcp.cu's pgs_group computes (ops/lcp.py
// pgs_solve for every LCP of the batch) by the same algorithm: one group
// of 32 lanes (one warp) per LCP, lane l owning rows r = l + 32 o, the
// residual w = A x - b kept current; for row i its owner clips x_i (a
// friction row fetches x_f from its owner by one shuffle), broadcasts
// delta = x_i' - x_i (one shuffle), and every lane updates w_r += A(r, i)
// delta.
//
// What changes is where A lives. lcp.cu keeps a lane's rows of A in
// registers, a[kN][M]: at M = 129 that is 5 rows of 129 values, 645
// registers a lane against the card's 255. Here each block (one warp, one
// LCP) stages its A row-major in dynamic shared memory once, by coalesced
// loads, with findex beside it: 129^2 x 4 B = 66,564 B in f32 (3 LCPs per
// SM), 133,128 B in f64 (1 per SM), above the 48 KiB a launch gets
// without cudaFuncSetAttribute's opt-in. With M = 129 = 1 (mod 32), the
// lanes reading column i of their rows, A(l + 32 o, i), hit 32 distinct
// banks in f32 and two wavefronts, the least, in f64: no transpose. x, w,
// 1 / A_rr, lo, hi and fscale of the lane's <= 5 rows stay in registers.
//
// The row loop is split into the slot o (unrolled, so the lane's arrays
// keep compile-time indices and stay in registers) and the lane within it
// (rolled: #pragma unroll 1 over a compile-time trip count); the sweeps
// never unroll. Each LCP is a dependent chain of iters x M row updates of
// two shuffles each, and at most 3 LCPs share an SM: the kernel is
// latency-bound far above its bound (PERF.md section 6).
//
// pgs_wide, the body, takes the staged A as a pointer and is NPTT_HD: the
// host build of tests/test_torch_pgs_wide.py runs it on one host thread
// per lane against pgs_solve.
#include "lane_group.cuh"

// The LCP sizes this body is built for; the wrapper routes every m above
// one row per lane here and refuses sizes without an instance. The
// catapult: 41 contact slots of 3 rows and 3 limited dofs, 129 rows.
#define NPTT_PGS_WIDE_SIZES(X) X(129)

namespace nptt {

// One warp per LCP and per block.
constexpr int kK7WideGroup = 32;

template <typename T, int M>
constexpr long long pgs_wide_shared_bytes() {
  return (long long)M * M * sizeof(T) + (long long)M * sizeof(int);
}

// K7's wide body for one LCP on a lane group of G: As its A (M x M,
// row-major; shared memory on the card), fi its findex, b, lo, hi, fs, x0
// and out its vectors.
template <typename T, int M, int G, class Grp>
NPTT_HD void pgs_wide(const Grp& g, const T* __restrict__ As, const int* __restrict__ fi,
                      const T* __restrict__ b, const T* __restrict__ lo,
                      const T* __restrict__ hi, const T* __restrict__ fs,
                      const T* __restrict__ x0, int iters, T* __restrict__ out) {
  constexpr int kN = (M + G - 1) / G;
  T x[kN], w[kN], inv_diag[kN], lo_r[kN], hi_r[kN], fs_r[kN];
#pragma unroll (unroll_by(true, kN))
  for (int o = 0; o < kN; ++o) {
    const int r = g.lane + G * o;
    x[o] = w[o] = inv_diag[o] = lo_r[o] = hi_r[o] = fs_r[o] = T(0);
    if (r >= M) continue;
    x[o] = x0[r];
    lo_r[o] = lo[r];
    hi_r[o] = hi[r];
    fs_r[o] = fs[r];
    const T d = As[r * M + r];
    const T id = T(1) / d;
    inv_diag[o] = nabs(d) > T(1e-12) ? id : T(0);
    T acc = As[r * M] * x0[0];
#pragma unroll 1
    for (int j = 1; j < M; ++j) acc = acc + As[r * M + j] * x0[j];
    w[o] = acc - b[r];
  }
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
#pragma unroll (unroll_by(true, kN))
    for (int o = 0; o < kN; ++o) {
      // the rows i = G o + li of slot o, owned by lane li
#pragma unroll 1
      for (int li = 0; li < G; ++li) {
        const int i = G * o + li;
        if (i >= M) break;  // the last slot's rows end early, on every lane alike
        T lo_i = lo_r[o], hi_i = hi_r[o];
        const int f = fi[i];
        if (f >= 0) {
          T mine = x[0];
#pragma unroll (unroll_by(true, kN - 1))
          for (int oo = 1; oo < kN; ++oo)
            if (oo == f / G) mine = x[oo];
          const T f_hi = fs_r[o] * pmax(g.bcast(mine, f % G), T(0));
          lo_i = -f_hi;
          hi_i = f_hi;
        }
        const T xi = nclip(x[o] - w[o] * inv_diag[o], lo_i, hi_i);
        const T delta = g.bcast(xi - x[o], li);
        if (g.lane == li) x[o] = xi;
#pragma unroll (unroll_by(true, kN))
        for (int oo = 0; oo < kN; ++oo)
          if (oo < kN - 1 || g.lane + G * oo < M)
            w[oo] = w[oo] + As[(g.lane + G * oo) * M + i] * delta;
      }
    }
  }
#pragma unroll (unroll_by(true, kN))
  for (int o = 0; o < kN; ++o)
    if (g.lane + G * o < M) out[g.lane + G * o] = x[o];
}

#ifdef __CUDACC__
template <typename T, int M>
__global__ void __launch_bounds__(kK7WideGroup)
pgs_wide_kernel(int iters, const T* __restrict__ A, const T* __restrict__ b,
                const T* __restrict__ lo, const T* __restrict__ hi, const T* __restrict__ fs,
                const T* __restrict__ x0, const int* __restrict__ findex, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);
  int* fi = reinterpret_cast<int*>(As + M * M);
  const long long l = blockIdx.x;
  const T* A_l = A + l * M * M;
  for (int k = threadIdx.x; k < M * M; k += kK7WideGroup) As[k] = A_l[k];
  for (int k = threadIdx.x; k < M; k += kK7WideGroup) fi[k] = findex[k];
  __syncwarp();
  pgs_wide<T, M, kK7WideGroup>(warp_group<kK7WideGroup>(), As, fi, b + l * M, lo + l * M,
                               hi + l * M, fs + l * M, x0 + l * M, iters, out + l * M);
}

// One block of one warp per LCP, A and findex in dynamic shared memory
// (raised past the default 48 KiB first: without it the launch is refused
// and cudaGetLastError reports it).
template <typename T, int M>
static int launch_pgs_wide(long long n, int iters, const void* A, const void* b,
                           const void* lo, const void* hi, const void* fs, const void* x0,
                           const void* findex, void* out, cudaStream_t stream) {
  constexpr long long bytes = pgs_wide_shared_bytes<T, M>();
  cudaError_t err = cudaFuncSetAttribute(pgs_wide_kernel<T, M>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  if (n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  pgs_wide_kernel<T, M><<<(unsigned)n, kK7WideGroup, (size_t)bytes, stream>>>(
      iters, (const T*)A, (const T*)b, (const T*)lo, (const T*)hi, (const T*)fs, (const T*)x0,
      (const int*)findex, (T*)out);
  return (int)cudaGetLastError();
}
#endif

}  // namespace nptt

#ifdef __CUDACC__
// Returns 0, a cudaError_t, or -1 for a (dtype, m) without an instance.
// A (n, m, m), b/lo/hi/fs/x0/out (n, m), findex (m,) int32.
extern "C" int nptt_pgs_wide(int is_double, int m, long long n, int iters, const void* A,
                             const void* b, const void* lo, const void* hi, const void* fs,
                             const void* x0, const void* findex, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define NPTT_PGS_WIDE_CASE(M)                                                                  \
  if (m == M) {                                                                                \
    if (n == 0) return 0;                                                                      \
    return is_double                                                                           \
               ? nptt::launch_pgs_wide<double, M>(n, iters, A, b, lo, hi, fs, x0, findex, out, \
                                                  s)                                           \
               : nptt::launch_pgs_wide<float, M>(n, iters, A, b, lo, hi, fs, x0, findex, out,  \
                                                 s);                                           \
  }
  NPTT_PGS_WIDE_SIZES(NPTT_PGS_WIDE_CASE)
#undef NPTT_PGS_WIDE_CASE
  return -1;
}

// The wide instance's layout at m: out = (lanes per LCP, LCPs per block,
// shared bytes per block); -1 without an instance.
extern "C" int nptt_pgs_wide_group_shape(int is_double, int m, long long* out) {
#define NPTT_PGS_WIDE_SHAPE(M)                                                             \
  if (m == M) {                                                                            \
    out[0] = nptt::kK7WideGroup;                                                           \
    out[1] = 1;                                                                            \
    out[2] = is_double ? nptt::pgs_wide_shared_bytes<double, M>()                          \
                       : nptt::pgs_wide_shared_bytes<float, M>();                          \
    return 0;                                                                              \
  }
  NPTT_PGS_WIDE_SIZES(NPTT_PGS_WIDE_SHAPE)
#undef NPTT_PGS_WIDE_SHAPE
  return -1;
}
#endif
