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
// updates, and its matrix (m * m values, 3.1 KB in f32 at m = 28) is read
// iters times. Design: one thread per LCP; a block of NT threads first
// copies its NT matrices (contiguous in the (N, m, m) input) into shared
// memory, coalesced, laid out [row][column][thread] so that the threads of
// a warp read neighbouring words (no bank conflicts); x and the row data
// stay in registers through all sweeps, with the rows unrolled (m is a
// template constant), and the dot product is summed in row order like
// pgs_solve. findex is data (same for every thread); the coupled normal
// impulse is picked from the register array by an unrolled select. NT is
// set so that the block's matrices fill about 200 KB of shared memory (64
// LCPs in f32, 32 in f64 at m = 28): one block per SM.
//
// Least work per call (chip_smoke.py): (A, b, lo, hi, fscale, x0, findex)
// read and x written once; per LCP and sweep, m dot products of length m
// and the row update (pgs_sweep_ops in chip_smoke.py).
#include "common.cuh"

// The LCP sizes the kernel is built for; the wrapper refuses any other.
// The jump worm: 8 contact slots and 2 limited dofs, 28 rows.
#define NPTT_PGS_SIZES(X) X(28)

namespace nptt {

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

#ifdef __CUDACC__
template <typename T> struct PgsBlock;
template <> struct PgsBlock<float> { static constexpr int kThreads = 64; };
template <> struct PgsBlock<double> { static constexpr int kThreads = 32; };

template <typename T, int M>
__global__ void pgs_kernel(long long n, int iters, const T* __restrict__ A,
                           const T* __restrict__ b, const T* __restrict__ lo,
                           const T* __restrict__ hi, const T* __restrict__ fs,
                           const T* __restrict__ x0, const int* __restrict__ findex,
                           T* __restrict__ out) {
  constexpr int NT = PgsBlock<T>::kThreads, MM = M * M;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);
  const long long first = (long long)blockIdx.x * NT;
  const int n_here = (int)(n - first < NT ? n - first : NT);
  const T* Ab = A + first * MM;
  for (int idx = threadIdx.x; idx < n_here * MM; idx += NT) {
    const int l = idx / MM, e = idx % MM;
    As[e * NT + l] = Ab[idx];
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t >= n_here) return;
  const long long g = first + t;
  pgs_lcp<T, M>(As + t, NT, b + g * M, lo + g * M, hi + g * M, fs + g * M, x0 + g * M, findex,
                iters, out + g * M);
}

template <typename T, int M>
static int launch_pgs(long long n, int iters, const void* A, const void* b, const void* lo,
                      const void* hi, const void* fs, const void* x0, const void* findex,
                      void* out, cudaStream_t stream) {
  constexpr int NT = PgsBlock<T>::kThreads;
  const size_t smem = sizeof(T) * NT * M * M;
  cudaError_t err = cudaFuncSetAttribute(pgs_kernel<T, M>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n + NT - 1) / NT;
  pgs_kernel<T, M><<<(unsigned)blocks, NT, smem, stream>>>(
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
