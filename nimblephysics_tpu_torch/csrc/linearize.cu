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
#include "step.cuh"

namespace nptt {

template <typename T, int NB, int NQ, int NA>
NPTT_HD void linearize_thread(long long tid, const T* __restrict__ P, const int* __restrict__ I,
                              const T* __restrict__ xs, const T* __restrict__ u,
                              T* __restrict__ fx, T* __restrict__ fu) {
  constexpr int NX = 2 * NQ, K = NX + NA;
  const long long n = tid / K;
  const int k = (int)(tid % K);
  Dual<T> q[NQ], v[NQ], ua[NA], qn[NQ], vn[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    q[i] = Dual<T>(xs[n * NX + i], T(k == i ? 1 : 0));
    v[i] = Dual<T>(xs[n * NX + NQ + i], T(k == NQ + i ? 1 : 0));
  }
#pragma unroll
  for (int a = 0; a < NA; ++a) ua[a] = Dual<T>(u[n * NA + a], T(k == NX + a ? 1 : 0));
  device_step<T, Dual<T>, NB, NQ, NA>(P, I, q, v, ua, qn, vn);
  if (k < NX) {
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      fx[(n * NX + i) * NX + k] = qn[i].d;
      fx[(n * NX + NQ + i) * NX + k] = vn[i].d;
    }
  } else {
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      fu[(n * NX + i) * NA + (k - NX)] = qn[i].d;
      fu[(n * NX + NQ + i) * NA + (k - NX)] = vn[i].d;
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
