// K2: closed-loop line-search rollouts for every (alpha, world) pair.
//
// Replaces nimblephysics_tpu/ops/pallas_rollout.py :: rollout_gains_pallas
// (kernel _rollout_kernel), which put (alpha, world) pairs on the TPU's
// lanes and traced the cost callable into the kernel.
//
// Bound on this card: arithmetic, then latency. Each pair runs T dependent
// steps of the device step, a few hundred flops each, and moves (x, u) out
// once per step. Design: one thread per (alpha, world), x carried in
// registers through the T steps; each step applies
// u = clip(u_ref + alpha k + K (x - x_ref)), adds the running cost, and
// runs the device step of step.cuh; the terminal cost is added at the end.
// The cost is data, not code: diagonal weights on q, v and u for the running
// cost and on x for the final cost (trajectory/costs.py).
//
// Least work per call (chip_smoke.py least_work): each input read once and
// (xs, us, costs) written once; per (alpha, world, t) the control law, the
// running cost and one plain step (ops/device_step.py step_ops), and the
// final cost per (alpha, world).
#include "step.cuh"

namespace nptt {

template <typename T, int NB, int NQ, int NA>
NPTT_HD void rollout_thread(long long l, long long B, int Tn, const T* __restrict__ P,
                            const int* __restrict__ I, const T* __restrict__ w,
                            const T* __restrict__ x0, const T* __restrict__ xs_ref,
                            const T* __restrict__ u_ref, const T* __restrict__ K,
                            const T* __restrict__ k, const T* __restrict__ alphas,
                            T* __restrict__ xs, T* __restrict__ us, T* __restrict__ costs) {
  using L = StepLayout<NB, NQ, NA>;
  constexpr int NX = 2 * NQ;
  const long long a = l / B, b = l % B;
  const T alpha = alphas[a];
  const T* wq = w;
  const T* wv = w + NQ;
  const T* wu = w + 2 * NQ;
  const T* wf = w + 2 * NQ + NA;
  T x[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    x[i] = x0[b * NX + i];
    xs[l * (Tn + 1) * NX + i] = x[i];
  }
  T cost = T(0);
  for (int t = 0; t < Tn; ++t) {
    const long long bt = b * Tn + t;
    T dx[NX], u[NA];
#pragma unroll
    for (int i = 0; i < NX; ++i) dx[i] = x[i] - xs_ref[(b * (Tn + 1) + t) * NX + i];
#pragma unroll
    for (int j = 0; j < NA; ++j) {
      T Kdx = T(0);
#pragma unroll
      for (int i = 0; i < NX; ++i) Kdx = Kdx + K[(bt * NA + j) * NX + i] * dx[i];
      T uj = u_ref[bt * NA + j] + (alpha * k[bt * NA + j] + Kdx);
      const T lo = P[L::kAct + 2 * j], hi = P[L::kAct + 2 * j + 1];
      uj = uj < lo ? lo : (uj > hi ? hi : uj);  // NaN passes through, as in clip
      u[j] = uj;
      us[(l * Tn + t) * NA + j] = uj;
    }
    T cq = T(0), cv = T(0), cu = T(0);
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      cq = cq + wq[i] * (x[i] * x[i]);
      cv = cv + wv[i] * (x[NQ + i] * x[NQ + i]);
    }
#pragma unroll
    for (int j = 0; j < NA; ++j) cu = cu + wu[j] * (u[j] * u[j]);
    cost = cost + (cq + cv + cu);
    T qn[NQ], vn[NQ];
    device_step<T, T, NB, NQ, NA>(P, I, x, x + NQ, u, qn, vn);
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      x[i] = qn[i];
      x[NQ + i] = vn[i];
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) xs[(l * (Tn + 1) + t + 1) * NX + i] = x[i];
  }
  T cf = T(0);
#pragma unroll
  for (int i = 0; i < NX; ++i) cf = cf + wf[i] * (x[i] * x[i]);
  costs[l] = cost + cf;
}

#ifdef __CUDACC__
template <typename T, int NB, int NQ, int NA>
__global__ void rollout_kernel(long long A, long long B, int Tn, const T* __restrict__ P,
                               const int* __restrict__ I, const T* __restrict__ w,
                               const T* __restrict__ x0, const T* __restrict__ xs_ref,
                               const T* __restrict__ u_ref, const T* __restrict__ K,
                               const T* __restrict__ k, const T* __restrict__ alphas,
                               T* __restrict__ xs, T* __restrict__ us, T* __restrict__ costs) {
  const long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (l < A * B)
    rollout_thread<T, NB, NQ, NA>(l, B, Tn, P, I, w, x0, xs_ref, u_ref, K, k, alphas, xs, us,
                                  costs);
}

template <typename T, int NB, int NQ, int NA>
static int launch_rollout(long long A, long long B, int Tn, const void* P, const void* I,
                          const void* w, const void* x0, const void* xs_ref, const void* u_ref,
                          const void* K, const void* k, const void* alphas, void* xs, void* us,
                          void* costs, cudaStream_t stream) {
  const int threads = 128;
  const long long blocks = (A * B + threads - 1) / threads;
  rollout_kernel<T, NB, NQ, NA><<<(unsigned)blocks, threads, 0, stream>>>(
      A, B, Tn, (const T*)P, (const int*)I, (const T*)w, (const T*)x0, (const T*)xs_ref,
      (const T*)u_ref, (const T*)K, (const T*)k, (const T*)alphas, (T*)xs, (T*)us, (T*)costs);
  return (int)cudaGetLastError();
}
#endif

}  // namespace nptt

#ifdef __CUDACC__
// Returns 0, a cudaError_t, or -1 for a (dtype, nb, nq, na) without an instance.
extern "C" int nptt_rollout(int is_double, int nb, int nq, int na, long long A, long long B, int T,
                            const void* P, const void* I, const void* w, const void* x0,
                            const void* xs_ref, const void* u_ref, const void* K, const void* k,
                            const void* alphas, void* xs, void* us, void* costs, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define NPTT_ROLLOUT_CASE(NB, NQ, NA)                                                        \
  if (nb == NB && nq == NQ && na == NA)                                                      \
    return is_double ? nptt::launch_rollout<double, NB, NQ, NA>(A, B, T, P, I, w, x0, xs_ref, \
                                                                 u_ref, K, k, alphas, xs, us, \
                                                                 costs, s)                    \
                     : nptt::launch_rollout<float, NB, NQ, NA>(A, B, T, P, I, w, x0, xs_ref,  \
                                                                u_ref, K, k, alphas, xs, us,  \
                                                                costs, s);
  NPTT_STEP_SHAPES(NPTT_ROLLOUT_CASE)
#undef NPTT_ROLLOUT_CASE
  return -1;
}
#endif
