// K2: closed-loop line-search rollouts for every (alpha, world) pair, and
// K6: the full-LCP class rollout of the contact replan.
//
// K2 replaces nimblephysics_tpu/ops/pallas_rollout.py :: rollout_gains_pallas
// (kernel _rollout_kernel), which put (alpha, world) pairs on the TPU's
// lanes and traced the cost callable into the kernel. With frozen classes
// (M > 0 rows, NS of them contact slots) its step is step.cuh's
// frozen_step, whose PCG runs n_cg iterations, the class masks of step t
// read from cm and us (B, T, M).
//
// Bound on this card: arithmetic, then latency. Each pair runs T dependent
// steps of the device step, a few hundred flops each, and moves (x, u) out
// once per step. Design: one thread per (alpha, world), x carried in
// registers through the T steps; each step applies
// u = clip(u_ref + alpha k + K (x - x_ref)), adds the running cost, and
// runs the device step of step.cuh; the terminal cost is added at the end.
// The cost is data, not code: diagonal weights on q, v and u for the running
// cost and on x for the final cost, each about its target state
// (trajectory/costs.py): w = [wq | wv | wu | wx | x_goal running | x_goal
// final].
//
// Least work per call (chip_smoke.py least_work): each input read once and
// (xs, us, costs) written once; per (alpha, world, t) the control law, the
// running cost and one plain step (ops/device_step.py step_ops, or
// frozen_step_ops with classes), and the final cost per (alpha, world).
//
// Where the rows stay rolled (step.cuh group_layout: the jump worm's
// m = 28) one thread per pair is latency-bound: 8,192 threads in 64 blocks
// walk a 28-row Qf in local memory 24 times per step (PERF.md section 6).
// There K2 runs one lane group of kK2Group lanes per (alpha, world)
// instead (frozen_group.cuh): every lane carries x and applies the control
// law and the running cost, the lanes share the frozen step's rows and its
// Qf in shared memory, and lanes 0 .. nx - 1 (na - 1) write xs (us).
//
// K6 replaces rollout_classes_pallas (kernel _classes_kernel), which ran
// the T-step scan of the full constrained step with the worlds on lanes
// and the state carried in VMEM across time chunks. Bound on this card:
// arithmetic (the LCP's three normal-equation rounds and eight PGS sweeps
// per step); one thread per world carries x through the T steps in
// registers, reads u packed (T, NA, B) and writes (x', cmask) packed
// (T, NX + M, B), so neighbouring threads touch neighbouring addresses.
// Least work (chip_smoke.py least_work): u and x0 read, (xs, cmask)
// written once, one class_step per (world, t) (ops/device_step.py
// class_step_ops).
#include "frozen_group.cuh"

namespace nptt {

template <typename T, int NB, int NQ, int NA, int M, int NS>
NPTT_HD void rollout_thread(long long l, long long B, int Tn, int n_cg, const T* __restrict__ P,
                            const int* __restrict__ I, const T* __restrict__ w,
                            const T* __restrict__ x0, const T* __restrict__ xs_ref,
                            const T* __restrict__ u_ref, const T* __restrict__ K,
                            const T* __restrict__ k, const T* __restrict__ alphas,
                            const T* __restrict__ cm, const T* __restrict__ ucl,
                            T* __restrict__ xs, T* __restrict__ us, T* __restrict__ costs) {
  using L = StepLayout<NB, NQ, NA>;
  constexpr int NX = 2 * NQ;
  const long long a = l / B, b = l % B;
  const T alpha = alphas[a];
  const T* wq = w;
  const T* wv = w + NQ;
  const T* wu = w + 2 * NQ;
  const T* wf = w + 2 * NQ + NA;
  const T* gr = wf + NX;
  const T* gf = gr + NX;
  T x[NX];
#pragma unroll (unroll_by(L::kUnroll, NX))
  for (int i = 0; i < NX; ++i) {
    x[i] = x0[b * NX + i];
    xs[l * (Tn + 1) * NX + i] = x[i];
  }
  T cost = T(0);
  for (int t = 0; t < Tn; ++t) {
    const long long bt = b * Tn + t;
    T dx[NX], u[NA];
#pragma unroll (unroll_by(L::kUnroll, NX))
    for (int i = 0; i < NX; ++i) dx[i] = x[i] - xs_ref[(b * (Tn + 1) + t) * NX + i];
#pragma unroll (unroll_by(L::kUnroll, NA))
    for (int j = 0; j < NA; ++j) {
      T Kdx = T(0);
#pragma unroll (unroll_by(L::kUnroll, NX))
      for (int i = 0; i < NX; ++i) Kdx = Kdx + K[(bt * NA + j) * NX + i] * dx[i];
      T uj = u_ref[bt * NA + j] + (alpha * k[bt * NA + j] + Kdx);
      const T lo = P[L::kAct + 2 * j], hi = P[L::kAct + 2 * j + 1];
      uj = uj < lo ? lo : (uj > hi ? hi : uj);  // NaN passes through, as in clip
      u[j] = uj;
      us[(l * Tn + t) * NA + j] = uj;
    }
    T cq = T(0), cv = T(0), cu = T(0);
#pragma unroll (unroll_by(L::kUnroll, NQ))
    for (int i = 0; i < NQ; ++i) {
      const T dq = x[i] - gr[i], dv = x[NQ + i] - gr[NQ + i];
      cq = cq + wq[i] * (dq * dq);
      cv = cv + wv[i] * (dv * dv);
    }
#pragma unroll (unroll_by(L::kUnroll, NA))
    for (int j = 0; j < NA; ++j) cu = cu + wu[j] * (u[j] * u[j]);
    cost = cost + (cq + cv + cu);
    T qn[NQ], vn[NQ];
    if constexpr (M == 0)
      device_step<T, T, NB, NQ, NA>(P, I, x, x + NQ, u, qn, vn);
    else
      frozen_step<T, T, NB, NQ, NA, M, NS>(P, I, x, x + NQ, u, cm + bt * M, ucl + bt * M, n_cg,
                                           qn, vn);
#pragma unroll (unroll_by(L::kUnroll, NQ))
    for (int i = 0; i < NQ; ++i) {
      x[i] = qn[i];
      x[NQ + i] = vn[i];
    }
#pragma unroll (unroll_by(L::kUnroll, NX))
    for (int i = 0; i < NX; ++i) xs[(l * (Tn + 1) + t + 1) * NX + i] = x[i];
  }
  T cf = T(0);
#pragma unroll (unroll_by(L::kUnroll, NX))
  for (int i = 0; i < NX; ++i) {
    const T dx = x[i] - gf[i];
    cf = cf + wf[i] * (dx * dx);
  }
  costs[l] = cost + cf;
}

// K2 on a lane group (group_layout(M)): rollout_thread's pair l, the
// frozen step on the group (group_frozen_step).
template <typename T, int NB, int NQ, int NA, int M, int NS, int G, class Grp>
NPTT_HD void rollout_group(const Grp& g, FrozenShared<T, NB, NQ, M, 1>& sh, long long l,
                           long long B, int Tn, int n_cg, const T* __restrict__ P,
                           const int* __restrict__ I,
                           const T* __restrict__ w, const T* __restrict__ x0,
                           const T* __restrict__ xs_ref, const T* __restrict__ u_ref,
                           const T* __restrict__ K, const T* __restrict__ k,
                           const T* __restrict__ alphas, const T* __restrict__ cm,
                           const T* __restrict__ ucl, T* __restrict__ xs, T* __restrict__ us,
                           T* __restrict__ costs) {
  using L = StepLayout<NB, NQ, NA>;
  constexpr int NX = 2 * NQ;
  const long long a = l / B, b = l % B;
  const T alpha = alphas[a];
  const T* wq = w;
  const T* wv = w + NQ;
  const T* wu = w + 2 * NQ;
  const T* wf = w + 2 * NQ + NA;
  const T* gr = wf + NX;
  const T* gf = gr + NX;
  T x[NX];
#pragma unroll (unroll_by(true, NX))
  for (int i = 0; i < NX; ++i) {
    x[i] = x0[b * NX + i];
    if (i == g.lane) xs[l * (Tn + 1) * NX + i] = x[i];
  }
  T cost = T(0);
#pragma unroll 1
  for (int t = 0; t < Tn; ++t) {
    const long long bt = b * Tn + t;
    T dx[NX], u[NA];
#pragma unroll (unroll_by(true, NX))
    for (int i = 0; i < NX; ++i) dx[i] = x[i] - xs_ref[(b * (Tn + 1) + t) * NX + i];
#pragma unroll (unroll_by(true, NA))
    for (int j = 0; j < NA; ++j) {
      T Kdx = T(0);
#pragma unroll (unroll_by(true, NX))
      for (int i = 0; i < NX; ++i) Kdx = Kdx + K[(bt * NA + j) * NX + i] * dx[i];
      T uj = u_ref[bt * NA + j] + (alpha * k[bt * NA + j] + Kdx);
      const T lo = P[L::kAct + 2 * j], hi = P[L::kAct + 2 * j + 1];
      uj = uj < lo ? lo : (uj > hi ? hi : uj);  // NaN passes through, as in clip
      u[j] = uj;
      if (j == g.lane) us[(l * Tn + t) * NA + j] = uj;
    }
    T cq = T(0), cv = T(0), cu = T(0);
#pragma unroll (unroll_by(true, NQ))
    for (int i = 0; i < NQ; ++i) {
      const T dq = x[i] - gr[i], dv = x[NQ + i] - gr[NQ + i];
      cq = cq + wq[i] * (dq * dq);
      cv = cv + wv[i] * (dv * dv);
    }
#pragma unroll (unroll_by(true, NA))
    for (int j = 0; j < NA; ++j) cu = cu + wu[j] * (u[j] * u[j]);
    cost = cost + (cq + cv + cu);
    T qn[NQ], vn[NQ];
    group_frozen_step<T, NB, NQ, NA, M, NS, G>(g, sh, P, I, x, x + NQ, u, cm + bt * M,
                                               ucl + bt * M, n_cg, qn, vn);
#pragma unroll (unroll_by(true, NQ))
    for (int i = 0; i < NQ; ++i) {
      x[i] = qn[i];
      x[NQ + i] = vn[i];
    }
#pragma unroll (unroll_by(true, NX))
    for (int i = 0; i < NX; ++i)
      if (i == g.lane) xs[(l * (Tn + 1) + t + 1) * NX + i] = x[i];
  }
  T cf = T(0);
#pragma unroll (unroll_by(true, NX))
  for (int i = 0; i < NX; ++i) {
    const T dx = x[i] - gf[i];
    cf = cf + wf[i] * (dx * dx);
  }
  if (g.lane == 0) costs[l] = cost + cf;
}

template <typename T, int NB, int NQ, int NA, int M>
NPTT_HD void classes_thread(long long b, long long B, int Tn, const T* __restrict__ P,
                            const int* __restrict__ I, const T* __restrict__ x0,
                            const T* __restrict__ u_tb, T* __restrict__ out) {
  using L = StepLayout<NB, NQ, NA>;
  constexpr int NX = 2 * NQ, E = NX + M;
  T x[NX];
#pragma unroll (unroll_by(true, NX))
  for (int i = 0; i < NX; ++i) x[i] = x0[b * NX + i];
  for (int t = 0; t < Tn; ++t) {
    T u[NA], qn[NQ], vn[NQ], cm[M];
#pragma unroll (unroll_by(true, NA))
    for (int a = 0; a < NA; ++a) u[a] = u_tb[((long long)t * NA + a) * B + b];
    class_step<T, T, NB, NQ, NA, M>(P, I, x, x + NQ, u, qn, vn, cm);
#pragma unroll (unroll_by(true, NQ))
    for (int i = 0; i < NQ; ++i) {
      x[i] = qn[i];
      x[NQ + i] = vn[i];
    }
#pragma unroll (unroll_by(true, NX))
    for (int i = 0; i < NX; ++i) out[((long long)t * E + i) * B + b] = x[i];
#pragma unroll (row_unroll(M, M))
    for (int r = 0; r < M; ++r) out[((long long)t * E + NX + r) * B + b] = cm[r];
  }
}

#ifdef __CUDACC__
template <typename T, int NB, int NQ, int NA, int M, int NS>
__global__ void rollout_kernel(long long A, long long B, int Tn, int n_cg, const T* __restrict__ P,
                               const int* __restrict__ I, const T* __restrict__ w,
                               const T* __restrict__ x0, const T* __restrict__ xs_ref,
                               const T* __restrict__ u_ref, const T* __restrict__ K,
                               const T* __restrict__ k, const T* __restrict__ alphas,
                               const T* __restrict__ cm, const T* __restrict__ ucl,
                               T* __restrict__ xs, T* __restrict__ us, T* __restrict__ costs) {
  const long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (l < A * B)
    rollout_thread<T, NB, NQ, NA, M, NS>(l, B, Tn, n_cg, P, I, w, x0, xs_ref, u_ref, K, k, alphas,
                                         cm, ucl, xs, us, costs);
}

// K2 on lane groups: kGroupsPerBlock groups of G lanes per block, each
// with its FrozenShared in dynamic shared memory.
template <typename T, int NB, int NQ, int NA, int M, int NS, int G>
__global__ void rollout_group_kernel(long long A, long long B, int Tn, int n_cg,
                                     const T* __restrict__ P, const int* __restrict__ I,
                                     const T* __restrict__ w, const T* __restrict__ x0,
                                     const T* __restrict__ xs_ref, const T* __restrict__ u_ref,
                                     const T* __restrict__ K, const T* __restrict__ k,
                                     const T* __restrict__ alphas, const T* __restrict__ cm,
                                     const T* __restrict__ ucl, T* __restrict__ xs,
                                     T* __restrict__ us, T* __restrict__ costs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long l = (long long)blockIdx.x * kGroupsPerBlock + threadIdx.x / G;
  if (l >= A * B) return;  // a whole group leaves: its lanes' mask holds only them
  auto* sh = reinterpret_cast<FrozenShared<T, NB, NQ, M, 1>*>(smem) + threadIdx.x / G;
  rollout_group<T, NB, NQ, NA, M, NS, G>(warp_group<G>(), *sh, l, B, Tn, n_cg, P, I, w, x0,
                                         xs_ref, u_ref, K, k, alphas, cm, ucl, xs, us, costs);
}

template <typename T, int NB, int NQ, int NA, int M, int NS>
static int launch_rollout(long long A, long long B, int Tn, int n_cg, const void* P, const void* I,
                          const void* w, const void* x0, const void* xs_ref, const void* u_ref,
                          const void* K, const void* k, const void* alphas, const void* cm,
                          const void* ucl, void* xs, void* us, void* costs, cudaStream_t stream) {
  if constexpr (group_layout(M)) {
    constexpr int G = kK2Group;
    const size_t smem = kGroupsPerBlock * sizeof(FrozenShared<T, NB, NQ, M, 1>);
    auto kernel = rollout_group_kernel<T, NB, NQ, NA, M, NS, G>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    const long long blocks = (A * B + kGroupsPerBlock - 1) / kGroupsPerBlock;
    kernel<<<(unsigned)blocks, kGroupsPerBlock * G, smem, stream>>>(
        A, B, Tn, n_cg, (const T*)P, (const int*)I, (const T*)w, (const T*)x0, (const T*)xs_ref,
        (const T*)u_ref, (const T*)K, (const T*)k, (const T*)alphas, (const T*)cm, (const T*)ucl,
        (T*)xs, (T*)us, (T*)costs);
  } else {
    const int threads = 128;
    const long long blocks = (A * B + threads - 1) / threads;
    rollout_kernel<T, NB, NQ, NA, M, NS><<<(unsigned)blocks, threads, 0, stream>>>(
        A, B, Tn, n_cg, (const T*)P, (const int*)I, (const T*)w, (const T*)x0, (const T*)xs_ref,
        (const T*)u_ref, (const T*)K, (const T*)k, (const T*)alphas, (const T*)cm, (const T*)ucl,
        (T*)xs, (T*)us, (T*)costs);
  }
  return (int)cudaGetLastError();
}

template <typename T, int NB, int NQ, int NA, int M>
__global__ void classes_kernel(long long B, int Tn, const T* __restrict__ P,
                               const int* __restrict__ I, const T* __restrict__ x0,
                               const T* __restrict__ u_tb, T* __restrict__ out) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B) classes_thread<T, NB, NQ, NA, M>(b, B, Tn, P, I, x0, u_tb, out);
}

template <typename T, int NB, int NQ, int NA, int M>
static int launch_classes(long long B, int Tn, const void* P, const void* I, const void* x0,
                          const void* u_tb, void* out, cudaStream_t stream) {
  const int threads = 128;
  const long long blocks = (B + threads - 1) / threads;
  classes_kernel<T, NB, NQ, NA, M><<<(unsigned)blocks, threads, 0, stream>>>(
      B, Tn, (const T*)P, (const int*)I, (const T*)x0, (const T*)u_tb, (T*)out);
  return (int)cudaGetLastError();
}
#endif

}  // namespace nptt

#ifdef __CUDACC__
// Returns 0, a cudaError_t, or -1 for a (dtype, nb, nq, na, m, ns) without
// an instance. m = 0: the contact-free step; m > 0: the frozen step on the
// class masks cm and us (B, T, m).
extern "C" int nptt_rollout(int is_double, int nb, int nq, int na, int m, int ns, long long A,
                            long long B, int T, int n_cg, const void* P, const void* I,
                            const void* w, const void* x0, const void* xs_ref, const void* u_ref,
                            const void* K, const void* k, const void* alphas, const void* cm,
                            const void* ucl, void* xs, void* us, void* costs, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define NPTT_ROLLOUT_CALL(NB, NQ, NA, M, NS)                                                   \
  return is_double ? nptt::launch_rollout<double, NB, NQ, NA, M, NS>(                          \
                         A, B, T, n_cg, P, I, w, x0, xs_ref, u_ref, K, k, alphas, cm, ucl, xs, \
                         us, costs, s)                                                         \
                   : nptt::launch_rollout<float, NB, NQ, NA, M, NS>(                           \
                         A, B, T, n_cg, P, I, w, x0, xs_ref, u_ref, K, k, alphas, cm, ucl, xs, \
                         us, costs, s);
#define NPTT_ROLLOUT_FREE(NB, NQ, NA) \
  if (m == 0 && ns == 0 && nb == NB && nq == NQ && na == NA) NPTT_ROLLOUT_CALL(NB, NQ, NA, 0, 0)
#define NPTT_ROLLOUT_FROZEN(NB, NQ, NA, M, NS) \
  if (m == M && ns == NS && nb == NB && nq == NQ && na == NA) NPTT_ROLLOUT_CALL(NB, NQ, NA, M, NS)
  NPTT_STEP_SHAPES(NPTT_ROLLOUT_FREE)
  NPTT_CONTACT_SHAPES(NPTT_ROLLOUT_FROZEN)
  NPTT_WORM_SHAPES(NPTT_ROLLOUT_FROZEN)
#undef NPTT_ROLLOUT_FROZEN
#undef NPTT_ROLLOUT_FREE
#undef NPTT_ROLLOUT_CALL
  return -1;
}

// K2's lane-group layout at the worm's shape: out = (lanes per group,
// groups per block, shared bytes per block).
extern "C" int nptt_rollout_group_shape(int is_double, long long* out) {
#define NPTT_SHAPE(NB, NQ, NA, M, NS)                                                  \
  out[0] = nptt::kK2Group;                                                            \
  out[1] = nptt::kGroupsPerBlock;                                                     \
  out[2] = nptt::kGroupsPerBlock * (is_double ? sizeof(nptt::FrozenShared<double, NB, NQ, M, 1>) \
                                              : sizeof(nptt::FrozenShared<float, NB, NQ, M, 1>));
  NPTT_WORM_SHAPES(NPTT_SHAPE)
#undef NPTT_SHAPE
  return 0;
}

// K6. Returns 0, a cudaError_t, or -1 for a (dtype, nb, nq, na, m) without
// an instance. u_tb (T, na, B); out (T, 2 nq + m, B).
extern "C" int nptt_rollout_classes(int is_double, int nb, int nq, int na, int m, long long B,
                                    int T, const void* P, const void* I, const void* x0,
                                    const void* u_tb, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define NPTT_CLASSES_CASE(NB, NQ, NA, M, NS)                                                 \
  if (m == M && nb == NB && nq == NQ && na == NA)                                            \
    return is_double ? nptt::launch_classes<double, NB, NQ, NA, M>(B, T, P, I, x0, u_tb, out, s) \
                     : nptt::launch_classes<float, NB, NQ, NA, M>(B, T, P, I, x0, u_tb, out, s);
  NPTT_CONTACT_SHAPES(NPTT_CLASSES_CASE)
#undef NPTT_CLASSES_CASE
  return -1;
}
#endif
