// K2: closed-loop line-search rollouts for every (alpha, world) pair (K6,
// the full-LCP class rollout of the contact replan, is classes.cu).
//
// K2 replaces nimblephysics_tpu/ops/pallas_rollout.py :: rollout_gains_pallas
// (kernel _rollout_kernel), which put (alpha, world) pairs on the TPU's
// lanes and traced the cost callable into the kernel. With frozen classes
// (M > 0 rows, NS of them contact slots) its step is step.cuh's
// frozen_step, whose PCG runs n_cg iterations, the class masks of step t
// read from cm and us (B, T, M).
//
// Bound on this card: arithmetic, then latency. Each pair runs T dependent
// steps of the device step, a few thousand flops each, and moves (x, u)
// out once per step; the 6 x 2,048 pairs of the contact path fill one warp
// per scheduler at most, so each step's latency is the kernel's time (one
// alpha takes as long as six on an NVIDIA H100 80GB HBM3 at 700 W).
// Design: one thread per (alpha,
// world), the A alphas of a world on neighbouring lanes (their loads of
// the world's inputs are one broadcast), x carried in
// registers through the T steps, and no division of a zero on the frozen
// PCG's chain (common.cuh qdiv: the residual of a row that does not clamp
// stays zero, and the IEEE division of a zero takes its slow path, a
// call); each step applies
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
#include "frozen_group.cuh"

namespace nptt {

// K2's one-thread kernel (k2_lanes(m) == 0): its threads per block (32:
// the 384 warps of the contact path spread over every SM).
constexpr int kK2Threads = 32;

// Step t's inputs of one world: x_ref, K, k, u_ref and the class masks.
template <typename T, int NX, int NA, int M>
struct PairInputs {
  static constexpr int kM = M > 0 ? M : 1;
  T xr[NX], K[NA][NX], k[NA], ur[NA], cm[kM], us[kM];
  template <bool U>
  NPTT_HD void load(long long b, int Tn, int t, const T* __restrict__ xs_ref,
                    const T* __restrict__ u_ref, const T* __restrict__ Kg,
                    const T* __restrict__ kg, const T* __restrict__ cmg,
                    const T* __restrict__ ucl) {
    const long long bt = b * Tn + t;
#pragma unroll (unroll_by(U, NX))
    for (int i = 0; i < NX; ++i) xr[i] = xs_ref[(b * (Tn + 1) + t) * NX + i];
#pragma unroll (unroll_by(U, NA))
    for (int j = 0; j < NA; ++j) {
#pragma unroll (unroll_by(U, NX))
      for (int i = 0; i < NX; ++i) K[j][i] = Kg[(bt * NA + j) * NX + i];
      k[j] = kg[bt * NA + j];
      ur[j] = u_ref[bt * NA + j];
    }
    if constexpr (M > 0) {
#pragma unroll (row_unroll(M, M))
      for (int r = 0; r < M; ++r) {
        cm[r] = cmg[bt * M + r];
        us[r] = ucl[bt * M + r];
      }
    }
  }
};

// K2's one-thread body for pair l = a B + b; each step's inputs are loaded
// as the step starts.
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
    PairInputs<T, NX, NA, M> in;
    in.template load<L::kUnroll>(b, Tn, t, xs_ref, u_ref, K, k, cm, ucl);
    T dx[NX], u[NA];
#pragma unroll (unroll_by(L::kUnroll, NX))
    for (int i = 0; i < NX; ++i) dx[i] = x[i] - in.xr[i];
#pragma unroll (unroll_by(L::kUnroll, NA))
    for (int j = 0; j < NA; ++j) {
      T Kdx = T(0);
#pragma unroll (unroll_by(L::kUnroll, NX))
      for (int i = 0; i < NX; ++i) Kdx = Kdx + in.K[j][i] * dx[i];
      T uj = in.ur[j] + (alpha * in.k[j] + Kdx);
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
      frozen_step<T, T, NB, NQ, NA, M, NS>(P, I, x, x + NQ, u, in.cm, in.us, n_cg, qn, vn);
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

#ifdef __CUDACC__
template <typename T, int NB, int NQ, int NA, int M, int NS>
__global__ void rollout_kernel(long long A, long long B, int Tn, int n_cg, const T* __restrict__ P,
                               const int* __restrict__ I, const T* __restrict__ w,
                               const T* __restrict__ x0, const T* __restrict__ xs_ref,
                               const T* __restrict__ u_ref, const T* __restrict__ K,
                               const T* __restrict__ k, const T* __restrict__ alphas,
                               const T* __restrict__ cm, const T* __restrict__ ucl,
                               T* __restrict__ xs, T* __restrict__ us, T* __restrict__ costs) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long l = (tid % A) * B + tid / A;  // a world's alphas on neighbouring lanes
  if (tid < A * B)
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
  if constexpr (k2_lanes(M) > 0) {
    constexpr int G = k2_lanes(M);
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
    const int threads = kK2Threads;
    const long long blocks = (A * B + threads - 1) / threads;
    rollout_kernel<T, NB, NQ, NA, M, NS><<<(unsigned)blocks, threads, 0, stream>>>(
        A, B, Tn, n_cg, (const T*)P, (const int*)I, (const T*)w, (const T*)x0, (const T*)xs_ref,
        (const T*)u_ref, (const T*)K, (const T*)k, (const T*)alphas, (const T*)cm, (const T*)ucl,
        (T*)xs, (T*)us, (T*)costs);
  }
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

namespace nptt {
// K2's layout at an instance: (lanes per group, 0 for one thread per
// (alpha, world); groups or threads per block; shared bytes per block).
template <typename T, int NB, int NQ, int M>
void rollout_layout(long long* out) {
  constexpr int G = k2_lanes(M);
  out[0] = G;
  if constexpr (G > 0) {
    out[1] = kGroupsPerBlock;
    out[2] = kGroupsPerBlock * sizeof(FrozenShared<T, NB, NQ, M, 1>);
  } else {
    out[1] = kK2Threads;
    out[2] = 0;
  }
}
}  // namespace nptt

// K2's layout (nptt::rollout_layout) at the instance with m rows (0:
// without classes); -1 for an m without an instance.
extern "C" int nptt_rollout_layout(int is_double, int m, long long* out) {
#define NPTT_LAYOUT(NB, NQ, NA, M, NS)                                            \
  if (m == M) {                                                                  \
    if (is_double)                                                               \
      nptt::rollout_layout<double, NB, NQ, M>(out);                              \
    else                                                                         \
      nptt::rollout_layout<float, NB, NQ, M>(out);                               \
    return 0;                                                                    \
  }
#define NPTT_LAYOUT_FREE(NB, NQ, NA) NPTT_LAYOUT(NB, NQ, NA, 0, 0)
  NPTT_STEP_SHAPES(NPTT_LAYOUT_FREE)
  NPTT_CONTACT_SHAPES(NPTT_LAYOUT)
  NPTT_WORM_SHAPES(NPTT_LAYOUT)
#undef NPTT_LAYOUT_FREE
#undef NPTT_LAYOUT
  return -1;
}

#endif
