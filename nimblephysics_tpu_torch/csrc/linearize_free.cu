// K3: (fx, fu) = d step / d(x, u) at every point of a batch of trajectories
// (the contact-free step; K3 with classes= runs K4's kernel, linearize.cu).
//
// Replaces nimblephysics_tpu/ops/pallas_linearize.py :: linearize_pallas,
// which folded the nx + na basis directions of a JVP into the TPU's lane
// batch and evaluated the traced step with ops/lanevmap.py.
//
// Bound on this card: arithmetic. Each (point, direction) pair runs one
// forward-mode step (a few thousand flops) and moves only nx + na values
// in and nx values out.
//
// Design: one thread per (point, direction), the threads of a block taking
// one direction for kK3Threads neighbouring points, the blocks of the
// directions of q first, then those of v, then those of u, so that the
// direction's kind is uniform in a block and an SM runs mostly one kind's
// code at a time. The thread runs the device step of step.cuh seeded with
// its basis direction, on Dual<T> only where the direction moves it
// (forward_dynamics_impl's three scalar types):
//   * a direction of q: all of it on Dual<T>;
//   * a direction of v: the transforms and articulated inertias plain, the
//     velocities, their bias terms and the forces on Dual<T>;
//   * a direction of u: the velocities plain too, only the forces on
//     Dual<T>.
// So no thread carries a tangent that is zero by construction. One thread
// per point running the directions in turn, with the transforms and
// inertias of the first direction of q passed to those of v and u through
// shared memory (the primal's q-only values once per point), spilled to
// 1,760 bytes of stack and ran 1.7 ms against 0.92 for this layout in f32
// on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6); one warp per
// direction of 32 points, five warps a block at 255 registers, fitted one
// block (5 warps) per SM and ran 1.49 ms even under the plain unroll below.
//
// Every loop of this file's instances unrolls under a plain #pragma unroll
// (NPTT_PLAIN_UNROLL, common.cuh): each has a compile-time trip count, and
// the counted pragma of the shared step left the dual step's arrays in
// local memory (0.92 against 0.54 ms, PERF.md section 6).
//
// Least work per call (chip_smoke.py least_work): (xs, u) read and (fx, fu)
// written once; per point one plain step and each direction's tangent
// alone (ops/device_step.py k3_least_ops: 12,841 operations on the
// cartpole, against 23,793 for one plain step and nx + na whole
// tangents). The kernel recomputes the step's values in each direction's
// thread (k3_point_op_kinds: 22,369).
#define NPTT_PLAIN_UNROLL
#include "step.cuh"

namespace nptt {

// the points of a block, all of one direction
constexpr int kK3Threads = 128;

template <typename S>
struct is_dual : std::false_type {};
template <typename R>
struct is_dual<Dual<R>> : std::true_type {};

// x as S: with tangent 1 where on, on Dual; plain otherwise
template <typename S, typename R>
NPTT_HD S seeded(R x, bool on) {
  if constexpr (is_dual<S>::value)
    return S(x, on ? R(1.0) : R(0.0));
  else
    return x;
}

// Column k of (fx, fu) at one point x (nx), ua (na): the step with the
// inputs the direction moves on Dual<R> and, by its kind, q (SQ) and v
// (SV) plain where it leaves them fixed.
template <typename T, typename R, typename SQ, typename SV, int NB, int NQ, int NA>
NPTT_HD void linearize_direction(int k, const T* __restrict__ P, const int* __restrict__ I,
                                 const T* x, const T* ua, R* col) {
  using L = StepLayout<NB, NQ, NA>;
  using D = Dual<R>;
  constexpr int NX = 2 * NQ;
  SQ q[NQ], Rb[NB][9], pb[NB][3];
  SV v[NQ];
  D uu[NA], qdd[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    q[i] = seeded<SQ>(R(x[i]), k == i);
    v[i] = seeded<SV>(R(x[NQ + i]), k == NQ + i);
  }
#pragma unroll
  for (int a = 0; a < NA; ++a) uu[a] = seeded<D>(R(ua[a]), k == NX + a);
  forward_dynamics_impl<T, SQ, SV, D, NB, NQ, NA, L::kUnroll, false>(nullptr, P, I, q, v, uu, Rb,
                                                                      pb, qdd);
  const T dt = P[L::kDt];
  // (q', v') = (q + v dt, v + dt qdd), as device_step; q' moves with q and v only
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    if constexpr (is_dual<SV>::value)
      col[i] = (q[i] + v[i] * dt).d;
    else
      col[i] = R(T(0));
    col[NQ + i] = (v[i] + dt * qdd[i]).d;
  }
}

// The thread of (point n, direction k): column k of (fx, fu) at point n.
template <typename T, typename R, int NB, int NQ, int NA>
NPTT_HD void linearize_dir(long long n, int k, const T* __restrict__ P, const int* __restrict__ I,
                           const T* __restrict__ xs, const T* __restrict__ u, R* __restrict__ fx,
                           R* __restrict__ fu) {
  using D = Dual<R>;
  constexpr int NX = 2 * NQ;
  R col[NX];
  if (k < NQ)
    linearize_direction<T, R, D, D, NB, NQ, NA>(k, P, I, xs + n * NX, u + n * NA, col);
  else if (k < NX)
    linearize_direction<T, R, R, D, NB, NQ, NA>(k, P, I, xs + n * NX, u + n * NA, col);
  else
    linearize_direction<T, R, R, R, NB, NQ, NA>(k, P, I, xs + n * NX, u + n * NA, col);
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    if (k < NX)
      fx[(n * NX + i) * NX + k] = col[i];
    else
      fu[(n * NX + i) * NA + (k - NX)] = col[i];
  }
}

#ifdef __CUDACC__
// blocks_per_dir blocks of kK3Threads points per direction, the directions
// of q first, then those of v, then those of u
template <typename T, int NB, int NQ, int NA>
__global__ void linearize_dir_kernel(long long n_points, long long blocks_per_dir,
                                     const T* __restrict__ P, const int* __restrict__ I,
                                     const T* __restrict__ xs, const T* __restrict__ u,
                                     T* __restrict__ fx, T* __restrict__ fu) {
  const int k = (int)(blockIdx.x / blocks_per_dir);
  const long long n = (long long)(blockIdx.x % blocks_per_dir) * kK3Threads + threadIdx.x;
  if (n < n_points) linearize_dir<T, T, NB, NQ, NA>(n, k, P, I, xs, u, fx, fu);
}

template <typename T, int NB, int NQ, int NA>
static int launch_linearize(long long n_points, const void* P, const void* I, const void* xs,
                            const void* u, void* fx, void* fu, cudaStream_t stream) {
  static_assert(StepLayout<NB, NQ, NA>::kUnroll,
                "K3's loops unroll under a plain #pragma unroll: small models only");
  const long long per_dir = (n_points + kK3Threads - 1) / kK3Threads;
  linearize_dir_kernel<T, NB, NQ, NA><<<(unsigned)(per_dir * (2 * NQ + NA)), kK3Threads, 0,
                                        stream>>>(n_points, per_dir, (const T*)P, (const int*)I,
                                                  (const T*)xs, (const T*)u, (T*)fx, (T*)fu);
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
