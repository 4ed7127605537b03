// K6: the full-LCP class rollout of the contact replan.
//
// Replaces nimblephysics_tpu/ops/pallas_rollout.py :: rollout_classes_pallas
// (kernel _classes_kernel), which ran the T-step scan of the full
// constrained step with the worlds on lanes and the state carried in VMEM
// across time chunks.
//
// Bound on this card: latency. A world is a chain of T dependent full
// steps (step.cuh class_step: the dynamics, then direct_boxed_solve_lane's
// three normal-equation rounds and eight PGS sweeps), a few thousand
// operations each, about 9.5 us per step on one thread, while the least
// work of the whole call is 0.0175 ms (PERF.md section 6).
//
// Design: one thread per world carries x through the T steps in registers,
// reading u (B, T, na) and writing xs (B, T, nx) and cmask (B, T, m) in the
// wrapper's layouts (no permute before or after the launch), with the next
// step's u loaded before the step runs. The packed model rides in the
// kernel's parameters (__grid_constant__ ClassesModel): the step reads its
// constants from the constant bank, most as operands of the arithmetic
// itself, not by a global load each (282 in the f32 SASS with the model
// behind a pointer, 10 here). kK6Threads threads per block spread the
// worlds over the SMs. This file defines NPTT_PLAIN_UNROLL: the step's
// loops, its row loops included, unroll under a plain #pragma unroll (the
// counted pragma of the shared step left a one-thread kernel's step arrays
// in local memory, K3, PERF.md section 6); every loop here has a
// compile-time trip count, and class_step is built for the cartpole's 4
// limit rows only (NPTT_CONTACT_SHAPES; no contact slots), so none of the
// worm's instances sees the plain pragma. Together these took the call
// from 1.11 to 0.99 ms; a group of 4 lanes per world, each lane owning an
// LCP row of the normal-equation rounds and the residuals, ran 1.10 (its
// shuffles cost what the rows saved at m = 4).
//
// Least work per call (chip_smoke.py contact_least_work): u and x0 read,
// (xs, cmask, us) written once, one class_step per (world, t)
// (ops/device_step.py class_step_ops).
#define NPTT_PLAIN_UNROLL
#include "step.cuh"

namespace nptt {

// threads (worlds) per block: 16, so that B = 2,048 worlds take 128 SMs
// with half a warp each (f32 on an NVIDIA H100 80GB HBM3 at 700 W: 0.986
// ms against 1.000 at 32 and 1.011 at 64 threads, PERF.md section 6)
constexpr int kK6Threads = 16;

// The packed model of a K6 instance (ops/device_step.py pack_model: the
// step's reals and the rows' bounds; the step's ints and the rows' dofs and
// kinds), passed by value in the kernel's parameters.
template <typename T, int NB, int NQ, int NA, int M>
struct ClassesModel {
  using RL = RowLayout<NB, NQ, NA, M, 0>;
  static constexpr int kReals = RL::kSlot, kInts = RL::iSlotBody;
  T P[kReals];
  int I[kInts];
};

// World b's T steps: x0 (B, NX), u (B, T, NA) in; xs (B, T, NX) post-step
// states and cmask (B, T, M) out.
template <typename T, int NB, int NQ, int NA, int M>
NPTT_HD void classes_thread(long long b, int Tn, const T* __restrict__ P,
                            const int* __restrict__ I, const T* __restrict__ x0,
                            const T* __restrict__ u, T* __restrict__ xs, T* __restrict__ cmask) {
  static_assert(M <= 8, "classes.cu unrolls every row loop (NPTT_PLAIN_UNROLL)");
  constexpr int NX = 2 * NQ;
  T x[NX], un[NA];
NPTT_UNROLL(true, NX)
  for (int i = 0; i < NX; ++i) x[i] = x0[b * NX + i];
NPTT_UNROLL(true, NA)
  for (int a = 0; a < NA; ++a) un[a] = Tn > 0 ? u[b * Tn * NA + a] : T(0);
#pragma unroll 1
  for (int t = 0; t < Tn; ++t) {
    const long long bt = b * Tn + t;
    T ut[NA], qn[NQ], vn[NQ], cm[M];
NPTT_UNROLL(true, NA)
    for (int a = 0; a < NA; ++a) {
      ut[a] = un[a];
      if (t + 1 < Tn) un[a] = u[(bt + 1) * NA + a];
    }
    class_step<T, T, NB, NQ, NA, M>(P, I, x, x + NQ, ut, qn, vn, cm);
NPTT_UNROLL(true, NQ)
    for (int i = 0; i < NQ; ++i) {
      x[i] = qn[i];
      x[NQ + i] = vn[i];
    }
NPTT_UNROLL(true, NX)
    for (int i = 0; i < NX; ++i) xs[bt * NX + i] = x[i];
NPTT_ROW_UNROLL(M, M)
    for (int r = 0; r < M; ++r) cmask[bt * M + r] = cm[r];
  }
}

#ifdef __CUDACC__
template <typename T, int NB, int NQ, int NA, int M>
__global__ void classes_kernel(long long B, int Tn,
                               const __grid_constant__ ClassesModel<T, NB, NQ, NA, M> model,
                               const T* __restrict__ x0, const T* __restrict__ u,
                               T* __restrict__ xs, T* __restrict__ cmask) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B) classes_thread<T, NB, NQ, NA, M>(b, Tn, model.P, model.I, x0, u, xs, cmask);
}

template <typename T, int NB, int NQ, int NA, int M>
static int launch_classes(long long B, int Tn, int nr, int ni, const void* P, const void* I,
                          const void* x0, const void* u, void* xs, void* cmask,
                          cudaStream_t stream) {
  using Model = ClassesModel<T, NB, NQ, NA, M>;
  if (nr != Model::kReals || ni != Model::kInts) return -1;
  Model model;
  for (int k = 0; k < Model::kReals; ++k) model.P[k] = ((const T*)P)[k];
  for (int k = 0; k < Model::kInts; ++k) model.I[k] = ((const int*)I)[k];
  const long long blocks = (B + kK6Threads - 1) / kK6Threads;
  classes_kernel<T, NB, NQ, NA, M><<<(unsigned)blocks, kK6Threads, 0, stream>>>(
      B, Tn, model, (const T*)x0, (const T*)u, (T*)xs, (T*)cmask);
  return (int)cudaGetLastError();
}
#endif

}  // namespace nptt

#ifdef __CUDACC__
// K6. Returns 0, a cudaError_t, or -1 for a (dtype, nb, nq, na, m) without
// an instance or a packed model (nr reals, ni ints) of another size. P and
// I are the packed model in host memory (ops/device_step.py
// pack_model_host); x0 (B, 2 nq), u (B, T, na); xs (B, T, 2 nq), cmask (B,
// T, m).
extern "C" int nptt_classes(int is_double, int nb, int nq, int na, int m, int nr, int ni,
                            long long B, int T, const void* P, const void* I, const void* x0,
                            const void* u, void* xs, void* cmask, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define NPTT_CLASSES_CASE(NB, NQ, NA, M, NS)                                                 \
  if (m == M && nb == NB && nq == NQ && na == NA)                                            \
    return is_double ? nptt::launch_classes<double, NB, NQ, NA, M>(B, T, nr, ni, P, I, x0, u, \
                                                                   xs, cmask, s)             \
                     : nptt::launch_classes<float, NB, NQ, NA, M>(B, T, nr, ni, P, I, x0, u, \
                                                                  xs, cmask, s);
  NPTT_CONTACT_SHAPES(NPTT_CLASSES_CASE)
#undef NPTT_CLASSES_CASE
  return -1;
}
#endif
