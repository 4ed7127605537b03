// K1: the iLQR Riccati backward pass for a batch of worlds.
//
// Replaces nimblephysics_tpu/ops/pallas_riccati.py :: riccati_backward_pallas
// (kernel _riccati_kernel), which put the worlds on the TPU's 128 lanes and
// walked time in chunks held in VMEM, the value-function carry in VMEM.
//
// Bound on this card: device memory. Per world and step the kernel reads
// (fx, fu, lx, lu, lxx, luu, lux) once and writes (K, k) once, and does a
// few hundred flops on them, far below the 67 TFLOP/s f32 rate. A world's
// steps are a chain (step t needs step t + 1's Vx and Vxx), so what limits
// a kernel that walks them is the latency of each step's loads, and the
// number of worlds in flight to hide it.
//
// Design: one lane group (lane_group.cuh) of k1_lanes(nx) lanes per world,
// t = T-1..0 inside the group.
//   * The inputs are read where the solver keeps them, (B, T, ...) with a
//     world's steps contiguous: no packing pass before the launch, and (K,
//     k) are written straight into (B, T, na, nx) and (B, T, na).
//   * A world's next chunk of kK1Chunk steps of the seven inputs is copied
//     into the group's shared memory (cp.async, 16 bytes a copy but for a
//     run's unaligned ends) while the group computes the current chunk, two
//     stages: the TPU kernel's t-chunks in VMEM.
//   * Lane i owns row i of Vx, Vxx, W = Vxx fx, Qxx and of the Vxx update
//     (rows i, i + G, ... where G < nx); lanes a < na own the rows of Qu,
//     Quu, Qux, K and k. A product that needs a whole matrix reads it from
//     the world's shared scratch, written by its owners before a __syncwarp.
//     Every lane runs the small pivot-free Gauss-Jordan on Quu_reg itself
//     (na <= 3), so every lane holds the same inverse and the same smallest
//     pivot (the PD flag). Each lane sums in the order of the one-thread
//     kernel that came before (term by term as below), so f64 results equal
//     a one-thread walk's.
//   At B = 4096 worlds and nx = 4 that is 512 warps, and at the worm's B =
//   2048 and nx = 8 also 512, in place of the 128 and 64 warps of one
//   thread per world. In f32 on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md
//   section 6): 0.128 ms for the launch at (4, 1) and 0.269 at (8, 2),
//   against 0.236 and 0.796 for one thread per world with the same reads
//   and staging, and 0.312 and 0.543 for the packed one-thread kernel that
//   came before (whose packing took another 0.58 and 0.65 ms); chunks of 4
//   steps ran 0.148 and 0.257, of 16 0.131 and 0.434.
//
// Least work per call (chip_smoke.py least_work): each input read once and
// (K, k, dV, ok) written once; riccati_step_ops(nx, na) operations per
// (world, t), term by term as below (638 for nx = 4, na = 1).
#include "lane_group.cuh"

namespace nptt {

// Lanes per world: 0 takes the power of two at or above nx, 1 runs one
// thread per world. Steps per staged chunk.
constexpr int kK1Lanes = 0, kK1Chunk = 8;
// a block's shared memory at most (two blocks of the f32 instances fit an SM)
constexpr int kK1BlockBytes = 112 * 1024;

NPTT_HD constexpr int pow2_at_least(int n) { return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2); }
NPTT_HD constexpr int k1_lanes(int nx) { return kK1Lanes ? kK1Lanes : pow2_at_least(nx); }

// The per-step sizes of the seven inputs (fx, fu, lx, lu, lxx, luu, lux),
// in the order they are staged.
constexpr int kK1Inputs = 7;
template <int NX, int NA>
NPTT_HD constexpr int k1_input_size(int i) {
  return i == 0 || i == 4 ? NX * NX : (i == 1 || i == 6 ? NX * NA : (i == 2 ? NX : (i == 3 ? NA : NA * NA)));
}
// a chunk's run of input i in a stage, padded by 16 bytes so that it can
// start at its source's alignment, and where it starts in the stage
template <typename T, int NX, int NA>
NPTT_HD constexpr int k1_run(int i) { return kK1Chunk * k1_input_size<NX, NA>(i) + 16 / (int)sizeof(T); }
template <typename T, int NX, int NA>
NPTT_HD constexpr int k1_run_offset(int i) { return i == 0 ? 0 : k1_run_offset<T, NX, NA>(i - 1) + k1_run<T, NX, NA>(i - 1); }

// One world's shared memory: two stages of kK1Chunk steps of each input,
// and the step's scratch.
template <typename T, int NX, int NA>
struct RiccatiShared {
  alignas(16) T in[2][k1_run_offset<T, NX, NA>(kK1Inputs)];
  T Vx[NX], W[NX][NX], Wu[NX][NA], Qu[NA], Quu[NA][NA], QuuR[NA][NA], Qux[NA][NX], QuxR[NA][NX],
      K[NA][NX], k[NA], V2[NX][NX], Vn[NX][NX];
};

// The bytes between two worlds' RiccatiShared: a multiple of 16 that is 16
// more than a multiple of 128, so that the worlds of one warp reading the
// same offset hit distinct banks.
template <typename T, int NX, int NA>
NPTT_HD constexpr int riccati_world_bytes() {
  return ((int)sizeof(RiccatiShared<T, NX, NA>) + 127) / 128 * 128 + 16;
}

template <typename T, int NX, int NA>
NPTT_HD constexpr int riccati_worlds_per_block() {
  constexpr int G = k1_lanes(NX), by_lanes = 128 / G,
                by_bytes = kK1BlockBytes / riccati_world_bytes<T, NX, NA>();
  return by_bytes < 1 ? 1 : (by_bytes < by_lanes ? by_bytes : by_lanes);
}

// Copy n values from src to dst (shared memory): 16 bytes a copy where src
// and dst agree modulo 16, the unaligned ends one value a copy; the lanes
// of the group share the copies. Asynchronous on the card (cp.async:
// complete after async_wait and a sync of the group).
template <typename T>
NPTT_HD void async_copy(T* dst, const T* __restrict__ src, int n, int lane, int G) {
  constexpr int V = 16 / sizeof(T);
  const int head = (int)((V - ((unsigned long long)src / sizeof(T)) % V) % V);
  const int h = head < n ? head : n, nv = (n - h) / V, tail = h + nv * V;
  for (int e = lane; e < h; e += G) {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     (unsigned)__cvta_generic_to_shared(dst + e)),
                 "l"(src + e), "n"(sizeof(T)));
#else
    dst[e] = src[e];
#endif
  }
  for (int e = lane; e < nv; e += G) {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     (unsigned)__cvta_generic_to_shared(dst + h + e * V)),
                 "l"(src + h + e * V));
#else
    for (int v = 0; v < V; ++v) dst[h + e * V + v] = src[h + e * V + v];
#endif
  }
  for (int e = tail + lane; e < n; e += G) {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     (unsigned)__cvta_generic_to_shared(dst + e)),
                 "l"(src + e), "n"(sizeof(T)));
#else
    dst[e] = src[e];
#endif
  }
}

NPTT_HD void async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

// wait until at most `pending` of this lane's committed copy groups are in flight
template <int pending>
NPTT_HD void async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending));
#endif
}

// Where input i's run of a chunk starts in stage s: its run's base plus the
// source's offset modulo 16 bytes (so that the 16-byte copies line up).
template <typename T, int NX, int NA>
NPTT_HD T* stage_run(RiccatiShared<T, NX, NA>& S, int s, int i, const T* src) {
  return S.in[s] + k1_run_offset<T, NX, NA>(i) + (int)(((unsigned long long)src / sizeof(T)) % (16 / sizeof(T)));
}

// One world's backward pass on a group of G lanes (WarpGroup on the card,
// HostGroup in the host build). in[7]: fx, fu, lx, lu, lxx, luu, lux, each
// (B, T, ...) contiguous; K (B, T, na, nx) and k (B, T, na) written in place.
template <typename T, int NX, int NA, int G, class Group>
NPTT_HD void riccati_group(const Group& g, RiccatiShared<T, NX, NA>& S, long long b, int Tn,
                           const T* const* in, const T* __restrict__ VxT,
                           const T* __restrict__ VxxT, const T* __restrict__ reg_in,
                           T* __restrict__ Kout, T* __restrict__ kout, T* __restrict__ dV,
                           bool* __restrict__ ok_out) {
  constexpr int kR = (NX + G - 1) / G, kRa = (NA + G - 1) / G, C = kK1Chunk;
  const int lane = g.lane;
  // the rows this lane owns: Vxx's, Qx's (and next step's Vx's)
  T Vxx[kR][NX], Qx[kR], Qxx[kR][NX], Vn[kR][NX], Vxn[kR];
#pragma unroll (unroll_by(true, kR))
  for (int o = 0; o < kR; ++o) {
    const int i = lane + G * o;
    if (i >= NX) continue;
    S.Vx[i] = VxT[b * NX + i];
#pragma unroll (unroll_by(true, NX))
    for (int j = 0; j < NX; ++j) Vxx[o][j] = VxxT[(b * NX + i) * NX + j];
  }
  const T reg = reg_in[b];
  T dv0 = T(0), dv1 = T(0);
  bool ok = true;

  // the chunks from the last steps down: chunk c covers [lo, hi), hi = Tn - c C
  const int n_chunks = (Tn + C - 1) / C;
  auto issue = [&](int c) {
    const int hi = Tn - c * C, lo = hi - C > 0 ? hi - C : 0;
    for (int i = 0; i < kK1Inputs; ++i) {
      const T* src = in[i] + (b * Tn + lo) * k1_input_size<NX, NA>(i);
      async_copy(stage_run(S, c & 1, i, src), src, (hi - lo) * k1_input_size<NX, NA>(i), lane, G);
    }
  };
  issue(0);
  async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) issue(c + 1);
    async_commit();
    async_wait<1>();  // chunk c's copies have landed (this lane's)
    g.sync();         // ... and every lane's, as have the initial Vx
    const int hi = Tn - c * C, lo = hi - C > 0 ? hi - C : 0;
    const T* run[kK1Inputs];
    for (int i = 0; i < kK1Inputs; ++i) {
      const T* src = in[i] + (b * Tn + lo) * k1_input_size<NX, NA>(i);
      run[i] = stage_run(S, c & 1, i, src);
    }
    for (int t = hi - 1; t >= lo; --t) {
      const int j = t - lo;
      const T* fx = run[0] + j * k1_input_size<NX, NA>(0);
      const T* fu = run[1] + j * k1_input_size<NX, NA>(1);
      const T* lx = run[2] + j * k1_input_size<NX, NA>(2);
      const T* lu = run[3] + j * k1_input_size<NX, NA>(3);
      const T* lxx = run[4] + j * k1_input_size<NX, NA>(4);
      const T* luu = run[5] + j * k1_input_size<NX, NA>(5);
      const T* lux = run[6] + j * k1_input_size<NX, NA>(6);

      // Q terms of the owned rows; W = Vxx fx, Wu = Vxx fu
#pragma unroll (unroll_by(true, kR))
      for (int o = 0; o < kR; ++o) {
        const int i = lane + G * o;
        if (i >= NX) continue;
        T s = lx[i];
#pragma unroll (unroll_by(true, NX))
        for (int k = 0; k < NX; ++k) s = s + fx[k * NX + i] * S.Vx[k];
        Qx[o] = s;
#pragma unroll (unroll_by(true, NX))
        for (int jj = 0; jj < NX; ++jj) {
          T w = T(0);
#pragma unroll (unroll_by(true, NX))
          for (int k = 0; k < NX; ++k) w = w + Vxx[o][k] * fx[k * NX + jj];
          S.W[i][jj] = w;
        }
#pragma unroll (unroll_by(true, NA))
        for (int a = 0; a < NA; ++a) {
          T w = T(0);
#pragma unroll (unroll_by(true, NX))
          for (int k = 0; k < NX; ++k) w = w + Vxx[o][k] * fu[k * NA + a];
          S.Wu[i][a] = w;
        }
      }
      g.sync();
      // Qxx's owned rows; Qu, Quu and Qux with the Tassa state
      // regularisation (Quu + reg fu^T fu, Qux + reg fu^T fx) on lanes a < na
#pragma unroll (unroll_by(true, kR))
      for (int o = 0; o < kR; ++o) {
        const int i = lane + G * o;
        if (i >= NX) continue;
#pragma unroll (unroll_by(true, NX))
        for (int jj = 0; jj < NX; ++jj) {
          T s = T(0);
#pragma unroll (unroll_by(true, NX))
          for (int k = 0; k < NX; ++k) s = s + fx[k * NX + i] * S.W[k][jj];
          Qxx[o][jj] = lxx[i * NX + jj] + s;
        }
      }
#pragma unroll (unroll_by(true, kRa))
      for (int o = 0; o < kRa; ++o) {
        const int a = lane + G * o;
        if (a >= NA) continue;
        T s = lu[a];
#pragma unroll (unroll_by(true, NX))
        for (int k = 0; k < NX; ++k) s = s + fu[k * NA + a] * S.Vx[k];
        S.Qu[a] = s;
#pragma unroll (unroll_by(true, NA))
        for (int c2 = 0; c2 < NA; ++c2) {
          T q = T(0), r = T(0);
#pragma unroll (unroll_by(true, NX))
          for (int k = 0; k < NX; ++k) {
            q = q + fu[k * NA + a] * S.Wu[k][c2];
            r = r + fu[k * NA + a] * fu[k * NA + c2];
          }
          const T quu = luu[a * NA + c2] + q;
          S.Quu[a][c2] = quu;
          S.QuuR[a][c2] = quu + reg * r;
        }
#pragma unroll (unroll_by(true, NX))
        for (int i = 0; i < NX; ++i) {
          T q = T(0), r = T(0);
#pragma unroll (unroll_by(true, NX))
          for (int k = 0; k < NX; ++k) {
            q = q + fu[k * NA + a] * S.W[k][i];
            r = r + fu[k * NA + a] * fx[k * NX + i];
          }
          const T qux = lux[a * NX + i] + q;
          S.Qux[a][i] = qux;
          S.QuxR[a][i] = qux + reg * r;
        }
      }
      g.sync();

      // pivot-free Gauss-Jordan on [Quu_reg | I] on every lane; the smallest
      // pivot is the PD flag
      T M[NA][2 * NA];
#pragma unroll (unroll_by(true, NA))
      for (int a = 0; a < NA; ++a)
#pragma unroll (unroll_by(true, NA))
        for (int c2 = 0; c2 < NA; ++c2) {
          M[a][c2] = S.QuuR[a][c2];
          M[a][NA + c2] = T(a == c2 ? 1 : 0);
        }
      T min_piv = M[0][0];
#pragma unroll (unroll_by(true, NA))
      for (int kk = 0; kk < NA; ++kk) {
        const T piv = M[kk][kk];
        if (nisnan(piv) || piv < min_piv) min_piv = piv;
        const T inv_p = T(1) / piv;
        T row[2 * NA];
#pragma unroll (unroll_by(true, 2 * NA))
        for (int jj = 0; jj < 2 * NA; ++jj) row[jj] = M[kk][jj] * inv_p;
#pragma unroll (unroll_by(true, NA))
        for (int i = 0; i < NA; ++i) {
          if (i == kk) continue;
          const T f = M[i][kk];
#pragma unroll (unroll_by(true, 2 * NA))
          for (int jj = 0; jj < 2 * NA; ++jj) M[i][jj] = M[i][jj] - f * row[jj];
        }
#pragma unroll (unroll_by(true, 2 * NA))
        for (int jj = 0; jj < 2 * NA; ++jj) M[kk][jj] = row[jj];
      }
      ok = ok && nisfinite(min_piv) && (min_piv > T(0));

      // k and K on their rows' lanes, straight into the outputs
#pragma unroll (unroll_by(true, kRa))
      for (int o = 0; o < kRa; ++o) {
        const int a = lane + G * o;
        if (a >= NA) continue;
        T s = T(0);
#pragma unroll (unroll_by(true, NA))
        for (int c2 = 0; c2 < NA; ++c2) s = s + M[a][NA + c2] * S.Qu[c2];
        S.k[a] = -s;
        kout[(b * Tn + t) * NA + a] = -s;
#pragma unroll (unroll_by(true, NX))
        for (int i = 0; i < NX; ++i) {
          T r = T(0);
#pragma unroll (unroll_by(true, NA))
          for (int c2 = 0; c2 < NA; ++c2) r = r + M[a][NA + c2] * S.QuxR[c2][i];
          S.K[a][i] = -r;
          Kout[((b * Tn + t) * NA + a) * NX + i] = -r;
        }
      }
      g.sync();

      // value function update
      T Quu_k[NA];
#pragma unroll (unroll_by(true, NA))
      for (int a = 0; a < NA; ++a) {
        T s = T(0);
#pragma unroll (unroll_by(true, NA))
        for (int c2 = 0; c2 < NA; ++c2) s = s + S.Quu[a][c2] * S.k[c2];
        Quu_k[a] = s;
      }
#pragma unroll (unroll_by(true, kR))
      for (int o = 0; o < kR; ++o) {
        const int i = lane + G * o;
        if (i >= NX) continue;
        T s = Qx[o];
#pragma unroll (unroll_by(true, NA))
        for (int a = 0; a < NA; ++a)
          s = s + S.K[a][i] * (Quu_k[a] + S.Qu[a]) + S.Qux[a][i] * S.k[a];
        Vxn[o] = s;
        T KtQuu[NA];
#pragma unroll (unroll_by(true, NA))
        for (int a = 0; a < NA; ++a) {
          T q = T(0);
#pragma unroll (unroll_by(true, NA))
          for (int c2 = 0; c2 < NA; ++c2) q = q + S.K[c2][i] * S.Quu[c2][a];
          KtQuu[a] = q;
        }
#pragma unroll (unroll_by(true, NX))
        for (int jj = 0; jj < NX; ++jj) {
          T s1 = T(0), s2 = T(0);
#pragma unroll (unroll_by(true, NA))
          for (int a = 0; a < NA; ++a) {
            s1 = s1 + KtQuu[a] * S.K[a][jj];
            s2 = s2 + S.K[a][i] * S.Qux[a][jj];
          }
          Vn[o][jj] = Qxx[o][jj] + s1;
          S.V2[i][jj] = s2;
        }
      }
      g.sync();
#pragma unroll (unroll_by(true, kR))
      for (int o = 0; o < kR; ++o) {
        const int i = lane + G * o;
        if (i >= NX) continue;
#pragma unroll (unroll_by(true, NX))
        for (int jj = 0; jj < NX; ++jj) {
          Vn[o][jj] = Vn[o][jj] + S.V2[i][jj] + S.V2[jj][i];
          S.Vn[i][jj] = Vn[o][jj];
        }
        S.Vx[i] = Vxn[o];  // every read of this step's Vx lies before the last sync
      }
      g.sync();
#pragma unroll (unroll_by(true, kR))
      for (int o = 0; o < kR; ++o) {
        const int i = lane + G * o;
        if (i >= NX) continue;
#pragma unroll (unroll_by(true, NX))
        for (int jj = 0; jj < NX; ++jj) Vxx[o][jj] = T(0.5) * (S.Vn[i][jj] + S.Vn[jj][i]);
      }
      T s0 = T(0), s1 = T(0);
#pragma unroll (unroll_by(true, NA))
      for (int a = 0; a < NA; ++a) {
        s0 = s0 + S.k[a] * S.Qu[a];
        s1 = s1 + S.k[a] * Quu_k[a];
      }
      dv0 = dv0 + s0;
      dv1 = dv1 + T(0.5) * s1;
      // the next step's first reads of S (Vx, fx) and writes (W) wait for
      // nothing: its writes of W, Qu, K, V2 and Vn lie behind two syncs
    }
    g.sync();  // every lane is done with stage c & 1 before chunk c + 2 lands there
  }
  if (lane == 0) {
    dV[2 * b] = dv0;
    dV[2 * b + 1] = dv1;
    ok_out[b] = ok;
  }
}

#ifdef __CUDACC__
template <typename T, int NX, int NA>
__global__ void riccati_kernel(long long B, int Tn, const T* __restrict__ fx,
                               const T* __restrict__ fu, const T* __restrict__ lx,
                               const T* __restrict__ lu, const T* __restrict__ lxx,
                               const T* __restrict__ luu, const T* __restrict__ lux,
                               const T* __restrict__ VxT, const T* __restrict__ VxxT,
                               const T* __restrict__ reg, T* __restrict__ K, T* __restrict__ k,
                               T* __restrict__ dV, bool* __restrict__ ok) {
  constexpr int G = k1_lanes(NX), W = riccati_worlds_per_block<T, NX, NA>();
  extern __shared__ __align__(16) unsigned char smem[];
  const long long b = (long long)blockIdx.x * W + threadIdx.x / G;
  if (b >= B) return;  // a whole group leaves: its lanes' mask holds only them
  auto* S = reinterpret_cast<RiccatiShared<T, NX, NA>*>(
      smem + (threadIdx.x / G) * riccati_world_bytes<T, NX, NA>());
  const T* in[7] = {fx, fu, lx, lu, lxx, luu, lux};
  riccati_group<T, NX, NA, G>(warp_group<G>(), *S, b, Tn, in, VxT, VxxT, reg, K, k, dV, ok);
}

template <typename T, int NX, int NA>
static int launch_riccati(long long B, int Tn, const void* const* p, cudaStream_t stream) {
  constexpr int G = k1_lanes(NX), W = riccati_worlds_per_block<T, NX, NA>();
  const int smem = W * riccati_world_bytes<T, NX, NA>();
  auto kernel = riccati_kernel<T, NX, NA>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (B + W - 1) / W;
  kernel<<<(unsigned)blocks, W * G, smem, stream>>>(
      B, Tn, (const T*)p[0], (const T*)p[1], (const T*)p[2], (const T*)p[3], (const T*)p[4],
      (const T*)p[5], (const T*)p[6], (const T*)p[7], (const T*)p[8], (const T*)p[9], (T*)p[10],
      (T*)p[11], (T*)p[12], (bool*)p[13]);
  return (int)cudaGetLastError();
}

// K1's layout at an instance: lanes per world, worlds per block, steps per
// staged chunk, shared bytes per block.
template <typename T, int NX, int NA>
void riccati_layout(long long* out) {
  constexpr int W = riccati_worlds_per_block<T, NX, NA>();
  out[0] = k1_lanes(NX);
  out[1] = W;
  out[2] = kK1Chunk;
  out[3] = W * riccati_world_bytes<T, NX, NA>();
}
#endif

}  // namespace nptt

#ifdef __CUDACC__
#define NPTT_RICCATI_SHAPES(X) X(4, 1) X(6, 3) X(8, 2)

// Returns 0, a cudaError_t, or -1 for a (dtype, nx, na) without an instance.
// Pointers: fx, fu, lx, lu, lxx, luu, lux (B, T, ...), Vx_T, Vxx_T, reg,
// then the outputs K, k, dV, ok.
extern "C" int nptt_riccati(int is_double, int nx, int na, long long B, int T, const void* fx,
                            const void* fu, const void* lx, const void* lu, const void* lxx,
                            const void* luu, const void* lux, const void* VxT, const void* VxxT,
                            const void* reg, void* K, void* k, void* dV, void* ok, void* stream) {
  const void* p[14] = {fx, fu, lx, lu, lxx, luu, lux, VxT, VxxT, reg, K, k, dV, ok};
  cudaStream_t s = (cudaStream_t)stream;
#define NPTT_RICCATI_CASE(NX, NA)                                                      \
  if (nx == NX && na == NA)                                                            \
    return is_double ? nptt::launch_riccati<double, NX, NA>(B, T, p, s)                \
                     : nptt::launch_riccati<float, NX, NA>(B, T, p, s);
  NPTT_RICCATI_SHAPES(NPTT_RICCATI_CASE)
#undef NPTT_RICCATI_CASE
  return -1;
}

// K1's layout (nptt::riccati_layout) at (nx, na); -1 without an instance.
extern "C" int nptt_riccati_layout(int is_double, int nx, int na, long long* out) {
#define NPTT_RICCATI_LAYOUT(NX, NA)                                                    \
  if (nx == NX && na == NA) {                                                          \
    if (is_double)                                                                     \
      nptt::riccati_layout<double, NX, NA>(out);                                       \
    else                                                                               \
      nptt::riccati_layout<float, NX, NA>(out);                                        \
    return 0;                                                                          \
  }
  NPTT_RICCATI_SHAPES(NPTT_RICCATI_LAYOUT)
#undef NPTT_RICCATI_LAYOUT
  return -1;
}
#endif
