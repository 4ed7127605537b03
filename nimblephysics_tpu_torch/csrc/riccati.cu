// K1: the iLQR Riccati backward pass for a batch of worlds.
//
// Replaces nimblephysics_tpu/ops/pallas_riccati.py :: riccati_backward_pallas
// (kernel _riccati_kernel), which put the worlds on the TPU's 128 lanes and
// walked time in chunks with the value-function carry in VMEM.
//
// Bound on this card: device memory. Per world and step the kernel reads the
// packed (fx, fu, lx, lu, lxx, luu, lux) row once (E values) and writes
// (K, k) once, and does a few hundred flops on them, far below the
// 67 TFLOP/s f32 rate. Design: one thread per world, t = T-1..0 inside the
// thread, Vx/Vxx and the dV/ok carry in registers, nx/na template constants
// so every small matrix product is unrolled. The wrapper packs the inputs
// to (T, E, B) with the world index fastest, so the 32 threads of a warp
// read 32 consecutive values of each row (coalesced), and the kernel writes
// (K, k) in the same (T, Eo, B) layout. Known limit: B = 4096 worlds is 128
// warps on 132 SMs, one warp per SM, so memory latency is hidden by nothing
// but the loads of one step in flight.
//
// Least work per call (chip_smoke.py least_work): each input read once and
// (K, k, dV, ok) written once; riccati_step_ops(nx, na) operations per
// (world, t), term by term as below (638 for nx = 4, na = 1).
#include "common.cuh"

namespace nptt {

template <typename T, int NX, int NA>
struct RiccatiLayout {
  static constexpr int ofx = 0, ofu = ofx + NX * NX, olx = ofu + NX * NA,
                       olu = olx + NX, olxx = olu + NA, oluu = olxx + NX * NX,
                       olux = oluu + NA * NA, E = olux + NA * NX, EO = NA * NX + NA;
};

template <typename T, int NX, int NA>
NPTT_HD void riccati_thread(long long b, long long B, int Tn, const T* __restrict__ steps,
                            const T* __restrict__ VxT, const T* __restrict__ VxxT,
                            const T* __restrict__ reg_in, T* __restrict__ Kk,
                            T* __restrict__ dV, bool* __restrict__ ok_out) {
  using L = RiccatiLayout<T, NX, NA>;
  T Vx[NX], Vxx[NX][NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    Vx[i] = VxT[b * NX + i];
#pragma unroll
    for (int j = 0; j < NX; ++j) Vxx[i][j] = VxxT[(b * NX + i) * NX + j];
  }
  const T reg = reg_in[b];
  T dv0 = T(0), dv1 = T(0);
  bool ok = true;

  for (int t = Tn - 1; t >= 0; --t) {
    const T* st = steps + (long long)t * L::E * B + b;
    T fx[NX][NX], fu[NX][NA], lx[NX], lu[NA], lxx[NX][NX], luu[NA][NA], lux[NA][NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        fx[i][j] = st[(L::ofx + i * NX + j) * B];
        lxx[i][j] = st[(L::olxx + i * NX + j) * B];
      }
#pragma unroll
      for (int a = 0; a < NA; ++a) fu[i][a] = st[(L::ofu + i * NA + a) * B];
      lx[i] = st[(L::olx + i) * B];
    }
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      lu[a] = st[(L::olu + a) * B];
#pragma unroll
      for (int c = 0; c < NA; ++c) luu[a][c] = st[(L::oluu + a * NA + c) * B];
#pragma unroll
      for (int i = 0; i < NX; ++i) lux[a][i] = st[(L::olux + a * NX + i) * B];
    }

    // Q terms; W = Vxx fx, Wu = Vxx fu
    T Qx[NX], Qu[NA], W[NX][NX], Wu[NX][NA];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      T s = lx[i];
#pragma unroll
      for (int k = 0; k < NX; ++k) s = s + fx[k][i] * Vx[k];
      Qx[i] = s;
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        T w = T(0);
#pragma unroll
        for (int k = 0; k < NX; ++k) w = w + Vxx[i][k] * fx[k][j];
        W[i][j] = w;
      }
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        T w = T(0);
#pragma unroll
        for (int k = 0; k < NX; ++k) w = w + Vxx[i][k] * fu[k][a];
        Wu[i][a] = w;
      }
    }
    T Qxx[NX][NX], Quu[NA][NA], Qux[NA][NX], Quu_reg[NA][NA], Qux_reg[NA][NX];
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      T s = lu[a];
#pragma unroll
      for (int k = 0; k < NX; ++k) s = s + fu[k][a] * Vx[k];
      Qu[a] = s;
    }
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        T s = T(0);
#pragma unroll
        for (int k = 0; k < NX; ++k) s = s + fx[k][i] * W[k][j];
        Qxx[i][j] = lxx[i][j] + s;
      }
    // Tassa state regularisation: Quu + reg fu^T fu, Qux + reg fu^T fx
#pragma unroll
    for (int a = 0; a < NA; ++a) {
#pragma unroll
      for (int c = 0; c < NA; ++c) {
        T s = T(0), r = T(0);
#pragma unroll
        for (int k = 0; k < NX; ++k) {
          s = s + fu[k][a] * Wu[k][c];
          r = r + fu[k][a] * fu[k][c];
        }
        Quu[a][c] = luu[a][c] + s;
        Quu_reg[a][c] = Quu[a][c] + reg * r;
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        T s = T(0), r = T(0);
#pragma unroll
        for (int k = 0; k < NX; ++k) {
          s = s + fu[k][a] * W[k][i];
          r = r + fu[k][a] * fx[k][i];
        }
        Qux[a][i] = lux[a][i] + s;
        Qux_reg[a][i] = Qux[a][i] + reg * r;
      }
    }

    // pivot-free Gauss-Jordan on [Quu_reg | I]; the smallest pivot is the PD flag
    T M[NA][2 * NA];
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int c = 0; c < NA; ++c) {
        M[a][c] = Quu_reg[a][c];
        M[a][NA + c] = T(a == c ? 1 : 0);
      }
    T min_piv = M[0][0];
#pragma unroll
    for (int kk = 0; kk < NA; ++kk) {
      const T piv = M[kk][kk];
      if (nisnan(piv) || piv < min_piv) min_piv = piv;
      const T inv_p = T(1) / piv;
      T row[2 * NA];
#pragma unroll
      for (int j = 0; j < 2 * NA; ++j) row[j] = M[kk][j] * inv_p;
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        if (i == kk) continue;
        const T f = M[i][kk];
#pragma unroll
        for (int j = 0; j < 2 * NA; ++j) M[i][j] = M[i][j] - f * row[j];
      }
#pragma unroll
      for (int j = 0; j < 2 * NA; ++j) M[kk][j] = row[j];
    }
    ok = ok && nisfinite(min_piv) && (min_piv > T(0));

    T k_t[NA], K_t[NA][NX];
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      T s = T(0);
#pragma unroll
      for (int c = 0; c < NA; ++c) s = s + M[a][NA + c] * Qu[c];
      k_t[a] = -s;
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        T r = T(0);
#pragma unroll
        for (int c = 0; c < NA; ++c) r = r + M[a][NA + c] * Qux_reg[c][i];
        K_t[a][i] = -r;
      }
    }

    // value function update
    T Quu_k[NA];
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      T s = T(0);
#pragma unroll
      for (int c = 0; c < NA; ++c) s = s + Quu[a][c] * k_t[c];
      Quu_k[a] = s;
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      T s = Qx[i];
#pragma unroll
      for (int a = 0; a < NA; ++a) s = s + K_t[a][i] * (Quu_k[a] + Qu[a]) + Qux[a][i] * k_t[a];
      Vx[i] = s;
    }
    T KtQuu[NX][NA], Vn[NX][NX];
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        T s = T(0);
#pragma unroll
        for (int c = 0; c < NA; ++c) s = s + K_t[c][i] * Quu[c][a];
        KtQuu[i][a] = s;
      }
    T V2[NX][NX];
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        T s1 = T(0), s2 = T(0);
#pragma unroll
        for (int a = 0; a < NA; ++a) {
          s1 = s1 + KtQuu[i][a] * K_t[a][j];
          s2 = s2 + K_t[a][i] * Qux[a][j];
        }
        Vn[i][j] = Qxx[i][j] + s1;
        V2[i][j] = s2;
      }
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j) Vn[i][j] = Vn[i][j] + V2[i][j] + V2[j][i];
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j) Vxx[i][j] = T(0.5) * (Vn[i][j] + Vn[j][i]);
    T s0 = T(0), s1 = T(0);
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      s0 = s0 + k_t[a] * Qu[a];
      s1 = s1 + k_t[a] * Quu_k[a];
    }
    dv0 = dv0 + s0;
    dv1 = dv1 + T(0.5) * s1;

    T* out = Kk + (long long)t * L::EO * B + b;
#pragma unroll
    for (int a = 0; a < NA; ++a) {
#pragma unroll
      for (int i = 0; i < NX; ++i) out[(a * NX + i) * B] = K_t[a][i];
      out[(NA * NX + a) * B] = k_t[a];
    }
  }
  dV[2 * b] = dv0;
  dV[2 * b + 1] = dv1;
  ok_out[b] = ok;
}

#ifdef __CUDACC__
template <typename T, int NX, int NA>
__global__ void riccati_kernel(long long B, int Tn, const T* __restrict__ steps,
                               const T* __restrict__ VxT, const T* __restrict__ VxxT,
                               const T* __restrict__ reg, T* __restrict__ Kk,
                               T* __restrict__ dV, bool* __restrict__ ok) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B) riccati_thread<T, NX, NA>(b, B, Tn, steps, VxT, VxxT, reg, Kk, dV, ok);
}

template <typename T, int NX, int NA>
static int launch_riccati(long long B, int Tn, const void* steps, const void* VxT,
                          const void* VxxT, const void* reg, void* Kk, void* dV, void* ok,
                          cudaStream_t stream) {
  const int threads = 32;  // B is small: spread the warps over the SMs
  const long long blocks = (B + threads - 1) / threads;
  riccati_kernel<T, NX, NA><<<(unsigned)blocks, threads, 0, stream>>>(
      B, Tn, (const T*)steps, (const T*)VxT, (const T*)VxxT, (const T*)reg, (T*)Kk,
      (T*)dV, (bool*)ok);
  return (int)cudaGetLastError();
}
#endif

}  // namespace nptt

#ifdef __CUDACC__
// Returns 0, a cudaError_t, or -1 for a (dtype, nx, na) without an instance.
extern "C" int nptt_riccati(int is_double, int nx, int na, long long B, int T,
                            const void* steps, const void* VxT, const void* VxxT,
                            const void* reg, void* Kk, void* dV, void* ok, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define NPTT_RICCATI_CASE(NX, NA)                                                              \
  if (nx == NX && na == NA)                                                                    \
    return is_double                                                                           \
               ? nptt::launch_riccati<double, NX, NA>(B, T, steps, VxT, VxxT, reg, Kk, dV, ok, s) \
               : nptt::launch_riccati<float, NX, NA>(B, T, steps, VxT, VxxT, reg, Kk, dV, ok, s);
  NPTT_RICCATI_CASE(4, 1)
  NPTT_RICCATI_CASE(6, 3)
  NPTT_RICCATI_CASE(8, 2)
#undef NPTT_RICCATI_CASE
  return -1;
}
#endif
