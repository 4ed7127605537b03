// A lane group: G lanes of one warp that share one piece of work, behind
// one interface, sync(), bcast(), sum() and max(): WarpGroup on the card
// (__syncwarp, __shfl_sync and __shfl_xor_sync within the group's lanes),
// HostGroup in the host build of tests/test_torch_device_step.py, which
// runs the same bodies with one host thread per lane: sync() is a barrier,
// and each shuffle exchanges the lanes' values through an array, the
// butterflies in the device's order. K2, K4 and K5 at the worm's m = 28
// (frozen_group.cuh), K7 (lcp.cu) and K1 (riccati.cu) run on such groups.
#pragma once

#include "common.cuh"

#ifndef __CUDACC__
#include <condition_variable>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>
#endif

namespace nptt {

NPTT_HD constexpr int log2_of(int g) { return g > 1 ? 1 + log2_of(g / 2) : 0; }

#ifdef __CUDACC__
// G lanes of one warp (G a power of two up to 32, aligned within the warp).
template <int G>
struct WarpGroup {
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0,
                "a group is a power of two of lanes of one warp");
  int lane, base;  // the lane in the group; the warp lane of the group's lane 0
  unsigned mask;
  NPTT_HD void sync() const {
#ifdef __CUDA_ARCH__
    __syncwarp(mask);
#endif
  }
  // lane src's v on every lane of the group
  template <typename S>
  NPTT_HD S bcast(S v, int src) const {
#ifdef __CUDA_ARCH__
    return __shfl_sync(mask, v, base + src);
#else
    return v;
#endif
  }
  // v[k] summed over the group's lanes, every lane getting the same sums
  template <typename S, int N>
  NPTT_HD void sum(S (&v)[N]) const {
#ifdef __CUDA_ARCH__
#pragma unroll (unroll_by(true, log2_of(G)))
    for (int o = G / 2; o > 0; o >>= 1)
#pragma unroll (unroll_by(true, N))
      for (int k = 0; k < N; ++k) v[k] = v[k] + __shfl_xor_sync(mask, v[k], o);
#endif
  }
  template <typename S>
  NPTT_HD S max(S v) const {
#ifdef __CUDA_ARCH__
#pragma unroll (unroll_by(true, log2_of(G)))
    for (int o = G / 2; o > 0; o >>= 1) v = pmax(v, __shfl_xor_sync(mask, v, o));
#endif
    return v;
  }
};

// The calling thread's lane in its group of G, and the group's lane mask.
template <int G>
__device__ __forceinline__ WarpGroup<G> warp_group() {
  const int w = threadIdx.x & 31;
  const unsigned mask = G == 32 ? 0xffffffffu : (((1u << G) - 1u) << (w & ~(G - 1)));
  return WarpGroup<G>{w & (G - 1), w & ~(G - 1), mask};
}
#else
// The host build's group: HostGroup<G>::run calls body(group) on G
// threads, one per lane.
struct HostGroupState {
  std::mutex mu;
  std::condition_variable cv;
  int waiting = 0;
  long generation = 0;
  std::vector<unsigned char> slots;
};

template <int G>
struct HostGroup {
  int lane;
  HostGroupState* st;
  void sync() const {
    std::unique_lock<std::mutex> lk(st->mu);
    const long gen = st->generation;
    if (++st->waiting == G) {
      st->waiting = 0;
      ++st->generation;
      st->cv.notify_all();
    } else {
      st->cv.wait(lk, [&] { return st->generation != gen; });
    }
  }
  // one butterfly step: every lane gets lane ^ o's values
  template <typename S, int N>
  void exchange(const S (&v)[N], int o, S (&w)[N]) const {
    static_assert(N * sizeof(S) <= 1024, "exchange slots hold 1 KiB per lane");
    std::memcpy(st->slots.data() + lane * 1024, v, sizeof(v));
    sync();
    std::memcpy(w, st->slots.data() + (lane ^ o) * 1024, sizeof(w));
    sync();
  }
  template <typename S>
  S bcast(S v, int src) const {
    S a[1] = {v}, w[1];
    exchange(a, lane ^ src, w);
    return w[0];
  }
  template <typename S, int N>
  void sum(S (&v)[N]) const {
    for (int o = G / 2; o > 0; o >>= 1) {
      S w[N];
      exchange(v, o, w);
      for (int k = 0; k < N; ++k) v[k] = v[k] + w[k];
    }
  }
  template <typename S>
  S max(S v) const {
    for (int o = G / 2; o > 0; o >>= 1) {
      S a[1] = {v}, w[1];
      exchange(a, o, w);
      v = pmax(v, w[0]);
    }
    return v;
  }
  template <class F>
  static void run(F body) {
    HostGroupState st;
    st.slots.resize(G * 1024);
    std::vector<std::thread> lanes;
    for (int l = 0; l < G; ++l) lanes.emplace_back([&st, &body, l] { body(HostGroup<G>{l, &st}); });
    for (auto& t : lanes) t.join();
  }
};
#endif

}  // namespace nptt
