// A lane group: G lanes of one warp that share one piece of work, behind
// one interface, sync(), bcast(), sum() and max(): WarpGroup on the card
// (__syncwarp, __shfl_sync and __shfl_xor_sync within the group's lanes),
// HostGroup in the host build of tests/test_torch_device_step.py, which
// runs the same bodies with one host thread per lane, and FiberGroup in
// tests/test_torch_pgs_wide.py's, one fiber per lane: sync() is a barrier
// (a generation count under a mutex; or a switch to the next fiber), and
// each shuffle exchanges the lanes' values through one of two arrays in
// turn, so one barrier per exchange suffices (a lane writes an array again
// only after the next barrier, which every lane passes after reading it),
// the butterflies in the device's order.
// K2, K4 and K5 at the worm's m = 28 (frozen_group.cuh), K7 (lcp.cu,
// lcp_wide.cu) and K1 (riccati.cu) run on such groups.
#pragma once

#include "common.cuh"

#ifndef __CUDACC__
#include <condition_variable>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>
#include <ucontext.h>
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
// The host builds' groups: HostGroup<G>::run calls body(group) on G
// threads, one per lane; FiberGroup<G>::run on G fibers of the calling
// thread, switched in turn at every sync(), so that a barrier costs G
// context switches on one core whatever the machine's load. Both exchange
// the lanes' values the same way (HostLanes).
struct HostGroupState {
  int waiting = 0;
  long generation = 0;
  std::mutex mu;
  std::condition_variable cv;
  std::vector<unsigned char> slots;  // two arrays of 1 KiB per lane
  std::vector<long> exchanges;       // per lane (copies of a group share it)
};

struct FiberState {
  std::vector<unsigned char> slots;
  std::vector<long> exchanges;
  std::vector<ucontext_t> ctx;
  ucontext_t main;
  std::vector<std::vector<char>> stacks;
};

constexpr size_t kFiberStack = 1 << 18;

// What both host groups share, over Group's sync().
template <int G, class Group, class State>
struct HostLanes {
  int lane;
  State* st;
  // one butterfly step: every lane gets lane ^ o's values
  template <typename S, int N>
  void exchange(const S (&v)[N], int o, S (&w)[N]) const {
    static_assert(N * sizeof(S) <= 1024, "exchange slots hold 1 KiB per lane");
    unsigned char* buf = st->slots.data() + (st->exchanges[lane]++ & 1) * G * 1024;
    std::memcpy(buf + lane * 1024, v, sizeof(v));
    static_cast<const Group&>(*this).sync();
    std::memcpy(w, buf + (lane ^ o) * 1024, sizeof(w));
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
};

template <int G>
struct HostGroup : HostLanes<G, HostGroup<G>, HostGroupState> {
  void sync() const {
    HostGroupState* st = this->st;
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
  template <class F>
  static void run(F body) {
    HostGroupState st;
    st.slots.resize(2 * G * 1024);
    st.exchanges.assign(G, 0);
    std::vector<std::thread> lanes;
    for (int l = 0; l < G; ++l)
      lanes.emplace_back([&st, &body, l] { body(HostGroup<G>{{l, &st}}); });
    for (auto& t : lanes) t.join();
  }
};

template <int G>
struct FiberGroup : HostLanes<G, FiberGroup<G>, FiberState> {
  // every lane runs the same syncs, so switching to the next lane at each
  // one passes it only when all G have reached it
  void sync() const {
    swapcontext(&this->st->ctx[this->lane], &this->st->ctx[(this->lane + 1) % G]);
  }
  template <class F>
  struct Entry {
    static inline thread_local F* body = nullptr;
    static inline thread_local FiberState* st = nullptr;
    static void lane_main(int lane) { (*body)(FiberGroup<G>{{lane, st}}); }
  };
  template <class F>
  static void run(F body) {
    FiberState st;
    st.slots.resize(2 * G * 1024);
    st.exchanges.assign(G, 0);
    st.ctx.resize(G);
    st.stacks.assign(G, std::vector<char>(kFiberStack));
    Entry<F>::body = &body;
    Entry<F>::st = &st;
    for (int l = 0; l < G; ++l) {
      getcontext(&st.ctx[l]);
      st.ctx[l].uc_stack.ss_sp = st.stacks[l].data();
      st.ctx[l].uc_stack.ss_size = kFiberStack;
      // a lane that returns resumes the next one, the last the caller
      st.ctx[l].uc_link = l + 1 < G ? &st.ctx[l + 1] : &st.main;
      makecontext(&st.ctx[l], reinterpret_cast<void (*)()>(&Entry<F>::lane_main), 1, l);
    }
    swapcontext(&st.main, &st.ctx[0]);
  }
};
#endif

}  // namespace nptt
