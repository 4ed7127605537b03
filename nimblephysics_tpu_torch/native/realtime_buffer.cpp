// Native realtime control runtime — the latency-critical host path.
//
// C++ counterpart of dart/realtime/RealTimeControlBuffer (double-buffered
// force plans read lock-free by the control thread while the planner
// publishes, RealTimeControlBuffer.hpp:20-84) and dart/realtime/Ticker.
// The planner publishes plans from Python (device -> host copies);
// serving robots at kHz rates must not touch the GIL or allocate, so the
// buffer lives here and is read via ctypes from any thread/process.
//
// Concurrency: seqlock. The publisher bumps `seq` to odd, writes the
// inactive slot + header, swaps `active`, bumps `seq` to even. Readers
// retry while seq is odd or changed mid-read.

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Plan {
  double start_time = 0.0;
  double dt = 0.0;
  std::vector<double> u;  // horizon x na, row-major
};

struct RtBuffer {
  int horizon;
  int na;
  Plan slots[2];
  std::atomic<int> active{-1};       // -1: no plan yet
  std::atomic<uint64_t> seq{0};
  std::atomic<uint64_t> published{0};
};

double now_monotonic() {
  using clock = std::chrono::steady_clock;
  return std::chrono::duration<double>(clock::now().time_since_epoch()).count();
}

}  // namespace

extern "C" {

void* rtb_create(int horizon, int na) {
  auto* b = new RtBuffer();
  b->horizon = horizon;
  b->na = na;
  b->slots[0].u.resize(static_cast<size_t>(horizon) * na, 0.0);
  b->slots[1].u.resize(static_cast<size_t>(horizon) * na, 0.0);
  return b;
}

void rtb_destroy(void* handle) { delete static_cast<RtBuffer*>(handle); }

// Publish a new plan (planner thread). u is horizon*na row-major.
void rtb_publish(void* handle, double start_time, double dt, const double* u) {
  auto* b = static_cast<RtBuffer*>(handle);
  int cur = b->active.load(std::memory_order_acquire);
  int next = (cur == 0) ? 1 : 0;
  Plan& p = b->slots[next];
  p.start_time = start_time;
  p.dt = dt;
  std::memcpy(p.u.data(), u, sizeof(double) * p.u.size());
  b->seq.fetch_add(1, std::memory_order_acq_rel);      // -> odd
  b->active.store(next, std::memory_order_release);
  b->seq.fetch_add(1, std::memory_order_acq_rel);      // -> even
  b->published.fetch_add(1, std::memory_order_relaxed);
}

// Read the control for wall time t (control thread, lock-free).
// Returns the plan row index used, or -1 when no plan exists.
int rtb_control_at(void* handle, double t, double* out) {
  auto* b = static_cast<RtBuffer*>(handle);
  for (;;) {
    uint64_t s0 = b->seq.load(std::memory_order_acquire);
    if (s0 & 1) { std::this_thread::yield(); continue; }
    int cur = b->active.load(std::memory_order_acquire);
    if (cur < 0) return -1;
    const Plan& p = b->slots[cur];
    long idx = (p.dt > 0.0)
                   ? static_cast<long>((t - p.start_time) / p.dt)
                   : 0;
    if (idx < 0) idx = 0;
    if (idx >= b->horizon) idx = b->horizon - 1;
    std::memcpy(out, p.u.data() + static_cast<size_t>(idx) * b->na,
                sizeof(double) * b->na);
    uint64_t s1 = b->seq.load(std::memory_order_acquire);
    if (s0 == s1) return static_cast<int>(idx);
  }
}

uint64_t rtb_num_published(void* handle) {
  return static_cast<RtBuffer*>(handle)->published.load(
      std::memory_order_relaxed);
}

// ---- Ticker (dart/realtime/Ticker): precise periodic timing ---------------

double ticker_now() { return now_monotonic(); }

// Sleep until monotonic time `t` (coarse sleep + spin for the last 200us).
void ticker_sleep_until(double t) {
  for (;;) {
    double remaining = t - now_monotonic();
    if (remaining <= 0.0) return;
    if (remaining > 2e-4) {
      std::this_thread::sleep_for(
          std::chrono::duration<double>(remaining - 2e-4));
    } else {
      std::this_thread::yield();
    }
  }
}

}  // extern "C"
