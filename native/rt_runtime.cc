// Native real-time runtime: lock-free policy handoff + periodic RT loop.
//
// Native equivalent of the reference's real-time plumbing:
//  - PolicySlot: seqlock double-buffer replacing realtime_tools::RealtimeBuffer
//    (the MPC->control-thread policy handoff inside MPC_MRT_Interface,
//    BipedalController.cpp:319-352): the solver thread publishes the policy
//    blob (node times / states / inputs / gains flattened), the control loop
//    reads the latest consistent snapshot without ever blocking the writer.
//  - RtLoop: SCHED_FIFO periodic loop with absolute-deadline sleeping and
//    cycle-overrun accounting (BipedalHWLoop.cpp:31-85 semantics).
//
// Exposed as a plain C ABI for ctypes (see runtime/native_rt.py).
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <pthread.h>
#include <sched.h>
#include <thread>
#include <time.h>
#include <vector>

namespace {

struct PolicySlot {
  size_t n;
  std::vector<double> buf[2];     // double buffer
  std::atomic<uint64_t> seq{0};   // even: stable; odd: write in progress
};

struct RtLoopStats {
  uint64_t cycles = 0;
  uint64_t overruns = 0;
  int64_t max_cycle_ns = 0;
  int64_t last_cycle_ns = 0;
};

struct RtLoop {
  pthread_t thread;
  std::atomic<bool> running{false};
  double freq_hz;
  int priority;
  int (*callback)(void*);
  void* ctx;
  RtLoopStats stats;
};

int64_t now_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return int64_t(ts.tv_sec) * 1000000000LL + ts.tv_nsec;
}

void* rt_loop_main(void* arg) {
  RtLoop* loop = static_cast<RtLoop*>(arg);
  if (loop->priority > 0) {
    sched_param param{};
    param.sched_priority = loop->priority;
    // best effort: unprivileged environments fall back to CFS
    pthread_setschedparam(pthread_self(), SCHED_FIFO, &param);
  }
  const int64_t period_ns = int64_t(1e9 / loop->freq_hz);
  timespec next;
  clock_gettime(CLOCK_MONOTONIC, &next);
  while (loop->running.load(std::memory_order_relaxed)) {
    const int64_t t0 = now_ns();
    if (loop->callback(loop->ctx) != 0) {
      loop->running.store(false);
      break;
    }
    const int64_t cycle = now_ns() - t0;
    loop->stats.cycles++;
    loop->stats.last_cycle_ns = cycle;
    if (cycle > loop->stats.max_cycle_ns) loop->stats.max_cycle_ns = cycle;
    if (cycle > period_ns) loop->stats.overruns++;  // cycle-overrun warning analog
    next.tv_nsec += period_ns;
    while (next.tv_nsec >= 1000000000L) {
      next.tv_nsec -= 1000000000L;
      next.tv_sec += 1;
    }
    clock_nanosleep(CLOCK_MONOTONIC, TIMER_ABSTIME, &next, nullptr);
  }
  return nullptr;
}

}  // namespace

extern "C" {

void* policy_slot_create(size_t n_doubles) {
  auto* s = new PolicySlot();
  s->n = n_doubles;
  s->buf[0].assign(n_doubles, 0.0);
  s->buf[1].assign(n_doubles, 0.0);
  return s;
}

void policy_slot_destroy(void* h) { delete static_cast<PolicySlot*>(h); }

// Publish a new policy blob. Single writer assumed (the MPC thread).
void policy_slot_write(void* h, const double* data, size_t n) {
  auto* s = static_cast<PolicySlot*>(h);
  const uint64_t seq = s->seq.load(std::memory_order_relaxed);
  const int next = int((seq / 2 + 1) % 2);
  std::memcpy(s->buf[next].data(), data, sizeof(double) * (n < s->n ? n : s->n));
  s->seq.store(seq + 1, std::memory_order_release);  // odd: switching
  s->seq.store(seq + 2, std::memory_order_release);  // even: buf[next] stable
}

// Read the latest consistent snapshot; returns the sequence number (0 if no
// policy was ever published). Lock-free; retries across concurrent writes.
uint64_t policy_slot_read(void* h, double* out, size_t n) {
  auto* s = static_cast<PolicySlot*>(h);
  for (;;) {
    const uint64_t before = s->seq.load(std::memory_order_acquire);
    if (before == 0) return 0;
    if (before & 1) {
      std::this_thread::yield();
      continue;
    }
    const int cur = int((before / 2) % 2);
    std::memcpy(out, s->buf[cur].data(), sizeof(double) * (n < s->n ? n : s->n));
    const uint64_t after = s->seq.load(std::memory_order_acquire);
    if (after == before) return before;
  }
}

void* rt_loop_start(double freq_hz, int priority, int (*cb)(void*), void* ctx) {
  auto* loop = new RtLoop();
  loop->freq_hz = freq_hz;
  loop->priority = priority;
  loop->callback = cb;
  loop->ctx = ctx;
  loop->running.store(true);
  pthread_create(&loop->thread, nullptr, rt_loop_main, loop);
  return loop;
}

void rt_loop_stop(void* h) {
  auto* loop = static_cast<RtLoop*>(h);
  loop->running.store(false);
  pthread_join(loop->thread, nullptr);
}

// out: [cycles, overruns, max_cycle_ns, last_cycle_ns]
void rt_loop_stats(void* h, int64_t* out) {
  auto* loop = static_cast<RtLoop*>(h);
  out[0] = int64_t(loop->stats.cycles);
  out[1] = int64_t(loop->stats.overruns);
  out[2] = loop->stats.max_cycle_ns;
  out[3] = loop->stats.last_cycle_ns;
}

void rt_loop_destroy(void* h) { delete static_cast<RtLoop*>(h); }

}  // extern "C"
