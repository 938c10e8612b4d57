// ThreadSanitizer harness for the ingest core: one producer pushing
// records across several (including out-of-order) windows while a
// consumer drains and closes windows concurrently. Built by `make tsan`
// with -fsanitize=thread; exits 0 iff the aggregate counts balance and
// TSAN reports nothing (TSAN itself fails the process on a race when run
// with halt_on_error, and prints WARNINGs otherwise — the pytest wrapper
// checks both).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

// Source-stamp marker (the Makefile passes -DALZ_BIN_STAMP with the
// sha256 prefix of ingest.cc + tsan_test.cc concatenated): the alazspec
// staleness guard byte-scans the binary for it, so a tsan_test built
// from a different ingest core than the one checked in is flagged
// (ROADMAP ALZ020 follow-up).
#ifndef ALZ_BIN_STAMP
#define ALZ_BIN_STAMP "unstamped"
#endif
__attribute__((used)) static const char kAlzSourceStamp[] =
    "ALZ_SOURCE_STAMP:" ALZ_BIN_STAMP;

extern "C" {
struct AlzRecord {
  int64_t start_time_ms;
  uint64_t latency_ns;
  int32_t from_uid;
  int32_t to_uid;
  uint32_t status;
  uint8_t from_type;
  uint8_t to_type;
  uint8_t protocol;
  uint8_t flags;
};

void* alz_create(int64_t, uint32_t, uint32_t, uint32_t);
void alz_destroy(void*);
uint32_t alz_push(void*, const AlzRecord*, uint32_t);
int64_t alz_drain(void*);
int64_t alz_current_window(void*);
uint64_t alz_ring_dropped(void*);
uint64_t alz_late_dropped(void*);
uint64_t alz_acc_dropped(void*);
int32_t alz_close_window(void*, uint32_t, int64_t*, int32_t*, int32_t*,
                         uint8_t*, uint64_t*, uint64_t*, uint64_t*, uint32_t*,
                         uint32_t*, uint32_t*);
}

namespace {

constexpr uint32_t kBufCap = 4096;
constexpr int kRecords = 200000;
constexpr int kWindows = 20;

struct Buffers {
  std::vector<int32_t> src = std::vector<int32_t>(kBufCap);
  std::vector<int32_t> dst = std::vector<int32_t>(kBufCap);
  std::vector<uint8_t> proto = std::vector<uint8_t>(kBufCap);
  std::vector<uint64_t> count = std::vector<uint64_t>(kBufCap);
  std::vector<uint64_t> lat_sum = std::vector<uint64_t>(kBufCap);
  std::vector<uint64_t> lat_max = std::vector<uint64_t>(kBufCap);
  std::vector<uint32_t> err5 = std::vector<uint32_t>(kBufCap);
  std::vector<uint32_t> err4 = std::vector<uint32_t>(kBufCap);
  std::vector<uint32_t> tls = std::vector<uint32_t>(kBufCap);
};

uint64_t close_one(void* ig, Buffers* b, int* windows_closed) {
  int64_t ws = 0;
  int32_t n = alz_close_window(
      ig, kBufCap, &ws, b->src.data(), b->dst.data(), b->proto.data(),
      b->count.data(), b->lat_sum.data(), b->lat_max.data(), b->err5.data(),
      b->err4.data(), b->tls.data());
  if (n < 0) return 0;
  *windows_closed += 1;
  uint64_t total = 0;
  for (int32_t i = 0; i < n; ++i) total += b->count[i];
  return total;
}

}  // namespace

int main() {
  void* ig = alz_create(/*window_ms=*/100, /*ring=*/1 << 14, /*edges=*/kBufCap,
                        /*nodes=*/4096);

  std::atomic<uint64_t> pushed{0};
  std::atomic<bool> done{false};

  std::thread producer([&] {
    AlzRecord rec;
    std::memset(&rec, 0, sizeof(rec));
    uint32_t state = 12345;
    for (int i = 0; i < kRecords; ++i) {
      state = state * 1664525u + 1013904223u;
      int64_t w = (i * kWindows) / kRecords;  // advancing windows...
      if ((state >> 16 & 7) == 0 && w > 0) w -= 1;  // ...with stragglers
      rec.start_time_ms = w * 100 + (state & 63);
      rec.latency_ns = state & 0xFFFF;
      rec.from_uid = static_cast<int32_t>(state % 50);
      rec.to_uid = static_cast<int32_t>((state >> 8) % 50);
      rec.status = (state & 15) == 0 ? 500 : 200;
      rec.protocol = state % 8;
      rec.flags = state & 1;
      pushed.fetch_add(alz_push(ig, &rec, 1), std::memory_order_relaxed);
    }
    done.store(true, std::memory_order_release);
  });

  Buffers bufs;
  uint64_t accumulated = 0;
  int windows_closed = 0;
  while (!done.load(std::memory_order_acquire)) {
    int64_t ready = alz_drain(ig);
    if (ready != INT64_MIN) accumulated += close_one(ig, &bufs, &windows_closed);
  }
  producer.join();
  // final flush: drain the remainder and close every open window
  while (alz_drain(ig) != INT64_MIN) accumulated += close_one(ig, &bufs, &windows_closed);
  while (alz_current_window(ig) != INT64_MIN)
    accumulated += close_one(ig, &bufs, &windows_closed);

  uint64_t late = alz_late_dropped(ig);
  uint64_t ring_drop = alz_ring_dropped(ig);
  uint64_t acc_drop = alz_acc_dropped(ig);
  uint64_t accounted = accumulated + late + acc_drop;
  std::printf(
      "pushed=%llu accumulated=%llu late=%llu ring_dropped=%llu acc_dropped=%llu windows=%d\n",
      (unsigned long long)pushed.load(), (unsigned long long)accumulated,
      (unsigned long long)late, (unsigned long long)ring_drop,
      (unsigned long long)acc_drop, windows_closed);
  alz_destroy(ig);
  if (accounted != pushed.load()) {
    std::fprintf(stderr, "FAIL: %llu accepted but %llu accounted\n",
                 (unsigned long long)pushed.load(), (unsigned long long)accounted);
    return 1;
  }
  // Under TSAN slowdown the ring drops aggressively and may skip whole
  // windows; the invariant is the balance above plus multi-window progress.
  if (windows_closed < 2) {
    std::fprintf(stderr, "FAIL: only %d windows closed\n", windows_closed);
    return 1;
  }
  std::puts("OK");
  return 0;
}
