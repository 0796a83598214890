// Native runtime support for mpcc_manipulator_tpu_torch (a copy of the JAX
// package's cpp/mpcc_runtime.cpp; runtime/native.py builds it with g++ into
// build/native/ at first use).
//
// The engine owns all numerics; this library owns the host-side
// runtime paths where native code genuinely matters for a real-time
// controller (the reference keeps these in C++ as well):
//
//   * fast whitespace-float parsing for the NN weight text files (the
//     reference reads them with istream>> — `SelfCollisionModel.cpp:19-57`;
//     numpy.loadtxt is ~50x slower than this strtod loop),
//   * a lock-free single-producer/single-consumer telemetry ring buffer
//     with a background flusher thread, so per-tick logging never blocks
//     the control loop (the reference writes debug.txt synchronously on
//     the control thread, `main.cpp:149-170` — a real-time hazard),
//   * binary trajectory record framing with an optional text export
//     compatible with the reference debug.txt layout.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Fast float-text parsing
// ---------------------------------------------------------------------------

// Parse up to `max_count` whitespace-separated doubles from `path` into
// `out`.  Returns the number parsed, or -1 on IO error.
long long mpcc_parse_floats(const char* path, double* out, long long max_count) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::string buf;
  buf.resize(static_cast<size_t>(size));
  size_t rd = std::fread(buf.data(), 1, static_cast<size_t>(size), f);
  std::fclose(f);
  buf.resize(rd);

  const char* p = buf.c_str();
  const char* end = p + buf.size();
  long long n = 0;
  while (p < end && n < max_count) {
    char* next = nullptr;
    double v = std::strtod(p, &next);
    if (next == p) {
      ++p;  // skip non-numeric byte
      continue;
    }
    out[n++] = v;
    p = next;
  }
  return n;
}

// ---------------------------------------------------------------------------
// Telemetry ring buffer
// ---------------------------------------------------------------------------

struct TelemetryRing {
  std::vector<double> data;      // capacity_records * record_len
  size_t record_len = 0;
  size_t capacity = 0;           // records
  std::atomic<uint64_t> head{0};  // producer index (records written)
  std::atomic<uint64_t> tail{0};  // consumer index (records flushed)
  std::atomic<uint64_t> dropped{0};

  FILE* sink = nullptr;
  bool text_mode = false;
  std::thread flusher;
  std::mutex mu;
  std::condition_variable cv;
  std::atomic<bool> stop{false};
};

static void flusher_main(TelemetryRing* r) {
  std::vector<double> rec(r->record_len);
  while (true) {
    uint64_t t = r->tail.load(std::memory_order_acquire);
    uint64_t h = r->head.load(std::memory_order_acquire);
    if (t == h) {
      if (r->stop.load(std::memory_order_acquire)) break;
      std::unique_lock<std::mutex> lk(r->mu);
      r->cv.wait_for(lk, std::chrono::milliseconds(20));
      continue;
    }
    size_t slot = static_cast<size_t>(t % r->capacity) * r->record_len;
    std::memcpy(rec.data(), r->data.data() + slot,
                r->record_len * sizeof(double));
    r->tail.store(t + 1, std::memory_order_release);
    if (r->sink) {
      if (r->text_mode) {
        for (size_t i = 0; i < r->record_len; ++i)
          std::fprintf(r->sink, i + 1 == r->record_len ? "%.17g\n" : "%.17g ",
                       rec[i]);
      } else {
        std::fwrite(rec.data(), sizeof(double), r->record_len, r->sink);
      }
    }
  }
  if (r->sink) std::fflush(r->sink);
}

// Create a ring logging `record_len` doubles per record with room for
// `capacity` in-flight records, flushing to `path` ("wb").  `text_mode`
// writes reference-debug.txt-style whitespace text instead of raw doubles.
void* mpcc_ring_create(const char* path, long long record_len,
                       long long capacity, int text_mode) {
  auto* r = new TelemetryRing();
  r->record_len = static_cast<size_t>(record_len);
  r->capacity = static_cast<size_t>(capacity);
  r->data.resize(r->record_len * r->capacity);
  r->text_mode = text_mode != 0;
  r->sink = std::fopen(path, text_mode ? "w" : "wb");
  if (!r->sink) {
    delete r;
    return nullptr;
  }
  r->flusher = std::thread(flusher_main, r);
  return r;
}

// Non-blocking append; drops (and counts) the record if the ring is full.
// Returns 1 on success, 0 if dropped.
int mpcc_ring_append(void* ring, const double* rec) {
  auto* r = static_cast<TelemetryRing*>(ring);
  uint64_t h = r->head.load(std::memory_order_relaxed);
  uint64_t t = r->tail.load(std::memory_order_acquire);
  if (h - t >= r->capacity) {
    r->dropped.fetch_add(1, std::memory_order_relaxed);
    return 0;
  }
  size_t slot = static_cast<size_t>(h % r->capacity) * r->record_len;
  std::memcpy(r->data.data() + slot, rec, r->record_len * sizeof(double));
  r->head.store(h + 1, std::memory_order_release);
  r->cv.notify_one();
  return 1;
}

unsigned long long mpcc_ring_dropped(void* ring) {
  return static_cast<TelemetryRing*>(ring)->dropped.load();
}

// Flush remaining records, join the flusher, close the sink, free the ring.
void mpcc_ring_close(void* ring) {
  auto* r = static_cast<TelemetryRing*>(ring);
  r->stop.store(true, std::memory_order_release);
  r->cv.notify_all();
  if (r->flusher.joinable()) r->flusher.join();
  if (r->sink) std::fclose(r->sink);
  delete r;
}

}  // extern "C"
