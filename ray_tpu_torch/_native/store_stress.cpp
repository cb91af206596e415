// Multithreaded stress driver for the native store, built with
// -fsanitize=thread / -fsanitize=address by tests/core/test_store_sanitize.py
// (reference: the C++ runtime ships TSAN/ASAN CI configs — bazel
// --config=tsan/asan over the raylet/plasma cc_tests).
//
// Single translation unit: includes store.cpp directly so the stress
// binary links the sanitizer runtime into every store function.
//
// Exercises the full concurrent surface: allocation, seal, lookup,
// acquire/release readers, delete-under-reader (zombie path), evict,
// reap, and stats, from N writer threads + N reader threads sharing one
// segment. Exits 0 iff all invariants held (sanitizer findings abort
// the process by themselves).

#include "store.cpp"

#include <atomic>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

std::atomic<uint64_t> g_errors{0};

void FillId(uint8_t* id, int writer, int i) {
  std::memset(id, 0, 28);
  std::memcpy(id, &writer, sizeof(writer));
  std::memcpy(id + 8, &i, sizeof(i));
}

void WriterLoop(void* h, int writer, int iters) {
  uint8_t id[28];
  for (int i = 0; i < iters; i++) {
    FillId(id, writer, i);
    uint64_t size = 64 + (i % 17) * 64;
    uint64_t off = ns_alloc(h, id, size);
    if (off == ~0ULL || off == ~0ULL - 1) continue;  // full / exists
    ns_seal(h, id);
    if (i % 3 == 0) {
      ns_delete(h, id);   // may zombie under a racing reader
    } else if (i % 3 == 1) {
      ns_evict(h, id);    // refuses under readers
    }
    if (i % 64 == 0) {
      uint64_t used, cap;
      uint32_t n;
      ns_stats(h, &used, &cap, &n);
      if (used > cap * 4) g_errors++;
    }
  }
}

void ReaderLoop(void* h, int target_writer, int iters, int pid) {
  uint8_t id[28];
  for (int i = 0; i < iters; i++) {
    FillId(id, target_writer, i % 97);
    uint64_t off = 0, size = 0;
    uint32_t st = ns_acquire(h, id, pid, &off, &size);
    if (st == 2) {
      if (size == 0) g_errors++;
      ns_release(h, id, pid);
    }
    ns_lookup(h, id, &off, &size);
  }
}

}  // namespace

int main(int argc, char** argv) {
  const char* path = argc > 1 ? argv[1] : "/dev/shm/_store_stress.seg";
  int iters = argc > 2 ? std::atoi(argv[2]) : 4000;
  std::remove(path);
  void* h = ns_create(path, 256ull << 20, 4096);
  if (h == nullptr) {
    std::fprintf(stderr, "ns_create failed\n");
    return 2;
  }
  const int kWriters = 4, kReaders = 4;
  std::vector<std::thread> ts;
  for (int w = 0; w < kWriters; w++)
    ts.emplace_back(WriterLoop, h, w, iters);
  for (int r = 0; r < kReaders; r++)
    ts.emplace_back(ReaderLoop, h, r % kWriters, iters, 1000 + r);
  for (auto& t : ts) t.join();
  // crash-cleanup path: pretend every reader pid died
  ns_reap(h);
  uint64_t used, cap;
  uint32_t n;
  ns_stats(h, &used, &cap, &n);
  ns_close(h);
  std::remove(path);
  if (g_errors.load() != 0) {
    std::fprintf(stderr, "invariant violations: %llu\n",
                 (unsigned long long)g_errors.load());
    return 1;
  }
  std::printf("stress ok: %u objects resident, %llu bytes\n", n,
              (unsigned long long)used);
  return 0;
}
