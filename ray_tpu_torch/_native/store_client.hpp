// ray_tpu C++ store client: put/get raw buffers in a node's shared
// -memory object store from native code.
//
// Reference: the reference ships a C++ public API (``cpp/`` — Put/Get
// over the core worker). The TPU-native runtime keeps tasks/actors
// Python-side (specs travel as pickles), so the C++ surface targets
// what native code actually needs on a TPU host: zero-copy access to
// the object store — e.g. a C++ data loader producing blocks that
// Python tasks consume, or a native consumer mapping results without
// copies. Header-only over the same extern-C ABI the Python ctypes
// client uses (store.cpp), so both languages share one allocator,
// reader ledger, and crash-reap semantics.
//
// Usage:
//   ray::tpu::StoreClient store("/dev/shm/raytpu-<session>-<node>.seg");
//   auto id = ray::tpu::ObjectId::FromHex("...28-byte hex...");
//   store.Put(id, data, size);
//   ray::tpu::ObjectView v = store.Get(id);   // zero-copy, leased
//   ...
//   v.Release();  // or let the destructor release
//
// Interop: Python sees these objects via the normal runtime once their
// ids are announced (ray_tpu.core.native_store.NativeShmClient reads
// the same segment); ids are exchanged out of band (e.g. the KV API).

#pragma once

#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <unistd.h>

namespace ray {
namespace tpu {

extern "C" {
void* ns_open(const char* path);
void ns_close(void* handle);
uint64_t ns_alloc(void* handle, const uint8_t* id, uint64_t size);
uint64_t ns_seal(void* handle, const uint8_t* id);
uint32_t ns_lookup(void* handle, const uint8_t* id, uint64_t* off,
                   uint64_t* size);
uint32_t ns_acquire(void* handle, const uint8_t* id, int32_t pid,
                    uint64_t* off, uint64_t* size);
void ns_release(void* handle, const uint8_t* id, int32_t pid);
void ns_release_all(void* handle, int32_t pid);
void* ns_base(void* handle);
uint64_t ns_evict(void* handle, const uint8_t* id);
}

constexpr uint32_t kIdLen = 28;
constexpr uint64_t kFull = ~0ULL;
constexpr uint64_t kExists = ~0ULL - 1;

struct ObjectId {
  uint8_t bytes[kIdLen];

  static ObjectId FromHex(const std::string& hex) {
    if (hex.size() != kIdLen * 2)
      throw std::invalid_argument("object id hex must be 56 chars");
    ObjectId id;
    for (uint32_t i = 0; i < kIdLen; i++)
      id.bytes[i] = static_cast<uint8_t>(
          std::stoul(hex.substr(i * 2, 2), nullptr, 16));
    return id;
  }

  std::string Hex() const {
    static const char* d = "0123456789abcdef";
    std::string out(kIdLen * 2, '0');
    for (uint32_t i = 0; i < kIdLen; i++) {
      out[i * 2] = d[bytes[i] >> 4];
      out[i * 2 + 1] = d[bytes[i] & 0xf];
    }
    return out;
  }
};

class StoreClient;

// Zero-copy leased view of a sealed object. Holds a reader reference
// in the shared ledger (the extent cannot be evicted, spilled, or
// compacted away underneath it); released on destruction. Leases of
// crashed processes are reaped by the node manager.
class ObjectView {
 public:
  ObjectView() = default;
  ObjectView(const ObjectView&) = delete;
  ObjectView& operator=(const ObjectView&) = delete;
  ObjectView(ObjectView&& o) noexcept { *this = std::move(o); }
  ObjectView& operator=(ObjectView&& o) noexcept {
    Release();
    handle_ = o.handle_;
    id_ = o.id_;
    data_ = o.data_;
    size_ = o.size_;
    o.handle_ = nullptr;
    o.data_ = nullptr;
    return *this;
  }
  ~ObjectView() { Release(); }

  const uint8_t* data() const { return data_; }
  uint64_t size() const { return size_; }
  bool valid() const { return data_ != nullptr; }

  void Release() {
    if (handle_ != nullptr && data_ != nullptr) {
      ns_release(handle_, id_.bytes, static_cast<int32_t>(getpid()));
      data_ = nullptr;
      handle_ = nullptr;
    }
  }

 private:
  friend class StoreClient;
  void* handle_ = nullptr;
  ObjectId id_{};
  const uint8_t* data_ = nullptr;
  uint64_t size_ = 0;
};

class StoreClient {
 public:
  explicit StoreClient(const std::string& segment_path) {
    handle_ = ns_open(segment_path.c_str());
    if (handle_ == nullptr)
      throw std::runtime_error("cannot open segment " + segment_path);
    base_ = static_cast<uint8_t*>(ns_base(handle_));
  }
  StoreClient(const StoreClient&) = delete;
  StoreClient& operator=(const StoreClient&) = delete;
  ~StoreClient() {
    if (handle_ != nullptr) {
      ns_release_all(handle_, static_cast<int32_t>(getpid()));
      ns_close(handle_);
    }
  }

  // Create + write + seal in one call. Throws on duplicate id; returns
  // false when the store cannot admit the object right now (caller
  // should make room / retry — the Python node manager's background
  // eviction works toward the budget).
  bool Put(const ObjectId& id, const void* data, uint64_t size) {
    uint64_t off = ns_alloc(handle_, id.bytes, size);
    if (off == kExists) throw std::runtime_error("object exists");
    if (off == kFull) return false;
    std::memcpy(base_ + off, data, size);
    ns_seal(handle_, id.bytes);
    return true;
  }

  bool Contains(const ObjectId& id) const {
    uint64_t off = 0, size = 0;
    return ns_lookup(handle_, id.bytes, &off, &size) == 2;
  }

  // Zero-copy leased view; invalid() when the object is not sealed
  // here (spilled objects are restored by the Python runtime paths).
  ObjectView Get(const ObjectId& id) {
    uint64_t off = 0, size = 0;
    uint32_t state = ns_acquire(handle_, id.bytes,
                                static_cast<int32_t>(getpid()), &off,
                                &size);
    ObjectView v;
    if (state != 2) return v;
    v.handle_ = handle_;
    v.id_ = id;
    v.data_ = base_ + off;
    v.size_ = size;
    return v;
  }

  // Owner-side eager free (refuses under live readers); returns freed
  // bytes.
  uint64_t Evict(const ObjectId& id) {
    return ns_evict(handle_, id.bytes);
  }

 private:
  void* handle_ = nullptr;
  uint8_t* base_ = nullptr;
};

}  // namespace tpu
}  // namespace ray
