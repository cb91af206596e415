// Native shared-memory object store: the plasma-equivalent data plane.
//
// Reference analog: src/ray/object_manager/plasma/{store.cc,
// plasma_allocator.h, dlmalloc.cc} — objects live inside ONE mmap'd
// segment; an in-segment index (open-addressed hash of 28-byte object
// ids -> extent) plus a process-shared mutex make create/seal/lookup a
// handful of shared-memory ops instead of per-object file syscalls.
// The Python layer keeps eviction/spill policy (like the raylet owns
// plasma's lifecycle); this file is the allocator + index + views.
//
// Build: g++ -O2 -shared -fPIC -o libnativestore.so store.cpp -lpthread
// ABI: every function is extern "C", loaded via ctypes.

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <vector>

#include <fcntl.h>
#include <pthread.h>
#include <signal.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x52545055'53544f52ULL;  // "RTPUSTOR"
constexpr uint32_t kMaxFree = 4096;
constexpr uint64_t kAlign = 64;
constexpr uint32_t kIdLen = 28;

// Slot states
constexpr uint32_t kFree = 0;
constexpr uint32_t kBuilding = 1;
constexpr uint32_t kSealed = 2;
constexpr uint32_t kZombie = 3;  // deleted while readers hold views

constexpr uint32_t kMaxReaders = 8192;

struct Slot {
  uint8_t id[kIdLen];
  uint64_t off;    // relative to data_off
  uint64_t size;
  uint32_t state;
  uint32_t probe;  // nonzero if the slot was ever used (tombstones keep
                   // probe chains intact after delete)
  uint32_t refcnt;  // live zero-copy readers (plasma client refs)
  uint32_t pad;
};

// Crash-safe reader ledger: acquires are keyed by (pid, slot), so the
// node manager can reap references held by processes that died without
// releasing (plasma's disconnected-client cleanup).
struct Reader {
  int32_t pid;    // 0 = free entry
  uint32_t slot;  // slot index
  uint32_t count;
  uint32_t pad;
};

struct FreeExtent {
  uint64_t off;
  uint64_t size;
};

struct Header {
  uint64_t magic;
  uint64_t total_size;  // whole segment incl. header
  uint64_t capacity;    // data area bytes
  uint64_t data_off;
  uint64_t bump;        // high-water mark within data area
  uint64_t used;
  uint32_t nslots;
  uint32_t nfree;
  uint32_t nobjects;
  uint32_t pad;
  pthread_mutex_t mutex;
  // Slots then free extents follow.
};

struct Handle {
  int fd;
  uint8_t* base;
  uint64_t mapped;
  Header* hdr;
  Slot* slots;
  FreeExtent* freelist;
  Reader* readers;
};

uint64_t HashId(const uint8_t* id) {
  // FNV-1a over the 28-byte id.
  uint64_t h = 1469598103934665603ULL;
  for (uint32_t i = 0; i < kIdLen; i++) {
    h ^= id[i];
    h *= 1099511628211ULL;
  }
  return h;
}

uint64_t AlignUp(uint64_t v) { return (v + kAlign - 1) & ~(kAlign - 1); }

void Free(Handle* h, uint64_t off, uint64_t size);
void FreeSlot(Handle* h, Slot* s);

// A process died holding the lock, possibly mid-mutation: the slot table
// is the source of truth (each slot is written id-first, state-last), so
// rebuild every piece of derived allocator state from it — drop slots
// with impossible geometry, recompute bump/used/nobjects, reconstruct the
// freelist from the gaps between live extents, and clear reader-ledger
// entries that point at freed/corrupt slots. Anything the dead process
// half-allocated but never published in a slot is reclaimed by the
// recomputed bump/freelist.
void RecoverAllocator(Handle* h) {
  Header* hdr = h->hdr;
  uint32_t nlive = 0;
  FreeExtent* live = new FreeExtent[hdr->nslots];
  uint64_t used = 0;
  uint32_t nobjects = 0;
  for (uint32_t i = 0; i < hdr->nslots; i++) {
    Slot* s = &h->slots[i];
    if (s->state == kFree) continue;
    uint64_t asize = AlignUp(s->size ? s->size : 1);
    if (s->state > kZombie || s->off > hdr->capacity ||
        asize > hdr->capacity - s->off) {
      // torn write: demote to tombstone (probe chain stays intact)
      s->state = kFree;
      s->probe = 1;
      s->refcnt = 0;
      continue;
    }
    live[nlive].off = s->off;
    live[nlive].size = asize;
    nlive++;
    used += asize;
    if (s->state == kBuilding || s->state == kSealed) nobjects++;
  }
  std::sort(live, live + nlive,
            [](const FreeExtent& a, const FreeExtent& b) {
              return a.off < b.off;
            });
  uint64_t cursor = 0;
  uint32_t nfree = 0;
  for (uint32_t i = 0; i < nlive; i++) {
    if (live[i].off > cursor && nfree < kMaxFree) {
      h->freelist[nfree].off = cursor;
      h->freelist[nfree].size = live[i].off - cursor;
      nfree++;
    }
    uint64_t end = live[i].off + live[i].size;
    if (end > cursor) cursor = end;
  }
  hdr->bump = cursor;
  hdr->nfree = nfree;
  hdr->used = used;
  hdr->nobjects = nobjects;
  delete[] live;
  // Rebuild per-slot refcounts from the ledger (a crash between the
  // ledger increment and the slot increment would otherwise skew them
  // forever), then reclaim zombies nobody references anymore.
  for (uint32_t i = 0; i < hdr->nslots; i++) {
    if (h->slots[i].state != kFree) h->slots[i].refcnt = 0;
  }
  for (uint32_t i = 0; i < kMaxReaders; i++) {
    Reader* r = &h->readers[i];
    if (r->pid == 0) continue;
    if (r->slot >= hdr->nslots || h->slots[r->slot].state == kFree) {
      r->pid = 0;
      r->count = 0;
      continue;
    }
    h->slots[r->slot].refcnt += r->count;
  }
  for (uint32_t i = 0; i < hdr->nslots; i++) {
    Slot* s = &h->slots[i];
    if (s->state == kZombie && s->refcnt == 0) FreeSlot(h, s);
  }
}

class Locker {
 public:
  explicit Locker(Handle* h) : h_(h) {
    int rc = pthread_mutex_lock(&h_->hdr->mutex);
    if (rc == EOWNERDEAD) {
      // A crashed process died holding the lock mid-critical-section:
      // rebuild derived allocator state from the slot table before
      // declaring the mutex consistent.
      RecoverAllocator(h_);
      pthread_mutex_consistent(&h_->hdr->mutex);
    }
  }
  ~Locker() { pthread_mutex_unlock(&h_->hdr->mutex); }

 private:
  Handle* h_;
};

Slot* FindSlot(Handle* h, const uint8_t* id, bool find_empty) {
  Header* hdr = h->hdr;
  uint64_t idx = HashId(id) % hdr->nslots;
  Slot* first_tomb = nullptr;
  for (uint32_t i = 0; i < hdr->nslots; i++) {
    Slot* s = &h->slots[(idx + i) % hdr->nslots];
    if (s->state == kFree) {
      if (s->probe == 0) {
        // End of probe chain.
        if (find_empty) return first_tomb ? first_tomb : s;
        return nullptr;
      }
      if (find_empty && first_tomb == nullptr) first_tomb = s;
      continue;  // tombstone: keep probing
    }
    if (memcmp(s->id, id, kIdLen) == 0) return s;
  }
  return find_empty ? first_tomb : nullptr;
}

// Allocate from free list (first fit) or bump. Returns relative offset
// or UINT64_MAX.
uint64_t Alloc(Handle* h, uint64_t size) {
  Header* hdr = h->hdr;
  for (uint32_t i = 0; i < hdr->nfree; i++) {
    FreeExtent* e = &h->freelist[i];
    if (e->size >= size) {
      uint64_t off = e->off;
      e->off += size;
      e->size -= size;
      if (e->size == 0) {
        h->freelist[i] = h->freelist[hdr->nfree - 1];
        hdr->nfree--;
      }
      return off;
    }
  }
  if (hdr->bump + size > hdr->capacity) return UINT64_MAX;
  uint64_t off = hdr->bump;
  hdr->bump += size;
  return off;
}

void Free(Handle* h, uint64_t off, uint64_t size) {
  Header* hdr = h->hdr;
  // Coalesce with an adjacent extent if possible.
  for (uint32_t i = 0; i < hdr->nfree; i++) {
    FreeExtent* e = &h->freelist[i];
    if (e->off + e->size == off) {
      e->size += size;
      return;
    }
    if (off + size == e->off) {
      e->off = off;
      e->size += size;
      return;
    }
  }
  if (off + size == hdr->bump) {  // give back to the bump region
    hdr->bump = off;
    return;
  }
  if (hdr->nfree < kMaxFree) {
    h->freelist[hdr->nfree].off = off;
    h->freelist[hdr->nfree].size = size;
    hdr->nfree++;
  }
  // else: extent leaks until the session ends (bounded by kMaxFree
  // fragmentation; acceptable for a session-scoped store).
}

Handle* MapSegment(int fd, uint64_t total) {
  void* base =
      mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  Handle* h = new Handle();
  h->fd = fd;
  h->base = static_cast<uint8_t*>(base);
  h->mapped = total;
  h->hdr = reinterpret_cast<Header*>(base);
  h->slots = reinterpret_cast<Slot*>(h->base + sizeof(Header));
  h->freelist = reinterpret_cast<FreeExtent*>(
      h->base + sizeof(Header) + sizeof(Slot) * h->hdr->nslots);
  h->readers = reinterpret_cast<Reader*>(
      h->base + sizeof(Header) + sizeof(Slot) * h->hdr->nslots +
      sizeof(FreeExtent) * kMaxFree);
  return h;
}

// Free a zombie slot's extent once its last reader releases.
void FreeSlot(Handle* h, Slot* s) {
  uint64_t asize = AlignUp(s->size ? s->size : 1);
  Free(h, s->off, asize);
  s->state = kFree;  // probe stays 1: tombstone
  h->hdr->used -= asize;
}

constexpr uint32_t kProbeWindow = 128;

Reader* FindReader(Handle* h, int32_t pid, uint32_t slot_idx,
                   bool create) {
  // Fixed probe window, scanned fully by both find and create, so a
  // create and its later find always agree on the entry.
  uint64_t start = ((uint64_t)pid * 2654435761ULL + slot_idx) % kMaxReaders;
  Reader* free_entry = nullptr;
  for (uint32_t i = 0; i < kProbeWindow; i++) {
    Reader* r = &h->readers[(start + i) % kMaxReaders];
    if (r->pid == pid && r->slot == slot_idx && r->count > 0) return r;
    if (r->pid == 0 && free_entry == nullptr) free_entry = r;
  }
  if (create && free_entry != nullptr) {
    free_entry->pid = pid;
    free_entry->slot = slot_idx;
    free_entry->count = 0;
    return free_entry;
  }
  return nullptr;
}

}  // namespace

extern "C" {

// Create the segment file. Returns handle or null.
void* ns_create(const char* path, uint64_t capacity, uint32_t nslots) {
  int fd = open(path, O_RDWR | O_CREAT | O_EXCL, 0600);
  if (fd < 0) return nullptr;
  uint64_t meta = sizeof(Header) + sizeof(Slot) * (uint64_t)nslots +
                  sizeof(FreeExtent) * (uint64_t)kMaxFree +
                  sizeof(Reader) * (uint64_t)kMaxReaders;
  meta = AlignUp(meta);
  uint64_t total = meta + capacity;
  if (ftruncate(fd, (off_t)total) != 0) {
    close(fd);
    unlink(path);
    return nullptr;
  }
  Handle* h;
  {
    void* base =
        mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
    if (base == MAP_FAILED) {
      close(fd);
      unlink(path);
      return nullptr;
    }
    Header* hdr = static_cast<Header*>(base);
    memset(hdr, 0, sizeof(Header));
    hdr->total_size = total;
    hdr->capacity = capacity;
    hdr->data_off = meta;
    hdr->nslots = nslots;
    pthread_mutexattr_t attr;
    pthread_mutexattr_init(&attr);
    pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
    pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
    pthread_mutex_init(&hdr->mutex, &attr);
    pthread_mutexattr_destroy(&attr);
    // Slots/freelist are already zero (fresh file pages).
    hdr->magic = kMagic;  // publish last
    h = new Handle();
    h->fd = fd;
    h->base = static_cast<uint8_t*>(base);
    h->mapped = total;
    h->hdr = hdr;
    h->slots = reinterpret_cast<Slot*>(h->base + sizeof(Header));
    h->freelist = reinterpret_cast<FreeExtent*>(
        h->base + sizeof(Header) + sizeof(Slot) * nslots);
    h->readers = reinterpret_cast<Reader*>(
        h->base + sizeof(Header) + sizeof(Slot) * nslots +
        sizeof(FreeExtent) * kMaxFree);
  }
  return h;
}

// Open an existing segment. Returns handle or null.
void* ns_open(const char* path) {
  int fd = open(path, O_RDWR);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || (uint64_t)st.st_size < sizeof(Header)) {
    close(fd);
    return nullptr;
  }
  // Map header first to learn the total size.
  void* probe = mmap(nullptr, sizeof(Header), PROT_READ, MAP_SHARED, fd, 0);
  if (probe == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  Header* hdr = static_cast<Header*>(probe);
  if (hdr->magic != kMagic) {
    munmap(probe, sizeof(Header));
    close(fd);
    return nullptr;
  }
  uint64_t total = hdr->total_size;
  munmap(probe, sizeof(Header));
  return MapSegment(fd, total);
}

// Reserve space for an object. Returns ABSOLUTE offset into the
// segment, or UINT64_MAX (full) / UINT64_MAX-1 (already exists).
uint64_t ns_alloc(void* handle, const uint8_t* id, uint64_t size) {
  Handle* h = static_cast<Handle*>(handle);
  uint64_t asize = AlignUp(size ? size : 1);
  Locker lock(h);
  Slot* existing = FindSlot(h, id, false);
  if (existing != nullptr) return UINT64_MAX - 1;
  Slot* s = FindSlot(h, id, true);
  if (s == nullptr) return UINT64_MAX;  // index full
  uint64_t off = Alloc(h, asize);
  if (off == UINT64_MAX) return UINT64_MAX;
  memcpy(s->id, id, kIdLen);
  s->off = off;
  s->size = size;
  s->state = kBuilding;
  s->probe = 1;
  h->hdr->used += asize;
  h->hdr->nobjects++;
  return h->hdr->data_off + off;
}

// Publish. Returns size or UINT64_MAX if unknown id.
uint64_t ns_seal(void* handle, const uint8_t* id) {
  Handle* h = static_cast<Handle*>(handle);
  Locker lock(h);
  Slot* s = FindSlot(h, id, false);
  if (s == nullptr) return UINT64_MAX;
  s->state = kSealed;
  return s->size;
}

// Lookup. Returns state (0 absent, 1 building, 2 sealed); fills
// absolute offset + logical size when sealed.
uint32_t ns_lookup(void* handle, const uint8_t* id, uint64_t* off,
                   uint64_t* size) {
  Handle* h = static_cast<Handle*>(handle);
  Locker lock(h);
  Slot* s = FindSlot(h, id, false);
  if (s == nullptr || s->state == kZombie) return 0;
  if (off) *off = h->hdr->data_off + s->off;
  if (size) *size = s->size;
  return s->state;
}

// Delete. The extent is freed immediately when unreferenced; with live
// readers the slot turns ZOMBIE (invisible to lookups) and its bytes
// are reclaimed on the last release/reap — never under a reader.
uint64_t ns_delete(void* handle, const uint8_t* id) {
  Handle* h = static_cast<Handle*>(handle);
  Locker lock(h);
  Slot* s = FindSlot(h, id, false);
  if (s == nullptr || s->state == kZombie) return 0;
  uint64_t asize = AlignUp(s->size ? s->size : 1);
  h->hdr->nobjects--;
  if (s->refcnt > 0) {
    s->state = kZombie;
    return 0;
  }
  FreeSlot(h, s);
  return asize;
}

// Evict: free ONLY if no reader holds a reference (the eviction path —
// plasma never evicts referenced objects). Returns freed bytes, 0 if
// absent/referenced.
uint64_t ns_evict(void* handle, const uint8_t* id) {
  Handle* h = static_cast<Handle*>(handle);
  Locker lock(h);
  Slot* s = FindSlot(h, id, false);
  if (s == nullptr || s->state == kZombie || s->refcnt > 0) return 0;
  uint64_t asize = AlignUp(s->size ? s->size : 1);
  h->hdr->nobjects--;
  FreeSlot(h, s);
  return asize;
}

// Acquire a read reference (sealed objects only). Returns state.
uint32_t ns_acquire(void* handle, const uint8_t* id, int32_t pid,
                    uint64_t* off, uint64_t* size) {
  Handle* h = static_cast<Handle*>(handle);
  Locker lock(h);
  Slot* s = FindSlot(h, id, false);
  if (s == nullptr || s->state != kSealed) return s ? s->state : 0;
  Reader* r = FindReader(h, pid, (uint32_t)(s - h->slots), true);
  if (r == nullptr) return 0;  // ledger full: treat as absent (copy path)
  r->count++;
  s->refcnt++;
  if (off) *off = h->hdr->data_off + s->off;
  if (size) *size = s->size;
  return kSealed;
}

// Drop one read reference.
void ns_release(void* handle, const uint8_t* id, int32_t pid) {
  Handle* h = static_cast<Handle*>(handle);
  Locker lock(h);
  Slot* s = FindSlot(h, id, false);
  if (s == nullptr || s->refcnt == 0) return;
  Reader* r = FindReader(h, pid, (uint32_t)(s - h->slots), false);
  if (r == nullptr || r->count == 0) return;
  r->count--;
  if (r->count == 0) r->pid = 0;
  s->refcnt--;
  if (s->refcnt == 0 && s->state == kZombie) FreeSlot(h, s);
}

// Drop ALL references held by one pid (clean client shutdown).
void ns_release_all(void* handle, int32_t pid) {
  Handle* h = static_cast<Handle*>(handle);
  Locker lock(h);
  for (uint32_t i = 0; i < kMaxReaders; i++) {
    Reader* r = &h->readers[i];
    if (r->pid != pid || r->count == 0) continue;
    Slot* s = &h->slots[r->slot];
    if (s->refcnt >= r->count) s->refcnt -= r->count;
    else s->refcnt = 0;
    r->pid = 0;
    r->count = 0;
    if (s->refcnt == 0 && s->state == kZombie) FreeSlot(h, s);
  }
}

// Reap references held by dead processes (node-manager heartbeat).
// Returns number of reaped ledger entries.
uint32_t ns_reap(void* handle) {
  Handle* h = static_cast<Handle*>(handle);
  Locker lock(h);
  uint32_t reaped = 0;
  for (uint32_t i = 0; i < kMaxReaders; i++) {
    Reader* r = &h->readers[i];
    if (r->pid == 0 || r->count == 0) continue;
    if (kill(r->pid, 0) == -1 && errno == ESRCH) {
      Slot* s = &h->slots[r->slot];
      if (s->refcnt >= r->count) s->refcnt -= r->count;
      else s->refcnt = 0;
      r->pid = 0;
      r->count = 0;
      if (s->refcnt == 0 && s->state == kZombie) FreeSlot(h, s);
      reaped++;
    }
  }
  return reaped;
}

// Test/diagnostic hook: force the EOWNERDEAD recovery path.
void ns_recover(void* handle) {
  Handle* h = static_cast<Handle*>(handle);
  Locker lock(h);
  RecoverAllocator(h);
}

void ns_stats(void* handle, uint64_t* used, uint64_t* capacity,
              uint32_t* nobjects) {
  Handle* h = static_cast<Handle*>(handle);
  Locker lock(h);
  if (used) *used = h->hdr->used;
  if (capacity) *capacity = h->hdr->capacity;
  if (nobjects) *nobjects = h->hdr->nobjects;
}

// Enumerate sealed objects: fills out_ids (max_n * kIdLen bytes),
// out_sizes and out_refcnts (max_n entries each); returns the count
// written. Lets the node-manager authority see locally-created objects
// it was never notified about (spill/eviction candidates) — plasma's
// store-side object table walk.
uint32_t ns_list(void* handle, uint8_t* out_ids, uint64_t* out_sizes,
                 uint32_t* out_refcnts, uint32_t max_n) {
  Handle* h = static_cast<Handle*>(handle);
  Locker lock(h);
  Header* hdr = h->hdr;
  uint32_t n = 0;
  for (uint32_t i = 0; i < hdr->nslots && n < max_n; i++) {
    Slot* s = &h->slots[i];
    if (s->state != kSealed) continue;
    memcpy(out_ids + static_cast<size_t>(n) * kIdLen, s->id, kIdLen);
    out_sizes[n] = s->size;
    out_refcnts[n] = s->refcnt;
    n++;
  }
  return n;
}

// Base pointer of the mapping (for ctypes buffer construction).
uint8_t* ns_base(void* handle) {
  return static_cast<Handle*>(handle)->base;
}

// Largest contiguous allocatable run (freelist max + bump tail).
uint64_t ns_largest_free(void* handle) {
  Handle* h = static_cast<Handle*>(handle);
  Locker lock(h);
  Header* hdr = h->hdr;
  uint64_t best = hdr->capacity > hdr->bump
      ? hdr->capacity - hdr->bump : 0;
  for (uint32_t i = 0; i < hdr->nfree; i++) {
    if (h->freelist[i].size > best) best = h->freelist[i].size;
  }
  return best;
}

// Defragment: slide every MOVABLE extent (sealed, zero readers — an
// acquire takes the same lock and pins via refcnt, so movability is
// race-free) toward low addresses, packing around pinned extents
// (building / reader-held / zombie), then rebuild the freelist from
// the remaining gaps. This is what plasma gets from dlmalloc's
// boundary-tag coalescing plus eviction; a pinned-scatter arena
// otherwise fragments until no large extent fits even at low
// utilization (observed: 17 MB create failing with 48 MB of 192 MB
// held). Returns the largest contiguous free run afterwards.
uint64_t ns_compact(void* handle) {
  Handle* h = static_cast<Handle*>(handle);
  Locker lock(h);
  Header* hdr = h->hdr;
  // live slots in address order
  struct Ent { Slot* s; uint64_t off; uint64_t asize; bool movable; };
  std::vector<Ent> live;
  live.reserve(hdr->nobjects);
  for (uint32_t i = 0; i < hdr->nslots; i++) {
    Slot* s = &h->slots[i];
    if (s->state == kFree) continue;
    Ent e;
    e.s = s;
    e.off = s->off;
    e.asize = AlignUp(s->size ? s->size : 1);
    e.movable = (s->state == kSealed && s->refcnt == 0);
    live.push_back(e);
  }
  std::sort(live.begin(), live.end(),
            [](const Ent& a, const Ent& b) { return a.off < b.off; });
  uint8_t* data = h->base + hdr->data_off;
  // extents are disjoint and processed in address order, so cursor
  // (end of the previous packed/pinned extent) never exceeds the next
  // extent's offset
  uint64_t cursor = 0;
  for (auto& e : live) {
    if (!e.movable) {
      // pinned: the gap [cursor, e.off) stays free; packing resumes
      // after it
      cursor = e.off + e.asize;
      continue;
    }
    if (e.off > cursor) {
      memmove(data + cursor, data + e.off, e.asize);
      e.s->off = cursor;
      e.off = cursor;
    }
    cursor = e.off + e.asize;
  }
  // rebuild freelist + bump from the (possibly moved) extents
  std::sort(live.begin(), live.end(),
            [](const Ent& a, const Ent& b) { return a.off < b.off; });
  uint64_t scan = 0;
  uint32_t nfree = 0;
  for (auto& e : live) {
    if (e.off > scan && nfree < kMaxFree) {
      h->freelist[nfree].off = scan;
      h->freelist[nfree].size = e.off - scan;
      nfree++;
    }
    uint64_t end = e.off + e.asize;
    if (end > scan) scan = end;
  }
  hdr->bump = scan;
  hdr->nfree = nfree;
  uint64_t best = hdr->capacity > scan ? hdr->capacity - scan : 0;
  for (uint32_t i = 0; i < nfree; i++) {
    if (h->freelist[i].size > best) best = h->freelist[i].size;
  }
  return best;
}

uint64_t ns_total_size(void* handle) {
  return static_cast<Handle*>(handle)->mapped;
}

void ns_close(void* handle) {
  Handle* h = static_cast<Handle*>(handle);
  munmap(h->base, h->mapped);
  close(h->fd);
  delete h;
}

}  // extern "C"
