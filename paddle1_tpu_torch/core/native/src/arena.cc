// Shared-memory arena of the port's DataLoader: worker processes write
// collated batches into it, the parent reads them out.
//
// The arena part of the JAX package's core/native/src/native.cc (its
// lines 122-248), copied: POSIX shm slabs with a bump allocator and
// per-block reference counts (reference
// paddle/fluid/memory/allocation/mmap_allocator.cc). Built by
// core/native/__init__.py with g++ at first use and loaded through
// ctypes; a plain C ABI, no Python or PyTorch headers.

#include <atomic>
#include <cerrno>
#include <cstdint>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------------------
// ShmArena: POSIX shared-memory slab with block allocator + refcounts.
// Layout: [ArenaHeader][BlockHeader data...]*
// ---------------------------------------------------------------------------

struct ArenaHeader {
  uint64_t magic;           // 0x50311A7E
  uint64_t size;            // total bytes
  std::atomic<uint64_t> bump;  // offset of next free byte
};

struct BlockHeader {
  uint64_t len;             // payload bytes
  std::atomic<int64_t> refs;
};

static const uint64_t kMagic = 0x50311A7EULL;

// Create (or attach to) a named shm arena; returns mapped base or null.
// ftruncate runs ONLY on fresh O_EXCL creation — resizing an arena another
// process already mapped would shear its mapping.
void* shm_arena_create(const char* name, uint64_t size) {
  bool created = true;
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0 && errno == EEXIST) {
    created = false;
    fd = shm_open(name, O_RDWR, 0600);
  }
  if (fd < 0) return nullptr;
  if (created) {
    if (ftruncate(fd, (off_t)size) != 0) {
      close(fd);
      shm_unlink(name);
      return nullptr;
    }
  } else {
    struct stat st;
    if (fstat(fd, &st) != 0 || (uint64_t)st.st_size < size) {
      close(fd);
      return nullptr;  // existing arena too small; caller picks a new name
    }
    size = (uint64_t)st.st_size;
  }
  void* base = mmap(nullptr, size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return nullptr;
  auto* hdr = static_cast<ArenaHeader*>(base);
  if (created || hdr->magic != kMagic) {
    hdr->magic = kMagic;
    hdr->size = size;
    hdr->bump.store(sizeof(ArenaHeader));
  }
  return base;
}

void* shm_arena_attach(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* base =
      mmap(nullptr, st.st_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  return base == MAP_FAILED ? nullptr : base;
}

void shm_arena_detach(void* base) {
  auto* hdr = static_cast<ArenaHeader*>(base);
  munmap(base, hdr->size);
}

uint64_t shm_arena_size(void* base) {
  return static_cast<ArenaHeader*>(base)->size;
}

void shm_arena_unlink(const char* name) { shm_unlink(name); }

// Allocate a refcounted block; returns offset of the payload (0 on failure).
uint64_t shm_alloc(void* base, uint64_t len) {
  auto* hdr = static_cast<ArenaHeader*>(base);
  uint64_t need = sizeof(BlockHeader) + ((len + 63) & ~63ULL);
  // CAS loop instead of fetch_add + rollback: a failed add followed by a
  // fetch_sub can momentarily overlap a concurrent winner's range.
  uint64_t off = hdr->bump.load(std::memory_order_relaxed);
  do {
    if (off + need > hdr->size) return 0;  // arena full
  } while (!hdr->bump.compare_exchange_weak(off, off + need,
                                            std::memory_order_acq_rel,
                                            std::memory_order_relaxed));
  auto* blk = reinterpret_cast<BlockHeader*>(static_cast<char*>(base) + off);
  blk->len = len;
  blk->refs.store(1);
  return off + sizeof(BlockHeader);
}

uint8_t* shm_ptr(void* base, uint64_t payload_off) {
  return reinterpret_cast<uint8_t*>(base) + payload_off;
}

static BlockHeader* blk_of(void* base, uint64_t payload_off) {
  return reinterpret_cast<BlockHeader*>(static_cast<char*>(base) +
                                        payload_off - sizeof(BlockHeader));
}

void shm_incref(void* base, uint64_t payload_off) {
  blk_of(base, payload_off)->refs.fetch_add(1);
}

// Returns refcount after decrement (block memory reclaimed only on reset).
int64_t shm_decref(void* base, uint64_t payload_off) {
  return blk_of(base, payload_off)->refs.fetch_sub(1) - 1;
}

// Reset the bump pointer (all blocks must be released; epoch-style reuse,
// which is the DataLoader pattern: arena per epoch/prefetch window).
void shm_arena_reset(void* base) {
  auto* hdr = static_cast<ArenaHeader*>(base);
  hdr->bump.store(sizeof(ArenaHeader));
}

uint64_t shm_arena_used(void* base) {
  return static_cast<ArenaHeader*>(base)->bump.load();
}

}  // extern "C"
