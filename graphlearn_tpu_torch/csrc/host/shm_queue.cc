// Cross-process sample-message queue in SysV shared memory.
//
// Host-side rethink of the reference's ShmQueue
// (`csrc/shm_queue.cc`, `include/shm_queue.h:30-240`).  The reference
// allocates variable-size blocks on a byte ring with per-block
// semaphores because its torch messages are ragged.  Our whole design
// is static-shape (padded batches), so every message in an epoch has
// the same byte size: a fixed-slot bounded MPMC ring (Vyukov sequence
// numbers for slot ownership + two counting semaphores for blocking)
// is simpler, has no fragmentation, and one fewer copy on the reader
// side.  Multi-producer / multi-consumer, blocking semantics identical
// to the reference (producers block when full, consumers when empty).
//
// The queue is picklable by shmid (reference `py_export.cc:132-140`):
// any process on the host can attach with `glt_queue_attach`.
#include <cerrno>
#include <ctime>
#include <semaphore.h>
#include <sys/ipc.h>
#include <sys/shm.h>

#include <atomic>
#include <cstdint>
#include <cstring>

#include "common.h"

namespace {

struct SlotHeader {
  std::atomic<uint64_t> seq;  // Vyukov sequence number.
  uint64_t len;               // payload bytes actually used.
};

struct QueueHeader {
  uint64_t magic;
  uint64_t num_slots;
  uint64_t slot_bytes;  // payload capacity per slot (excl. SlotHeader)
  std::atomic<uint64_t> head;  // producer ticket
  std::atomic<uint64_t> tail;  // consumer ticket
  sem_t free_slots;    // counts empty slots; producers wait here
  sem_t filled_slots;  // counts ready slots; consumers wait here
};

constexpr uint64_t kMagic = 0x474c545451ull;  // "GLTTQ"
constexpr size_t kAlign = 64;

inline size_t aligned(size_t x) { return (x + kAlign - 1) / kAlign * kAlign; }

inline size_t slot_stride(uint64_t slot_bytes) {
  return aligned(sizeof(SlotHeader)) + aligned(slot_bytes);
}

struct Queue {
  int shmid;
  QueueHeader* hdr;
  char* slots;

  SlotHeader* slot_hdr(uint64_t i) const {
    return reinterpret_cast<SlotHeader*>(
        slots + i * slot_stride(hdr->slot_bytes));
  }
  char* slot_data(uint64_t i) const {
    return slots + i * slot_stride(hdr->slot_bytes) +
           aligned(sizeof(SlotHeader));
  }
};

Queue* attach(int shmid) {
  void* base = shmat(shmid, nullptr, 0);
  if (base == (void*)-1) return nullptr;
  auto* q = new Queue();
  q->shmid = shmid;
  q->hdr = reinterpret_cast<QueueHeader*>(base);
  q->slots = reinterpret_cast<char*>(base) + aligned(sizeof(QueueHeader));
  return q;
}

}  // namespace

extern "C" {

// Create a queue with `num_slots` slots of `slot_bytes` payload each.
// Returns an opaque handle, or null on failure.  The segment is
// created IPC_PRIVATE: share it by passing `glt_queue_shmid` to
// children (fork/spawn both fine).
void* glt_queue_create(uint64_t num_slots, uint64_t slot_bytes) {
  size_t total =
      aligned(sizeof(QueueHeader)) + num_slots * slot_stride(slot_bytes);
  int shmid = shmget(IPC_PRIVATE, total, IPC_CREAT | 0600);
  if (shmid < 0) return nullptr;
  Queue* q = attach(shmid);
  if (!q) return nullptr;
  q->hdr->magic = kMagic;
  q->hdr->num_slots = num_slots;
  q->hdr->slot_bytes = slot_bytes;
  q->hdr->head.store(0);
  q->hdr->tail.store(0);
  sem_init(&q->hdr->free_slots, /*pshared=*/1, num_slots);
  sem_init(&q->hdr->filled_slots, /*pshared=*/1, 0);
  for (uint64_t i = 0; i < num_slots; ++i) {
    q->slot_hdr(i)->seq.store(i);
    q->slot_hdr(i)->len = 0;
  }
  // Mark for auto-removal once every attached process detaches (or
  // dies) — the kernel reclaims the segment, so no leak on crash.
  shmctl(shmid, IPC_RMID, nullptr);
  return q;
}

void* glt_queue_attach(int shmid) { return attach(shmid); }

int glt_queue_shmid(void* handle) {
  return static_cast<Queue*>(handle)->shmid;
}

uint64_t glt_queue_slot_bytes(void* handle) {
  return static_cast<Queue*>(handle)->hdr->slot_bytes;
}

uint64_t glt_queue_num_slots(void* handle) {
  return static_cast<Queue*>(handle)->hdr->num_slots;
}

// Number of messages currently ready to read.
uint64_t glt_queue_size(void* handle) {
  Queue* q = static_cast<Queue*>(handle);
  int v = 0;
  sem_getvalue(&q->hdr->filled_slots, &v);
  return v < 0 ? 0 : (uint64_t)v;
}

// Blocking enqueue.  Returns 0 ok, -1 message too large.
int glt_queue_put(void* handle, const void* data, uint64_t len) {
  Queue* q = static_cast<Queue*>(handle);
  if (len > q->hdr->slot_bytes) return -1;
  sem_wait(&q->hdr->free_slots);
  uint64_t ticket = q->hdr->head.fetch_add(1);
  uint64_t i = ticket % q->hdr->num_slots;
  SlotHeader* sh = q->slot_hdr(i);
  // Wait until this slot's previous consumer has fully released it.
  while (sh->seq.load(std::memory_order_acquire) != ticket) {
  }
  memcpy(q->slot_data(i), data, len);
  sh->len = len;
  sh->seq.store(ticket + 1, std::memory_order_release);
  sem_post(&q->hdr->filled_slots);
  return 0;
}

// Blocking dequeue into `out` (capacity `cap`).  Returns payload
// length, or -1 if the message exceeds `cap` (message is dropped).
int64_t glt_queue_get(void* handle, void* out, uint64_t cap) {
  Queue* q = static_cast<Queue*>(handle);
  sem_wait(&q->hdr->filled_slots);
  uint64_t ticket = q->hdr->tail.fetch_add(1);
  uint64_t i = ticket % q->hdr->num_slots;
  SlotHeader* sh = q->slot_hdr(i);
  while (sh->seq.load(std::memory_order_acquire) != ticket + 1) {
  }
  int64_t len = (int64_t)sh->len;
  int64_t ret = len;
  if ((uint64_t)len <= cap) {
    memcpy(out, q->slot_data(i), len);
  } else {
    ret = -1;
  }
  sh->seq.store(ticket + q->hdr->num_slots, std::memory_order_release);
  sem_post(&q->hdr->free_slots);
  return ret;
}

// Timed dequeue: like glt_queue_get but waits at most `timeout_ms`
// for a message.  Returns payload length, -1 oversized (dropped),
// -2 timeout (nothing consumed).  Lets consumers run liveness
// watchdogs without busy-polling or losing the blocking fast path.
int64_t glt_queue_get_timed(void* handle, void* out, uint64_t cap,
                            int64_t timeout_ms) {
  Queue* q = static_cast<Queue*>(handle);
  struct timespec ts;
  clock_gettime(CLOCK_REALTIME, &ts);
  ts.tv_sec += timeout_ms / 1000;
  ts.tv_nsec += (timeout_ms % 1000) * 1000000L;
  if (ts.tv_nsec >= 1000000000L) {
    ts.tv_sec += 1;
    ts.tv_nsec -= 1000000000L;
  }
  while (sem_timedwait(&q->hdr->filled_slots, &ts) != 0) {
    if (errno == ETIMEDOUT) return -2;
    if (errno != EINTR) return -2;  // treat other failures as timeout
  }
  uint64_t ticket = q->hdr->tail.fetch_add(1);
  uint64_t i = ticket % q->hdr->num_slots;
  SlotHeader* sh = q->slot_hdr(i);
  while (sh->seq.load(std::memory_order_acquire) != ticket + 1) {
  }
  int64_t len = (int64_t)sh->len;
  int64_t ret = len;
  if ((uint64_t)len <= cap) {
    memcpy(out, q->slot_data(i), len);
  } else {
    ret = -1;
  }
  sh->seq.store(ticket + q->hdr->num_slots, std::memory_order_release);
  sem_post(&q->hdr->free_slots);
  return ret;
}

// Non-blocking probe: returns 1 if a message is ready.
int glt_queue_empty(void* handle) {
  return glt_queue_size(handle) == 0 ? 1 : 0;
}

void glt_queue_detach(void* handle) {
  Queue* q = static_cast<Queue*>(handle);
  shmdt(reinterpret_cast<void*>(q->hdr));
  delete q;
}

}  // extern "C"
