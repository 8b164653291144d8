/* Shared-memory SPSC ring buffer — the native core of the multiprocess
 * DataLoader.
 *
 * Reference role: paddle/fluid/operators/reader/buffered_reader.cc
 * (double-buffered async feed) + memory/allocation/mmap_allocator.cc +
 * imperative/data_loader.cc (shared-memory queues between dataloader
 * worker processes and the trainer).  TPU-native shape: one ring per
 * worker process living in POSIX shared memory; the worker pushes
 * length-framed pickled batches, the trainer process pops them without
 * any Python-level queue locks (single-producer/single-consumer,
 * lock-free with C11 atomics; waiting sides nanosleep-poll, which at
 * batch granularity costs nothing).
 *
 * Layout: [header][data region of `capacity` bytes]
 * Frames are 8-byte aligned: u64 payload length, then payload.  A
 * frame never wraps: if it does not fit contiguously, a WRAP marker
 * (len == ~0) is written (when >= 8 bytes remain) and the writer
 * continues at offset 0; the reader skips to the region start on
 * seeing the marker or when fewer than 8 contiguous bytes remain.
 */
#include <stdatomic.h>
#include <stdint.h>
#include <string.h>
#include <time.h>

typedef struct {
    uint64_t capacity;
    _Atomic uint64_t head;   /* bytes written, monotonic  */
    _Atomic uint64_t tail;   /* bytes consumed, monotonic */
    _Atomic uint32_t closed;
    uint32_t _pad;
    char data[];
} ring_t;

#define WRAP_MARKER 0xFFFFFFFFFFFFFFFFull

static void sleep_us(long us) {
    struct timespec ts = {0, us * 1000L};
    nanosleep(&ts, 0);
}

static uint64_t align8(uint64_t x) { return (x + 7ull) & ~7ull; }

uint64_t ring_needed(uint64_t capacity) {
    return sizeof(ring_t) + capacity;
}

void ring_init(void *mem, uint64_t capacity) {
    ring_t *r = (ring_t *)mem;
    r->capacity = capacity;
    atomic_store(&r->head, 0);
    atomic_store(&r->tail, 0);
    atomic_store(&r->closed, 0);
}

void ring_close(void *mem) {
    atomic_store(&((ring_t *)mem)->closed, 1);
}

int ring_is_closed(void *mem) {
    return (int)atomic_load(&((ring_t *)mem)->closed);
}

/* 0 = ok, -1 = timeout, -2 = closed */
int ring_push(void *mem, const void *buf, uint64_t len, long timeout_ms) {
    ring_t *r = (ring_t *)mem;
    uint64_t need = 8 + align8(len);
    long waited_us = 0;
    /* cap at capacity/2: when a wrap is required, contig < need <=
     * capacity/2 bounds contig + need < capacity, so a drained ring can
     * ALWAYS take the frame — larger frames could hit offsets where
     * wrap space never fits and spin forever. */
    if (need > r->capacity / 2) return -3;
    for (;;) {
        if (atomic_load(&r->closed)) return -2;
        uint64_t head = atomic_load(&r->head);
        uint64_t tail = atomic_load(&r->tail);
        uint64_t off = head % r->capacity;
        uint64_t contig = r->capacity - off;
        uint64_t total = (contig >= need) ? need : contig + need;
        if (head + total - tail <= r->capacity) {
            if (contig < need) {
                if (contig >= 8) {
                    uint64_t m = WRAP_MARKER;
                    memcpy(r->data + off, &m, 8);
                }
                head += contig;
                off = 0;
            }
            memcpy(r->data + off, &len, 8);
            memcpy(r->data + off + 8, buf, len);
            atomic_store(&r->head, head + need);
            return 0;
        }
        if (timeout_ms >= 0 && waited_us > timeout_ms * 1000L) return -1;
        sleep_us(200);
        waited_us += 200;
    }
}

/* next frame's payload length without consuming:
 * >=0 length, -1 timeout, -2 closed-and-drained */
int64_t ring_peek(void *mem, long timeout_ms) {
    ring_t *r = (ring_t *)mem;
    long waited_us = 0;
    for (;;) {
        uint64_t head = atomic_load(&r->head);
        uint64_t tail = atomic_load(&r->tail);
        if (head == tail) {
            if (atomic_load(&r->closed)) return -2;
            if (timeout_ms >= 0 && waited_us > timeout_ms * 1000L)
                return -1;
            sleep_us(200);
            waited_us += 200;
            continue;
        }
        uint64_t off = tail % r->capacity;
        uint64_t contig = r->capacity - off;
        uint64_t len;
        if (contig < 8) {
            atomic_store(&r->tail, tail + contig);
            continue;
        }
        memcpy(&len, r->data + off, 8);
        if (len == WRAP_MARKER) {
            atomic_store(&r->tail, tail + contig);
            continue;
        }
        return (int64_t)len;
    }
}

/* >=0 payload length, -1 timeout, -2 closed-and-drained, -3 too small */
int64_t ring_pop(void *mem, void *out, uint64_t maxlen, long timeout_ms) {
    ring_t *r = (ring_t *)mem;
    int64_t len = ring_peek(mem, timeout_ms);
    if (len < 0) return len;
    if ((uint64_t)len > maxlen) return -3;
    uint64_t tail = atomic_load(&r->tail);
    uint64_t off = tail % r->capacity;
    memcpy(out, r->data + off + 8, (size_t)len);
    atomic_store(&r->tail, tail + 8 + align8((uint64_t)len));
    return len;
}
