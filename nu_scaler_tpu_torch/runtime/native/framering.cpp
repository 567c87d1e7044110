// Native frame-ring runtime — the C++ replacement for the reference's Rust
// capture plumbing (crossbeam channel + worker thread + mpsc drain,
// nu_scaler_core/src/capture/realtime.rs:282-382,564-657).
//
// Provides, behind a C ABI (consumed via ctypes from
// nu_scaler_tpu_torch/runtime/framering.py):
//   * a lock-free-ish bounded frame ring with drop-oldest semantics and
//     latest-frame drain (the consumer contract of realtime.rs:496-530)
//   * BGRA→RGBA swizzle (lib.rs:253-261 / realtime.rs:463-494) — SIMD-ized
//     by the compiler at -O3
//   * a synthetic test-pattern generator (benchmark.rs:188-207) so producer
//     threads can run entirely in native code
//   * frame statistics (pushed/dropped) for the observability layer
//
// Build: g++ at the first use, into build/nu_scaler_tpu_torch/ under a name
// keyed by this source's hash (nu_scaler_tpu_torch/kernels/_build.py);
// framering.py records a failed build and the capture stack falls back to the
// pure-Python ring.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

namespace {

struct Frame {
    std::vector<uint8_t> data;
    uint32_t width = 0;
    uint32_t height = 0;
    uint64_t seq = 0;
};

struct Ring {
    std::mutex mu;
    std::vector<Frame> slots;
    size_t capacity;
    size_t head = 0;   // next write position
    size_t count = 0;  // filled slots
    std::atomic<uint64_t> pushed{0};
    std::atomic<uint64_t> dropped{0};
    uint64_t next_seq = 1;

    explicit Ring(size_t cap) : slots(cap), capacity(cap) {}
};

}  // namespace

extern "C" {

void* nu_ring_create(uint32_t capacity) {
    if (capacity == 0) capacity = 1;
    return new Ring(capacity);
}

void nu_ring_destroy(void* ring) { delete static_cast<Ring*>(ring); }

// Push a frame (copies `data`). Drop-oldest when full.
void nu_ring_push(void* ring, const uint8_t* data, uint32_t width,
                  uint32_t height) {
    Ring* r = static_cast<Ring*>(ring);
    const size_t nbytes = size_t(width) * height * 4;
    std::lock_guard<std::mutex> lock(r->mu);
    if (r->count == r->capacity) {
        r->dropped.fetch_add(1, std::memory_order_relaxed);
        r->count--;  // overwrite oldest implicitly: advance logical tail
    }
    Frame& slot = r->slots[r->head];
    slot.data.assign(data, data + nbytes);
    slot.width = width;
    slot.height = height;
    slot.seq = r->next_seq++;
    r->head = (r->head + 1) % r->capacity;
    r->count++;
    r->pushed.fetch_add(1, std::memory_order_relaxed);
}

// Drain to the latest frame. Returns 1 and fills out params when a frame was
// available; 0 otherwise ("WouldBlock" → no frame). `out` must hold
// max_bytes; frames larger than max_bytes are reported truncated=1.
int nu_ring_latest(void* ring, uint8_t* out, uint64_t max_bytes,
                   uint32_t* width, uint32_t* height, int* truncated) {
    Ring* r = static_cast<Ring*>(ring);
    std::lock_guard<std::mutex> lock(r->mu);
    if (r->count == 0) return 0;
    size_t newest = (r->head + r->capacity - 1) % r->capacity;
    Frame& f = r->slots[newest];
    const uint64_t n = f.data.size();
    *width = f.width;
    *height = f.height;
    *truncated = n > max_bytes ? 1 : 0;
    std::memcpy(out, f.data.data(), n > max_bytes ? max_bytes : n);
    r->count = 0;  // drain-all semantics
    return 1;
}

uint64_t nu_ring_pushed(void* ring) {
    return static_cast<Ring*>(ring)->pushed.load(std::memory_order_relaxed);
}

uint64_t nu_ring_dropped(void* ring) {
    return static_cast<Ring*>(ring)->dropped.load(std::memory_order_relaxed);
}

// BGRA → RGBA swizzle (the per-frame CPU conversion the reference does in
// lib.rs:253-261); in-place variant also allowed (src == dst).
void nu_bgra_to_rgba(const uint8_t* src, uint8_t* dst, uint64_t npixels) {
    for (uint64_t i = 0; i < npixels; ++i) {
        const uint8_t b = src[i * 4 + 0];
        const uint8_t g = src[i * 4 + 1];
        const uint8_t r = src[i * 4 + 2];
        const uint8_t a = src[i * 4 + 3];
        dst[i * 4 + 0] = r;
        dst[i * 4 + 1] = g;
        dst[i * 4 + 2] = b;
        dst[i * 4 + 3] = a;
    }
}

// Gradient test pattern (benchmark.rs:188-207) with a moving bright square —
// native synthetic source for producer threads.
void nu_test_pattern(uint8_t* dst, uint32_t width, uint32_t height,
                     uint32_t tick) {
    for (uint32_t y = 0; y < height; ++y) {
        const uint8_t g = uint8_t(uint64_t(y) * 255 / height);
        for (uint32_t x = 0; x < width; ++x) {
            const uint64_t idx = (uint64_t(y) * width + x) * 4;
            dst[idx + 0] = uint8_t(uint64_t(x) * 255 / width);
            dst[idx + 1] = g;
            dst[idx + 2] = uint8_t(uint64_t(x + y) * 255 / (width + height));
            dst[idx + 3] = 255;
        }
    }
    // moving square
    const uint32_t size = height / 8 > 8 ? height / 8 : 8;
    if (width > size && height > size) {
        const uint32_t px = (tick * 4) % (width - size);
        const uint32_t py = (height - size) / 2;
        for (uint32_t y = py; y < py + size; ++y) {
            uint8_t* row = dst + (uint64_t(y) * width + px) * 4;
            for (uint32_t x = 0; x < size; ++x) {
                row[x * 4 + 0] = 255;
                row[x * 4 + 1] = 255;
                row[x * 4 + 2] = 255;
            }
        }
    }
}

}  // extern "C"
