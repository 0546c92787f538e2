// Native host-side hot loops for the streaming feeder.
//
// The framework's device boundary is split re/im f32 planes
// (aether_primitives_tpu/boundary.py) while the capture interchange format
// is interleaved (re, im) pairs — the reference crate's repr(C) cf32 layout
// (reference src/lib.rs:10, src/util/file.rs). Staging a long capture into
// the device feed therefore runs one deinterleave per block on the host;
// at multi-Gsample/s stream rates that loop is worth native code with
// explicit restrict/vectorization hints (numpy's .real/.imag copies are
// strided memcpys that vectorize poorly on some builds).
//
// Built by aether_primitives_tpu/native.py with g++ -O3; exposed via ctypes.
// Everything here is plain C ABI, single-threaded per call (callers shard
// blocks across threads if needed).

#include <condition_variable>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

extern "C" {

// interleaved [n] complex64 (2n f32) -> two [n] f32 planes
void deinterleave_c64(const float* __restrict src, float* __restrict re,
                      float* __restrict im, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    re[i] = src[2 * i];
    im[i] = src[2 * i + 1];
  }
}

// two [n] f32 planes -> interleaved [n] complex64
void interleave_c64(const float* __restrict re, const float* __restrict im,
                    float* __restrict dst, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    dst[2 * i] = re[i];
    dst[2 * i + 1] = im[i];
  }
}

// max |x|^2 over an interleaved complex64 buffer + its index — the host-side
// correlation-peak pick for small tails (device handles big blocks)
void peak_c64(const float* __restrict src, size_t n, size_t* idx_out,
              float* mag2_out) {
  float best = -1.0f;
  size_t best_i = 0;
  for (size_t i = 0; i < n; ++i) {
    const float re = src[2 * i], im = src[2 * i + 1];
    const float m = re * re + im * im;
    if (m > best) {
      best = m;
      best_i = i;
    }
  }
  *idx_out = best_i;
  *mag2_out = best;
}

// bit-pack {0,1} bytes LSB-first into bytes (8x smaller capture files for
// demod output streams)
void pack_bits_lsb(const uint8_t* __restrict bits, uint8_t* __restrict out,
                   size_t n_bits) {
  const size_t n_bytes = (n_bits + 7) / 8;
  memset(out, 0, n_bytes);
  for (size_t i = 0; i < n_bits; ++i) {
    out[i / 8] |= (uint8_t)((bits[i] & 1u) << (i % 8));
  }
}

void unpack_bits_lsb(const uint8_t* __restrict packed,
                     uint8_t* __restrict bits, size_t n_bits) {
  for (size_t i = 0; i < n_bits; ++i) {
    bits[i] = (packed[i / 8] >> (i % 8)) & 1u;
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Threaded capture feeder: the native runtime analog of the reference's
// feeder-thread + pool steady state (reference src/pipeline.rs spawn_stage,
// src/pool.rs, examples/pipeline.rs:57-85). A producer thread reads an
// interleaved-complex64 capture file block-by-block and deinterleaves each
// block into a bounded ring of (re, im) f32 plane buffers; the consumer
// (the Python device-feed loop) pops blocks while the NEXT blocks' disk
// read + deinterleave proceed concurrently. The bounded ring is the
// backpressure the reference's unbounded mpsc channel lacked (its
// documented OOM pitfall, examples/pipeline.rs:61-66).

namespace {

struct FeederSlot {
  std::vector<float> re, im;
  size_t nvalid = 0;
  bool ready = false;
};

struct Feeder {
  FILE* f = nullptr;
  size_t block = 0;          // samples per block
  std::vector<FeederSlot> ring;
  size_t head = 0;           // next slot the producer fills
  size_t tail = 0;           // next slot the consumer drains
  bool eof = false;          // producer saw end-of-file
  bool stop = false;         // consumer asked for shutdown
  std::mutex mu;
  std::condition_variable cv_prod, cv_cons;
  std::thread th;
  std::vector<float> staging;  // interleaved read buffer, 2*block floats

  void run() {
    for (;;) {
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_prod.wait(lk, [&] { return stop || !ring[head].ready; });
        if (stop) return;
      }
      const size_t got =
          fread(staging.data(), sizeof(float), 2 * block, f);
      const size_t n = got / 2;
      FeederSlot& s = ring[head];
      deinterleave_c64(staging.data(), s.re.data(), s.im.data(), n);
      {
        std::lock_guard<std::mutex> lk(mu);
        s.nvalid = n;
        s.ready = true;
        head = (head + 1) % ring.size();
        if (n < block) eof = true;
        cv_cons.notify_one();
      }
      if (n < block) return;
    }
  }
};

}  // namespace

extern "C" {

// Open `path` (raw interleaved complex64) for threaded block streaming.
// Returns an opaque handle or null. `depth` >= 2 ring slots bound memory
// at depth * block * 8 bytes.
void* feeder_open(const char* path, size_t block_samples, size_t depth) {
  if (block_samples == 0 || depth < 2) return nullptr;
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  Feeder* fd = new Feeder();
  fd->f = f;
  fd->block = block_samples;
  fd->ring.resize(depth);
  for (auto& s : fd->ring) {
    s.re.resize(block_samples);
    s.im.resize(block_samples);
  }
  fd->staging.resize(2 * block_samples);
  fd->th = std::thread([fd] { fd->run(); });
  return fd;
}

// Pop the next block into caller-owned [block] f32 plane buffers.
// Returns the number of valid samples (== block for full blocks, < block
// for the final partial block, 0 once the capture is exhausted).
size_t feeder_next(void* h, float* __restrict re, float* __restrict im) {
  Feeder* fd = static_cast<Feeder*>(h);
  std::unique_lock<std::mutex> lk(fd->mu);
  FeederSlot& s = fd->ring[fd->tail];
  fd->cv_cons.wait(lk, [&] { return s.ready || fd->eof; });
  if (!s.ready) return 0;  // eof and ring drained
  const size_t n = s.nvalid;
  lk.unlock();
  memcpy(re, s.re.data(), n * sizeof(float));
  memcpy(im, s.im.data(), n * sizeof(float));
  lk.lock();
  s.ready = false;
  s.nvalid = 0;
  fd->tail = (fd->tail + 1) % fd->ring.size();
  fd->cv_prod.notify_one();
  return n;
}

void feeder_close(void* h) {
  Feeder* fd = static_cast<Feeder*>(h);
  {
    std::lock_guard<std::mutex> lk(fd->mu);
    fd->stop = true;
    fd->cv_prod.notify_all();
  }
  if (fd->th.joinable()) fd->th.join();
  fclose(fd->f);
  delete fd;
}

}  // extern "C"
