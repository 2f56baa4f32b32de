// fastloader: native batch-assembly runtime for the training input pipeline
// (the port's copy of native/fastloader.cpp; the same C ABI and the same
// batches, flips included).
//
// The reference fed its trainer through torch DataLoader worker *processes*
// re-decoding PNGs every epoch (trainers/trainer.py:413, SURVEY.md §3.1).
// This runtime replaces the per-epoch hot path with:
//   - a memory-mapped clip cache (raw contiguous array written once by
//     data/native_loader.py build_frame_cache)
//   - a pool of C++ threads gathering sampled clips into ready batch
//     buffers (double/triple buffered ring), entirely outside the GIL
//   - optional fused uint8 augmentation (horizontal flip) during the gather
//
// Exposed as a C ABI consumed via ctypes
// (sd_video_gen_tpu_torch/data/native_loader.py, which builds it with g++
// into build/native/ at first use).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <map>
#include <queue>
#include <random>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Batch {
  std::vector<uint8_t> data;
  std::vector<int64_t> indices;
  int64_t n = 0;
};

struct Loader {
  // mmap'd cache
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t file_bytes = 0;
  int64_t n_clips = 0;
  int64_t clip_bytes = 0;  // bytes per clip record

  // frame geometry for augmentation (0 width = flat records, no augment)
  int64_t frames = 0, height = 0, width = 0, channels = 0;

  // epoch state
  std::vector<int64_t> order;
  int64_t batch_size = 0;
  int64_t next_batch = 0;
  int64_t n_batches = 0;
  bool flip_augment = false;
  uint64_t seed = 0;

  // pipeline
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  std::map<int64_t, Batch*> ready;  // keyed by batch index: in-order delivery
  std::vector<Batch*> freelist;
  std::atomic<int64_t> claim{0};
  std::atomic<int64_t> delivered{0};
  std::atomic<bool> stop{false};
  size_t max_ready = 3;

  ~Loader() { shutdown(); unmap(); }

  void unmap() {
    if (base) munmap(const_cast<uint8_t*>(base), file_bytes);
    if (fd >= 0) close(fd);
    base = nullptr; fd = -1;
  }

  void shutdown() {
    {
      // stop must flip under the SAME lock the CV predicates read it
      // with, or a worker that just evaluated stop==false can block
      // after our notify fires (the delivered/cv_free fix below, applied
      // to the shutdown path) — then join() hangs the process.
      std::lock_guard<std::mutex> lk(mu);
      stop.store(true);
    }
    cv_free.notify_all();
    cv_ready.notify_all();
    for (auto& t : workers) if (t.joinable()) t.join();
    workers.clear();
    std::lock_guard<std::mutex> lk(mu);
    for (auto& kv : ready) delete kv.second;
    ready.clear();
    for (auto* b : freelist) delete b;
    freelist.clear();
  }

  void gather(Batch* b, int64_t batch_idx) {
    const int64_t start = batch_idx * batch_size;
    const int64_t n = std::min(batch_size, (int64_t)order.size() - start);
    b->n = n;
    b->indices.resize(n);
    b->data.resize((size_t)n * clip_bytes);
    std::mt19937_64 rng(seed * 1315423911ULL + batch_idx);
    std::uniform_int_distribution<int> coin(0, 1);
    for (int64_t i = 0; i < n; ++i) {
      const int64_t clip = order[start + i];
      b->indices[i] = clip;
      const uint8_t* src = base + (size_t)clip * clip_bytes;
      uint8_t* dst = b->data.data() + (size_t)i * clip_bytes;
      if (flip_augment && width > 0 && coin(rng)) {
        // horizontal flip: reverse the W axis of (T, H, W, C) uint8
        const int64_t row = width * channels;
        for (int64_t t = 0; t < frames; ++t) {
          for (int64_t h = 0; h < height; ++h) {
            const uint8_t* srow = src + ((t * height + h) * row);
            uint8_t* drow = dst + ((t * height + h) * row);
            for (int64_t w = 0; w < width; ++w)
              memcpy(drow + (width - 1 - w) * channels,
                     srow + w * channels, channels);
          }
        }
      } else {
        memcpy(dst, src, clip_bytes);
      }
    }
  }

  void worker_loop() {
    for (;;) {
      const int64_t bi = claim.fetch_add(1);
      if (bi >= n_batches || stop.load()) return;
      Batch* b = nullptr;
      {
        // bounded lookahead: a worker may only take a buffer when its batch
        // id is within the ring window of the oldest undelivered batch —
        // otherwise late ids could hoard every buffer while the id the
        // consumer is blocked on starves (ordered-delivery deadlock).
        std::unique_lock<std::mutex> lk(mu);
        cv_free.wait(lk, [&] {
          return stop.load() ||
                 (!freelist.empty() &&
                  bi < delivered.load() + (int64_t)max_ready);
        });
        if (stop.load()) return;
        b = freelist.back();
        freelist.pop_back();
      }
      gather(b, bi);
      {
        std::lock_guard<std::mutex> lk(mu);
        ready[bi] = b;
      }
      cv_ready.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* fl_open(const char* path, int64_t n_clips, int64_t clip_bytes,
              int64_t frames, int64_t height, int64_t width,
              int64_t channels) {
  auto* L = new Loader();
  L->fd = open(path, O_RDONLY);
  if (L->fd < 0) { delete L; return nullptr; }
  struct stat st;
  if (fstat(L->fd, &st) != 0 ||
      (int64_t)st.st_size < n_clips * clip_bytes) {
    delete L; return nullptr;
  }
  L->file_bytes = st.st_size;
  L->base = (const uint8_t*)mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED,
                                 L->fd, 0);
  if (L->base == MAP_FAILED) { L->base = nullptr; delete L; return nullptr; }
  madvise(const_cast<uint8_t*>(L->base), st.st_size, MADV_WILLNEED);
  L->n_clips = n_clips;
  L->clip_bytes = clip_bytes;
  L->frames = frames; L->height = height; L->width = width;
  L->channels = channels;
  return L;
}

// order: epoch sample of clip ids (length n); batches of batch_size are
// assembled by n_threads workers into a ring of prefetch buffers.
int64_t fl_start_epoch(void* handle, const int64_t* order, int64_t n,
                       int64_t batch_size, int32_t n_threads,
                       int32_t prefetch, int32_t flip_augment,
                       uint64_t seed) {
  auto* L = (Loader*)handle;
  L->shutdown();
  L->stop.store(false);
  for (int64_t i = 0; i < n; ++i)
    if (order[i] < 0 || order[i] >= L->n_clips)
      return -1;  // the C ABI is the trust boundary: an out-of-range clip
                  // id would memcpy past the mmap (SIGBUS or garbage)
  L->order.assign(order, order + n);
  L->batch_size = batch_size;
  L->n_batches = (n + batch_size - 1) / batch_size;
  L->claim.store(0);
  L->delivered.store(0);
  L->flip_augment = flip_augment != 0;
  L->seed = seed;
  L->max_ready = std::max(2, (int)prefetch);
  for (size_t i = 0; i < L->max_ready + 1; ++i)
    L->freelist.push_back(new Batch());
  const int nt = std::max(1, (int)n_threads);
  for (int t = 0; t < nt; ++t)
    L->workers.emplace_back([L] { L->worker_loop(); });
  return L->n_batches;
}

// Blocks until a batch is ready; copies clip data + ids into caller buffers.
// Returns the number of clips in the batch (0 = epoch finished).
int64_t fl_next_batch(void* handle, uint8_t* out_data, int64_t* out_indices,
                      int64_t* served /* in/out batch counter */) {
  auto* L = (Loader*)handle;
  if (*served >= L->n_batches) return 0;
  Batch* b = nullptr;
  {
    // deterministic epochs: block until the *next sequential* batch is ready
    std::unique_lock<std::mutex> lk(L->mu);
    const int64_t want = *served;
    L->cv_ready.wait(lk, [&] {
      return L->stop.load() || L->ready.count(want) > 0;
    });
    if (L->stop.load() && L->ready.count(want) == 0) return -1;
    b = L->ready[want];
    L->ready.erase(want);
  }
  const int64_t n = b->n;
  memcpy(out_data, b->data.data(), (size_t)n * L->clip_bytes);
  memcpy(out_indices, b->indices.data(), n * sizeof(int64_t));
  {
    // delivered must advance under the SAME lock as the freelist push:
    // a worker evaluating cv_free's predicate holds mu with the old
    // `delivered`, and an increment+notify landing in that window (before
    // the worker's atomic release-and-block) would be a lost wakeup —
    // with one worker thread that deadlocks the epoch.
    std::lock_guard<std::mutex> lk(L->mu);
    L->freelist.push_back(b);
    L->delivered.fetch_add(1);
  }
  L->cv_free.notify_all();
  *served += 1;
  return n;
}

void fl_close(void* handle) { delete (Loader*)handle; }

}  // extern "C"
