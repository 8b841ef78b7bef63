// Native clip-loading runtime of the port: a memory-mapped pack directory
// (frames.u8, written by ganode_tpu_torch/data/ucf101.py) -> worker threads
// that keep normalized training batches ready ahead of the training loop.
//
// Decoding happened once, offline (ganode_tpu_torch/data/ucf101.py::
// pack_ucf101). What is left on the hot path is memory movement: gather a
// random n_frame window per sample from the mapped uint8 frames, convert it to
// float32 (v - 128) / 128 (reference dataset/ucf101new.py:95), and hand the
// loop a ready batch. The window of sample s of batch i is a counter-based
// hash of (seed, i, s) (SplitMix64, fill_batch below), so batch i is the same
// bit for bit whatever the thread count or scheduling, and a loader opened at
// start_batch = n continues an uninterrupted stream at its batch n.
//
// The C ABI (gl_open, gl_next, gl_close) and the window choice are the JAX
// package's, so both packages serve the same batches from the same pack,
// seed and start_batch. Bound with ctypes in ganode_tpu_torch/runtime/
// native.py, which builds this file with g++ into ganode_tpu_torch/_build/.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <queue>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

// SplitMix64: counter-based, statistically solid, no shared state.
static inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

struct Batch {
  int64_t index;
  std::vector<float> clips;
  std::vector<int64_t> labels;
};

struct Loader {
  // mmap'd frame store
  const uint8_t* frames = nullptr;
  size_t frames_bytes = 0;
  int fd = -1;

  // per-video index (copies of the arrays Python hands us)
  std::vector<int64_t> offsets;
  std::vector<int64_t> lengths;
  std::vector<int64_t> labels;
  std::vector<int64_t> eligible;  // videos with length >= n_frame

  int64_t n_frame = 16, batch = 32, height = 64, width = 64, channels = 3;
  uint64_t seed = 0;
  size_t frame_bytes = 0;
  size_t clip_floats = 0;

  // prefetch machinery
  std::vector<std::thread> workers;
  std::atomic<int64_t> next_to_produce{0};
  int64_t next_to_consume = 0;
  size_t ring_capacity = 4;
  std::mutex mu;
  std::condition_variable cv_produced, cv_space;
  // completed batches keyed by index (workers may finish out of order)
  std::vector<Batch> ready;
  std::atomic<bool> stopping{false};

  void fill_batch(int64_t batch_idx, Batch* out) {
    out->index = batch_idx;
    out->clips.resize(batch * clip_floats);
    out->labels.resize(batch);
    const size_t hw = static_cast<size_t>(height) * width * channels;
    for (int64_t s = 0; s < batch; ++s) {
      uint64_t r1 = splitmix64(seed ^ splitmix64(
          static_cast<uint64_t>(batch_idx) * 2654435761ULL + s));
      uint64_t r2 = splitmix64(r1);
      int64_t vid = eligible[r1 % eligible.size()];
      int64_t max_start = lengths[vid] - n_frame;
      int64_t start = max_start > 0 ? static_cast<int64_t>(r2 % (max_start + 1)) : 0;
      const uint8_t* src = frames + (offsets[vid] + start) * frame_bytes;
      float* dst = out->clips.data() + s * clip_floats;
      const size_t n = n_frame * hw;
      for (size_t i = 0; i < n; ++i) {
        dst[i] = (static_cast<float>(src[i]) - 128.0f) / 128.0f;
      }
      out->labels[s] = labels[vid];
    }
  }

  void worker_loop() {
    while (!stopping.load(std::memory_order_relaxed)) {
      int64_t idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_space.wait(lk, [&] {
          return stopping ||
                 next_to_produce.load() < next_to_consume +
                     static_cast<int64_t>(ring_capacity);
        });
        if (stopping) return;
        idx = next_to_produce.fetch_add(1);
      }
      Batch b;
      fill_batch(idx, &b);
      {
        std::lock_guard<std::mutex> lk(mu);
        ready.push_back(std::move(b));
      }
      cv_produced.notify_all();
    }
  }

  bool next(float* clips_out, int64_t* labels_out) {
    std::unique_lock<std::mutex> lk(mu);
    int64_t want = next_to_consume;
    cv_produced.wait(lk, [&] {
      if (stopping) return true;
      for (const auto& b : ready)
        if (b.index == want) return true;
      return false;
    });
    if (stopping) return false;
    for (size_t i = 0; i < ready.size(); ++i) {
      if (ready[i].index == want) {
        std::memcpy(clips_out, ready[i].clips.data(),
                    ready[i].clips.size() * sizeof(float));
        std::memcpy(labels_out, ready[i].labels.data(),
                    ready[i].labels.size() * sizeof(int64_t));
        ready.erase(ready.begin() + i);
        next_to_consume++;
        cv_space.notify_all();
        return true;
      }
    }
    return false;  // unreachable
  }
};

}  // namespace

extern "C" {

void* gl_open(const char* frames_path, const int64_t* offsets,
              const int64_t* lengths, const int64_t* labels, int64_t n_videos,
              int64_t n_frame, int64_t batch, int64_t height, int64_t width,
              int64_t channels, int64_t n_threads, uint64_t seed,
              int64_t start_batch) {
  auto* L = new Loader();
  // resume support: the stream continues from batch index `start_batch`, and
  // because fill_batch derives every sample from (seed, batch_idx, s) alone,
  // the continuation is bit-identical to an uninterrupted run.
  L->next_to_produce = start_batch;
  L->next_to_consume = start_batch;
  L->n_frame = n_frame;
  L->batch = batch;
  L->height = height;
  L->width = width;
  L->channels = channels;
  L->seed = seed;
  L->frame_bytes = static_cast<size_t>(height) * width * channels;
  L->clip_floats = static_cast<size_t>(n_frame) * L->frame_bytes;

  L->fd = open(frames_path, O_RDONLY);
  if (L->fd < 0) {
    delete L;
    return nullptr;
  }
  struct stat st;
  fstat(L->fd, &st);
  L->frames_bytes = st.st_size;
  void* map = mmap(nullptr, L->frames_bytes, PROT_READ, MAP_PRIVATE, L->fd, 0);
  if (map == MAP_FAILED) {
    close(L->fd);
    delete L;
    return nullptr;
  }
  L->frames = static_cast<const uint8_t*>(map);
  madvise(map, L->frames_bytes, MADV_WILLNEED);

  L->offsets.assign(offsets, offsets + n_videos);
  L->lengths.assign(lengths, lengths + n_videos);
  L->labels.assign(labels, labels + n_videos);
  for (int64_t i = 0; i < n_videos; ++i) {
    if (L->lengths[i] >= n_frame) L->eligible.push_back(i);
  }
  if (L->eligible.empty()) {
    munmap(map, L->frames_bytes);
    close(L->fd);
    delete L;
    return nullptr;
  }

  int64_t threads = n_threads > 0 ? n_threads : 4;
  for (int64_t i = 0; i < threads; ++i) {
    L->workers.emplace_back([L] { L->worker_loop(); });
  }
  return L;
}

int gl_next(void* handle, float* clips_out, int64_t* labels_out) {
  auto* L = static_cast<Loader*>(handle);
  return L->next(clips_out, labels_out) ? 0 : -1;
}

void gl_close(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->stopping = true;
  }
  L->cv_space.notify_all();
  L->cv_produced.notify_all();
  for (auto& t : L->workers) t.join();
  if (L->frames) munmap(const_cast<uint8_t*>(L->frames), L->frames_bytes);
  if (L->fd >= 0) close(L->fd);
  delete L;
}

}  // extern "C"
