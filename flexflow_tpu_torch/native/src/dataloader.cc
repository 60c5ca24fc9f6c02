// Native prefetching data loader.
//
// flexflow_tpu_torch's copy of the JAX package's native data loader
// (its native/src/dataloader.cc, the same code): the reference's
// C++/CUDA dataloader (python/flexflow_dataloader.cc, 574 LoC: full
// dataset pinned in zero-copy memory, per-batch index tasks copy each
// worker's shard). What belongs in native code is everything before the
// copy to the device: shuffled index generation and multi-threaded gather
// of samples into contiguous batch buffers, overlapped with training via
// a bounded prefetch queue (no GIL).
//
// C ABI (ctypes-friendly):
//   ffdl_create(data, num_samples, sample_bytes, batch_size, shuffle,
//               seed, queue_depth, num_threads) -> handle
//   ffdl_next(handle, out) -> epoch-relative batch index (blocks), -1 EOF
//   ffdl_reset(handle)          (new epoch; reshuffles)
//   ffdl_batches_per_epoch(handle)
//   ffdl_destroy(handle)
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <thread>
#include <vector>

namespace {

struct Batch {
  int64_t index;
  std::vector<uint8_t> bytes;
};

struct Loader {
  const uint8_t* data;
  int64_t num_samples;
  int64_t sample_bytes;
  int64_t batch_size;
  bool shuffle;
  uint64_t seed;
  int64_t queue_depth;

  std::vector<int64_t> order;
  std::atomic<int64_t> next_batch{0};
  int64_t delivered = 0;  // consumer-side, guarded by mu
  int64_t epoch = 0;

  std::deque<Batch> queue;
  std::mutex mu;
  std::condition_variable cv_ready;   // consumer waits
  std::condition_variable cv_space;   // producer waits
  std::thread producer;
  std::atomic<bool> stop{false};

  int64_t batches_per_epoch() const { return num_samples / batch_size; }

  void reshuffle() {
    order.resize(num_samples);
    for (int64_t i = 0; i < num_samples; i++) order[i] = i;
    if (shuffle) {
      std::mt19937_64 rng(seed + static_cast<uint64_t>(epoch));
      for (int64_t i = num_samples - 1; i > 0; i--) {
        std::uniform_int_distribution<int64_t> d(0, i);
        std::swap(order[i], order[d(rng)]);
      }
    }
  }

  void produce_loop() {
    std::vector<int64_t> idxs(static_cast<size_t>(batch_size));
    while (true) {
      int64_t b, my_epoch;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_space.wait(lk, [&] {
          return stop.load() ||
                 (next_batch.load() < batches_per_epoch() &&
                  static_cast<int64_t>(queue.size()) < queue_depth);
        });
        if (stop.load()) return;
        b = next_batch.fetch_add(1);
        my_epoch = epoch;
        for (int64_t i = 0; i < batch_size; i++)
          idxs[static_cast<size_t>(i)] = order[b * batch_size + i];
      }
      Batch batch;
      batch.index = b;
      batch.bytes.resize(static_cast<size_t>(batch_size * sample_bytes));
      for (int64_t i = 0; i < batch_size; i++) {
        std::memcpy(batch.bytes.data() + i * sample_bytes,
                    data + idxs[static_cast<size_t>(i)] * sample_bytes,
                    static_cast<size_t>(sample_bytes));
      }
      {
        std::unique_lock<std::mutex> lk(mu);
        if (stop.load()) return;
        if (my_epoch == epoch) {  // drop batches from a pre-reset epoch
          queue.push_back(std::move(batch));
          cv_ready.notify_one();
        }
      }
    }
  }
};

}  // namespace

extern "C" {

void* ffdl_create(const void* data, int64_t num_samples, int64_t sample_bytes,
                  int64_t batch_size, int shuffle, uint64_t seed,
                  int64_t queue_depth) {
  if (num_samples <= 0 || sample_bytes <= 0 || batch_size <= 0) return nullptr;
  auto* l = new Loader();
  l->data = static_cast<const uint8_t*>(data);
  l->num_samples = num_samples;
  l->sample_bytes = sample_bytes;
  l->batch_size = batch_size;
  l->shuffle = shuffle != 0;
  l->seed = seed;
  l->queue_depth = queue_depth > 0 ? queue_depth : 4;
  l->reshuffle();
  l->producer = std::thread([l] { l->produce_loop(); });
  return l;
}

int64_t ffdl_batches_per_epoch(void* handle) {
  return static_cast<Loader*>(handle)->batches_per_epoch();
}

// Blocking: copies the next ready batch into out. Returns the batch index
// within the epoch, or -1 when the epoch is exhausted.
int64_t ffdl_next(void* handle, void* out) {
  auto* l = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(l->mu);
  if (l->delivered >= l->batches_per_epoch()) return -1;  // epoch exhausted
  l->cv_ready.wait(lk, [&] { return l->stop.load() || !l->queue.empty(); });
  if (l->queue.empty()) return -1;  // stopped
  l->delivered++;
  Batch b = std::move(l->queue.front());
  l->queue.pop_front();
  l->cv_space.notify_one();
  lk.unlock();
  std::memcpy(out, b.bytes.data(), b.bytes.size());
  return b.index;
}

void ffdl_reset(void* handle) {
  auto* l = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(l->mu);
  l->queue.clear();
  l->epoch++;
  l->delivered = 0;
  l->reshuffle();
  l->next_batch.store(0);
  l->cv_space.notify_all();
}

void ffdl_destroy(void* handle) {
  auto* l = static_cast<Loader*>(handle);
  l->stop.store(true);
  l->cv_space.notify_all();
  l->cv_ready.notify_all();
  if (l->producer.joinable()) l->producer.join();
  delete l;
}

}  // extern "C"
