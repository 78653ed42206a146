// fastmatch-tpu native frame loader: threaded decode+resize prefetch.
//
// The SLAM/SfM pipelines consume frames strictly in order, but decode is
// embarrassingly parallel — this is the runtime's data-loading stage
// (SURVEY.md §3.2: first-party native components around the JAX compute
// path). N worker threads claim frame indices atomically, decode via the
// imageio functions in this library, bilinear-resize to the static detector
// shape, and publish into a bounded reorder buffer; the consumer blocks on
// the next in-order frame. Bounded memory: workers stall while they are more
// than `capacity` frames ahead of the consumer.
//
// C ABI (ctypes): fm_loader_open / fm_loader_next / fm_loader_close.

#include <atomic>
#include <condition_variable>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" {
int fm_load_gray(const char* path, float** data, int* w, int* h);
int fm_resize_bilinear(const float* src, int sw, int sh, float* dst, int dw, int dh);
void fm_free(float* p);
}

namespace {

struct Frame {
  std::vector<float> data;  // dst_w * dst_h, or empty on decode failure
  int rc;                   // 0 ok, nonzero decode error
};

struct Loader {
  std::vector<std::string> paths;
  int dst_w, dst_h, capacity;
  std::vector<std::thread> workers;

  std::mutex mu;
  std::condition_variable cv_produced;  // consumer waits for next frame
  std::condition_variable cv_space;     // workers wait for window space
  std::map<int, Frame> ready;           // reorder buffer
  std::atomic<int> next_claim{0};       // next index a worker takes
  int next_consume = 0;                 // next index the consumer needs
  bool closed = false;

  void work() {
    for (;;) {
      int idx = next_claim.fetch_add(1);
      if (idx >= (int)paths.size()) return;
      // Stay within `capacity` frames of the consumer (bounded memory).
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_space.wait(lk, [&] { return closed || idx < next_consume + capacity; });
        if (closed) return;
      }
      Frame fr;
      float* raw = nullptr;
      int w = 0, h = 0;
      fr.rc = fm_load_gray(paths[idx].c_str(), &raw, &w, &h);
      if (fr.rc == 0) {
        fr.data.resize((size_t)dst_w * dst_h);
        if (w == dst_w && h == dst_h) {
          std::memcpy(fr.data.data(), raw, sizeof(float) * (size_t)w * h);
        } else {
          fm_resize_bilinear(raw, w, h, fr.data.data(), dst_w, dst_h);
        }
        fm_free(raw);
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        if (closed) return;
        ready.emplace(idx, std::move(fr));
      }
      cv_produced.notify_all();
    }
  }
};

}  // namespace

extern "C" {

// Open a prefetching loader over n paths ('\n'-joined in `paths_joined`).
// Every frame is delivered at (dst_w, dst_h) float32 grayscale.
void* fm_loader_open(const char* paths_joined, int n_paths, int dst_w, int dst_h,
                     int n_threads, int capacity) {
  if (n_paths <= 0 || dst_w <= 0 || dst_h <= 0) return nullptr;
  auto* L = new Loader();
  L->dst_w = dst_w;
  L->dst_h = dst_h;
  L->capacity = capacity > 0 ? capacity : 8;
  const char* p = paths_joined;
  for (int i = 0; i < n_paths; i++) {
    const char* e = strchr(p, '\n');
    if (!e) e = p + strlen(p);
    L->paths.emplace_back(p, e - p);
    p = (*e == '\n') ? e + 1 : e;
  }
  if ((int)L->paths.size() != n_paths) {
    delete L;
    return nullptr;
  }
  int nt = n_threads > 0 ? n_threads : 4;
  if (nt > n_paths) nt = n_paths;
  for (int i = 0; i < nt; i++) L->workers.emplace_back([L] { L->work(); });
  return L;
}

// Copy the next in-order frame into dst (dst_w*dst_h floats). Returns the
// frame index (>= 0), -1 when the sequence is exhausted, or -2 on a decode
// error for that frame (the loader stays usable; the bad frame is skipped).
int fm_loader_next(void* handle, float* dst) {
  auto* L = (Loader*)handle;
  if (!L) return -1;
  std::unique_lock<std::mutex> lk(L->mu);
  if (L->next_consume >= (int)L->paths.size()) return -1;
  int idx = L->next_consume;
  L->cv_produced.wait(lk, [&] { return L->ready.count(idx) > 0; });
  Frame fr = std::move(L->ready[idx]);
  L->ready.erase(idx);
  L->next_consume = idx + 1;
  lk.unlock();
  L->cv_space.notify_all();
  if (fr.rc != 0) return -2;
  std::memcpy(dst, fr.data.data(), sizeof(float) * fr.data.size());
  return idx;
}

void fm_loader_close(void* handle) {
  auto* L = (Loader*)handle;
  if (!L) return;
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->closed = true;
  }
  L->cv_space.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
