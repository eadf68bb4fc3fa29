// Threaded RGB-D frame prefetcher: decodes PNG pairs ahead of the consumer,
// applies the res-factor subsample and depth rescale in native code, and
// hands the Python driver ready float32 buffers.
//
// This is the runtime counterpart of the reference's synchronous per-frame
// disk reads (FrontEnd.cpp:216-254, Utils/Datasets.cpp) — redesigned as a
// pipelined producer so TPU steps never wait on the filesystem.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" int sf_decode_png(const char* path, uint8_t** out, int* width,
                             int* height, int* channels, int* bitdepth);
extern "C" void sf_free(void* p);

namespace {

struct Frame {
  std::vector<float> rgb;       // h*w*3 in [0,1]
  std::vector<float> depth_mm;  // h*w
  int w = 0, h = 0;
  int status = 0;  // 0 ok, <0 error
};

struct Loader {
  std::vector<std::string> rgb_paths, depth_paths;
  int res_factor = 1;
  float depth_to_mm = 1.0f;
  int out_w = 0, out_h = 0;
  size_t window = 8;

  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::map<int, Frame> ready;
  std::atomic<int> next_job{0};
  int next_consume = 0;
  bool stop = false;
  std::vector<std::thread> workers;

  void worker() {
    for (;;) {
      int idx = next_job.fetch_add(1);
      if (idx >= int(rgb_paths.size())) return;
      Frame fr = decode(idx);
      std::unique_lock<std::mutex> lk(mu);
      cv_space.wait(lk, [&] {
        return stop || idx < next_consume + int(window);
      });
      if (stop) return;
      ready.emplace(idx, std::move(fr));
      cv_ready.notify_all();
    }
  }

  Frame decode(int idx) {
    Frame fr;
    uint8_t* rgb_raw = nullptr;
    uint8_t* dep_raw = nullptr;
    int rw, rh, rc, rb, dw, dh, dc, db;
    int s1 = sf_decode_png(rgb_paths[idx].c_str(), &rgb_raw, &rw, &rh, &rc, &rb);
    int s2 = sf_decode_png(depth_paths[idx].c_str(), &dep_raw, &dw, &dh, &dc, &db);
    if (s1 != 0 || s2 != 0 || rb != 8) {
      fr.status = s1 != 0 ? s1 : (s2 != 0 ? s2 : -100);
      if (rgb_raw) sf_free(rgb_raw);
      if (dep_raw) sf_free(dep_raw);
      return fr;
    }
    const int f = res_factor;
    fr.w = rw / f;
    fr.h = rh / f;
    fr.rgb.resize(size_t(fr.w) * fr.h * 3);
    fr.depth_mm.resize(size_t(fr.w) * fr.h);
    const float inv255 = 1.0f / 255.0f;
    for (int y = 0; y < fr.h; y++) {
      for (int x = 0; x < fr.w; x++) {
        const uint8_t* px = rgb_raw + (size_t(y) * f * rw + size_t(x) * f) * rc;
        float* o = &fr.rgb[(size_t(y) * fr.w + x) * 3];
        if (rc >= 3) {
          o[0] = px[0] * inv255;
          o[1] = px[1] * inv255;
          o[2] = px[2] * inv255;
        } else {
          o[0] = o[1] = o[2] = px[0] * inv255;
        }
      }
    }
    const int dff = res_factor * dw / rw == 0 ? 1 : res_factor;  // same grid
    for (int y = 0; y < fr.h; y++) {
      for (int x = 0; x < fr.w; x++) {
        float v;
        size_t src = size_t(y) * dff * dw + size_t(x) * dff;
        if (db == 16)
          v = float(((const uint16_t*)dep_raw)[src * dc]);
        else
          v = float(dep_raw[src * dc]);
        fr.depth_mm[size_t(y) * fr.w + x] = v * depth_to_mm;
      }
    }
    sf_free(rgb_raw);
    sf_free(dep_raw);
    return fr;
  }
};

}  // namespace

extern "C" {

void* sf_loader_create(const char** rgb_paths, const char** depth_paths,
                       int n, int res_factor, float depth_to_mm,
                       int queue_depth, int n_threads) {
  Loader* L = new Loader();
  for (int i = 0; i < n; i++) {
    L->rgb_paths.emplace_back(rgb_paths[i]);
    L->depth_paths.emplace_back(depth_paths[i]);
  }
  L->res_factor = res_factor;
  L->depth_to_mm = depth_to_mm;
  L->window = queue_depth > 0 ? queue_depth : 8;
  int nt = n_threads > 0 ? n_threads : 2;
  for (int t = 0; t < nt; t++)
    L->workers.emplace_back([L] { L->worker(); });
  return L;
}

// Blocks until frame idx is decoded; copies into caller buffers.
// Returns 0 ok, <0 decode error, -1000 bad index/size. Frames must be
// consumed in ascending order for the window to advance.
int sf_loader_get(void* handle, int idx, float* rgb_out, float* depth_out,
                  int* w, int* h) {
  Loader* L = (Loader*)handle;
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv_ready.wait(lk, [&] { return L->ready.count(idx) || L->stop; });
  if (L->stop) return -1001;
  Frame fr = std::move(L->ready[idx]);
  L->ready.erase(idx);
  if (idx >= L->next_consume) {
    L->next_consume = idx + 1;
    L->cv_space.notify_all();
  }
  lk.unlock();
  if (fr.status != 0) return fr.status;
  *w = fr.w;
  *h = fr.h;
  memcpy(rgb_out, fr.rgb.data(), fr.rgb.size() * sizeof(float));
  memcpy(depth_out, fr.depth_mm.data(), fr.depth_mm.size() * sizeof(float));
  return 0;
}

void sf_loader_destroy(void* handle) {
  Loader* L = (Loader*)handle;
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->stop = true;
  }
  L->cv_ready.notify_all();
  L->cv_space.notify_all();
  L->next_job.store(1 << 30);
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
