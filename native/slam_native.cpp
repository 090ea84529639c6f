// Native runtime components for tc2li_slam_tpu.
//
// The compute path is JAX/XLA on the accelerator; this library covers the
// host runtime around it, the role C++ plays in the reference's stack (its whole
// pipeline is C++; ours needs native speed only where Python would stall the
// device): LiDAR binary decode + per-point time reconstruction, and a
// threaded read-ahead pipeline so frame N+1's disk IO and decode overlap
// frame N's device compute (the reference overlaps via its ROS spinner +
// front-end thread; we overlap via a prefetch pool).
//
// Plain C ABI (ctypes-friendly), no Python headers required.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Velodyne .bin decode (KITTI layout: float32 x, y, z, reflectance)
// ---------------------------------------------------------------------------

// Reads a scan, reconstructs per-point relative times from the azimuth sweep
// (HDL-64E: 360 deg in 0.1 s, clockwise from +x), pads/truncates to n_max.
// Returns the number of valid points, or -1 on IO error.
int read_velodyne(const char* path, float* out_xyz, float* out_time,
                  uint8_t* out_valid, int n_max) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long bytes = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  long n_pts = bytes / (4 * sizeof(float));
  std::vector<float> raw(static_cast<size_t>(n_pts) * 4);
  size_t got = std::fread(raw.data(), sizeof(float), raw.size(), f);
  std::fclose(f);
  n_pts = static_cast<long>(got / 4);

  const int n = static_cast<int>(n_pts < n_max ? n_pts : n_max);
  // decimate uniformly if the scan overflows the static buffer
  const double stride = n_pts > n_max ? static_cast<double>(n_pts) / n_max : 1.0;
  for (int i = 0; i < n; ++i) {
    const long s = static_cast<long>(i * stride);
    const float x = raw[s * 4 + 0];
    const float y = raw[s * 4 + 1];
    const float z = raw[s * 4 + 2];
    out_xyz[i * 3 + 0] = x;
    out_xyz[i * 3 + 1] = y;
    out_xyz[i * 3 + 2] = z;
    const float az = std::atan2(y, x);                    // [-pi, pi]
    out_time[i] = (static_cast<float>(M_PI) - az) /
                  (2.0f * static_cast<float>(M_PI)) * 0.1f;
    out_valid[i] = 1;
  }
  for (int i = n; i < n_max; ++i) {
    out_xyz[i * 3 + 0] = out_xyz[i * 3 + 1] = out_xyz[i * 3 + 2] = 0.f;
    out_time[i] = 0.f;
    out_valid[i] = 0;
  }
  return n;
}

// ---------------------------------------------------------------------------
// Threaded scan prefetcher
// ---------------------------------------------------------------------------

struct Prefetcher {
  std::vector<std::string> paths;
  int n_max = 0;
  int ahead = 4;
  std::vector<std::vector<float>> xyz;     // decoded slots
  std::vector<std::vector<float>> times;
  std::vector<std::vector<uint8_t>> valid;
  std::vector<int> counts;
  std::vector<std::atomic<int>> state;     // 0=todo 1=busy 2=ready
  std::mutex mu;
  std::condition_variable cv;
  std::atomic<bool> stop{false};
  std::atomic<int> cursor{0};
  std::vector<std::thread> workers;

  explicit Prefetcher(int n) : state(n) {}
};

static void prefetch_worker(Prefetcher* p) {
  while (!p->stop.load()) {
    int idx = -1;
    {
      // claim the next undone slot within the read-ahead window
      std::unique_lock<std::mutex> lk(p->mu);
      const int cur = p->cursor.load();
      const int hi = std::min<int>(static_cast<int>(p->paths.size()),
                                   cur + p->ahead + 1);
      for (int i = cur; i < hi; ++i) {
        int expect = 0;
        if (p->state[i].compare_exchange_strong(expect, 1)) { idx = i; break; }
      }
      if (idx < 0) {
        p->cv.wait_for(lk, std::chrono::milliseconds(5));
        continue;
      }
    }
    p->counts[idx] = read_velodyne(p->paths[idx].c_str(), p->xyz[idx].data(),
                                   p->times[idx].data(), p->valid[idx].data(),
                                   p->n_max);
    p->state[idx].store(2);
    p->cv.notify_all();
  }
}

void* prefetch_create(const char** paths, int n_paths, int n_max,
                      int n_threads, int ahead) {
  auto* p = new Prefetcher(n_paths);
  p->paths.assign(paths, paths + n_paths);
  p->n_max = n_max;
  p->ahead = ahead;
  p->xyz.resize(n_paths);
  p->times.resize(n_paths);
  p->valid.resize(n_paths);
  p->counts.resize(n_paths, 0);
  for (int i = 0; i < n_paths; ++i) {
    p->xyz[i].resize(static_cast<size_t>(n_max) * 3);
    p->times[i].resize(n_max);
    p->valid[i].resize(n_max);
    p->state[i].store(0);
  }
  for (int t = 0; t < n_threads; ++t)
    p->workers.emplace_back(prefetch_worker, p);
  return p;
}

// Blocks until scan i is decoded, copies it out, frees the slot's memory,
// and advances the read-ahead cursor. Returns the valid-point count.
int prefetch_get(void* handle, int i, float* out_xyz, float* out_time,
                 uint8_t* out_valid) {
  auto* p = static_cast<Prefetcher*>(handle);
  if (i < 0 || i >= static_cast<int>(p->paths.size())) return -1;
  p->cursor.store(i);
  p->cv.notify_all();
  {
    std::unique_lock<std::mutex> lk(p->mu);
    p->cv.wait(lk, [&] { return p->state[i].load() == 2 || p->stop.load(); });
  }
  if (p->state[i].load() != 2) return -1;
  std::memcpy(out_xyz, p->xyz[i].data(), sizeof(float) * 3 * p->n_max);
  std::memcpy(out_time, p->times[i].data(), sizeof(float) * p->n_max);
  std::memcpy(out_valid, p->valid[i].data(), p->n_max);
  // release slot memory (sequential consumption)
  std::vector<float>().swap(p->xyz[i]);
  std::vector<float>().swap(p->times[i]);
  std::vector<uint8_t>().swap(p->valid[i]);
  return p->counts[i];
}

void prefetch_destroy(void* handle) {
  auto* p = static_cast<Prefetcher*>(handle);
  p->stop.store(true);
  p->cv.notify_all();
  for (auto& t : p->workers) t.join();
  delete p;
}

// ---------------------------------------------------------------------------
// Trajectory writer (KITTI format) — bulk fprintf beats Python line loops
// ---------------------------------------------------------------------------

int write_kitti_trajectory(const char* path, const float* T_wc, int n) {
  FILE* f = std::fopen(path, "w");
  if (!f) return -1;
  for (int i = 0; i < n; ++i) {
    const float* T = T_wc + i * 16;
    std::fprintf(f,
                 "%.9e %.9e %.9e %.9e %.9e %.9e %.9e %.9e %.9e %.9e %.9e %.9e\n",
                 T[0], T[1], T[2], T[3], T[4], T[5], T[6], T[7], T[8], T[9],
                 T[10], T[11]);
  }
  std::fclose(f);
  return n;
}

}  // extern "C"
