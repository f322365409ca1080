// Async stereo frame loader: C++ decode/prefetch pipeline for the host side.
//
// Native re-design of the reference's synchronous ImageReader
// (reference: include/MotionEstimation/core/file_IO.h:300-421): frames are
// decoded by a background thread pool into a bounded queue so PNG decode and
// preprocessing overlap accelerator compute — at accelerator frame rates the
// decode is otherwise on the critical path. The port's copy of the JAX
// package's native/frame_loader.cpp. Supports the same two on-disk layouts:
//   * KITTI:   L_%06d.png / R_%06d.png, rows cropped to `kitti_crop`
//              (file_IO.cpp:313-340)
//   * generic: cam{N}_image%05d[_appendix].png (file_IO.cpp:296-310)
// honoring start/stop/skip (ImageReader seek semantics, file_IO.h:319-322).
//
// C ABI for ctypes; no Python-specific code.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <opencv2/imgcodecs.hpp>

namespace {

struct Frame {
  int index = -1;
  cv::Mat left, right;
  bool ok = false;
};

struct Loader {
  std::string dir, appendix;
  int start, stop, skip, kitti_crop, queue_depth;
  bool kitti, stereo;

  std::deque<Frame> queue;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::atomic<bool> done{false}, stop_flag{false};
  std::thread worker;

  std::string path(int cam, int idx) const {
    char buf[1024];
    if (kitti) {
      snprintf(buf, sizeof(buf), "%s/%s_%06d.png", dir.c_str(),
               cam == 0 ? "L" : "R", idx);
    } else if (appendix.empty()) {
      snprintf(buf, sizeof(buf), "%s/cam%d_image%05d.png", dir.c_str(), cam,
               idx);
    } else {
      snprintf(buf, sizeof(buf), "%s/cam%d_image%05d_%s.png", dir.c_str(), cam,
               idx, appendix.c_str());
    }
    return buf;
  }

  Frame load(int idx) const {
    Frame f;
    f.index = idx;
    f.left = cv::imread(path(0, idx), cv::IMREAD_GRAYSCALE);
    if (f.left.empty()) return f;
    if (kitti && f.left.rows > kitti_crop) f.left = f.left.rowRange(0, kitti_crop).clone();
    if (stereo) {
      f.right = cv::imread(path(1, idx), cv::IMREAD_GRAYSCALE);
      if (f.right.empty()) return f;
      if (kitti && f.right.rows > kitti_crop)
        f.right = f.right.rowRange(0, kitti_crop).clone();
    }
    f.ok = true;
    return f;
  }

  void run() {
    for (int idx = start; (stop < 0 || idx <= stop) && !stop_flag; idx += skip) {
      Frame f = load(idx);
      bool last = !f.ok;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_push.wait(lk, [&] {
          return (int)queue.size() < queue_depth || stop_flag;
        });
        if (stop_flag) break;
        if (f.ok) queue.push_back(std::move(f));
      }
      cv_pop.notify_one();
      if (last) break;
    }
    done = true;
    cv_pop.notify_all();
  }
};

}  // namespace

extern "C" {

void* fl_open(const char* dir, int start, int stop, int skip, int kitti,
              int kitti_crop, const char* appendix, int stereo,
              int queue_depth) {
  auto* L = new Loader();
  L->dir = dir;
  L->appendix = appendix ? appendix : "";
  L->start = start;
  L->stop = stop;
  L->skip = skip <= 0 ? 1 : skip;
  L->kitti = kitti != 0;
  L->kitti_crop = kitti_crop;
  L->stereo = stereo != 0;
  L->queue_depth = queue_depth <= 0 ? 4 : queue_depth;
  L->worker = std::thread([L] { L->run(); });
  return L;
}

// Peek dimensions of the next frame without consuming it. Returns 0 if the
// sequence is exhausted.
int fl_dims(void* h, int* height, int* width) {
  auto* L = static_cast<Loader*>(h);
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv_pop.wait(lk, [&] { return !L->queue.empty() || L->done; });
  if (L->queue.empty()) return 0;
  *height = L->queue.front().left.rows;
  *width = L->queue.front().left.cols;
  return 1;
}

// Pop the next decoded frame into caller-provided float32 buffers
// (row-major H*W). Returns the frame index, or -1 when exhausted.
int fl_next(void* h, float* left, float* right) {
  auto* L = static_cast<Loader*>(h);
  Frame f;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_pop.wait(lk, [&] { return !L->queue.empty() || L->done; });
    if (L->queue.empty()) return -1;
    f = std::move(L->queue.front());
    L->queue.pop_front();
  }
  L->cv_push.notify_one();
  f.left.convertTo(
      cv::Mat(f.left.rows, f.left.cols, CV_32F, left), CV_32F);
  if (L->stereo && right)
    f.right.convertTo(
        cv::Mat(f.right.rows, f.right.cols, CV_32F, right), CV_32F);
  return f.index;
}

void fl_close(void* h) {
  auto* L = static_cast<Loader*>(h);
  L->stop_flag = true;
  L->cv_push.notify_all();
  L->cv_pop.notify_all();
  if (L->worker.joinable()) L->worker.join();
  delete L;
}

}  // extern "C"
