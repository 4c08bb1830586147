// Native host-side batch image preprocessing for the data loader.
//
// The reference leans on torchvision CPU workers for decode/resize
// (src/dataset/transforms.py); the TPU build's host-side hot path is
// letterboxing decoded frames onto the fixed square canvas that feeds the
// device (data/loader.py::_resize_canvas). This library does that with a
// std::thread pool over images: bilinear uint8 HWC resize + batch packing,
// one pass, no Python in the loop.
//
// Exposed C ABI (ctypes, see ../native.py):
//   odtr_batch_resize(src_ptrs, src_hs, src_ws, n, dst, canvas, channels,
//                     num_threads)
//     src_ptrs: n pointers to HWC uint8 images (row-major, tightly packed)
//     dst:      n * canvas * canvas * channels uint8, pre-allocated
//
// Build: g++ -O3 -march=native -shared -fPIC -std=c++17 -pthread
//   (driven by ../native.py, cached next to the source)

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Bilinear resize one HWC uint8 image to (canvas x canvas).
// Matches cv2.INTER_LINEAR's half-pixel-center sampling convention.
void resize_one(const uint8_t* src, int sh, int sw, uint8_t* dst, int canvas,
                int ch) {
  const float scale_y = static_cast<float>(sh) / canvas;
  const float scale_x = static_cast<float>(sw) / canvas;
  for (int oy = 0; oy < canvas; ++oy) {
    float fy = (oy + 0.5f) * scale_y - 0.5f;
    fy = std::max(0.0f, std::min(fy, static_cast<float>(sh - 1)));
    const int y0 = static_cast<int>(fy);
    const int y1 = std::min(y0 + 1, sh - 1);
    const float wy = fy - y0;
    uint8_t* out_row = dst + static_cast<size_t>(oy) * canvas * ch;
    const uint8_t* row0 = src + static_cast<size_t>(y0) * sw * ch;
    const uint8_t* row1 = src + static_cast<size_t>(y1) * sw * ch;
    for (int ox = 0; ox < canvas; ++ox) {
      float fx = (ox + 0.5f) * scale_x - 0.5f;
      fx = std::max(0.0f, std::min(fx, static_cast<float>(sw - 1)));
      const int x0 = static_cast<int>(fx);
      const int x1 = std::min(x0 + 1, sw - 1);
      const float wx = fx - x0;
      const float w00 = (1 - wy) * (1 - wx), w01 = (1 - wy) * wx;
      const float w10 = wy * (1 - wx), w11 = wy * wx;
      const uint8_t* p00 = row0 + static_cast<size_t>(x0) * ch;
      const uint8_t* p01 = row0 + static_cast<size_t>(x1) * ch;
      const uint8_t* p10 = row1 + static_cast<size_t>(x0) * ch;
      const uint8_t* p11 = row1 + static_cast<size_t>(x1) * ch;
      uint8_t* out = out_row + static_cast<size_t>(ox) * ch;
      for (int c = 0; c < ch; ++c) {
        const float v =
            w00 * p00[c] + w01 * p01[c] + w10 * p10[c] + w11 * p11[c];
        out[c] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

}  // namespace

extern "C" {

void odtr_batch_resize(const uint8_t** src_ptrs, const int32_t* src_hs,
                       const int32_t* src_ws, int32_t n, uint8_t* dst,
                       int32_t canvas, int32_t channels,
                       int32_t num_threads) {
  if (num_threads <= 0) {
    num_threads = static_cast<int32_t>(std::thread::hardware_concurrency());
    if (num_threads <= 0) num_threads = 4;
  }
  num_threads = std::min(num_threads, n);
  const size_t dst_stride =
      static_cast<size_t>(canvas) * canvas * channels;
  std::atomic<int32_t> next(0);
  auto worker = [&]() {
    while (true) {
      const int32_t i = next.fetch_add(1);
      if (i >= n) break;
      resize_one(src_ptrs[i], src_hs[i], src_ws[i], dst + i * dst_stride,
                 canvas, channels);
    }
  };
  if (num_threads <= 1) {
    worker();
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(num_threads);
  for (int32_t t = 0; t < num_threads; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

int32_t odtr_runtime_abi_version() { return 1; }

}  // extern "C"
