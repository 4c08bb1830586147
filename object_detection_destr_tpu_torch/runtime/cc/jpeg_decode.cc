// Native fused JPEG decode + canvas resize for the data loader.
//
// For real datasets the host hot path is JPEG decode (+ letterbox resize)
// per image; doing it in one threaded native pass removes both the Python
// per-image loop and the intermediate full-resolution RGB buffer handoff.
// Uses the system libjpeg (decode) and the bilinear resampler from
// batch_resize.cc's convention (half-pixel centers).
//
// Exposed C ABI (ctypes, see ../native.py):
//   odtr_batch_decode_resize(blobs, blob_lens, n, dst, canvas, num_threads,
//                            status)
//     blobs:  n pointers to JPEG byte blobs
//     dst:    n * canvas * canvas * 3 uint8, pre-allocated
//     status: n int32, 0 = ok, nonzero = decode error for that image
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread -ljpeg

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <atomic>
#include <thread>
#include <vector>

#include <jpeglib.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Bilinear resize RGB u8, half-pixel-center convention (matches
// batch_resize.cc::resize_one).
void resize_rgb(const uint8_t* src, int sh, int sw, uint8_t* dst, int canvas) {
  const float sy = static_cast<float>(sh) / canvas;
  const float sx = static_cast<float>(sw) / canvas;
  for (int oy = 0; oy < canvas; ++oy) {
    float fy = (oy + 0.5f) * sy - 0.5f;
    fy = fy < 0 ? 0 : (fy > sh - 1 ? sh - 1 : fy);
    const int y0 = static_cast<int>(fy);
    const int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
    const float wy = fy - y0;
    uint8_t* out_row = dst + static_cast<size_t>(oy) * canvas * 3;
    const uint8_t* r0 = src + static_cast<size_t>(y0) * sw * 3;
    const uint8_t* r1 = src + static_cast<size_t>(y1) * sw * 3;
    for (int ox = 0; ox < canvas; ++ox) {
      float fx = (ox + 0.5f) * sx - 0.5f;
      fx = fx < 0 ? 0 : (fx > sw - 1 ? sw - 1 : fx);
      const int x0 = static_cast<int>(fx);
      const int x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
      const float wx = fx - x0;
      const float w00 = (1 - wy) * (1 - wx), w01 = (1 - wy) * wx;
      const float w10 = wy * (1 - wx), w11 = wy * wx;
      const uint8_t* p00 = r0 + x0 * 3;
      const uint8_t* p01 = r0 + x1 * 3;
      const uint8_t* p10 = r1 + x0 * 3;
      const uint8_t* p11 = r1 + x1 * 3;
      uint8_t* out = out_row + ox * 3;
      for (int c = 0; c < 3; ++c) {
        out[c] = static_cast<uint8_t>(
            w00 * p00[c] + w01 * p01[c] + w10 * p10[c] + w11 * p11[c] + 0.5f);
      }
    }
  }
}

int decode_one(const uint8_t* blob, size_t len, uint8_t* dst, int canvas) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  std::vector<uint8_t> rgb;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(blob),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  cinfo.out_color_space = JCS_RGB;
  // libjpeg DCT-domain downscale: pick the smallest 1/1..1/8 scale that
  // stays >= the canvas on both axes (big decode-time win on large photos)
  for (unsigned denom = 8; denom >= 1; --denom) {
    if (cinfo.image_width / denom >= static_cast<unsigned>(canvas) &&
        cinfo.image_height / denom >= static_cast<unsigned>(canvas)) {
      cinfo.scale_num = 1;
      cinfo.scale_denom = denom;
      break;
    }
    cinfo.scale_num = 1;
    cinfo.scale_denom = 1;
  }
  jpeg_start_decompress(&cinfo);
  const int w = cinfo.output_width, h = cinfo.output_height;
  const int comps = cinfo.output_components;
  if (comps != 3) {  // grayscale etc.: fall back to replicate channels
    std::vector<uint8_t> row(static_cast<size_t>(w) * comps);
    rgb.resize(static_cast<size_t>(w) * h * 3);
    while (cinfo.output_scanline < cinfo.output_height) {
      uint8_t* rp = row.data();
      jpeg_read_scanlines(&cinfo, &rp, 1);
      uint8_t* out = rgb.data() + static_cast<size_t>(cinfo.output_scanline - 1) * w * 3;
      for (int x = 0; x < w; ++x) {
        const uint8_t v = row[static_cast<size_t>(x) * comps];
        out[x * 3] = out[x * 3 + 1] = out[x * 3 + 2] = v;
      }
    }
  } else {
    rgb.resize(static_cast<size_t>(w) * h * 3);
    while (cinfo.output_scanline < cinfo.output_height) {
      uint8_t* rp = rgb.data() + static_cast<size_t>(cinfo.output_scanline) * w * 3;
      jpeg_read_scanlines(&cinfo, &rp, 1);
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  resize_rgb(rgb.data(), h, w, dst, canvas);
  return 0;
}

}  // namespace

extern "C" {

void odtr_batch_decode_resize(const uint8_t** blobs, const int64_t* blob_lens,
                              int32_t n, uint8_t* dst, int32_t canvas,
                              int32_t num_threads, int32_t* status) {
  if (num_threads <= 0) {
    num_threads = static_cast<int32_t>(std::thread::hardware_concurrency());
    if (num_threads <= 0) num_threads = 4;
  }
  num_threads = num_threads < n ? num_threads : n;
  const size_t stride = static_cast<size_t>(canvas) * canvas * 3;
  std::atomic<int32_t> next(0);
  auto worker = [&]() {
    while (true) {
      const int32_t i = next.fetch_add(1);
      if (i >= n) break;
      status[i] = decode_one(blobs[i], static_cast<size_t>(blob_lens[i]),
                             dst + i * stride, canvas);
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

}  // extern "C"
