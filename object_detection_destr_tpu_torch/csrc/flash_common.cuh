// Helpers shared by the flash-attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu, flash_attention_bwd_two_pass.cu): operand strides
// and the 16-byte alignment test, and, for the float32 backward kernels on
// the CUDA cores, dtype conversion, warp reductions, shared-memory tile
// loads and the 32-key reduce-scatter.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int kWarp = 32;
constexpr int kTileK = 32;  // keys per shared-memory tile: one per lane
constexpr float kMaskedLogit = -1e9f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kHeaderBytes = kTileK * sizeof(int);  // per-key state of a tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Copies kTileK rows of `width` elements (global row stride `stride`) into a
// dense shared tile, zero-filling rows past `rows_valid`. With `vec`, 16
// bytes a thread (the rows and their starts are 16-byte aligned).
template <typename T>
__device__ __forceinline__ void load_tile(T* __restrict__ dst, const T* __restrict__ src,
                                          int rows_valid, int width, long stride, bool vec) {
  if (vec) {
    constexpr int kVec = 16 / sizeof(T);
    const int chunks = width / kVec;
    for (int c = threadIdx.x; c < kTileK * chunks; c += blockDim.x) {
      const int j = c / chunks, e = (c - j * chunks) * kVec;
      int4 val = make_int4(0, 0, 0, 0);
      if (j < rows_valid) val = *reinterpret_cast<const int4*>(src + j * stride + e);
      *reinterpret_cast<int4*>(dst + j * width + e) = val;
    }
    return;
  }
  for (int idx = threadIdx.x; idx < kTileK * width; idx += blockDim.x) {
    const int j = idx / width, e = idx - j * width;
    dst[idx] = j < rows_valid ? src[j * stride + e] : from_f32<T>(0.f);
  }
}

// Dot products of one row (this lane's P-slot slice `reg`, lanes striding
// the width) with the kTileK rows of a shared tile; returns key `lane`'s sum
// on lane `lane`. The partial sums are finished by one reduce-scatter
// butterfly across the warp (31 shuffles); counted loops with constant
// bounds keep part[] in registers.
template <typename T, int P>
__device__ __forceinline__ float tile_dots(const float (&reg)[P], const T* __restrict__ tile,
                                           int width, int lane) {
  float part[kTileK];
#pragma unroll
  for (int j = 0; j < kTileK; ++j) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int e = lane + kWarp * i;
      if (e < width) s = fmaf(reg[i], to_f32(tile[j * width + e]), s);
    }
    part[j] = s;
  }
#pragma unroll
  for (int step = 0; step < 5; ++step) {
    const int o = 16 >> step;
    const bool upper = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (i < o) {
        const float send = upper ? part[i] : part[i + o];
        const float keep = upper ? part[i + o] : part[i];
        part[i] = keep + __shfl_xor_sync(kFull, send, o);
      }
    }
  }
  return part[0];
}

// 16-byte tile loads need the base pointer, every row start and every head
// offset on a 16-byte boundary.
template <typename T>
bool aligned16(const void* base, int width, int num_heads) {
  return reinterpret_cast<uintptr_t>(base) % 16 == 0 && (width * sizeof(T)) % 16 == 0 &&
         ((long)width * num_heads * sizeof(T)) % 16 == 0;
}

// Element strides of one operand: batch, head, row (the feature stride is
// 1). The head-packed (B, S, h*d) layout has (S*h*d, d, h*d), the head-major
// (B, h, S, d) one (h*S*d, S*d, d); a view of either with its own strides
// works as well.
struct Strides {
  long long b, h, s;
  __device__ long off(int bi, int hh, int row) const {
    return (long)(bi * b + hh * h + row * s);
  }
};

// The same condition for an operand with its own strides: the base, every
// row start and every head and batch offset on a 16-byte boundary.
template <typename T>
bool aligned16_strided(const void* base, int width, const Strides& s) {
  const long long bytes = sizeof(T);
  return reinterpret_cast<uintptr_t>(base) % 16 == 0 && (width * bytes) % 16 == 0 &&
         (s.b * bytes) % 16 == 0 && (s.h * bytes) % 16 == 0 && (s.s * bytes) % 16 == 0;
}

}  // namespace flash
