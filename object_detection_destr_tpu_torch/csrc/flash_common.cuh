// Helpers shared by the flash-attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu, flash_attention_bwd_two_pass.cu): the masked
// logit, operand strides and the 16-byte alignment tests.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int kWarp = 32;
constexpr float kMaskedLogit = -1e9f;
constexpr unsigned kFull = 0xffffffffu;

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
