// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC 2011) for the attention-probability dropout of the flash-attention
// forward and backward kernels.
//
// The keep decision of element (query q, key k) of head bh = b * heads + h is
// a pure function of (seed, bh, q, k): word 0 of Philox4x32-10 with key
// (seed, 0) and counter (q, k, bh, 0). It does not depend on how a kernel
// tiles the work, so the backward regenerates exactly the forward's mask.
// Keep iff bits >= threshold, threshold = uint32(rate * 2^32) — the rule of
// object_detection_destr_tpu/ops/pallas/flash_attention.py::_drop_threshold.
// The plain PyTorch twin is ops/cuda/flash_attention.py::philox_keep_bits.
//
// The seed lives in device memory, the low 32 bits of one int64, so that a
// CUDA graph that replays a launch with its arguments fixed still draws a new
// mask whenever the seed's tensor holds a new value (the JAX kernels read
// theirs from a ref, _prng_keep(seed_ref, ...)).
#pragma once

#include <stdint.h>

namespace philox {

constexpr uint32_t kM0 = 0xD2511F53u;
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;
constexpr uint32_t kW1 = 0xBB67AE85u;

// The seed a thread draws with: one read of *seed, none when dropout is off
// (drop_threshold 0; the pointer may then be null).
__device__ __forceinline__ uint32_t load_seed(const long long* seed, uint32_t drop_threshold) {
  return drop_threshold ? (uint32_t)(unsigned long long)__ldg(seed) : 0u;
}

__device__ __forceinline__ uint32_t bits(uint32_t seed, uint32_t bh, uint32_t q, uint32_t k) {
  uint32_t c0 = q, c1 = k, c2 = bh, c3 = 0u;
  uint32_t k0 = seed, k1 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c0), lo0 = kM0 * c0;
    const uint32_t hi1 = __umulhi(kM1, c2), lo1 = kM1 * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return c0;
}

}  // namespace philox
