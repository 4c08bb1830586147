// The greedy first-match walk of both mAP metrics, for Hopper (sm_90a). CUDA
// C++ with a plain C interface, loaded with ctypes by
// object_detection_destr_tpu_torch/ops/cuda/greedy_match.py.
//
// It replaces no TPU kernel: the JAX package computes this walk with
// lax.scan over ranks inside vmaps over images and classes
// (object_detection_destr_tpu/losses/metrics.py, _update_one_class l.83-98
// for the 11-point metric, _coco_batch_records l.265-278 for COCO AP), which
// XLA compiles into the metric's one program. The port's counterpart of that
// compiled scan is this kernel; ops/cuda/greedy_match.py holds its plain
// PyTorch version (a loop over ranks of batched tensor ops).
//
// Per problem p (one image and one class): iou (R, T) float32 holds -1 where
// target t is not a valid target of the class; the ranks i < n_use[p] count.
// For each threshold j on its own, walking the ranks in order:
//   skip_matched = 0 (the 11-point rule, l.84-92): best = argmax_t iou[i, t];
//     hit = iou[i, best] >= thr[j] and best not yet matched at j;
//   skip_matched = 1 (COCO's rule, l.265-275): best = argmax_t of iou[i, t]
//     with the matched targets at j replaced by -1; hit = that value >= thr[j];
//   a hit marks best as matched at j; hits[p, i, j] = hit and i < n_use[p].
// The argmax is jnp.argmax's: the first index wins ties, and a NaN counts as
// the maximum (a NaN row never hits: NaN >= thr is false).
//
// What bounds it on this card: latency, not bytes or operations. The walk
// is sequential over ranks, and a problem reads R x T floats once (0.36 MB
// at R = T = 300) and does a compare or two a float; the work of a whole
// validation batch is a few MB. The design: one block per problem, one warp
// per threshold (warp w takes thresholds w, w + W, ...), the J x T matched
// flags in shared memory, each warp's flags its own, so the warps never wait
// for each other. A rank's row is read by the warp's lanes in strides of 32
// (coalesced; the other warps of the block find it in L1), each lane keeps
// its first best, and a shuffle tree merges the lanes' (value, index) pairs
// with the argmax's rules. Past n_use the block writes zeros and stops.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThresholds = 32;  // one warp each at most
constexpr int kWarp = 32;

struct Thresholds {
  float v[kMaxThresholds];
};

// a better than b in jnp.argmax's order: NaN is the maximum; among equals
// (NaNs included) the lower index wins
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  const bool na = a != a, nb = b != b;
  if (na || nb) return na && (!nb || ia < ib);
  return a > b || (a == b && ia < ib);
}

__global__ void greedy_match_kernel(const float* __restrict__ iou, const int* __restrict__ n_use,
                                    Thresholds thr, uint8_t* __restrict__ hits, int r, int t, int nj,
                                    int skip_matched) {
  extern __shared__ uint8_t matched[];  // (J, T)
  const int p = blockIdx.x;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int warps = blockDim.x / kWarp;
  const float* rows = iou + (long)p * r * t;
  uint8_t* out = hits + (long)p * r * nj;
  const int used = min(max(n_use[p], 0), r);

  for (int j = warp; j < nj; j += warps) {
    uint8_t* m = matched + (long)j * t;
    for (int c = lane; c < t; c += kWarp) m[c] = 0;
    __syncwarp();
    const float threshold = thr.v[j];
    for (int i = 0; i < used; ++i) {
      const float* row = rows + (long)i * t;
      float best_v = 0.0f;
      int best_i = -1;
      for (int c = lane; c < t; c += kWarp) {
        float v = row[c];
        if (skip_matched && m[c]) v = -1.0f;
        if (best_i < 0 || better(v, c, best_v, best_i)) {
          best_v = v;
          best_i = c;
        }
      }
#pragma unroll
      for (int off = kWarp / 2; off > 0; off /= 2) {
        const float ov = __shfl_xor_sync(0xffffffffu, best_v, off);
        const int oi = __shfl_xor_sync(0xffffffffu, best_i, off);
        if (oi >= 0 && (best_i < 0 || better(ov, oi, best_v, best_i))) {
          best_v = ov;
          best_i = oi;
        }
      }
      // every lane holds the same (best_v, best_i); t >= 1, so best_i >= 0
      const bool hit = best_v >= threshold && !m[best_i];
      __syncwarp();  // every lane has read m before lane 0 writes it
      if (lane == 0) {
        if (hit) m[best_i] = 1;
        out[(long)i * nj + j] = hit;
      }
      __syncwarp();
    }
    for (int i = used + lane; i < r; i += kWarp) out[(long)i * nj + j] = 0;
  }
}

}  // namespace

extern "C" {

int odtt_greedy_match_abi_version() { return 1; }

// p problems. iou (P, R, T) float32, n_use (P,) int32 (device pointers);
// thresholds: nj floats in host memory (1 <= nj <= 32), passed to the kernel
// by value; hits (P, R, J) bytes out, every entry written. skip_matched 0
// or 1. Returns cudaGetLastError() after the launch (0 on success).
int odtt_greedy_match(const void* iou, const void* n_use, const float* thresholds, void* hits, int p, int r,
                      int t, int nj, int skip_matched, void* stream) {
  if (p <= 0 || r <= 0 || t <= 0 || nj <= 0 || nj > kMaxThresholds || thresholds == nullptr)
    return (int)cudaErrorInvalidValue;
  Thresholds thr;
  for (int j = 0; j < kMaxThresholds; ++j) thr.v[j] = j < nj ? thresholds[j] : 0.0f;
  const size_t smem = (size_t)nj * t;
  cudaError_t err =
      cudaFuncSetAttribute(greedy_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = kWarp * nj;  // one warp a threshold
  greedy_match_kernel<<<p, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(iou), static_cast<const int*>(n_use), thr, static_cast<uint8_t*>(hits), r, t,
      nj, skip_matched);
  return (int)cudaGetLastError();
}

}  // extern "C"
