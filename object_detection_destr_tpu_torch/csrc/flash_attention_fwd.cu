// Masked multi-head flash-attention forward on head-packed operands, for
// Hopper (sm_90a). CUDA C++ with a plain C interface, loaded with ctypes by
// object_detection_destr_tpu_torch/ops/cuda/flash_attention.py.
//
// Replaces the TPU kernel
//   object_detection_destr_tpu/ops/pallas/flash_attention.py::_fwd_kernel_packed
//   (l.592, launched by _fwd_impl_packed l.750, public entry
//   flash_attention_packed l.1174).
// It computes the same function, not the same blocks:
//   q (B, Sq, h*d), k (B, Sk, h*d), v (B, Sk, h*dv), key_valid (B, Sk) or none
//   out[b, i, hh*dv:(hh+1)*dv] = softmax_j(s_ij) @ v[b, :, hh]   (input dtype)
//   lse[b, hh, i] = logsumexp_j(s_ij)                            (float32)
//   s_ij = scale * <q_i, k_j> for a valid key, -1e9 for a masked key.
// Keys past Sk (the ragged end of the last tile) are left out entirely, so
// a fully masked row averages over the Sk real keys only. Logits, the
// online max and sum and the accumulator are float32 for both float32 and
// bfloat16 inputs.
//
// What bounds it on this card: at the serving path's shapes (Sq, Sk of a
// few hundred, d 32..512) a launch does 0.1-0.4 GFLOP on 1-2 MB of
// operands, a few microseconds of either peak, so the time is launch
// latency, occupancy and the latency of the per-key arithmetic, not bytes.
// What the design does about that, simply:
//   * grid (ceil(Sq / rows), h, B) with one warp per query row, so even the
//     single-head cross-attention (Sq = 600) spreads over the SMs; blocks
//     take 4 warps instead of 8 when the grid would not cover the card twice;
//   * each lane keeps its d/32 slice of the query row and its dv/32 slice of
//     the output accumulator in registers (lanes stride d and dv);
//   * K/V tiles of 32 keys are staged once per block in dynamic shared
//     memory and read by all of the block's rows; the cross-attention tile
//     (d 512, dv 256, float32) is 96 KB, past the 48 KB default, so the
//     launcher raises the block's dynamic shared-memory limit; rows are
//     copied 16 bytes a thread where the operands are 16-byte aligned;
//   * the 32 dot products of a tile are finished by one reduce-scatter
//     butterfly across the warp (31 shuffles) that leaves key j's score on
//     lane j, so the tile's max, exponentials and sum are one value a lane.
// wgmma, TMA and a pipelined K/V ring are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

// P = slots a lane holds of a d- or dv-wide row: ceil(max(d, dv) / 32)
// rounded up to a power of two, so the loops below unroll into registers.
template <typename T, int P>
__global__ void __launch_bounds__(256) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const uint8_t* __restrict__ key_valid, T* __restrict__ out,
    float* __restrict__ lse, int sq, int sk, int num_heads, int d, int dv,
    float scale, bool vec_k, bool vec_v) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* key_state = reinterpret_cast<int*>(smem);  // 1 valid, 0 masked, -1 past Sk
  T* k_tile = reinterpret_cast<T*>(smem + kHeaderBytes);  // (kTileK, d)
  T* v_tile = k_tile + kTileK * d;                        // (kTileK, dv)

  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int rows = blockDim.x / kWarp;
  const int row = blockIdx.x * rows + warp;
  const int hh = blockIdx.y;
  const int b = blockIdx.z;
  const bool active = row < sq;
  const long hd = (long)num_heads * d;
  const long hdv = (long)num_heads * dv;

  float qreg[P];
  float acc[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int e = lane + kWarp * i;
    qreg[i] = (active && e < d) ? to_f32(q[((long)b * sq + row) * hd + hh * d + e]) : 0.f;
    acc[i] = 0.f;
  }
  float m_run = -INFINITY;  // running max of the row's logits
  float l_run = 0.f;        // running sum of exp(logit - m_run)

  for (int t0 = 0; t0 < sk; t0 += kTileK) {
    __syncthreads();  // the previous tile is no longer read
    const int rows_left = sk - t0;
    load_tile(k_tile, k + ((long)b * sk + t0) * hd + hh * d, rows_left, d, hd, vec_k);
    load_tile(v_tile, v + ((long)b * sk + t0) * hdv + hh * dv, rows_left, dv, hdv, vec_v);
    if (threadIdx.x < kTileK) {
      const int key = t0 + threadIdx.x;
      key_state[threadIdx.x] =
          key >= sk ? -1 : (key_valid == nullptr ? 1 : (key_valid[(long)b * sk + key] != 0));
    }
    __syncthreads();
    if (!active) continue;

    // partial dot products of this lane's d-slice with every key of the tile
    float part[kTileK];
#pragma unroll
    for (int j = 0; j < kTileK; ++j) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int e = lane + kWarp * i;
        if (e < d) s = fmaf(qreg[i], to_f32(k_tile[j * d + e]), s);
      }
      part[j] = s;
    }
    // reduce-scatter: after the butterfly, lane j holds the sum for key j
    // (counted loops with constant bounds, so part[] stays in registers)
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
    const int state = key_state[lane];
    const float s = state < 0 ? -INFINITY : (state == 0 ? kMaskedLogit : part[0] * scale);

    // online softmax: the tile's first key is real, so m_new is finite
    const float m_new = fmaxf(m_run, warp_max(s));
    const float p = expf(s - m_new);
    const float alpha = expf(m_run - m_new);
    l_run = l_run * alpha + warp_sum(p);
    m_run = m_new;
#pragma unroll
    for (int i = 0; i < P; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < kTileK; ++j) {
      const float pj = __shfl_sync(kFull, p, j);
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int e = lane + kWarp * i;
        if (e < dv) acc[i] = fmaf(pj, to_f32(v_tile[j * dv + e]), acc[i]);
      }
    }
  }

  if (!active) return;
  const float inv_l = 1.f / l_run;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int e = lane + kWarp * i;
    if (e < dv) out[((long)b * sq + row) * hdv + hh * dv + e] = from_f32<T>(acc[i] * inv_l);
  }
  if (lane == 0) lse[((long)b * num_heads + hh) * sq + row] = m_run + logf(l_run);
}

// 16-byte tile loads need the base pointer, every row start and every head
// offset on a 16-byte boundary.
template <typename T>
bool aligned16(const void* base, int width, int num_heads) {
  return reinterpret_cast<uintptr_t>(base) % 16 == 0 && (width * sizeof(T)) % 16 == 0 &&
         ((long)width * num_heads * sizeof(T)) % 16 == 0;
}

template <typename T, int P>
int launch(const void* q, const void* k, const void* v, const void* key_valid,
           void* out, void* lse, int b, int sq, int sk, int num_heads, int d,
           int dv, float scale, cudaStream_t stream) {
  const int rows = ((sq + 7) / 8) * num_heads * b >= 2 * 132 ? 8 : 4;
  const dim3 grid((sq + rows - 1) / rows, num_heads, b);
  const size_t smem = kHeaderBytes + (size_t)kTileK * (d + dv) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_kernel<T, P><<<grid, rows * kWarp, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(key_valid), static_cast<T*>(out),
      static_cast<float*>(lse), sq, sk, num_heads, d, dv, scale,
      aligned16<T>(k, d, num_heads), aligned16<T>(v, dv, num_heads));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* key_valid,
             void* out, void* lse, int b, int sq, int sk, int num_heads, int d,
             int dv, float scale, cudaStream_t stream) {
  const int widest = d > dv ? d : dv;
  if (widest <= 32) return launch<T, 1>(q, k, v, key_valid, out, lse, b, sq, sk, num_heads, d, dv, scale, stream);
  if (widest <= 64) return launch<T, 2>(q, k, v, key_valid, out, lse, b, sq, sk, num_heads, d, dv, scale, stream);
  if (widest <= 128) return launch<T, 4>(q, k, v, key_valid, out, lse, b, sq, sk, num_heads, d, dv, scale, stream);
  if (widest <= 256) return launch<T, 8>(q, k, v, key_valid, out, lse, b, sq, sk, num_heads, d, dv, scale, stream);
  if (widest <= 512) return launch<T, 16>(q, k, v, key_valid, out, lse, b, sq, sk, num_heads, d, dv, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int odtt_flash_fwd_abi_version() { return 1; }

// dtype: 0 float32, 1 bfloat16. key_valid: (B, Sk) bytes or null.
// Returns cudaGetLastError() after the launch (0 on success).
int odtt_flash_attention_fwd(const void* q, const void* k, const void* v,
                             const void* key_valid, void* out, void* lse,
                             int dtype, int b, int sq, int sk, int num_heads,
                             int d, int dv, float scale, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || num_heads <= 0 || d <= 0 || dv <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(q, k, v, key_valid, out, lse, b, sq, sk, num_heads, d, dv, scale, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(q, k, v, key_valid, out, lse, b, sq, sk, num_heads, d, dv, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
