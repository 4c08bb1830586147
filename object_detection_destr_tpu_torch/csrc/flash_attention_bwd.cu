// Masked multi-head flash-attention backward on head-packed operands, with
// the forward's attention-probability dropout regenerated in the kernel, for
// Hopper (sm_90a). CUDA C++ with a plain C interface, loaded with ctypes by
// object_detection_destr_tpu_torch/ops/cuda/flash_attention.py.
//
// Replaces the TPU kernel
//   object_detection_destr_tpu/ops/pallas/flash_attention.py::_dkvq_kernel_packed
//   (l.884, launched by _bwd_impl_packed l.1070, reached through the custom
//   VJP of flash_attention_packed l.1173-1220).
// One launch produces dQ, dK and dV of the forward in flash_attention_fwd.cu:
//   p_ij  = exp(s_ij - lse_i)                      (s_ij as in the forward)
//   dp_ij = keep_ij / (1 - rate) * <dO_i, v_j>
//   ds_ij = p_ij * (dp_ij - delta_i)   delta_i = <dO_i, O_i> (computed by the
//           wrapper, as _delta_packed l.973 computes it outside the kernel)
//   dQ_i += scale * ds_ij k_j;  dK_j += scale * ds_ij q_i  (valid keys only)
//   dV_j += keep_ij / (1 - rate) * p_ij dO_i           (every real key)
// A masked key's logit is the constant -1e9, so it passes no gradient to q
// or k: a fully masked row gives dQ = 0 and its uniform weights 1/Sk over
// the Sk real keys reach dV only, which is the gradient of the port's
// forward (its lse, -1e9 + log Sk, rounds to -1e9 in float32, so p is set to
// 1/Sk there rather than recomputed from it).
//
// Design (FlashAttention-2's backward order, simply): grid
// (ceil(Sk / 32), h, B); a block owns one tile of 32 keys of one head and
// loops over every query row, 8 rows an iteration, one row a warp.
//   phase A, per warp: the row's q and dO slices in registers, s and dp for
//     the tile's 32 keys by two reduce-scatters (flash_common.cuh) leaving
//     key j on lane j, p, the Philox keep draw and ds on that lane; the row's
//     dQ contribution sum_j ds_ij k_j is added to a float32 dQ buffer with
//     atomics (the wrapper zeroes it and casts it to the query dtype);
//   phase B, the whole block: dK and dV of the tile accumulate in float32 in
//     shared memory, each element owned by one thread, from the 8 rows' q,
//     dO, ds and p staged in shared memory.
// The cross-attention tile (d 512, dv 256) holds 96 KB of float32
// accumulators beside its K/V tile (96 KB in float32), so the launcher
// raises the block's dynamic shared-memory limit to about 218 KB.
// What bounds it on this card: at the training shapes the float32 CUDA
// cores' arithmetic and the dQ atomics, not bytes; tensor cores are later
// work.

#include <math.h>

#include "flash_common.cuh"
#include "philox.cuh"

namespace {

using namespace flash;

constexpr int kRows = 8;  // query rows an iteration: one a warp
constexpr int kThreads = kRows * kWarp;
constexpr float kFullyMaskedLse = -5e8f;  // below any row with a valid key

__host__ __device__ inline size_t round16(size_t x) { return (x + 15) / 16 * 16; }

// Shared-memory layout, in bytes from the start.
struct Layout {
  size_t ds, pd, q, dout, dk, dv, k_tile, v_tile, total;
  __host__ __device__ Layout(int d, int dv_, size_t itemsize) {
    ds = kHeaderBytes;                                  // (kRows, kTileK) f32
    pd = ds + sizeof(float) * kRows * kTileK;           // (kRows, kTileK) f32
    q = pd + sizeof(float) * kRows * kTileK;            // (kRows, d) f32
    dout = q + sizeof(float) * kRows * d;               // (kRows, dv) f32
    dk = dout + sizeof(float) * kRows * dv_;            // (kTileK, d) f32
    dv = dk + sizeof(float) * kTileK * d;               // (kTileK, dv) f32
    k_tile = round16(dv + sizeof(float) * kTileK * dv_);  // (kTileK, d) T
    v_tile = round16(k_tile + itemsize * kTileK * d);    // (kTileK, dv) T
    total = v_tile + itemsize * kTileK * dv_;
  }
};

template <typename T, int P>
__global__ void __launch_bounds__(kThreads) flash_bwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const uint8_t* __restrict__ key_valid, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
    int sq, int sk, int num_heads, int d, int dvw, float scale, uint32_t seed,
    uint32_t drop_threshold, float inv_keep, bool vec_k, bool vec_v) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(d, dvw, sizeof(T));
  int* key_state = reinterpret_cast<int*>(smem);  // 1 valid, 0 masked, -1 past Sk
  float* ds_s = reinterpret_cast<float*>(smem + L.ds);
  float* pd_s = reinterpret_cast<float*>(smem + L.pd);
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  float* do_s = reinterpret_cast<float*>(smem + L.dout);
  float* dk_acc = reinterpret_cast<float*>(smem + L.dk);
  float* dv_acc = reinterpret_cast<float*>(smem + L.dv);
  T* k_tile = reinterpret_cast<T*>(smem + L.k_tile);
  T* v_tile = reinterpret_cast<T*>(smem + L.v_tile);

  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int t0 = blockIdx.x * kTileK;
  const int hh = blockIdx.y;
  const int b = blockIdx.z;
  const long hd = (long)num_heads * d;
  const long hdv = (long)num_heads * dvw;
  const uint32_t bh = (uint32_t)(b * num_heads + hh);
  const int keys_left = sk - t0;

  load_tile(k_tile, k + ((long)b * sk + t0) * hd + hh * d, keys_left, d, hd, vec_k);
  load_tile(v_tile, v + ((long)b * sk + t0) * hdv + hh * dvw, keys_left, dvw, hdv, vec_v);
  if (threadIdx.x < kTileK) {
    const int key = t0 + threadIdx.x;
    key_state[threadIdx.x] =
        key >= sk ? -1 : (key_valid == nullptr ? 1 : (key_valid[(long)b * sk + key] != 0));
  }
  for (int i = threadIdx.x; i < kTileK * d; i += blockDim.x) dk_acc[i] = 0.f;
  for (int i = threadIdx.x; i < kTileK * dvw; i += blockDim.x) dv_acc[i] = 0.f;
  __syncthreads();
  const int state = key_state[lane];

  for (int r0 = 0; r0 < sq; r0 += kRows) {
    // ---- phase A: one query row per warp
    const int row = r0 + warp;
    float ds_scaled = 0.f, pd = 0.f;
    if (row < sq) {
      float qreg[P], doreg[P];
      const long qoff = ((long)b * sq + row) * hd + hh * d;
      const long ooff = ((long)b * sq + row) * hdv + hh * dvw;
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int e = lane + kWarp * i;
        qreg[i] = e < d ? to_f32(q[qoff + e]) : 0.f;
        doreg[i] = e < dvw ? to_f32(dout[ooff + e]) : 0.f;
        if (e < d) q_s[warp * d + e] = qreg[i];
        if (e < dvw) do_s[warp * dvw + e] = doreg[i];
      }
      const float dot = tile_dots<T, P>(qreg, k_tile, d, lane);
      const float dp = tile_dots<T, P>(doreg, v_tile, dvw, lane);
      const long stat = ((long)b * num_heads + hh) * sq + row;
      if (state >= 0) {
        const float s = state == 0 ? kMaskedLogit : dot * scale;
        // a fully masked row's lse (-1e9 + log Sk) rounds to -1e9 in float32:
        // its probabilities are the uniform 1/Sk the forward used
        const float lse_i = lse[stat];
        const float p = lse_i < kFullyMaskedLse ? 1.f / (float)sk : expf(s - lse_i);
        float dpk = dp;
        pd = p;
        if (drop_threshold != 0u) {
          const bool keep =
              philox::bits(seed, bh, (uint32_t)row, (uint32_t)(t0 + lane)) >= drop_threshold;
          pd = keep ? p * inv_keep : 0.f;
          dpk = keep ? dp * inv_keep : 0.f;
        }
        if (state == 1) ds_scaled = p * (dpk - delta[stat]) * scale;
      }
      // dQ_i += sum_j ds_ij k_j, this lane's slice of the row
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int e = lane + kWarp * i;
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < kTileK; ++j) {
          const float dsj = __shfl_sync(kFull, ds_scaled, j);
          if (e < d) acc = fmaf(dsj, to_f32(k_tile[j * d + e]), acc);
        }
        if (e < d && acc != 0.f) atomicAdd(dq + qoff + e, acc);
      }
    } else {
      for (int e = lane; e < d; e += kWarp) q_s[warp * d + e] = 0.f;
      for (int e = lane; e < dvw; e += kWarp) do_s[warp * dvw + e] = 0.f;
    }
    ds_s[warp * kTileK + lane] = ds_scaled;
    pd_s[warp * kTileK + lane] = pd;
    __syncthreads();

    // ---- phase B: dK / dV of the tile, each element owned by one thread
    for (int idx = threadIdx.x; idx < kTileK * d; idx += blockDim.x) {
      const int j = idx / d, e = idx - j * d;
      float acc = dk_acc[idx];
#pragma unroll
      for (int w = 0; w < kRows; ++w) acc = fmaf(ds_s[w * kTileK + j], q_s[w * d + e], acc);
      dk_acc[idx] = acc;
    }
    for (int idx = threadIdx.x; idx < kTileK * dvw; idx += blockDim.x) {
      const int j = idx / dvw, e = idx - j * dvw;
      float acc = dv_acc[idx];
#pragma unroll
      for (int w = 0; w < kRows; ++w) acc = fmaf(pd_s[w * kTileK + j], do_s[w * dvw + e], acc);
      dv_acc[idx] = acc;
    }
    __syncthreads();
  }

  for (int idx = threadIdx.x; idx < kTileK * d; idx += blockDim.x) {
    const int j = idx / d, e = idx - j * d;
    if (j < keys_left) dk[((long)b * sk + t0 + j) * hd + hh * d + e] = from_f32<T>(dk_acc[idx]);
  }
  for (int idx = threadIdx.x; idx < kTileK * dvw; idx += blockDim.x) {
    const int j = idx / dvw, e = idx - j * dvw;
    if (j < keys_left) dv[((long)b * sk + t0 + j) * hdv + hh * dvw + e] = from_f32<T>(dv_acc[idx]);
  }
}

struct Args {
  const void *q, *k, *v, *key_valid, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  int b, sq, sk, num_heads, d, dv_;
  float scale;
  uint32_t seed, drop_threshold;
  float inv_keep;
  cudaStream_t stream;
};

template <typename T, int P>
int launch(const Args& a) {
  const dim3 grid((a.sk + kTileK - 1) / kTileK, a.num_heads, a.b);
  const size_t smem = Layout(a.d, a.dv_, sizeof(T)).total;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_kernel<T, P><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const uint8_t*>(a.key_valid), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(a.dq), static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.sq, a.sk,
      a.num_heads, a.d, a.dv_, a.scale, a.seed, a.drop_threshold, a.inv_keep,
      aligned16<T>(a.k, a.d, a.num_heads), aligned16<T>(a.v, a.dv_, a.num_heads));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a) {
  const int widest = a.d > a.dv_ ? a.d : a.dv_;
  if (widest <= 32) return launch<T, 1>(a);
  if (widest <= 64) return launch<T, 2>(a);
  if (widest <= 128) return launch<T, 4>(a);
  if (widest <= 256) return launch<T, 8>(a);
  if (widest <= 512) return launch<T, 16>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int odtt_flash_bwd_abi_version() { return 2; }

// Bytes of dynamic shared memory a block of the kernel takes at head widths
// d, dv and an operand itemsize of 4 (float32) or 2 (bfloat16): the Layout
// that ops/cuda/flash_attention.py::fused_backward_smem_bytes mirrors to plan
// the backward.
long long odtt_flash_bwd_smem_bytes(int d, int dv_, int itemsize) {
  return (long long)Layout(d, dv_, (size_t)itemsize).total;
}

// dtype: 0 float32, 1 bfloat16 (q, k, v, dout, dk, dv). key_valid: (B, Sk)
// bytes or null. lse, delta: (B, h, Sq) float32. dq: (B, Sq, h*d) float32,
// zeroed by the caller. drop_threshold / inv_keep / seed as in the forward.
// Returns cudaGetLastError() after the launch (0 on success).
int odtt_flash_attention_bwd(const void* q, const void* k, const void* v,
                             const void* key_valid, const void* dout, const void* lse,
                             const void* delta, void* dq, void* dk, void* dv, int dtype,
                             int b, int sq, int sk, int num_heads, int d, int dv_,
                             float scale, unsigned int seed, unsigned int drop_threshold,
                             float inv_keep, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || num_heads <= 0 || d <= 0 || dv_ <= 0)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, key_valid, dout, lse, delta, dq, dk, dv, b, sq, sk, num_heads, d,
               dv_, scale, seed, drop_threshold, inv_keep, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch<float>(a);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
