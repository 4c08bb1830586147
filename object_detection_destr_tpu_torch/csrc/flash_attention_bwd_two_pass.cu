// The two-pass flash-attention backward, for Hopper (sm_90a): one kernel
// for dQ and one for dK / dV, with the forward's attention-probability
// dropout regenerated in each. CUDA C++ with a plain C interface, loaded with
// ctypes by object_detection_destr_tpu_torch/ops/cuda/flash_attention.py.
//
// Replaces the TPU kernels
//   object_detection_destr_tpu/ops/pallas/flash_attention.py::_dq_kernel_packed
//   (l.778, pallas_call l.1124) and ::_dkv_kernel_packed (l.826, pallas_call
//   l.1152), which _bwd_impl_packed (l.1015) takes when the fused backward
//   does not fit (l.1037-1041), and, launched with head-major (B, h, S, d)
//   strides, ::_dq_kernel (l.344, pallas_call l.478) and ::_dkv_kernel
//   (l.385, pallas_call l.501), the backward of flash_attention_trainable
//   (_bwd_impl l.438, always two-pass).
// The function is that of flash_attention_bwd.cu (kernel #2), split in two:
//   p_ij  = exp(s_ij - lse_i)   (1/Sk where lse_i < -5e8: a fully masked row)
//   dp_ij = keep_ij / (1 - rate) * <dO_i, v_j>
//   ds_ij = p_ij * (dp_ij - delta_i)   (0 at masked keys)
//   dQ_i  = scale * sum_j ds_ij k_j                        (dq kernel)
//   dK_j  = scale * sum_i ds_ij q_i;  dV_j = sum_i keep_ij / (1 - rate) p_ij dO_i
//                                                          (dkv kernel)
// delta_i = <dO_i, O_i> comes from the wrapper, as _delta_packed (l.973)
// computes it outside the Pallas kernels (the unpacked Pallas kernels
// recompute it per tile; the value is the same).
//
// Why two passes on this card: #2 keeps a 32-key tile's float32 dK / dV
// accumulators in shared memory beside its K / V tile. At the cross-attention
// of a hidden-512 model (one head, d 1024, dv 512) that is about 346 KB in
// bfloat16, past the 227 KB a block can have. Here no accumulator lives in
// shared memory:
//   dq kernel: grid (ceil(Sq / rows), h, B), one warp per query row. The
//     row's q, dO and its dQ accumulator sit in registers (each lane holds
//     its d/32 and dv/32 slices); 32-key K / V tiles are staged in shared
//     memory (float32 at d 1024, dv 512: 192 KB) and read by the block's
//     rows. dQ is written once, in the query dtype: no atomics.
//   dkv kernel: grid (ceil(Sk / 8), h, B), one warp per key. The key's k, v
//     and its dK / dV accumulators sit in registers; 32-row tiles of q, dO,
//     lse and delta are staged in shared memory and read by the block's keys.
// Both kernels take each operand's (batch, head, row) element strides, so
// the packed (B, S, h*d) and the unpacked (B, h, S, d) layouts launch the
// same code. The 32 dot products of a tile are finished by one reduce-scatter
// (flash_common.cuh), so each lane owns one key (dq) or one query row (dkv).
// What bounds them on this card: the float32 CUDA-core arithmetic (s and dp
// are recomputed in both passes), not bytes; tensor cores are later work.

#include <math.h>

#include "flash_common.cuh"
#include "philox.cuh"

namespace {

using namespace flash;

constexpr int kWarps = 8;  // rows (dq) or keys (dkv) of a block
constexpr float kFullyMaskedLse = -5e8f;  // below any row with a valid key

struct Params {
  const void *q, *k, *v, *dout;
  const uint8_t* key_valid;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  Strides sq_, sk_, sv_, so_;  // q / dq, k / dk, v / dv, dout
  int b, sq, sk, num_heads, d, dv_;
  float scale;
  uint32_t seed, drop_threshold;
  float inv_keep;
  bool vec_a, vec_b;  // 16-byte tile loads of the two staged operands
};

// p and the scaled ds of one (query row, key) pair; `state` 1 valid key,
// 0 masked key. Returns ds * scale; writes the dropped probability to pd.
__device__ __forceinline__ float pair_grad(const Params& a, int state, float dot, float dp,
                                           float lse_i, float delta_i, uint32_t bh, int row,
                                           int key, float& pd) {
  const float s = state == 0 ? kMaskedLogit : dot * a.scale;
  // a fully masked row's lse (-1e9 + log Sk) rounds to -1e9 in float32: its
  // probabilities are the uniform 1/Sk the forward used
  const float p = lse_i < kFullyMaskedLse ? 1.f / (float)a.sk : expf(s - lse_i);
  float dpk = dp;
  pd = p;
  if (a.drop_threshold != 0u) {
    const bool keep = philox::bits(a.seed, bh, (uint32_t)row, (uint32_t)key) >= a.drop_threshold;
    pd = keep ? p * a.inv_keep : 0.f;
    dpk = keep ? dp * a.inv_keep : 0.f;
  }
  return state == 1 ? p * (dpk - delta_i) * a.scale : 0.f;
}

template <typename T, int P>
__global__ void __launch_bounds__(kWarps * kWarp) flash_dq_kernel(Params a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* key_state = reinterpret_cast<int*>(smem);  // 1 valid, 0 masked, -1 past Sk
  T* k_tile = reinterpret_cast<T*>(smem + kHeaderBytes);  // (kTileK, d)
  T* v_tile = k_tile + kTileK * a.d;                      // (kTileK, dv)
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);

  const int lane = threadIdx.x % kWarp;
  const int rows = blockDim.x / kWarp;
  const int row = blockIdx.x * rows + threadIdx.x / kWarp;
  const int hh = blockIdx.y;
  const int bi = blockIdx.z;
  const bool active = row < a.sq;
  const uint32_t bh = (uint32_t)(bi * a.num_heads + hh);

  float qreg[P], doreg[P], acc[P];
  const long qoff = a.sq_.off(bi, hh, active ? row : 0);
  const long ooff = a.so_.off(bi, hh, active ? row : 0);
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int e = lane + kWarp * i;
    qreg[i] = (active && e < a.d) ? to_f32(q[qoff + e]) : 0.f;
    doreg[i] = (active && e < a.dv_) ? to_f32(dout[ooff + e]) : 0.f;
    acc[i] = 0.f;
  }
  const long stat = ((long)bi * a.num_heads + hh) * a.sq + (active ? row : 0);
  const float lse_i = active ? a.lse[stat] : 0.f;
  const float delta_i = active ? a.delta[stat] : 0.f;

  for (int t0 = 0; t0 < a.sk; t0 += kTileK) {
    __syncthreads();  // the previous tile is no longer read
    const int keys_left = a.sk - t0;
    load_tile(k_tile, k + a.sk_.off(bi, hh, t0), keys_left, a.d, (long)a.sk_.s, a.vec_a);
    load_tile(v_tile, v + a.sv_.off(bi, hh, t0), keys_left, a.dv_, (long)a.sv_.s, a.vec_b);
    if (threadIdx.x < kTileK) {
      const int key = t0 + threadIdx.x;
      key_state[threadIdx.x] = key >= a.sk ? -1
          : (a.key_valid == nullptr ? 1 : (a.key_valid[(long)bi * a.sk + key] != 0));
    }
    __syncthreads();
    if (!active) continue;

    const float dot = tile_dots<T, P>(qreg, k_tile, a.d, lane);
    const float dp = tile_dots<T, P>(doreg, v_tile, a.dv_, lane);
    const int state = key_state[lane];
    float pd, ds = 0.f;
    if (state >= 0) ds = pair_grad(a, state, dot, dp, lse_i, delta_i, bh, row, t0 + lane, pd);
    // dQ_i += sum_j ds_ij k_j, this lane's slice of the row
#pragma unroll
    for (int j = 0; j < kTileK; ++j) {
      const float dsj = __shfl_sync(kFull, ds, j);
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int e = lane + kWarp * i;
        if (e < a.d) acc[i] = fmaf(dsj, to_f32(k_tile[j * a.d + e]), acc[i]);
      }
    }
  }

  if (!active) return;
  T* dq = static_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int e = lane + kWarp * i;
    if (e < a.d) dq[qoff + e] = from_f32<T>(acc[i]);
  }
}

template <typename T, int P>
__global__ void __launch_bounds__(kWarps * kWarp) flash_dkv_kernel(Params a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* lse_s = reinterpret_cast<float*>(smem);            // (kTileK)
  float* delta_s = lse_s + kTileK;                          // (kTileK)
  T* q_tile = reinterpret_cast<T*>(smem + 2 * kHeaderBytes);  // (kTileK, d)
  T* do_tile = q_tile + kTileK * a.d;                          // (kTileK, dv)
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);

  const int lane = threadIdx.x % kWarp;
  const int keys = blockDim.x / kWarp;
  const int key = blockIdx.x * keys + threadIdx.x / kWarp;
  const int hh = blockIdx.y;
  const int bi = blockIdx.z;
  const bool active = key < a.sk;
  const uint32_t bh = (uint32_t)(bi * a.num_heads + hh);
  const int state = !active ? -1
      : (a.key_valid == nullptr ? 1 : (a.key_valid[(long)bi * a.sk + key] != 0));

  float kreg[P], vreg[P], dk_acc[P], dv_acc[P];
  const long koff = a.sk_.off(bi, hh, active ? key : 0);
  const long voff = a.sv_.off(bi, hh, active ? key : 0);
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int e = lane + kWarp * i;
    kreg[i] = (active && e < a.d) ? to_f32(k[koff + e]) : 0.f;
    vreg[i] = (active && e < a.dv_) ? to_f32(v[voff + e]) : 0.f;
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }
  const long stat0 = ((long)bi * a.num_heads + hh) * a.sq;

  for (int r0 = 0; r0 < a.sq; r0 += kTileK) {
    __syncthreads();  // the previous tile is no longer read
    const int rows_left = a.sq - r0;
    load_tile(q_tile, q + a.sq_.off(bi, hh, r0), rows_left, a.d, (long)a.sq_.s, a.vec_a);
    load_tile(do_tile, dout + a.so_.off(bi, hh, r0), rows_left, a.dv_, (long)a.so_.s, a.vec_b);
    if (threadIdx.x < kTileK) {
      const bool real = (int)threadIdx.x < rows_left;
      lse_s[threadIdx.x] = real ? a.lse[stat0 + r0 + threadIdx.x] : 0.f;
      delta_s[threadIdx.x] = real ? a.delta[stat0 + r0 + threadIdx.x] : 0.f;
    }
    __syncthreads();
    if (!active) continue;

    // lane i: query row r0 + i against this warp's key
    const float dot = tile_dots<T, P>(kreg, q_tile, a.d, lane);
    const float dp = tile_dots<T, P>(vreg, do_tile, a.dv_, lane);
    const int row = r0 + lane;
    float pd = 0.f, ds = 0.f;
    if (row < a.sq) ds = pair_grad(a, state, dot, dp, lse_s[lane], delta_s[lane], bh, row, key, pd);
    // dK_j += sum_i ds_ij q_i and dV_j += sum_i pd_ij dO_i, this lane's slices
#pragma unroll
    for (int r = 0; r < kTileK; ++r) {
      const float dsr = __shfl_sync(kFull, ds, r);
      const float pdr = __shfl_sync(kFull, pd, r);
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int e = lane + kWarp * i;
        if (e < a.d) dk_acc[i] = fmaf(dsr, to_f32(q_tile[r * a.d + e]), dk_acc[i]);
        if (e < a.dv_) dv_acc[i] = fmaf(pdr, to_f32(do_tile[r * a.dv_ + e]), dv_acc[i]);
      }
    }
  }

  if (!active) return;
  T* dk = static_cast<T*>(a.dk);
  T* dv = static_cast<T*>(a.dv);
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int e = lane + kWarp * i;
    if (e < a.d) dk[koff + e] = from_f32<T>(dk_acc[i]);
    if (e < a.dv_) dv[voff + e] = from_f32<T>(dv_acc[i]);
  }
}

template <typename T, int P>
int launch(Params a, bool dq, cudaStream_t stream) {
  const dim3 threads(kWarps * kWarp);
  if (dq) {
    a.vec_a = aligned16_strided<T>(a.k, a.d, a.sk_);
    a.vec_b = aligned16_strided<T>(a.v, a.dv_, a.sv_);
    const dim3 grid((a.sq + kWarps - 1) / kWarps, a.num_heads, a.b);
    const size_t smem = kHeaderBytes + (size_t)kTileK * (a.d + a.dv_) * sizeof(T);
    cudaError_t err = cudaFuncSetAttribute(
        flash_dq_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_dq_kernel<T, P><<<grid, threads, smem, stream>>>(a);
  } else {
    a.vec_a = aligned16_strided<T>(a.q, a.d, a.sq_);
    a.vec_b = aligned16_strided<T>(a.dout, a.dv_, a.so_);
    const dim3 grid((a.sk + kWarps - 1) / kWarps, a.num_heads, a.b);
    const size_t smem = 2 * kHeaderBytes + (size_t)kTileK * (a.d + a.dv_) * sizeof(T);
    cudaError_t err = cudaFuncSetAttribute(
        flash_dkv_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_dkv_kernel<T, P><<<grid, threads, smem, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Params& a, bool dq, cudaStream_t stream) {
  const int widest = a.d > a.dv_ ? a.d : a.dv_;
  if (widest <= 32) return launch<T, 1>(a, dq, stream);
  if (widest <= 64) return launch<T, 2>(a, dq, stream);
  if (widest <= 128) return launch<T, 4>(a, dq, stream);
  if (widest <= 256) return launch<T, 8>(a, dq, stream);
  if (widest <= 512) return launch<T, 16>(a, dq, stream);
  if (widest <= 1024) return launch<T, 32>(a, dq, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int odtt_flash_bwd_two_pass_abi_version() { return 1; }

// dtype: 0 float32, 1 bfloat16 (q, k, v, dout and the gradients).
// strides: 12 element strides, (batch, head, row) of q (and dq), k (and dk),
// v (and dv), dout, in that order. key_valid: (B, Sk) bytes or null. lse,
// delta: (B, h, Sq) float32, contiguous. dq (dq pass) or dk, dv (dkv pass)
// are written in the input dtype, nothing else. drop_threshold / inv_keep /
// seed as in the forward. Returns cudaGetLastError() after the launch.
int odtt_flash_attention_two_pass(int pass_dq, const void* q, const void* k, const void* v,
                                  const void* key_valid, const void* dout, const void* lse,
                                  const void* delta, void* dq, void* dk, void* dv,
                                  const long long* strides, int dtype, int b, int sq, int sk,
                                  int num_heads, int d, int dv_, float scale, unsigned int seed,
                                  unsigned int drop_threshold, float inv_keep, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || num_heads <= 0 || d <= 0 || dv_ <= 0 || strides == nullptr)
    return (int)cudaErrorInvalidValue;
  Params a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.key_valid = static_cast<const uint8_t*>(key_valid);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.sq_ = Strides{strides[0], strides[1], strides[2]};
  a.sk_ = Strides{strides[3], strides[4], strides[5]};
  a.sv_ = Strides{strides[6], strides[7], strides[8]};
  a.so_ = Strides{strides[9], strides[10], strides[11]};
  a.b = b;
  a.sq = sq;
  a.sk = sk;
  a.num_heads = num_heads;
  a.d = d;
  a.dv_ = dv_;
  a.scale = scale;
  a.seed = seed;
  a.drop_threshold = drop_threshold;
  a.inv_keep = inv_keep;
  const bool is_dq = pass_dq != 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, is_dq, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, is_dq, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
