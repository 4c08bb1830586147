// Masked multi-head flash-attention forward with attention-probability
// dropout, for Hopper (sm_90a), on operands given by their (batch, head, row)
// element strides. CUDA C++ with a plain C interface, loaded with ctypes by
// object_detection_destr_tpu_torch/ops/cuda/flash_attention.py.
//
// Replaces the TPU kernels
//   object_detection_destr_tpu/ops/pallas/flash_attention.py::_fwd_kernel_packed
//   (l.592, launched by _fwd_impl_packed l.750, public entry
//   flash_attention_packed l.1174), launched with head-packed strides, and
//   ::_fwd_kernel (l.151, launched by _fwd_impl l.250, public entries
//   flash_attention l.307 and flash_attention_trainable l.531), launched with
//   head-major strides.
// It computes the same function, not the same blocks:
//   q (B, Sq, h*d) or (B, h, Sq, d), k and v alike with Sk rows (widths d and
//   dv), key_valid (B, Sk) or none, out laid out as q with width dv
//   p_ij = softmax_j(s_ij),  s_ij = scale * <q_i, k_j> (valid key) or -1e9 (masked)
//   out[b, hh, i] = sum_j keep_ij / (1 - rate) * p_ij * v[b, hh, j]
//   lse[b, hh, i] = logsumexp_j(s_ij)          (float32, (B, h, Sq), of the undropped p)
// keep_ij comes from philox.cuh as a function of (seed, b*h + hh, i, j) only,
// so the backward kernels regenerate it and both layouts of one logical
// input draw the same mask; rate 0 keeps everything. Keys past
// Sk (the ragged end of the last tile) are left out entirely, so a fully
// masked row averages over the Sk real keys only. Logits, the online max and
// sum and the accumulator are float32 for both float32 and bfloat16 inputs.
//
// What bounds it on this card: at the path's shapes (Sq, Sk of a few
// hundred, d 32..1024) a launch does 0.1-6 GFLOP on 1-30 MB of operands, so
// the time is occupancy and the latency of the per-key arithmetic on the
// float32 CUDA cores, not bytes. What the design does about that, simply:
//   * grid (ceil(Sq / rows), h, B) with one warp per query row, so even the
//     single-head cross-attention (Sq = 600) spreads over the SMs; blocks
//     take 4 warps instead of 8 when the grid would not cover the card twice;
//   * each lane keeps its d/32 slice of the query row and its dv/32 slice of
//     the output accumulator in registers (lanes stride d and dv);
//   * K/V tiles of 32 keys are staged once per block in dynamic shared
//     memory and read by all of the block's rows; the cross-attention tile
//     (d 512, dv 256, float32) is 96 KB, that of a hidden-512 model (d 1024,
//     dv 512) 192 KB, past the 48 KB default, so the launcher raises the
//     block's dynamic shared-memory limit;
//   * the 32 dot products of a tile are finished by one reduce-scatter
//     (flash_common.cuh) that leaves key j's score on lane j, so the tile's
//     max, exponentials, sum and dropout draw are one value a lane.
// wgmma, TMA and a pipelined K/V ring are later work.

#include <math.h>

#include "flash_common.cuh"
#include "philox.cuh"

namespace {

using namespace flash;

// P = slots a lane holds of a d- or dv-wide row: ceil(max(d, dv) / 32)
// rounded up to a power of two, so the loops below unroll into registers.
template <typename T, int P>
__global__ void __launch_bounds__(256) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const uint8_t* __restrict__ key_valid, T* __restrict__ out,
    float* __restrict__ lse, Strides sq_, Strides sk_, Strides sv_, Strides so_,
    int sq, int sk, int num_heads, int d, int dv, float scale, uint32_t seed,
    uint32_t drop_threshold, float inv_keep, bool vec_k, bool vec_v) {
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
  const uint32_t bh = (uint32_t)(b * num_heads + hh);
  const long qoff = sq_.off(b, hh, active ? row : 0);

  float qreg[P];
  float acc[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int e = lane + kWarp * i;
    qreg[i] = (active && e < d) ? to_f32(q[qoff + e]) : 0.f;
    acc[i] = 0.f;
  }
  float m_run = -INFINITY;  // running max of the row's logits
  float l_run = 0.f;        // running sum of exp(logit - m_run), undropped

  for (int t0 = 0; t0 < sk; t0 += kTileK) {
    __syncthreads();  // the previous tile is no longer read
    const int rows_left = sk - t0;
    load_tile(k_tile, k + sk_.off(b, hh, t0), rows_left, d, (long)sk_.s, vec_k);
    load_tile(v_tile, v + sv_.off(b, hh, t0), rows_left, dv, (long)sv_.s, vec_v);
    if (threadIdx.x < kTileK) {
      const int key = t0 + threadIdx.x;
      key_state[threadIdx.x] =
          key >= sk ? -1 : (key_valid == nullptr ? 1 : (key_valid[(long)b * sk + key] != 0));
    }
    __syncthreads();
    if (!active) continue;

    const float dot = tile_dots<T, P>(qreg, k_tile, d, lane);
    const int state = key_state[lane];
    const float s = state < 0 ? -INFINITY : (state == 0 ? kMaskedLogit : dot * scale);

    // online softmax: the tile's first key is real, so m_new is finite
    const float m_new = fmaxf(m_run, warp_max(s));
    const float p = expf(s - m_new);
    const float alpha = expf(m_run - m_new);
    l_run = l_run * alpha + warp_sum(p);
    m_run = m_new;
    float p_acc = p;
    if (drop_threshold != 0u) {
      const bool keep = philox::bits(seed, bh, (uint32_t)row, (uint32_t)(t0 + lane)) >= drop_threshold;
      p_acc = keep ? p * inv_keep : 0.f;
    }
#pragma unroll
    for (int i = 0; i < P; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < kTileK; ++j) {
      const float pj = __shfl_sync(kFull, p_acc, j);
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int e = lane + kWarp * i;
        if (e < dv) acc[i] = fmaf(pj, to_f32(v_tile[j * dv + e]), acc[i]);
      }
    }
  }

  if (!active) return;
  const float inv_l = 1.f / l_run;
  const long ooff = so_.off(b, hh, row);
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int e = lane + kWarp * i;
    if (e < dv) out[ooff + e] = from_f32<T>(acc[i] * inv_l);
  }
  if (lane == 0) lse[((long)b * num_heads + hh) * sq + row] = m_run + logf(l_run);
}

struct Args {
  const void *q, *k, *v, *key_valid;
  void *out, *lse;
  Strides sq_, sk_, sv_, so_;  // q, k, v, out
  int b, sq, sk, num_heads, d, dv;
  float scale;
  uint32_t seed, drop_threshold;
  float inv_keep;
  cudaStream_t stream;
};

template <typename T, int P>
int launch(const Args& a) {
  const int rows = ((a.sq + 7) / 8) * a.num_heads * a.b >= 2 * 132 ? 8 : 4;
  const dim3 grid((a.sq + rows - 1) / rows, a.num_heads, a.b);
  const size_t smem = kHeaderBytes + (size_t)kTileK * (a.d + a.dv) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_kernel<T, P><<<grid, rows * kWarp, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const uint8_t*>(a.key_valid), static_cast<T*>(a.out),
      static_cast<float*>(a.lse), a.sq_, a.sk_, a.sv_, a.so_, a.sq, a.sk, a.num_heads, a.d,
      a.dv, a.scale, a.seed, a.drop_threshold, a.inv_keep, aligned16_strided<T>(a.k, a.d, a.sk_),
      aligned16_strided<T>(a.v, a.dv, a.sv_));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a) {
  const int widest = a.d > a.dv ? a.d : a.dv;
  if (widest <= 32) return launch<T, 1>(a);
  if (widest <= 64) return launch<T, 2>(a);
  if (widest <= 128) return launch<T, 4>(a);
  if (widest <= 256) return launch<T, 8>(a);
  if (widest <= 512) return launch<T, 16>(a);
  if (widest <= 1024) return launch<T, 32>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int odtt_flash_fwd_abi_version() { return 3; }

// dtype: 0 float32, 1 bfloat16. key_valid: (B, Sk) bytes or null.
// strides: 12 element strides, (batch, head, row) of q, k, v and out, in
// that order (the feature stride is 1). lse: (B, h, Sq) float32, contiguous.
// drop_threshold 0 disables dropout; otherwise keep iff the element's Philox
// bits >= drop_threshold and scale kept probabilities by inv_keep.
// Returns cudaGetLastError() after the launch (0 on success).
int odtt_flash_attention_fwd(const void* q, const void* k, const void* v,
                             const void* key_valid, void* out, void* lse,
                             const long long* strides, int dtype, int b, int sq, int sk,
                             int num_heads, int d, int dv, float scale, unsigned int seed,
                             unsigned int drop_threshold, float inv_keep, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || num_heads <= 0 || d <= 0 || dv <= 0 || strides == nullptr)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, key_valid, out, lse,
               Strides{strides[0], strides[1], strides[2]}, Strides{strides[3], strides[4], strides[5]},
               Strides{strides[6], strides[7], strides[8]}, Strides{strides[9], strides[10], strides[11]},
               b, sq, sk, num_heads, d, dv, scale, seed, drop_threshold, inv_keep,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch<float>(a);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
