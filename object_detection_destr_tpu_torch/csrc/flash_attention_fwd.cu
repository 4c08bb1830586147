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
// Two kernels compute it, chosen by the operand dtype (no fallback between
// them: a bfloat16 call always runs the tensor-core kernel):
//
// bfloat16, flash_fwd_tc_kernel (FlashAttention-2's forward on Hopper's
// tensor cores). What bounds it on this card: a launch at the path's shapes
// (Sq, Sk 300-600, d 32..1024) needs 0.1-6 GFLOP, a few microseconds of
// bf16 tensor-core work, on 1-30 MB of operands, so bytes bound it; the
// CUDA-core kernel below spent 90-180x that bound on float32 FMAs and warp
// shuffles. The design:
//   * a block is 64 query rows of one (batch, head) and one chunk of up to
//     128 output columns; 4 warps of 16 rows. dv 256 and 512 (the cross-
//     attentions) are split across grid.y: each chunk recomputes S, so m, l
//     and lse are bit-identical in every chunk and chunk 0 writes lse. Split
//     rather than more warps a block: O stays 64 f32 registers a thread, and
//     the one-head cross-attention gets 2-4x the blocks to fill 132 SMs;
//   * S = Q K^T by mma.sync m16n8k16 (bf16 products are exact, f32 sums)
//     over d in chunks of 64 columns; K chunks (and Q chunks where d > 128)
//     stream through a 2-stage cp.async ring in dynamic shared memory, rows
//     padded by 16 bytes against bank conflicts, so the next stage's load
//     overlaps this one's math; for d <= 128, Q is read once into registers;
//   * scale, the -1e9 mask and keys past Sk (-inf) on the S fragments; the
//     online softmax on the fragments, each row reduced across its quad in
//     2 shuffles; the keep bit drawn per fragment element from (row, key);
//   * P keep / (1 - rate) rounded to bf16 where _fwd_kernel_packed rounds it
//     (l.639), fed straight from the S accumulators as the A operand of
//     P V, V read by ldmatrix.trans; O accumulates in f32 registers;
//   * a width that is not a multiple of 16 is zero-padded in shared memory
//     to the next 16 columns; 16-byte cp.async where every row is 16-byte
//     aligned, element copies otherwise.
//
// float32, flash_fwd_kernel (the serving path, TF32 off; the tensor-core
// path for float32 is later work). What bounds it on this card: at the
// path's shapes (Sq, Sk of a few hundred, d 32..1024) a launch does 0.1-6
// GFLOP on 1-30 MB of operands, so the time is occupancy and the latency of
// the per-key arithmetic on the float32 CUDA cores, not bytes. What the
// design does about that, simply:
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

#include <math.h>

#include "flash_common.cuh"
#include "philox.cuh"
#include "tensor_core.cuh"

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

// ---- bfloat16 on the tensor cores
using bf16 = __nv_bfloat16;
constexpr int kTcRows = 64;     // query rows a block: 4 warps of 16
constexpr int kTcThreads = 128;
constexpr int kTcKeys = 64;     // keys a tile
constexpr int kTcChunk = 64;    // columns of q and k a stage
constexpr int kQKStride = kTcChunk + tc::kPad;
constexpr int kQKSlot = kTcRows * kQKStride;  // elements of one q or k stage (kTcRows == kTcKeys)

// Shared memory of the kernel, in bytes: the key states of two tiles, NQ
// resident q chunks (or a 2-slot q ring where NQ == 0), a 2-slot k ring and
// a 2-slot v ring of DVC columns.
__host__ __device__ constexpr int tc_fwd_smem(int nq, int dvc) {
  return 2 * kTcKeys * 4 + ((nq == 0 ? 2 : nq) + 2) * kQKSlot * 2 + 2 * kTcKeys * (dvc + tc::kPad) * 2;
}

// NQ: q chunks of 64 columns held for the whole launch (1 for d <= 64, 2
// for d <= 128), or 0 to stream them beside k. DVC: output columns a block.
template <int NQ, int DVC>
__global__ void __launch_bounds__(kTcThreads) flash_fwd_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const uint8_t* __restrict__ key_valid, bf16* __restrict__ out, float* __restrict__ lse,
    Strides sq_, Strides sk_, Strides sv_, Strides so_, int sq, int sk, int num_heads, int d, int dv,
    float scale, uint32_t seed, uint32_t drop_threshold, float inv_keep, int dv_chunks, bool vec) {
  constexpr int kVStride = DVC + tc::kPad;
  constexpr int kQSlots = NQ == 0 ? 2 : NQ;
  constexpr int kNt = DVC / 8;  // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem[];
  int* key_state = reinterpret_cast<int*>(smem);  // [2][kTcKeys]: 1 valid, 0 masked, -1 past Sk
  bf16* q_s = reinterpret_cast<bf16*>(smem + 2 * kTcKeys * 4);
  bf16* k_s = q_s + kQSlots * kQKSlot;
  bf16* v_s = k_s + 2 * kQKSlot;

  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int g = lane / 4, t = lane % 4;
  const int r0 = blockIdx.x * kTcRows;
  const int hh = blockIdx.y / dv_chunks, chunk = blockIdx.y - hh * dv_chunks;
  const int b = blockIdx.z;
  const int c0 = chunk * DVC;  // first output column of the block
  const int dvw = min(DVC, dv - c0);
  const uint32_t bh = (uint32_t)(b * num_heads + hh);
  const int nq = (d + kTcChunk - 1) / kTcChunk;
  const int steps = (sk + kTcKeys - 1) / kTcKeys * nq;

  const bf16* q_blk = q + sq_.off(b, hh, r0);
  auto load = [&](int s) {
    const int kt = s / nq, c = s - kt * nq, key0 = kt * kTcKeys;
    const int cw = min(kTcChunk, d - c * kTcChunk);
    if (NQ == 0)
      tc::load_rows<kTcThreads>(q_s + (s & 1) * kQKSlot, kQKStride, q_blk + c * kTcChunk, sq_.s, kTcRows,
                                sq - r0, cw, vec);
    tc::load_rows<kTcThreads>(k_s + (s & 1) * kQKSlot, kQKStride, k + sk_.off(b, hh, key0) + c * kTcChunk,
                              sk_.s, kTcKeys, sk - key0, cw, vec);
    if (c == 0) {
      tc::load_rows<kTcThreads>(v_s + (kt & 1) * kTcKeys * kVStride, kVStride, v + sv_.off(b, hh, key0) + c0,
                                sv_.s, kTcKeys, sk - key0, dvw, vec);
      if (threadIdx.x < kTcKeys) {
        const int key = key0 + threadIdx.x;
        key_state[(kt & 1) * kTcKeys + threadIdx.x] =
            key >= sk ? -1 : (key_valid == nullptr ? 1 : (key_valid[(long)b * sk + key] != 0));
      }
    }
    tc::cp_async_commit();
  };

  if (NQ > 0)
    for (int c = 0; c < nq; ++c)
      tc::load_rows<kTcThreads>(q_s + c * kQKSlot, kQKStride, q_blk + c * kTcChunk, sq_.s, kTcRows, sq - r0,
                                min(kTcChunk, d - c * kTcChunk), vec);
  load(0);

  uint32_t qf[NQ > 0 ? NQ * 4 : 1][4];  // resident q: A fragments of 16 columns
  float s_acc[kTcKeys / 8][4];
  float o_acc[kNt][4];
#pragma unroll
  for (int n = 0; n < kNt; ++n) o_acc[n][0] = o_acc[n][1] = o_acc[n][2] = o_acc[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8 of the warp
  float l_part[2] = {0.f, 0.f};             // this thread's share of the rows' sums
  const int row_lo = r0 + warp * 16 + g;

  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      load(s + 1);
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const int kt = s / nq, c = s - kt * nq, key0 = kt * kTcKeys;
    const int ksteps = (min(kTcChunk, d - c * kTcChunk) + 15) / 16;
    if (NQ > 0 && s == 0) {
#pragma unroll
      for (int i = 0; i < (NQ > 0 ? NQ * 4 : 0); ++i)
        if ((i & 3) < ((min(kTcChunk, d - (i / 4) * kTcChunk) + 15) / 16))
          tc::load_a(qf[i], q_s + (i / 4) * kQKSlot, kQKStride, warp * 16, (i & 3) * 16, lane);
    }
    if (c == 0) {
#pragma unroll
      for (int j = 0; j < kTcKeys / 8; ++j) s_acc[j][0] = s_acc[j][1] = s_acc[j][2] = s_acc[j][3] = 0.f;
    }
    // S += Q[:, chunk c] K[tile, chunk c]^T
    const bf16* ks = k_s + (s & 1) * kQKSlot;
#pragma unroll
    for (int kk = 0; kk < kTcChunk / 16; ++kk) {
      if (kk >= ksteps) break;
      uint32_t a[4];
      if (NQ > 0) {
#pragma unroll
        for (int cc = 0; cc < (NQ > 0 ? NQ : 1); ++cc)
          if (cc == c) a[0] = qf[cc * 4 + kk][0], a[1] = qf[cc * 4 + kk][1], a[2] = qf[cc * 4 + kk][2],
                       a[3] = qf[cc * 4 + kk][3];
      } else {
        tc::load_a(a, q_s + (s & 1) * kQKSlot, kQKStride, warp * 16, kk * 16, lane);
      }
#pragma unroll
      for (int j = 0; j < kTcKeys / 16; ++j) {
        uint32_t bb[4];
        tc::load_b_rows(bb, ks, kQKStride, j * 16, kk * 16, lane);
        tc::mma(s_acc[2 * j], a, bb[0], bb[1]);
        tc::mma(s_acc[2 * j + 1], a, bb[2], bb[3]);
      }
    }
    if (c != nq - 1) {
      __syncthreads();
      continue;
    }

    // masking and the online softmax on the fragments
    const int* state = key_state + (kt & 1) * kTcKeys;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kTcKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int st = state[8 * j + 2 * t + (e & 1)];
        const float x = st < 0 ? -INFINITY : (st == 0 ? kMaskedLogit : s_acc[j][e] * scale);
        s_acc[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], m_new[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
      m_new[i] = fmaxf(m_run[i], mx[i]);  // the tile's first key is real: finite
      alpha[i] = expf(m_run[i] - m_new[i]);
      m_run[i] = m_new[i];
      l_part[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < kTcKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s_acc[j][e] - m_new[e >> 1]);
        l_part[e >> 1] += p;
        float p_acc = p;
        if (drop_threshold != 0u) {
          const int row = row_lo + (e >> 1) * 8;
          const uint32_t key = (uint32_t)(key0 + 8 * j + 2 * t + (e & 1));
          p_acc = row < sq && philox::bits(seed, bh, (uint32_t)row, key) >= drop_threshold ? p * inv_keep : 0.f;
        }
        s_acc[j][e] = p_acc;
      }
#pragma unroll
    for (int n = 0; n < kNt; ++n) {
      o_acc[n][0] *= alpha[0];
      o_acc[n][1] *= alpha[0];
      o_acc[n][2] *= alpha[1];
      o_acc[n][3] *= alpha[1];
    }
    // O += bf16(P) V: the S accumulators of keys 16 kk.. are the A fragment
    const bf16* vs = v_s + (kt & 1) * kTcKeys * kVStride;
    const int keys_here = sk - key0;
#pragma unroll
    for (int kk = 0; kk < kTcKeys / 16; ++kk) {
      if (kk * 16 >= keys_here) break;
      const uint32_t a[4] = {tc::pack_bf16(s_acc[2 * kk][0], s_acc[2 * kk][1]),
                             tc::pack_bf16(s_acc[2 * kk][2], s_acc[2 * kk][3]),
                             tc::pack_bf16(s_acc[2 * kk + 1][0], s_acc[2 * kk + 1][1]),
                             tc::pack_bf16(s_acc[2 * kk + 1][2], s_acc[2 * kk + 1][3])};
#pragma unroll
      for (int n2 = 0; n2 < kNt / 2; ++n2) {
        if (n2 * 16 >= dvw) break;
        uint32_t bb[4];
        tc::load_b_cols(bb, vs, kVStride, kk * 16, n2 * 16, lane);
        tc::mma(o_acc[2 * n2], a, bb[0], bb[1]);
        tc::mma(o_acc[2 * n2 + 1], a, bb[2], bb[3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_part[i] += __shfl_xor_sync(kFull, l_part[i], 1);
    l_part[i] += __shfl_xor_sync(kFull, l_part[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_lo + 8 * i;
    if (row >= sq) continue;
    const float inv_l = 1.f / l_part[i];
    bf16* orow = out + so_.off(b, hh, row) + c0;
#pragma unroll
    for (int n = 0; n < kNt; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * n + 2 * t + e;
        if (col < dvw) orow[col] = __float2bfloat16(o_acc[n][2 * i + e] * inv_l);
      }
    if (chunk == 0 && t == 0) lse[((long)b * num_heads + hh) * sq + row] = m_run[i] + logf(l_part[i]);
  }
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

template <int NQ, int DVC>
int launch_tc(const Args& a) {
  const int chunks = (a.dv + DVC - 1) / DVC;
  const dim3 grid((a.sq + kTcRows - 1) / kTcRows, a.num_heads * chunks, a.b);
  constexpr int smem = tc_fwd_smem(NQ, DVC);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_tc_kernel<NQ, DVC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const bool vec = aligned16_strided<bf16>(a.q, a.d, a.sq_) && aligned16_strided<bf16>(a.k, a.d, a.sk_) &&
                   aligned16_strided<bf16>(a.v, a.dv, a.sv_);
  flash_fwd_tc_kernel<NQ, DVC><<<grid, kTcThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const uint8_t*>(a.key_valid), static_cast<bf16*>(a.out), static_cast<float*>(a.lse),
      a.sq_, a.sk_, a.sv_, a.so_, a.sq, a.sk, a.num_heads, a.d, a.dv, a.scale, a.seed, a.drop_threshold,
      a.inv_keep, chunks, vec);
  return (int)cudaGetLastError();
}

template <int NQ>
int dispatch_tc_dv(const Args& a) {
  if (a.dv <= 32) return launch_tc<NQ, 32>(a);
  if (a.dv <= 64) return launch_tc<NQ, 64>(a);
  return launch_tc<NQ, 128>(a);  // dv > 128 in chunks of 128 across grid.y
}

int dispatch_tc(const Args& a) {
  if (a.d > 1024 || a.dv > 1024) return (int)cudaErrorInvalidValue;
  if (a.d <= 64) return dispatch_tc_dv<1>(a);
  if (a.d <= 128) return dispatch_tc_dv<2>(a);
  return dispatch_tc_dv<0>(a);  // q streamed in chunks of 64 columns
}

}  // namespace

extern "C" {

int odtt_flash_fwd_abi_version() { return 4; }

// dtype: 0 float32 (CUDA cores), 1 bfloat16 (tensor cores). key_valid:
// (B, Sk) bytes or null.
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
  if (dtype == 1) return dispatch_tc(a);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
