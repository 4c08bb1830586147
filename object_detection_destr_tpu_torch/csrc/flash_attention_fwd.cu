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
// Two kernels compute it, chosen by the operand dtype, both on Hopper's
// tensor cores (no fallback between them: a call runs its dtype's kernel or
// returns an error).
//
// bfloat16, flash_fwd_tc_kernel (FlashAttention-2's forward). What bounds
// it on this card: a launch at the path's shapes (Sq, Sk 300-600, d
// 32..1024) needs 0.1-6 GFLOP, a few microseconds of bf16 tensor-core work,
// on 1-30 MB of operands, so bytes bound it; a first kernel on the CUDA
// cores spent 90-180x that bound on float32 FMAs and warp shuffles. The
// design:
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
// float32, flash_fwd_f32_kernel (the serving path: float32 with TF32 off,
// so float32's accuracy is kept). The same masking and online softmax on
// the fragments, with every product in 3xTF32 on mma.sync m16n8k8: each
// operand split into tf32 big and small halves, three tf32 products a product
// (relative error about 1e-6 against float32; one tf32 product alone gives
// about 1e-3), in short chains of mma summed in IEEE float32. At the path's
// shapes the tf32 work is microseconds, so what bounds it is latency and
// how many SMs a launch fills: serving's B = 1 launches have 56, 40 and 20
// blocks of 64 rows for 132 SMs, so a block here is 16 rows whose 4 warps
// split the keys and combine at the end. Details at the kernel.

#include <math.h>

#include "flash_common.cuh"
#include "philox.cuh"
#include "tensor_core.cuh"

namespace {

using namespace flash;

// ---- float32 on the tensor cores, in 3xTF32
constexpr int kF32Rows = 16;                   // query rows a block: one m16 tile
constexpr int kF32Warps = 4;                   // warp w owns the key tiles w, w + 4, ...
constexpr int kF32Threads = kF32Warps * kWarp;
constexpr int kF32Keys = 16;                   // keys a tile
constexpr int kF32Chunk = 64;                  // columns of k a step
constexpr int kF32Stages = 3;                  // a warp's ring: k chunks, v tiles and key states
// q and k rows padded to 8 mod 32 words, so the float2 reads (g, 2t..2t+1)
// of a half-warp's 4 rows hit 4 different 8-bank groups; v rows padded by
// 4: rows 2t apart are 8t mod 32 words apart, so the reads (2t (+1), g) of
// a warp hit 32 different banks.
constexpr int kF32KStride = kF32Chunk + 8;
constexpr int kF32KSlot = kF32Keys * kF32KStride;

__host__ __device__ constexpr int f32_q_stride(int d) { return (d + 31) / 32 * 32 + 8; }
// Floats of one warp's ring: kF32Stages k chunks, v tiles of DVC columns
// and key states.
__host__ __device__ constexpr int f32_warp_ring(int dvc) {
  return kF32Stages * (kF32KSlot + kF32Keys * (dvc + 4) + kF32Keys);
}
// Shared memory of the kernel, in bytes: q (16 rows, all of d), then the
// warps' rings, which the warps' partial O, m and l reuse at the end.
__host__ __device__ constexpr int f32_fwd_smem(int d, int dvc) {
  return 4 * (kF32Rows * f32_q_stride(d) +
              (kF32Warps * f32_warp_ring(dvc) > kF32Warps * kF32Rows * (dvc + 6)
                   ? kF32Warps * f32_warp_ring(dvc)
                   : kF32Warps * kF32Rows * (dvc + 6)));
}

// The float32 path (serving's, TF32 off), flash_fwd_f32_kernel: S = Q K^T
// and P V on m16n8k8 in 3xTF32. A block is 16 query rows of one (batch,
// head) and one chunk of up to DVC output columns, and its 4 warps split the
// keys: warp w owns the tiles of 16 keys w, w + 4, ..., runs the online
// softmax over them with its own maximum, and streams them through a ring
// of its own (cp.async, kF32Stages deep, synced by __syncwarp: no block
// barrier in the main loop). At the end the warps' (m, l, O) meet in shared
// memory and are combined in warp order (O = sum_w e^(m_w - M) O_w / sum_w
// e^(m_w - M) l_w). Why: a launch on serving's B = 1 shapes has few rows
// (300-600) and a flash forward is a chain of steps per block; 16-row
// blocks give 200, 152 and 76 blocks at its three sites where 64-row blocks
// give 56, 40 and 20, and splitting the keys over the 4 warps cuts each
// chain to a quarter. K and V are restaged for 16 rows each, from L2.
// Layouts of the m16n8k8 fragments (tensor_core.cuh):
//   * S = Q K^T: k slot t of a k-step holds column 2t of its 8, slot t + 4
//     column 2t + 1, so each thread's A and B values are float2 reads;
//   * P V: slot t of the k-step of keys 8j..8j+7 holds key 8j + 2t and slot
//     t + 4 key 8j + 2t + 1, which makes the S accumulators of n-tile j
//     (c0, c2, c1, c3) the A fragment as they stand (no shuffle, no trip
//     through shared memory); V's B values are (8j + 2t (+1), g).
// Precision: every operand, P too, is split into tf32 big and small halves
// and each product is three tf32 products. The tensor cores' float32
// accumulation is not IEEE round-to-nearest, and its error grows with the
// length of a chain of mma into one accumulator (a first version that
// chained all of a row's products into one went past chip_smoke.py's float32
// tolerance at d 512 and Sk 7056). So S of one 64-column chunk goes into three
// accumulators, one a product kind (8 mma each), P V of one tile into a
// fresh one (6 mma), and these are added in IEEE float32. P is not rounded,
// as _fwd_kernel_packed rounds it only to the operand dtype (l.638-641).
template <int DVC>
__global__ void __launch_bounds__(kF32Threads) flash_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const uint8_t* __restrict__ key_valid, float* __restrict__ out, float* __restrict__ lse,
    Strides sq_, Strides sk_, Strides sv_, Strides so_, int sq, int sk, int num_heads, int d, int dv,
    float scale, const long long* __restrict__ seed_ptr, uint32_t drop_threshold, float inv_keep, int dv_chunks,
    bool vec) {
  const uint32_t seed = philox::load_seed(seed_ptr, drop_threshold);
  constexpr int kVStride = DVC + 4;
  constexpr int kNt = DVC / 8;  // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem[];
  const int q_stride = f32_q_stride(d);
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int g = lane / 4, t = lane % 4;
  float* q_s = reinterpret_cast<float*>(smem);  // (16, q_stride)
  float* rings = q_s + kF32Rows * q_stride;
  float* k_s = rings + warp * f32_warp_ring(DVC);     // [kF32Stages][16][kF32KStride]
  float* v_s = k_s + kF32Stages * kF32KSlot;          // [kF32Stages][16][kVStride]
  int* state_s = reinterpret_cast<int*>(v_s + kF32Stages * kF32Keys * kVStride);  // [kF32Stages][16]

  const int r0 = blockIdx.x * kF32Rows;
  const int hh = blockIdx.y / dv_chunks, chunk = blockIdx.y - hh * dv_chunks;
  const int b = blockIdx.z;
  const int c0 = chunk * DVC;  // first output column of the block
  const int dvw = min(DVC, dv - c0);
  const uint32_t bh = (uint32_t)(b * num_heads + hh);
  const int nq = (d + kF32Chunk - 1) / kF32Chunk;
  const int tiles = (sk + kF32Keys - 1) / kF32Keys;
  const int steps = (tiles > warp ? (tiles - warp + kF32Warps - 1) / kF32Warps : 0) * nq;

  // step s of this warp: chunk c of its tile i (key tile warp + 4 i) into
  // ring slot s % kF32Stages; with c == 0, the tile's v rows and key states
  // into slot i % kF32Stages. One cp.async group a step, empty past the last.
  auto load = [&](int s) {
    if (s < steps) {
      const int i = s / nq, c = s - i * nq, key0 = (warp + kF32Warps * i) * kF32Keys;
      tc::load_rows_f32<kF32Chunk>(k_s + (s % kF32Stages) * kF32KSlot, kF32KStride,
                                   k + sk_.off(b, hh, key0) + c * kF32Chunk, sk_.s, kF32Keys, sk - key0,
                                   min(kF32Chunk, d - c * kF32Chunk), vec, lane, kWarp);
      if (c == 0) {
        const int slot = i % kF32Stages;
        tc::load_rows_f32<DVC>(v_s + slot * kF32Keys * kVStride, kVStride, v + sv_.off(b, hh, key0) + c0, sv_.s,
                               kF32Keys, sk - key0, dvw, vec, lane, kWarp);
        if (lane < kF32Keys) {
          const int key = key0 + lane;
          state_s[slot * kF32Keys + lane] =
              key >= sk ? -1 : (key_valid == nullptr ? 1 : (key_valid[(long)b * sk + key] != 0));
        }
      }
    }
    tc::cp_async_commit();
  };

  // q once for the block (group 0), then each warp's first stages; the
  // barrier after q has landed is the only one before the combine
  tc::load_rows_f32<0>(q_s, q_stride, q + sq_.off(b, hh, r0), sq_.s, kF32Rows, sq - r0, d, vec, threadIdx.x,
                       kF32Threads);
  tc::cp_async_commit();
#pragma unroll
  for (int s = 0; s < kF32Stages - 1; ++s) load(s);
  tc::cp_async_wait<kF32Stages - 1>();
  __syncthreads();

  float s_acc[2][4];
  float o_acc[kNt][4];
#pragma unroll
  for (int n = 0; n < kNt; ++n) o_acc[n][0] = o_acc[n][1] = o_acc[n][2] = o_acc[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, over the warp's keys
  float l_part[2] = {0.f, 0.f};             // this thread's share of the rows' sums
  const float* qs = q_s + g * q_stride + 2 * t;

  for (int s = 0; s < steps; ++s) {
    tc::cp_async_wait<kF32Stages - 2>();  // step s has landed for this lane
    __syncwarp();                          // ... and for the warp; step s - 1's slot is free
    load(s + kF32Stages - 1);
    const int i = s / nq, c = s - i * nq, key0 = (warp + kF32Warps * i) * kF32Keys;
    const int ksteps = (min(kF32Chunk, d - c * kF32Chunk) + 7) / 8;
    // S (+)= Q[:, chunk c] K[tile, chunk c]^T: big x big, big x small and
    // small x big in three accumulators a key n-tile
    float sp[2][3][4] = {};
    const float* ks = k_s + (s % kF32Stages) * kF32KSlot + g * kF32KStride + 2 * t;
#pragma unroll
    for (int kk = 0; kk < kF32Chunk / 8; ++kk) {
      if (kk >= ksteps) break;
      const int col = c * kF32Chunk + kk * 8;
      const float2 lo = *reinterpret_cast<const float2*>(qs + col);
      const float2 hi = *reinterpret_cast<const float2*>(qs + 8 * q_stride + col);
      uint32_t ab[4], as[4];
      tc::split_tf32(lo.x, ab[0], as[0]);
      tc::split_tf32(hi.x, ab[1], as[1]);
      tc::split_tf32(lo.y, ab[2], as[2]);
      tc::split_tf32(hi.y, ab[3], as[3]);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float2 kv = *reinterpret_cast<const float2*>(ks + j * 8 * kF32KStride + kk * 8);
        uint32_t b0, b1, b0s, b1s;
        tc::split_tf32(kv.x, b0, b0s);
        tc::split_tf32(kv.y, b1, b1s);
        tc::mma_tf32(sp[j][0], ab, b0, b1);
        tc::mma_tf32(sp[j][1], ab, b0s, b1s);
        tc::mma_tf32(sp[j][2], as, b0, b1);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float part = sp[j][0][e] + (sp[j][1][e] + sp[j][2][e]);
        s_acc[j][e] = c == 0 ? part : s_acc[j][e] + part;
      }
    if (c != nq - 1) continue;

    // masking and the online softmax on the fragments
    const int slot = i % kF32Stages;
    const int* state = state_s + slot * kF32Keys;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int st = state[8 * j + 2 * t + (e & 1)];
        const float x = st < 0 ? -INFINITY : (st == 0 ? kMaskedLogit : s_acc[j][e] * scale);
        s_acc[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], m_new[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      m_new[r] = fmaxf(m_run[r], mx[r]);  // the tile's first key is real: finite
      alpha[r] = expf(m_run[r] - m_new[r]);
      m_run[r] = m_new[r];
      l_part[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s_acc[j][e] - m_new[e >> 1]);
        l_part[e >> 1] += p;
        float p_acc = p;
        if (drop_threshold != 0u) {
          const int row = r0 + g + (e >> 1) * 8;
          const uint32_t key = (uint32_t)(key0 + 8 * j + 2 * t + (e & 1));
          p_acc = row < sq && philox::bits(seed, bh, (uint32_t)row, key) >= drop_threshold ? p * inv_keep : 0.f;
        }
        s_acc[j][e] = p_acc;
      }
    // O = alpha O + P V, k-step j = keys 8j..8j+7 of the tile, A = (c0, c2,
    // c1, c3) of S's n-tile j; a tile's product in fresh accumulators
    uint32_t pb[2][4], ps[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      tc::split_tf32(s_acc[j][0], pb[j][0], ps[j][0]);
      tc::split_tf32(s_acc[j][2], pb[j][1], ps[j][1]);
      tc::split_tf32(s_acc[j][1], pb[j][2], ps[j][2]);
      tc::split_tf32(s_acc[j][3], pb[j][3], ps[j][3]);
    }
    const float* vs = v_s + slot * kF32Keys * kVStride + 2 * t * kVStride + g;
    const int js = sk - key0 > 8 ? 2 : 1;  // k-steps with a key before Sk
#pragma unroll
    for (int n = 0; n < kNt; ++n) {
      if (n * 8 >= dvw) break;
      float pv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (j >= js) break;
        const float* vj = vs + j * 8 * kVStride + n * 8;
        uint32_t b0, b1, b0s, b1s;
        tc::split_tf32(vj[0], b0, b0s);
        tc::split_tf32(vj[kVStride], b1, b1s);
        tc::mma_3xtf32(pv, pb[j], ps[j], b0, b1, b0s, b1s);
      }
      o_acc[n][0] = o_acc[n][0] * alpha[0] + pv[0];
      o_acc[n][1] = o_acc[n][1] * alpha[0] + pv[1];
      o_acc[n][2] = o_acc[n][2] * alpha[1] + pv[2];
      o_acc[n][3] = o_acc[n][3] * alpha[1] + pv[3];
    }
  }

  // combine the warps: partial O, m and l through shared memory (the rings
  // are free once every warp is past its loop)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_part[r] += __shfl_xor_sync(kFull, l_part[r], 1);
    l_part[r] += __shfl_xor_sync(kFull, l_part[r], 2);
  }
  tc::cp_async_wait<0>();
  __syncthreads();
  float* o_sum = rings;                                      // [4][16][kVStride]
  float* m_sum = o_sum + kF32Warps * kF32Rows * kVStride;    // [4][16]
  float* l_sum = m_sum + kF32Warps * kF32Rows;               // [4][16]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* orow = o_sum + (warp * kF32Rows + g + 8 * r) * kVStride + 2 * t;
#pragma unroll
    for (int n = 0; n < kNt; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n) = make_float2(o_acc[n][2 * r], o_acc[n][2 * r + 1]);
    if (t == 0) {
      m_sum[warp * kF32Rows + g + 8 * r] = m_run[r];
      l_sum[warp * kF32Rows + g + 8 * r] = l_part[r];
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= sq) continue;
    float m_all = -INFINITY;
#pragma unroll
    for (int w = 0; w < kF32Warps; ++w) m_all = fmaxf(m_all, m_sum[w * kF32Rows + g + 8 * r]);
    float f[kF32Warps], l_all = 0.f;  // a warp without keys has m = -inf: weight 0
#pragma unroll
    for (int w = 0; w < kF32Warps; ++w) {
      f[w] = expf(m_sum[w * kF32Rows + g + 8 * r] - m_all);
      l_all += f[w] * l_sum[w * kF32Rows + g + 8 * r];
    }
    const float inv_l = 1.f / l_all;
    float* orow = out + so_.off(b, hh, row) + c0;
    // warp w writes n-tiles w * kNt / 4 ..
#pragma unroll
    for (int n = 0; n < kNt; ++n) {
      if (n / (kNt / kF32Warps) != warp) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * n + 2 * t + e;
        if (col >= dvw) continue;
        float o = 0.f;
#pragma unroll
        for (int w = 0; w < kF32Warps; ++w) o += f[w] * o_sum[(w * kF32Rows + g + 8 * r) * kVStride + col];
        orow[col] = o * inv_l;
      }
    }
    if (chunk == 0 && warp == 0 && t == 0) lse[((long)b * num_heads + hh) * sq + row] = m_all + logf(l_all);
  }
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
    float scale, const long long* __restrict__ seed_ptr, uint32_t drop_threshold, float inv_keep, int dv_chunks,
    bool vec) {
  const uint32_t seed = philox::load_seed(seed_ptr, drop_threshold);
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
  const long long* seed;  // device memory
  uint32_t drop_threshold;
  float inv_keep;
  cudaStream_t stream;
};

template <int DVC>
int launch_f32(const Args& a) {
  const int chunks = (a.dv + DVC - 1) / DVC;
  const dim3 grid((a.sq + kF32Rows - 1) / kF32Rows, a.num_heads * chunks, a.b);
  const int smem = f32_fwd_smem(a.d, DVC);
  cudaError_t err =
      cudaFuncSetAttribute(flash_fwd_f32_kernel<DVC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const bool vec = aligned16_strided<float>(a.q, a.d, a.sq_) && aligned16_strided<float>(a.k, a.d, a.sk_) &&
                   aligned16_strided<float>(a.v, a.dv, a.sv_);
  flash_fwd_f32_kernel<DVC><<<grid, kF32Threads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k), static_cast<const float*>(a.v),
      static_cast<const uint8_t*>(a.key_valid), static_cast<float*>(a.out), static_cast<float*>(a.lse),
      a.sq_, a.sk_, a.sv_, a.so_, a.sq, a.sk, a.num_heads, a.d, a.dv, a.scale, a.seed, a.drop_threshold,
      a.inv_keep, chunks, vec);
  return (int)cudaGetLastError();
}

int dispatch_f32(const Args& a) {
  if (a.d > 1024 || a.dv > 1024) return (int)cudaErrorInvalidValue;
  if (a.dv <= 32) return launch_f32<32>(a);
  if (a.dv <= 64) return launch_f32<64>(a);
  return launch_f32<128>(a);  // dv > 128 in chunks of 128 across grid.y
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

int odtt_flash_fwd_abi_version() { return 6; }

// dtype: 0 float32 (tensor cores, 3xTF32), 1 bfloat16 (tensor cores). key_valid:
// (B, Sk) bytes or null.
// strides: 12 element strides, (batch, head, row) of q, k, v and out, in
// that order (the feature stride is 1). lse: (B, h, Sq) float32, contiguous.
// drop_threshold 0 disables dropout; otherwise keep iff the element's Philox
// bits (key: the low 32 bits of the int64 at seed, a device pointer) >=
// drop_threshold and scale kept probabilities by inv_keep.
// Returns cudaGetLastError() after the launch (0 on success).
int odtt_flash_attention_fwd(const void* q, const void* k, const void* v,
                             const void* key_valid, void* out, void* lse,
                             const long long* strides, int dtype, int b, int sq, int sk,
                             int num_heads, int d, int dv, float scale, const long long* seed,
                             unsigned int drop_threshold, float inv_keep, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || num_heads <= 0 || d <= 0 || dv <= 0 || strides == nullptr)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, key_valid, out, lse,
               Strides{strides[0], strides[1], strides[2]}, Strides{strides[3], strides[4], strides[5]},
               Strides{strides[6], strides[7], strides[8]}, Strides{strides[9], strides[10], strides[11]},
               b, sq, sk, num_heads, d, dv, scale, seed, drop_threshold, inv_keep,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch_f32(a);
  if (dtype == 1) return dispatch_tc(a);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
