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
// Two tensor-core kernels compute it, chosen by the operand dtype (no
// fallback between them or to the plain version).
//
// bfloat16, flash_bwd_tc_kernel (FlashAttention-2's backward order on
// Hopper's tensor cores). What bounds it on this card: a launch at the
// path's shapes needs 0.4-16 GFLOP, some microseconds of bf16 tensor-core
// work, on 5-40 MB of operands, so bytes bound it; the CUDA-core kernel it
// replaced spent 175-290x that bound on float32 FMAs, shuffles and shared-
// memory round trips. The design: grid (ceil(Sk / 32), h, B); a block of 4
// warps owns 32 keys of one head, holds their K and V rows in shared memory
// and loops over query tiles of 64 rows (32 where the accumulators live in
// shared memory), whose q / dO rows come through cp.async (a 2-stage ring
// where it fits) beside their lse and delta. In each tile:
//   1. S^T = K Q^T and dP^T = V dO^T by mma.sync m16n8k16 (bf16 operands:
//      exact products, f32 sums), a warp 16 keys x half the queries;
//   2. on the fragments: p = exp(s - lse) (1/Sk in a fully masked row), the
//      regenerated keep bit, dS = p (dP keep / (1 - rate) - delta) scale,
//      P keep / (1 - rate); both float32 tiles go to shared memory as bf16
//      pairs hi = bf16(x), lo = bf16(x - hi), so the gradient products below
//      keep them to about 2^-16 as _dkvq_kernel_packed (l.948-961) keeps
//      them in float32;
//   3. dV += (P keep)^T dO and dK += dS^T Q, two mmas (hi, lo) a product,
//      in f32 accumulators: in registers where they fit (d + dv <= 256: 16
//      keys x 64 columns a job, at most 2 jobs a warp), else in shared
//      memory (the hidden-256 cross-attention, d 512, dv 256: 32 keys x 768
//      f32, 96 KB, beside single-buffered q / dO tiles, 211 KB in all);
//   4. dQ += dS K the same way, warps over (16 queries, 64 columns), added
//      to the wrapper's zeroed f32 buffer with atomics.
// 32-key blocks give the one-head cross-attention (Sk 400) 208 blocks on
// 132 SMs; 64-key ones would give 112.
//
// float32, flash_bwd_f32_kernel (the same order on the tensor cores in
// 3xTF32, as flash_fwd_f32_kernel in flash_attention_fwd.cu: every product
// is three mma.sync m16n8k8 tf32 products of the operands' big and small
// halves, relative error about 5e-6 against float32). The CUDA-core kernel
// it replaced (one query row a warp, dot products by reduce-scatters) spent
// 36-72x its bound on float32 FMAs and shuffles. The design: grid
// (ceil(Sk / 16), h, B); a block owns 16 keys of one head (one m16 tile),
// holds their K and V rows in shared memory in float32 (split into tf32
// halves as fragments are loaded, so the hidden-256 cross-attention, d 512,
// dv 256, fits a block: 209,728 bytes) and loops over query tiles of 32
// rows, whose q / dO rows come through cp.async (a 2-stage ring where it
// fits the block, else 1) beside their lse and delta. In each tile:
//   1. S^T = K Q^T and dP^T = V dO^T, 16 keys x 8 queries a warp; each
//      64-column chunk of the sum in three fresh accumulators (big x big,
//      big x small, small x big), added in IEEE float32, as the forward does
//      (the tensor cores' float32 sums are not round-to-nearest, so mma
//      chains stay short). With 8 warps, two warps share an n-tile, each
//      summing half of d and dv, and swap partial sums through shared memory;
//   2. on the fragments: p = exp(s - lse) (1/Sk in a fully masked row), the
//      regenerated keep bit, dS = p (dP keep / (1 - rate) - delta) scale and
//      P keep / (1 - rate), to shared memory in float32;
//   3. dV += (P keep)^T dO and dK += dS^T Q, jobs of 16 keys x 64 (4 warps)
//      or 32 (8 warps) columns: the tile's product (12 mma a fragment) in
//      fresh registers, then added to float32 accumulators in shared memory;
//   4. dQ += dS K, jobs of 16 queries x the same columns, added to the
//      wrapper's zeroed float32 buffer with atomics (8-byte float2 atomics,
//      sm_90's, for each fragment's column pair where d is even).
// A block has 8 warps where d + dv passes 64, else 4: the chain of a tile
// is short and dependent, so latency bounds the kernel, and at the
// cross-attention one 210 KB block fills an SM (8 warps: 2.21 -> 1.18 ms a
// launch, PERF.md); the encoder's 64 columns give 8 warps too little to do.
// Operands are split by truncation (tc::split_tf32_trunc: two integer /
// float operations instead of two conversions more, 17-20 % of the time).
// Bank layout: K, V, the q / dO tiles and the accumulators have rows of 8
// mod 32 words, so the float2 reads of steps 1 and 3 (k slot t holding
// columns 2t and 2t + 1) and the B reads of rows t, columns g are conflict
// free; P keep and dS have rows of 4 mod 32 words for step 3's A reads.

#include <math.h>

#include "flash_common.cuh"
#include "philox.cuh"
#include "tensor_core.cuh"

namespace {

using namespace flash;

constexpr float kFullyMaskedLse = -5e8f;  // below any row with a valid key

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// ---- float32 on the tensor cores, in 3xTF32
constexpr int kF32Keys = 16;  // keys a block: one m16 tile
constexpr int kF32Rows = 32;  // query rows a tile: 4 n-tiles of 8
constexpr int kSmemOptin = 232448;    // an H100 block's opt-in shared memory
constexpr int kF32Exchange = 8 * kWarp * 4;  // floats: 8 warps' partial S / dP rows

// The warps of a block at head widths d, dv, and its shared-memory layout in
// bytes from the start (float strides beside). 8 warps (jobs of 32
// gradient columns) where d + dv passes 64, else 4 (jobs of 64): the
// encoder's 64 columns give 8 warps too little to do. 2 stages of q / dO
// tiles where they fit the block, else 1.
struct F32Layout {
  int warps, stages, ks, vs, ps;  // K / q / dK, V / dO / dV, P keep / dS row strides
  size_t lse, delta, k, v, q, dout, pd, ds, acc_k, acc_v, exchange, total;
  __host__ __device__ F32Layout(int d, int dv) {
    warps = d + dv > 64 ? 8 : 4;
    ks = round_up(d, 32) + 8;
    vs = round_up(dv, 32) + 8;
    ps = kF32Rows + 4;
    place(2);
    if (total > (size_t)kSmemOptin) place(1);
  }
  __host__ __device__ void place(int s) {
    stages = s;
    lse = kF32Keys * sizeof(int);                     // after the key states
    delta = lse + sizeof(float) * s * kF32Rows;
    k = delta + sizeof(float) * s * kF32Rows;         // (16, ks)
    v = k + sizeof(float) * kF32Keys * ks;            // (16, vs)
    q = v + sizeof(float) * kF32Keys * vs;            // s x (32, ks)
    dout = q + sizeof(float) * s * kF32Rows * ks;     // s x (32, vs)
    pd = dout + sizeof(float) * s * kF32Rows * vs;    // (16, ps)
    ds = pd + sizeof(float) * kF32Keys * ps;          // (16, ps)
    acc_k = ds + sizeof(float) * kF32Keys * ps;       // (16, ks)
    acc_v = acc_k + sizeof(float) * kF32Keys * ks;    // (16, vs)
    exchange = acc_v + sizeof(float) * kF32Keys * vs;  // (8, 32, 4) with 8 warps
    total = exchange + (warps == 8 ? sizeof(float) * kF32Exchange : 0);
  }
};

// W warps (F32Layout's), gradient jobs of CW columns.
template <int W, int CW>
__global__ void __launch_bounds__(W * kWarp) flash_bwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const uint8_t* __restrict__ key_valid, const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
    int sq, int sk, int num_heads, int d, int dvw, float scale, const long long* __restrict__ seed_ptr,
    uint32_t drop_threshold, float inv_keep, bool vec_qk, bool vec_vo, bool vec_dq) {
  const uint32_t seed = philox::load_seed(seed_ptr, drop_threshold);
  constexpr int kThreads = W * kWarp;
  constexpr int kNt = CW / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const F32Layout L(d, dvw);
  int* key_state = reinterpret_cast<int*>(smem);  // 1 valid, 0 masked, -1 past Sk
  float* lse_s = reinterpret_cast<float*>(smem + L.lse);
  float* delta_s = reinterpret_cast<float*>(smem + L.delta);
  float* k_s = reinterpret_cast<float*>(smem + L.k);
  float* v_s = reinterpret_cast<float*>(smem + L.v);
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  float* do_s = reinterpret_cast<float*>(smem + L.dout);
  float* pd_s = reinterpret_cast<float*>(smem + L.pd);
  float* ds_s = reinterpret_cast<float*>(smem + L.ds);
  float* acc_k = reinterpret_cast<float*>(smem + L.acc_k);
  float* acc_v = reinterpret_cast<float*>(smem + L.acc_v);
  float* exchange = reinterpret_cast<float*>(smem + L.exchange);

  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int g = lane / 4, t = lane % 4;
  const int key0 = blockIdx.x * kF32Keys;
  const int hh = blockIdx.y, b = blockIdx.z;
  const long hd = (long)num_heads * d, hdv = (long)num_heads * dvw;
  const uint32_t bh = (uint32_t)(b * num_heads + hh);
  const int nck = (d + CW - 1) / CW, ncv = (dvw + CW - 1) / CW;
  const int nqt = (sq + kF32Rows - 1) / kF32Rows;

  tc::load_rows_f32<0>(k_s, L.ks, k + ((long)b * sk + key0) * hd + hh * d, hd, kF32Keys, sk - key0, d, vec_qk,
                       threadIdx.x, kThreads);
  tc::load_rows_f32<0>(v_s, L.vs, v + ((long)b * sk + key0) * hdv + hh * dvw, hdv, kF32Keys, sk - key0, dvw,
                       vec_vo, threadIdx.x, kThreads);
  if (threadIdx.x < kF32Keys) {
    const int key = key0 + threadIdx.x;
    key_state[threadIdx.x] = key >= sk ? -1 : (key_valid == nullptr ? 1 : (key_valid[(long)b * sk + key] != 0));
  }
  for (int i = threadIdx.x; i < kF32Keys * L.ks; i += kThreads) acc_k[i] = 0.f;
  for (int i = threadIdx.x; i < kF32Keys * L.vs; i += kThreads) acc_v[i] = 0.f;
  auto load = [&](int it) {
    const int q0 = it * kF32Rows, slot = L.stages == 2 ? (it & 1) : 0;
    tc::load_rows_f32<0>(q_s + slot * kF32Rows * L.ks, L.ks, q + ((long)b * sq + q0) * hd + hh * d, hd, kF32Rows,
                         sq - q0, d, vec_qk, threadIdx.x, kThreads);
    tc::load_rows_f32<0>(do_s + slot * kF32Rows * L.vs, L.vs, dout + ((long)b * sq + q0) * hdv + hh * dvw, hdv,
                         kF32Rows, sq - q0, dvw, vec_vo, threadIdx.x, kThreads);
    for (int i = threadIdx.x; i < kF32Rows; i += kThreads) {
      const long stat = ((long)b * num_heads + hh) * sq + q0 + i;
      lse_s[slot * kF32Rows + i] = q0 + i < sq ? lse[stat] : 0.f;
      delta_s[slot * kF32Rows + i] = q0 + i < sq ? delta[stat] : 0.f;
    }
    tc::cp_async_commit();
  };
  load(0);  // with K and V: one cp.async group

  for (int it = 0; it < nqt; ++it) {
    if (L.stages == 1 && it > 0) load(it);
    if (L.stages == 2 && it + 1 < nqt) {
      load(it + 1);
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const int slot = L.stages == 2 ? (it & 1) : 0, q0 = it * kF32Rows;
    const float* qt_s = q_s + slot * kF32Rows * L.ks;
    const float* dot_s = do_s + slot * kF32Rows * L.vs;
    const float* lse_t = lse_s + slot * kF32Rows;
    const float* delta_t = delta_s + slot * kF32Rows;

    // 1. S^T and dP^T of the 16 keys x the 8 queries of n-tile warp % 4:
    //    element e of a fragment is key g + 8 (e / 2), query qb + 2t + e % 2.
    //    With 8 warps, warp w and w + 4 sum halves of d and dv and swap the
    //    partial sums of key rows g + 8 and g, so each finishes one half
    const int qb = (warp % 4) * 8, half = warp / 4;
    const int s_mid = W == 8 ? (d + 15) / 16 * 8 : d, p_mid = W == 8 ? (dvw + 15) / 16 * 8 : dvw;
    float st[4], dpt[4];
    tc::mma_abt_3xtf32(st, k_s + half * s_mid, L.ks, qt_s + qb * L.ks + half * s_mid, L.ks,
                       half ? d - s_mid : s_mid, g, t);
    tc::mma_abt_3xtf32(dpt, v_s + half * p_mid, L.vs, dot_s + qb * L.vs + half * p_mid, L.vs,
                       half ? dvw - p_mid : p_mid, g, t);
    if (W == 8) {
      float* mine = exchange + (warp * kWarp + lane) * 4;
      const int give = 2 * (1 - half);  // the other half's key rows
      *reinterpret_cast<float4*>(mine) = make_float4(st[give], st[give + 1], dpt[give], dpt[give + 1]);
      __syncthreads();
      const float4 got = *reinterpret_cast<const float4*>(exchange + ((warp ^ 4) * kWarp + lane) * 4);
      st[2 * half] += got.x;
      st[2 * half + 1] += got.y;
      dpt[2 * half] += got.z;
      dpt[2 * half + 1] += got.w;
    }

    // 2. p, the keep bit, dS and P keep on the fragments, to shared memory
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {  // key rows g and g + 8
      if (W == 8 && h2 != half) continue;
      const int kl = g + 8 * h2;
      const int state = key_state[kl];
      float pd[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ql = qb + 2 * t + e, row = q0 + ql;
        pd[e] = ds[e] = 0.f;
        if (state >= 0 && row < sq) {
          const float s = state == 0 ? kMaskedLogit : st[2 * h2 + e] * scale;
          // a fully masked row's lse (-1e9 + log Sk) rounds to -1e9 in
          // float32: its probabilities are the uniform 1/Sk the forward used
          const float lse_i = lse_t[ql];
          const float p = lse_i < kFullyMaskedLse ? 1.f / (float)sk : expf(s - lse_i);
          float dpk = dpt[2 * h2 + e];
          pd[e] = p;
          if (drop_threshold != 0u) {
            const bool keep = philox::bits(seed, bh, (uint32_t)row, (uint32_t)(key0 + kl)) >= drop_threshold;
            pd[e] = keep ? p * inv_keep : 0.f;
            dpk = keep ? dpk * inv_keep : 0.f;
          }
          if (state == 1) ds[e] = p * (dpk - delta_t[ql]) * scale;
        }
      }
      *reinterpret_cast<float2*>(pd_s + kl * L.ps + qb + 2 * t) = make_float2(pd[0], pd[1]);
      *reinterpret_cast<float2*>(ds_s + kl * L.ps + qb + 2 * t) = make_float2(ds[0], ds[1]);
    }
    __syncthreads();

    // 3. dK += dS^T Q and dV += (P keep)^T dO: jobs of 16 keys x CW columns
    for (int job = warp; job < nck + ncv; job += W) {
      const bool is_k = job < nck;
      const int col0 = (is_k ? job : job - nck) * CW;
      const int width = (is_k ? d : dvw) - col0, sb = is_k ? L.ks : L.vs;
      const float* a = (is_k ? ds_s : pd_s) + g * L.ps + t;  // A[key][query]
      const float* bm = (is_k ? qt_s : dot_s) + t * sb + col0 + g;  // B[query][column]
      float c[kNt][4] = {};
#pragma unroll
      for (int kq = 0; kq < kF32Rows / 8; ++kq) {
        uint32_t big[4], small[4];
        const float* ak = a + kq * 8;
        tc::split_a(big, small, ak[0], ak[8 * L.ps], ak[4], ak[8 * L.ps + 4]);
        tc::mma_row_3xtf32<kNt>(c, big, small, bm + kq * 8 * sb, sb, width);
      }
      float* acc = (is_k ? acc_k : acc_v) + g * sb + col0 + 2 * t;
#pragma unroll
      for (int n = 0; n < kNt; ++n) {
        if (n * 8 >= width) break;
        float2* lo = reinterpret_cast<float2*>(acc + 8 * n);
        float2* hi = reinterpret_cast<float2*>(acc + 8 * sb + 8 * n);
        *lo = make_float2(lo->x + c[n][0], lo->y + c[n][1]);
        *hi = make_float2(hi->x + c[n][2], hi->y + c[n][3]);
      }
    }

    // 4. dQ += dS K: jobs of 16 queries x CW columns, added to the float32 buffer
    for (int job = warp; job < 2 * nck; job += W) {
      const int qg = job & 1, col0 = (job >> 1) * CW;
      float c[kNt][4] = {};
#pragma unroll
      for (int kk = 0; kk < kF32Keys / 8; ++kk) {
        uint32_t big[4], small[4];
        const float* a = ds_s + (kk * 8 + t) * L.ps + qg * 16 + g;  // A[query][key] = dS[key][query]
        tc::split_a(big, small, a[0], a[8], a[4 * L.ps], a[4 * L.ps + 8]);
        tc::mma_row_3xtf32<kNt>(c, big, small, k_s + (kk * 8 + t) * L.ks + col0 + g, L.ks, d - col0);
      }
#pragma unroll
      for (int n = 0; n < kNt; ++n)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {  // rows g and g + 8, columns 2t and 2t + 1
          const int row = q0 + qg * 16 + g + 8 * h2, col = col0 + 8 * n + 2 * t;
          const float x0 = c[n][2 * h2], x1 = c[n][2 * h2 + 1];
          if (row >= sq || col >= d || (x0 == 0.f && x1 == 0.f)) continue;
          float* at = dq + ((long)b * sq + row) * hd + hh * d + col;
          if (vec_dq) {  // d even: one 8-byte atomic for the pair
            atomicAdd(reinterpret_cast<float2*>(at), make_float2(x0, x1));
          } else {
            atomicAdd(at, x0);
            if (col + 1 < d) atomicAdd(at + 1, x1);
          }
        }
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < kF32Keys * d; i += kThreads) {
    const int j = i / d, e = i - j * d;
    if (key0 + j < sk) dk[((long)b * sk + key0 + j) * hd + hh * d + e] = acc_k[j * L.ks + e];
  }
  for (int i = threadIdx.x; i < kF32Keys * dvw; i += kThreads) {
    const int j = i / dvw, e = i - j * dvw;
    if (key0 + j < sk) dv[((long)b * sk + key0 + j) * hdv + hh * dvw + e] = acc_v[j * L.vs + e];
  }
}

// ---- bfloat16 on the tensor cores
using bf16 = __nv_bfloat16;
constexpr int kTcKeys = 32;  // keys a block: 2 groups of 16
constexpr int kTcWarps = 4;
constexpr int kTcThreads = kTcWarps * kWarp;
// dS and P keep reach the gradient products as hi / lo bf16 pairs. Only a
// build with -DODTT_FLASH_BWD_ONE_BF16 feeds their hi part alone:
// chip_smoke.py builds that copy under another name to measure what the
// pair buys; the library the port loads never defines it.
#ifdef ODTT_FLASH_BWD_ONE_BF16
constexpr bool kSplit = false;
#else
constexpr bool kSplit = true;
#endif

// The kernel's shape at head widths d, dv: cw columns a dK / dV / dQ job,
// jpw jobs a warp with their accumulators in registers (0: in shared
// memory), qt query rows a tile.
struct TcPlan {
  int cw, jpw, qt;
  __host__ __device__ TcPlan(int d, int dv) {
    cw = (d > dv ? d : dv) <= 32 ? 32 : 64;
    const int jobs = 2 * ((d + cw - 1) / cw + (dv + cw - 1) / cw);  // 2 key groups
    jpw = jobs <= 2 * kTcWarps ? (jobs + kTcWarps - 1) / kTcWarps : 0;
    if (jpw == 0) cw = 64;
    qt = jpw == 0 ? 32 : 64;
  }
};

// Shared-memory layout in bytes from the start (element strides beside).
struct TcLayout {
  int stages, ks, vs, ps, aks, avs;  // q/k, v/dO, P/dS (bf16) and dK, dV accumulator (f32) strides
  size_t lse, delta, k, v, q, dout, pd_hi, pd_lo, ds_hi, ds_lo, acc_k, acc_v, total;
  __host__ __device__ TcLayout(int d, int dv) {
    const TcPlan p(d, dv);
    stages = p.jpw == 0 ? 1 : 2;
    ks = round_up(d, 16) + tc::kPad;
    vs = round_up(dv, 16) + tc::kPad;
    ps = p.qt + tc::kPad;
    aks = round_up(d, p.cw) + tc::kPad;
    avs = round_up(dv, p.cw) + tc::kPad;
    lse = kTcKeys * sizeof(int);                   // after the key states
    delta = lse + sizeof(float) * stages * p.qt;
    k = delta + sizeof(float) * stages * p.qt;      // (kTcKeys, ks)
    v = k + 2 * kTcKeys * ks;                       // (kTcKeys, vs)
    q = v + 2 * kTcKeys * vs;                       // stages x (qt, ks)
    dout = q + 2 * (size_t)stages * p.qt * ks;      // stages x (qt, vs)
    pd_hi = dout + 2 * (size_t)stages * p.qt * vs;  // (kTcKeys, ps) each
    pd_lo = pd_hi + 2 * kTcKeys * ps;
    ds_hi = pd_lo + 2 * kTcKeys * ps;
    ds_lo = ds_hi + 2 * kTcKeys * ps;
    acc_k = ds_lo + 2 * kTcKeys * ps;               // (kTcKeys, aks) f32
    acc_v = acc_k + sizeof(float) * kTcKeys * aks;  // (kTcKeys, avs) f32
    total = p.jpw == 0 ? acc_v + sizeof(float) * kTcKeys * avs : acc_k;
  }
};

template <int CW, int JPW, int QT>
__global__ void __launch_bounds__(kTcThreads) flash_bwd_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const uint8_t* __restrict__ key_valid, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dq,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int sq, int sk, int num_heads, int d, int dvw,
    float scale, const long long* __restrict__ seed_ptr, uint32_t drop_threshold, float inv_keep, bool vec_qk,
    bool vec_vo) {
  const uint32_t seed = philox::load_seed(seed_ptr, drop_threshold);
  constexpr bool kSmemAcc = JPW == 0;
  constexpr int kQPW = QT / 2;  // queries of a warp in step 1
  constexpr int kNt = CW / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const TcLayout L(d, dvw);
  int* key_state = reinterpret_cast<int*>(smem);  // 1 valid, 0 masked, -1 past Sk
  float* lse_s = reinterpret_cast<float*>(smem + L.lse);
  float* delta_s = reinterpret_cast<float*>(smem + L.delta);
  bf16* k_s = reinterpret_cast<bf16*>(smem + L.k);
  bf16* v_s = reinterpret_cast<bf16*>(smem + L.v);
  bf16* q_s = reinterpret_cast<bf16*>(smem + L.q);
  bf16* do_s = reinterpret_cast<bf16*>(smem + L.dout);
  bf16* pd_hi = reinterpret_cast<bf16*>(smem + L.pd_hi);
  bf16* pd_lo = reinterpret_cast<bf16*>(smem + L.pd_lo);
  bf16* ds_hi = reinterpret_cast<bf16*>(smem + L.ds_hi);
  bf16* ds_lo = reinterpret_cast<bf16*>(smem + L.ds_lo);
  float* acc_k = reinterpret_cast<float*>(smem + L.acc_k);
  float* acc_v = reinterpret_cast<float*>(smem + L.acc_v);

  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int g = lane / 4, t = lane % 4;
  const int key0 = blockIdx.x * kTcKeys;
  const int hh = blockIdx.y, b = blockIdx.z;
  const long hd = (long)num_heads * d, hdv = (long)num_heads * dvw;
  const uint32_t bh = (uint32_t)(b * num_heads + hh);
  const int nck = (d + CW - 1) / CW, ncv = (dvw + CW - 1) / CW;
  const int jobs = 2 * (nck + ncv);
  const int kw = round_up(d, 16), vw = round_up(dvw, 16);
  const int nqt = (sq + QT - 1) / QT;

  tc::load_rows<kTcThreads>(k_s, L.ks, k + ((long)b * sk + key0) * hd + hh * d, hd, kTcKeys, sk - key0, d,
                            vec_qk);
  tc::load_rows<kTcThreads>(v_s, L.vs, v + ((long)b * sk + key0) * hdv + hh * dvw, hdv, kTcKeys, sk - key0,
                            dvw, vec_vo);
  if (threadIdx.x < kTcKeys) {
    const int key = key0 + threadIdx.x;
    key_state[threadIdx.x] = key >= sk ? -1 : (key_valid == nullptr ? 1 : (key_valid[(long)b * sk + key] != 0));
  }
  if (kSmemAcc) {
    for (int i = threadIdx.x; i < kTcKeys * L.aks; i += kTcThreads) acc_k[i] = 0.f;
    for (int i = threadIdx.x; i < kTcKeys * L.avs; i += kTcThreads) acc_v[i] = 0.f;
  }
  auto load = [&](int it) {
    const int q0 = it * QT, slot = L.stages == 2 ? (it & 1) : 0;
    tc::load_rows<kTcThreads>(q_s + slot * QT * L.ks, L.ks, q + ((long)b * sq + q0) * hd + hh * d, hd, QT,
                              sq - q0, d, vec_qk);
    tc::load_rows<kTcThreads>(do_s + slot * QT * L.vs, L.vs, dout + ((long)b * sq + q0) * hdv + hh * dvw, hdv,
                              QT, sq - q0, dvw, vec_vo);
    for (int i = threadIdx.x; i < QT; i += kTcThreads) {
      const long stat = ((long)b * num_heads + hh) * sq + q0 + i;
      lse_s[slot * QT + i] = q0 + i < sq ? lse[stat] : 0.f;
      delta_s[slot * QT + i] = q0 + i < sq ? delta[stat] : 0.f;
    }
    tc::cp_async_commit();
  };
  load(0);

  float acc[JPW > 0 ? JPW : 1][kNt][4];
#pragma unroll
  for (int i = 0; i < (JPW > 0 ? JPW : 1); ++i)
#pragma unroll
    for (int n = 0; n < kNt; ++n) acc[i][n][0] = acc[i][n][1] = acc[i][n][2] = acc[i][n][3] = 0.f;

  // dV (P keep)^T dO or dK += dS^T Q for job `job`: 16 keys x CW columns
  auto accumulate = [&](int job, float (&c)[kNt][4], const bf16* qt_s, const bf16* dot_s) {
    const int kg = job & 1, cc = job >> 1;
    const bool is_k = cc < nck;
    const int col0 = (is_k ? cc : cc - nck) * CW;
    const int width = (is_k ? d : dvw) - col0;
    const bf16* hi = is_k ? ds_hi : pd_hi;
    const bf16* lo = is_k ? ds_lo : pd_lo;
    const bf16* bt = is_k ? qt_s : dot_s;
    const int bstride = is_k ? L.ks : L.vs;
#pragma unroll
    for (int kq = 0; kq < QT / 16; ++kq) {
      uint32_t a_hi[4], a_lo[4];
      tc::load_a(a_hi, hi, L.ps, kg * 16, kq * 16, lane);
      if constexpr (kSplit) tc::load_a(a_lo, lo, L.ps, kg * 16, kq * 16, lane);
#pragma unroll
      for (int n2 = 0; n2 < kNt / 2; ++n2) {
        if (n2 * 16 >= width) break;
        uint32_t bb[4];
        tc::load_b_cols(bb, bt, bstride, kq * 16, col0 + n2 * 16, lane);
        tc::mma(c[2 * n2], a_hi, bb[0], bb[1]);
        tc::mma(c[2 * n2 + 1], a_hi, bb[2], bb[3]);
        if constexpr (kSplit) {
          tc::mma(c[2 * n2], a_lo, bb[0], bb[1]);
          tc::mma(c[2 * n2 + 1], a_lo, bb[2], bb[3]);
        }
      }
    }
  };
  // the shared accumulator of job `job` at fragment element (n, e)
  auto acc_at = [&](int job, int n, int e) -> float* {
    const int kg = job & 1, cc = job >> 1;
    const int row = kg * 16 + g + (e >> 1) * 8, col = 8 * n + 2 * t + (e & 1);
    return cc < nck ? acc_k + row * L.aks + cc * CW + col : acc_v + row * L.avs + (cc - nck) * CW + col;
  };

  for (int it = 0; it < nqt; ++it) {
    if (L.stages == 1 && it > 0) load(it);
    if (L.stages == 2 && it + 1 < nqt) {
      load(it + 1);
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const int slot = L.stages == 2 ? (it & 1) : 0, q0 = it * QT;
    const bf16* qt_s = q_s + slot * QT * L.ks;
    const bf16* dot_s = do_s + slot * QT * L.vs;

    // 1. S^T and dP^T of 16 keys x kQPW queries
    const int kg = warp & 1, qb = (warp >> 1) * kQPW;
    float st[kQPW / 8][4], dpt[kQPW / 8][4];
#pragma unroll
    for (int j = 0; j < kQPW / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
    for (int kk = 0; kk < kw / 16; ++kk) {
      uint32_t a[4];
      tc::load_a(a, k_s, L.ks, kg * 16, kk * 16, lane);
#pragma unroll
      for (int j2 = 0; j2 < kQPW / 16; ++j2) {
        uint32_t bb[4];
        tc::load_b_rows(bb, qt_s, L.ks, qb + j2 * 16, kk * 16, lane);
        tc::mma(st[2 * j2], a, bb[0], bb[1]);
        tc::mma(st[2 * j2 + 1], a, bb[2], bb[3]);
      }
    }
    for (int kk = 0; kk < vw / 16; ++kk) {
      uint32_t a[4];
      tc::load_a(a, v_s, L.vs, kg * 16, kk * 16, lane);
#pragma unroll
      for (int j2 = 0; j2 < kQPW / 16; ++j2) {
        uint32_t bb[4];
        tc::load_b_rows(bb, dot_s, L.vs, qb + j2 * 16, kk * 16, lane);
        tc::mma(dpt[2 * j2], a, bb[0], bb[1]);
        tc::mma(dpt[2 * j2 + 1], a, bb[2], bb[3]);
      }
    }

    // 2. p, the keep bit, dS and P keep on the fragments; hi / lo to shared memory
#pragma unroll
    for (int j = 0; j < kQPW / 8; ++j)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {  // key rows g and g + 8
        const int kl = kg * 16 + g + 8 * h2;
        const int state = key_state[kl];
        float pd[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ql = qb + 8 * j + 2 * t + e, row = q0 + ql;
          pd[e] = ds[e] = 0.f;
          if (state >= 0 && row < sq) {
            const float s = state == 0 ? kMaskedLogit : st[j][2 * h2 + e] * scale;
            // a fully masked row's lse (-1e9 + log Sk) rounds to -1e9 in
            // float32: its probabilities are the uniform 1/Sk the forward used
            const float lse_i = lse_s[slot * QT + ql];
            const float p = lse_i < kFullyMaskedLse ? 1.f / (float)sk : expf(s - lse_i);
            float dpk = dpt[j][2 * h2 + e];
            pd[e] = p;
            if (drop_threshold != 0u) {
              const bool keep = philox::bits(seed, bh, (uint32_t)row, (uint32_t)(key0 + kl)) >= drop_threshold;
              pd[e] = keep ? p * inv_keep : 0.f;
              dpk = keep ? dpk * inv_keep : 0.f;
            }
            if (state == 1) ds[e] = p * (dpk - delta_s[slot * QT + ql]) * scale;
          }
        }
        const int at = kl * L.ps + qb + 8 * j + 2 * t;
        const __nv_bfloat162 ph = __floats2bfloat162_rn(pd[0], pd[1]);
        const __nv_bfloat162 dh = __floats2bfloat162_rn(ds[0], ds[1]);
        *reinterpret_cast<__nv_bfloat162*>(pd_hi + at) = ph;
        *reinterpret_cast<__nv_bfloat162*>(ds_hi + at) = dh;
        *reinterpret_cast<__nv_bfloat162*>(pd_lo + at) = __floats2bfloat162_rn(
            pd[0] - __low2float(ph), pd[1] - __high2float(ph));
        *reinterpret_cast<__nv_bfloat162*>(ds_lo + at) = __floats2bfloat162_rn(
            ds[0] - __low2float(dh), ds[1] - __high2float(dh));
      }
    __syncthreads();

    // 3. dK, dV
    if (kSmemAcc) {
      for (int job = warp; job < jobs; job += kTcWarps) {
        float c[kNt][4];
#pragma unroll
        for (int n = 0; n < kNt; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) c[n][e] = *acc_at(job, n, e);
        accumulate(job, c, qt_s, dot_s);
#pragma unroll
        for (int n = 0; n < kNt; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) *acc_at(job, n, e) = c[n][e];
      }
    } else {
#pragma unroll
      for (int i = 0; i < (JPW > 0 ? JPW : 1); ++i)
        if (warp + kTcWarps * i < jobs) accumulate(warp + kTcWarps * i, acc[i], qt_s, dot_s);
    }

    // 4. dQ += dS K, added to the float32 buffer
    for (int job = warp; job < (QT / 16) * nck; job += kTcWarps) {
      const int qg = job % (QT / 16), col0 = (job / (QT / 16)) * CW;
      float c[kNt][4];
#pragma unroll
      for (int n = 0; n < kNt; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kTcKeys / 16; ++kk) {
        uint32_t a_hi[4], a_lo[4];
        tc::load_a_trans(a_hi, ds_hi, L.ps, kk * 16, qg * 16, lane);
        if constexpr (kSplit) tc::load_a_trans(a_lo, ds_lo, L.ps, kk * 16, qg * 16, lane);
#pragma unroll
        for (int n2 = 0; n2 < kNt / 2; ++n2) {
          if (n2 * 16 >= d - col0) break;
          uint32_t bb[4];
          tc::load_b_cols(bb, k_s, L.ks, kk * 16, col0 + n2 * 16, lane);
          tc::mma(c[2 * n2], a_hi, bb[0], bb[1]);
          tc::mma(c[2 * n2 + 1], a_hi, bb[2], bb[3]);
          if constexpr (kSplit) {
            tc::mma(c[2 * n2], a_lo, bb[0], bb[1]);
            tc::mma(c[2 * n2 + 1], a_lo, bb[2], bb[3]);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < kNt; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = q0 + qg * 16 + g + (e >> 1) * 8, col = col0 + 8 * n + 2 * t + (e & 1);
          if (row < sq && col < d && c[n][e] != 0.f)
            atomicAdd(dq + ((long)b * sq + row) * hd + hh * d + col, c[n][e]);
        }
    }
    __syncthreads();
  }

  // dK, dV out, in bfloat16
  auto store = [&](int job, int n, int e, float x) {
    const int kg = job & 1, cc = job >> 1;
    const int key = key0 + kg * 16 + g + (e >> 1) * 8, col = 8 * n + 2 * t + (e & 1);
    if (key >= sk) return;
    if (cc < nck) {
      if (cc * CW + col < d) dk[((long)b * sk + key) * hd + hh * d + cc * CW + col] = __float2bfloat16(x);
    } else if ((cc - nck) * CW + col < dvw) {
      dv[((long)b * sk + key) * hdv + hh * dvw + (cc - nck) * CW + col] = __float2bfloat16(x);
    }
  };
  if (kSmemAcc) {
    for (int job = warp; job < jobs; job += kTcWarps)
#pragma unroll
      for (int n = 0; n < kNt; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) store(job, n, e, *acc_at(job, n, e));
  } else {
#pragma unroll
    for (int i = 0; i < (JPW > 0 ? JPW : 1); ++i)
      if (warp + kTcWarps * i < jobs)
#pragma unroll
        for (int n = 0; n < kNt; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) store(warp + kTcWarps * i, n, e, acc[i][n][e]);
  }
}

struct Args {
  const void *q, *k, *v, *key_valid, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  int b, sq, sk, num_heads, d, dv_;
  float scale;
  const long long* seed;  // device memory
  uint32_t drop_threshold;
  float inv_keep;
  cudaStream_t stream;
};

template <int W, int CW>
int launch_f32(const Args& a, size_t smem) {
  const dim3 grid((a.sk + kF32Keys - 1) / kF32Keys, a.num_heads, a.b);
  cudaError_t err =
      cudaFuncSetAttribute(flash_bwd_f32_kernel<W, CW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_f32_kernel<W, CW><<<grid, W * kWarp, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k), static_cast<const float*>(a.v),
      static_cast<const uint8_t*>(a.key_valid), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta), static_cast<float*>(a.dq),
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.sq, a.sk, a.num_heads, a.d, a.dv_, a.scale, a.seed,
      a.drop_threshold, a.inv_keep,
      aligned16<float>(a.q, a.d, a.num_heads) && aligned16<float>(a.k, a.d, a.num_heads),
      aligned16<float>(a.v, a.dv_, a.num_heads) && aligned16<float>(a.dout, a.dv_, a.num_heads),
      a.d % 2 == 0 && reinterpret_cast<uintptr_t>(a.dq) % 8 == 0);
  return (int)cudaGetLastError();
}

int dispatch_f32(const Args& a) {
  if ((a.d > a.dv_ ? a.d : a.dv_) > 512) return (int)cudaErrorInvalidValue;
  const F32Layout L(a.d, a.dv_);
  return L.warps == 8 ? launch_f32<8, 32>(a, L.total) : launch_f32<4, 64>(a, L.total);
}

template <int CW, int JPW, int QT>
int launch_tc(const Args& a) {
  const dim3 grid((a.sk + kTcKeys - 1) / kTcKeys, a.num_heads, a.b);
  const size_t smem = TcLayout(a.d, a.dv_).total;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_tc_kernel<CW, JPW, QT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_tc_kernel<CW, JPW, QT><<<grid, kTcThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const uint8_t*>(a.key_valid), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta), static_cast<float*>(a.dq),
      static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.sq, a.sk, a.num_heads, a.d, a.dv_, a.scale, a.seed,
      a.drop_threshold, a.inv_keep,
      aligned16<bf16>(a.q, a.d, a.num_heads) && aligned16<bf16>(a.k, a.d, a.num_heads),
      aligned16<bf16>(a.v, a.dv_, a.num_heads) && aligned16<bf16>(a.dout, a.dv_, a.num_heads));
  return (int)cudaGetLastError();
}

int dispatch_tc(const Args& a) {
  if ((a.d > a.dv_ ? a.d : a.dv_) > 512) return (int)cudaErrorInvalidValue;
  const TcPlan p(a.d, a.dv_);
  if (p.jpw == 0) return launch_tc<64, 0, 32>(a);
  if (p.cw == 32) return launch_tc<32, 1, 64>(a);
  if (p.jpw == 1) return launch_tc<64, 1, 64>(a);
  return launch_tc<64, 2, 64>(a);
}

}  // namespace

extern "C" {

int odtt_flash_bwd_abi_version() { return 5; }

// Bytes of dynamic shared memory a block takes at head widths d, dv and an
// operand itemsize of 4 (float32: F32Layout) or 2 (bfloat16: TcLayout), which
// ops/cuda/flash_attention.py::fused_backward_smem_bytes mirrors to plan the
// backward.
long long odtt_flash_bwd_smem_bytes(int d, int dv_, int itemsize) {
  if (itemsize == 2) return (long long)TcLayout(d, dv_).total;
  return (long long)F32Layout(d, dv_).total;
}

// dtype: 0 float32 (tensor cores, 3xTF32), 1 bfloat16 (tensor cores); q,
// k, v, dout, dk, dv in that dtype. key_valid: (B, Sk) bytes or null. lse, delta: (B, h, Sq) float32. dq: (B, Sq, h*d) float32,
// zeroed by the caller. drop_threshold / inv_keep / seed as in the forward.
// Returns cudaGetLastError() after the launch (0 on success).
int odtt_flash_attention_bwd(const void* q, const void* k, const void* v,
                             const void* key_valid, const void* dout, const void* lse,
                             const void* delta, void* dq, void* dk, void* dv, int dtype,
                             int b, int sq, int sk, int num_heads, int d, int dv_,
                             float scale, const long long* seed, unsigned int drop_threshold,
                             float inv_keep, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || num_heads <= 0 || d <= 0 || dv_ <= 0)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, key_valid, dout, lse, delta, dq, dk, dv, b, sq, sk, num_heads, d,
               dv_, scale, seed, drop_threshold, inv_keep, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch_f32(a);
  if (dtype == 1) return dispatch_tc(a);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
