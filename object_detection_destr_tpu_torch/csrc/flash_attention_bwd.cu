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
// Two kernels compute it, chosen by the operand dtype (no fallback between
// them: a bfloat16 call always runs the tensor-core kernel).
//
// bfloat16, flash_bwd_tc_kernel (FlashAttention-2's backward order on
// Hopper's tensor cores). What bounds it on this card: a launch at the
// path's shapes needs 0.4-16 GFLOP, some microseconds of bf16 tensor-core
// work, on 5-40 MB of operands, so bytes bound it; the CUDA-core kernel
// below spent 175-290x that bound on float32 FMAs, shuffles and shared-
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
// float32, flash_bwd_kernel (the CUDA-core kernel; the tensor-core path for
// float32 is later work). Design (FlashAttention-2's backward order,
// simply): grid (ceil(Sk / 32), h, B); a block owns one tile of 32 keys of
// one head and loops over every query row, 8 rows an iteration, one row a
// warp.
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
// cores' arithmetic and the dQ atomics, not bytes.

#include <math.h>

#include "flash_common.cuh"
#include "philox.cuh"
#include "tensor_core.cuh"

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
    int sq, int sk, int num_heads, int d, int dvw, float scale,
    const long long* __restrict__ seed_ptr, uint32_t drop_threshold, float inv_keep, bool vec_k, bool vec_v) {
  const uint32_t seed = philox::load_seed(seed_ptr, drop_threshold);
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

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

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

int odtt_flash_bwd_abi_version() { return 4; }

// Bytes of dynamic shared memory a block takes at head widths d, dv and an
// operand itemsize of 4 (float32: Layout) or 2 (bfloat16: TcLayout), which
// ops/cuda/flash_attention.py::fused_backward_smem_bytes mirrors to plan the
// backward.
long long odtt_flash_bwd_smem_bytes(int d, int dv_, int itemsize) {
  if (itemsize == 2) return (long long)TcLayout(d, dv_).total;
  return (long long)Layout(d, dv_, (size_t)itemsize).total;
}

// dtype: 0 float32 (CUDA cores), 1 bfloat16 (tensor cores; q, k, v, dout,
// dk, dv). key_valid: (B, Sk) bytes or null. lse, delta: (B, h, Sq) float32. dq: (B, Sq, h*d) float32,
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
  if (dtype == 0) return dispatch<float>(a);
  if (dtype == 1) return dispatch_tc(a);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
