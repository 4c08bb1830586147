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
//   dQ_i  = scale * sum_j ds_ij k_j                        (dq pass)
//   dK_j  = scale * sum_i ds_ij q_i;  dV_j = sum_i keep_ij / (1 - rate) p_ij dO_i
//                                                          (dkv pass)
// delta_i = <dO_i, O_i> comes from the wrapper, as _delta_packed (l.973)
// computes it outside the Pallas kernels (the unpacked Pallas kernels
// recompute it per tile; the value is the same). Every kernel here takes
// each operand's (batch, head, row) element strides, so the packed (B, S,
// h*d) and the unpacked (B, h, S, d) layouts launch the same code, and
// writes each gradient once, in the input dtype, with no atomics and no
// order of summation that depends on scheduling: both layouts give the
// same bits.
//
// Four tensor-core kernels compute it, chosen by the operand dtype and the
// head widths (two_pass_plan; no fallback between them or to the plain
// version): in each dtype one whose block holds all of d + dv, and a wide
// class past it that splits the gradient's columns across grid.y.
//
// bfloat16, flash_two_pass_tc_kernel (both passes, one template). What bounds
// it on this card: at the wide cross-attention (B 16, Sq 600, Sk 400, one
// head, d 1024, dv 512) a pass needs 20-24 GFLOP of bf16 tensor-core work
// and moves about 79 MB, about 0.024 ms either way; the CUDA-core kernels
// it replaced spent 390-530x that on float32 FMAs and warp shuffles. Why two
// passes: the hidden-512 cross-attention's float32 dK / dV accumulators (32
// keys x 1536 columns, 196 KB) do not fit beside its K / V tile in the 227 KB
// a block can have (#2's layout). The design, the same for both passes with
// the roles of queries and keys swapped:
//   * a block owns 16 rows of one (batch, head): keys in the dkv pass, query
//     rows in the dq pass. Each warp reads its A fragments of their K and V
//     (dkv) or q and dO (dq) rows into registers once; the other side's rows
//     (q and dO, or K and V) stream through a 2-stage cp.async ring, 32 rows
//     a stage (16 where d + dv > 1536), all columns, rows padded by 16 bytes
//     (tc::kPad) against bank conflicts, so the next tile's load overlaps
//     this one's math;
//   * the gradient's columns are split across the block's 8 warps, not
//     across grid.y: a warp owns 16-column jobs round robin (dK, then dV
//     columns), and its float32 accumulators stay in registers (96 a thread
//     at the wide site: dK 1024 + dV 512 columns / 8 warps). So S and dP of
//     a (row, key) pair are computed once a pass and its Philox bits drawn
//     once a pass: two draws an element in all, one in each kernel, against
//     one for every column chunk if the chunks went across grid.y;
//   * S = Q K^T and dP = dO V^T of a 16 x 32 tile by mma.sync m16n8k16 (bf16
//     operands: exact products, float32 sums), split over d and dv across
//     the 8 warps in runs of 16-column k-steps; the partial tiles meet in
//     shared memory and each of the 256 threads sums its pairs' partials in
//     warp order, so the sums do not depend on scheduling;
//   * the same thread applies scale, the mask, p = exp(s - lse) (1/Sk in a
//     fully masked row), the keep bit of (row, key), P keep / (1 - rate) and
//     dS = p (dP keep / (1 - rate) - delta) scale, and stores each float32
//     value as a bf16 pair hi = bf16(x), lo = bf16(x - hi), so the gradient
//     products keep it to about 2^-16 as _dkv_kernel_packed (l.826) and
//     _dq_kernel_packed (l.778) keep it in float32;
//   * dK += dS^T Q, dV += (P keep)^T dO (dkv) or dQ += dS K (dq): A operand
//     the hi / lo tile by ldmatrix, B operand the streamed tile by
//     ldmatrix.trans, two mmas a product;
//   * a width that is not a multiple of 16 is zero-padded in shared memory
//     (tc::load_rows); 16-byte cp.async where every row is 16-byte aligned,
//     element copies otherwise.
// With one block of 8 warps an SM (the accumulators' and A fragments'
// registers), the kernel is bound by the latency of its dependent mma and
// ldmatrix chains, not by either bound above. Its widest class ends at d +
// dv = 2048; wider heads (hidden 1024's cross-attention, d 2048, dv 1024)
// run flash_two_pass_tc_wide_kernel, which splits the gradient's columns
// across grid.y (its comment says why and what it costs).
//
// float32, flash_two_pass_f32_kernel (3xTF32 on the tensor cores: every
// product is three mma.sync m16n8k8 tf32 products of the operands' big and
// small halves, split by truncation as in flash_bwd_f32_kernel of
// flash_attention_bwd.cu, relative error about 1e-6 against float32). The
// CUDA-core kernels it replaced (a warp per own row, dot products by
// reduce-scatters) spent 73x (dq) and 84x (dkv) their bounds at hidden 512's
// cross-attention on float32 FMAs and shuffles. The bfloat16 kernel's
// structure with float32's operands, which take twice the bytes:
//   * a block of 8 warps owns 16 rows; their d- and dv-wide rows sit in
//     shared memory in float32, split into tf32 halves as fragments are read
//     (16 x 1536 columns, 99 KB at the wide cross site: as tf32 halves in
//     registers they would take 192 a thread beside the 96 accumulators; as
//     float32 fragments, with dK and dV in separate blocks, 96 beside 64,
//     they spilled and ran 2x slower: artifacts/port_f32_two_pass_r1/design2.py);
//     the other side's rows stream through a 2-stage cp.async ring of 8 rows
//     a stage, all columns (another 99 KB; stages of 16 rows would pass the
//     227 KB a block has at that site), 208 KB in all;
//   * S and dP of the 16 x 8 tile (one m16n8 tile): warp w sums an eighth of
//     d's and of dv's k-steps, each 64-column chunk in three fresh
//     accumulators added in IEEE float32 (tc::mma_abt_3xtf32: the tensor
//     cores' float32 sums are not round-to-nearest, so mma chains stay
//     short); the 16 partial tiles meet in shared memory, and 128 threads
//     each sum one pair's in warp order and turn it into dS and P keep
//     (pair_grad), kept in float32 in shared memory;
//   * the gradient's columns go round robin over the warps as 8-column jobs
//     (dK, then dV columns; or dQ): a job's product over a stage is one
//     k-step of 8 streamed rows, three mma into fresh registers, added in
//     IEEE float32 to its accumulators in registers (96 a thread at the wide
//     cross site: 1536 columns x 16 rows / 256 threads).
// What bounds it: neither bound; at hidden 512's cross site it runs at 10-12x
// its operations bound, and with both mma steps switched off 60 % of its
// time stays (artifacts/port_f32_two_pass_r1/variants.py): each stage's
// loads, three barriers and the pair step, with one block an SM.
// Its classes end at d / 8 + dv / 8 = 192 k-steps (24 jobs a warp, hidden
// 512's cross site); wider heads run flash_two_pass_f32_wide_kernel, the
// bfloat16 wide kernel's column slices in 3xTF32.
//
// two_pass_plan picks the kernel for every pass, dtype and width.

#include <math.h>

#include "flash_common.cuh"
#include "philox.cuh"
#include "tensor_core.cuh"

namespace {

using namespace flash;

constexpr float kFullyMaskedLse = -5e8f;  // below any row with a valid key

struct Params {
  const void *q, *k, *v, *dout;
  const uint8_t* key_valid;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  Strides sq_, sk_, sv_, so_;  // q / dq, k / dk, v / dv, dout
  int b, sq, sk, num_heads, d, dv_;
  float scale;
  const long long* seed;  // device memory
  uint32_t drop_threshold;
  float inv_keep;
  // 16-byte tile loads of the block's own operands (vec_a) and of the
  // streamed ones (vec_b)
  bool vec_a, vec_b;
};

// p and the scaled ds of one (query row, key) pair; `state` 1 valid key,
// 0 masked key. Returns ds * scale; writes the dropped probability to pd.
__device__ __forceinline__ float pair_grad(const Params& a, int state, float dot, float dp,
                                           float lse_i, float delta_i, uint32_t seed, uint32_t bh,
                                           int row, int key, float& pd) {
  const float s = state == 0 ? kMaskedLogit : dot * a.scale;
  // a fully masked row's lse (-1e9 + log Sk) rounds to -1e9 in float32: its
  // probabilities are the uniform 1/Sk the forward used
  const float p = lse_i < kFullyMaskedLse ? 1.f / (float)a.sk : expf(s - lse_i);
  float dpk = dp;
  pd = p;
  if (a.drop_threshold != 0u) {
    const bool keep = philox::bits(seed, bh, (uint32_t)row, (uint32_t)key) >= a.drop_threshold;
    pd = keep ? p * a.inv_keep : 0.f;
    dpk = keep ? dp * a.inv_keep : 0.f;
  }
  return state == 1 ? p * (dpk - delta_i) * a.scale : 0.f;
}

// ---- bfloat16 on the tensor cores
using bf16 = __nv_bfloat16;
constexpr int kTcRows = 16;  // own rows a block
constexpr int kTcWarps = 8;
constexpr int kTcThreads = kTcWarps * kWarp;
constexpr int kTcSlots = kTcWarps + 1;  // partial S / dP tiles: one a warp, two for the warp at the S / dP seam

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Streamed rows a stage for KPW k-steps a warp: 32, or 16 where two stages
// of 32 rows would not fit (d + dv above 1536).
__host__ __device__ constexpr int tc_stream_rows(int kpw) { return kpw <= 12 ? 32 : 16; }

// Shared-memory layout, in bytes from the start: 2 stages of the streamed
// rows' d-wide and dv-wide tiles (stage 1 first holds the own rows, read
// once into registers), the warps' partial S and dP tiles (float32) and the
// hi / lo tiles of dS and P keep (own x streamed).
struct TcLayout {
  int s1, s2, ps;  // element strides of the d-wide, the dv-wide and the hi / lo tiles
  size_t x1, x2, part, hilo, total;
  __host__ __device__ TcLayout(int d, int dv, int tr) {
    s1 = round_up(d, 16) + tc::kPad;
    s2 = round_up(dv, 16) + tc::kPad;
    ps = tr + tc::kPad;
    x1 = 0;
    x2 = x1 + 2 * 2 * (size_t)tr * s1;
    part = x2 + 2 * 2 * (size_t)tr * s2;
    hilo = part + sizeof(float) * kTcSlots * kTcRows * tr;
    total = hilo + 2 * 4 * kTcRows * ps;
  }
};

// DKV: the dkv pass (own rows are keys; streamed, query rows) or the dq pass
// (own rows are query rows; streamed, keys). KPW: the most k-steps of S and
// dP a warp takes, and the most 16-column gradient jobs it holds.
template <bool DKV, int KPW>
__global__ void __launch_bounds__(kTcThreads) flash_two_pass_tc_kernel(Params a) {
  const uint32_t seed = philox::load_seed(a.seed, a.drop_threshold);
  constexpr int TR = tc_stream_rows(KPW);  // streamed rows an iteration
  constexpr int kEpt = kTcRows * TR / kTcThreads;  // (own, streamed) pairs a thread
  extern __shared__ __align__(16) unsigned char smem[];
  const TcLayout L(a.d, a.dv_, TR);
  bf16* x1_s = reinterpret_cast<bf16*>(smem + L.x1);  // 2 stages, d wide: q (dkv) or K (dq)
  bf16* x2_s = reinterpret_cast<bf16*>(smem + L.x2);  // 2 stages, dv wide: dO or V
  float* part = reinterpret_cast<float*>(smem + L.part);  // [slot][own][streamed]
  bf16* ds_hi = reinterpret_cast<bf16*>(smem + L.hilo);   // (own, streamed) each
  bf16* ds_lo = ds_hi + kTcRows * L.ps;
  bf16* pd_hi = ds_lo + kTcRows * L.ps;
  bf16* pd_lo = pd_hi + kTcRows * L.ps;

  const bf16* a1 = static_cast<const bf16*>(DKV ? a.k : a.q);  // own rows, d wide
  const bf16* a2 = static_cast<const bf16*>(DKV ? a.v : a.dout);  // own rows, dv wide
  const bf16* x1 = static_cast<const bf16*>(DKV ? a.q : a.k);
  const bf16* x2 = static_cast<const bf16*>(DKV ? a.dout : a.v);
  const Strides sa1 = DKV ? a.sk_ : a.sq_, sa2 = DKV ? a.sv_ : a.so_;
  const Strides sx1 = DKV ? a.sq_ : a.sk_, sx2 = DKV ? a.so_ : a.sv_;
  const int n_own = DKV ? a.sk : a.sq, n_str = DKV ? a.sq : a.sk;

  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int g = lane / 4, t = lane % 4;
  const int own0 = blockIdx.x * kTcRows;
  const int hh = blockIdx.y, bi = blockIdx.z;
  const uint32_t bh = (uint32_t)(bi * a.num_heads + hh);
  const long stat0 = ((long)bi * a.num_heads + hh) * a.sq;
  const int nd16 = (a.d + 15) / 16, ndv16 = (a.dv_ + 15) / 16;
  const int ksteps = nd16 + ndv16;              // S over d, then dP over dv
  const int jobs = DKV ? ksteps : nd16;         // 16-column jobs: dK then dV, or dQ
  const int n_it = (n_str + TR - 1) / TR;
  // this warp's k-steps [j0, j1); the partial slots: S of warps [0, n_s), dP
  // of warps [w_dp, ...) in slots n_s + (w - w_dp)
  const int j0 = min(warp * KPW, ksteps), j1 = min(j0 + KPW, ksteps);
  const int n_s = (nd16 + KPW - 1) / KPW, w_dp = nd16 / KPW;
  const int n_dp = (ksteps + KPW - 1) / KPW - w_dp;

  // the own rows through stage 1, then this warp's A fragments into registers
  tc::load_rows<kTcThreads>(x1_s + TR * L.s1, L.s1, a1 + sa1.off(bi, hh, own0), sa1.s, kTcRows, n_own - own0,
                            a.d, a.vec_a);
  tc::load_rows<kTcThreads>(x2_s + TR * L.s2, L.s2, a2 + sa2.off(bi, hh, own0), sa2.s, kTcRows, n_own - own0,
                            a.dv_, a.vec_a);
  tc::cp_async_commit();
  auto load = [&](int it) {
    const int r0 = it * TR, slot = it & 1;
    tc::load_rows<kTcThreads>(x1_s + slot * TR * L.s1, L.s1, x1 + sx1.off(bi, hh, r0), sx1.s, TR, n_str - r0,
                              a.d, a.vec_b);
    tc::load_rows<kTcThreads>(x2_s + slot * TR * L.s2, L.s2, x2 + sx2.off(bi, hh, r0), sx2.s, TR, n_str - r0,
                              a.dv_, a.vec_b);
    tc::cp_async_commit();
  };
  load(0);
  tc::cp_async_wait<1>();
  __syncthreads();
  uint32_t af[KPW][4];
#pragma unroll
  for (int i = 0; i < KPW; ++i) {
    const int j = j0 + i;
    if (j >= j1) break;
    if (j < nd16)
      tc::load_a(af[i], x1_s + TR * L.s1, L.s1, 0, 16 * j, lane);
    else
      tc::load_a(af[i], x2_s + TR * L.s2, L.s2, 0, 16 * (j - nd16), lane);
  }

  // this thread's pairs of every tile: own rows r + 8 q (TR 32) or r, streamed row c
  const int c = threadIdx.x % TR, r = threadIdx.x / TR;
  auto key_state = [&](int key) {  // 1 valid, 0 masked, -1 past Sk
    return key >= a.sk ? -1 : (a.key_valid == nullptr ? 1 : (a.key_valid[(long)bi * a.sk + key] != 0));
  };
  // per query row: lse and delta; per key: its state. The own rows' once, the
  // streamed row's one tile ahead, so the loads' latency hides behind a tile
  float own_lse[kEpt], own_delta[kEpt];
  int own_state[kEpt];
#pragma unroll
  for (int q = 0; q < kEpt; ++q) {
    const int own = own0 + r + (kTcThreads / TR) * q;
    own_state[q] = DKV ? key_state(own) : 1;
    own_lse[q] = !DKV && own < a.sq ? a.lse[stat0 + own] : 0.f;
    own_delta[q] = !DKV && own < a.sq ? a.delta[stat0 + own] : 0.f;
  }
  float nx_lse = 0.f, nx_delta = 0.f;
  int nx_state = 1;
  auto fetch = [&](int it) {
    const int str = it * TR + c;
    if (DKV) {
      nx_lse = str < a.sq ? a.lse[stat0 + str] : 0.f;
      nx_delta = str < a.sq ? a.delta[stat0 + str] : 0.f;
    } else {
      nx_state = key_state(str);
    }
  };
  fetch(0);

  float acc[KPW][2][4];
#pragma unroll
  for (int i = 0; i < KPW; ++i)
#pragma unroll
    for (int n = 0; n < 2; ++n) acc[i][n][0] = acc[i][n][1] = acc[i][n][2] = acc[i][n][3] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    tc::cp_async_wait<0>();
    __syncthreads();  // tile it has landed; the other stage and the hi / lo tiles are free
    const float lse_c = nx_lse, delta_c = nx_delta;
    const int state_c = nx_state;
    if (it + 1 < n_it) {
      load(it + 1);
      fetch(it + 1);
    }
    const bf16* xs1 = x1_s + (it & 1) * TR * L.s1;
    const bf16* xs2 = x2_s + (it & 1) * TR * L.s2;

    // 1. partial S (own x streamed) over this warp's k-steps of d, then dP of dv
    float tp[TR / 8][4];
    auto zero = [&]() {
#pragma unroll
      for (int n = 0; n < TR / 8; ++n) tp[n][0] = tp[n][1] = tp[n][2] = tp[n][3] = 0.f;
    };
    auto store = [&](int slot) {
#pragma unroll
      for (int n = 0; n < TR / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; e += 2)
          *reinterpret_cast<float2*>(part + (slot * kTcRows + g + 4 * e) * TR + 8 * n + 2 * t) =
              make_float2(tp[n][e], tp[n][e + 1]);
    };
    zero();
#pragma unroll
    for (int i = 0; i < KPW; ++i) {
      const int j = j0 + i;
      if (j >= j1) break;
      if (j == nd16 && i > 0) {  // the seam: this warp's S is complete
        store(warp);
        zero();
      }
      const bool is_s = j < nd16;
#pragma unroll
      for (int n2 = 0; n2 < TR / 16; ++n2) {
        uint32_t bb[4];
        if (is_s)
          tc::load_b_rows(bb, xs1, L.s1, 16 * n2, 16 * j, lane);
        else
          tc::load_b_rows(bb, xs2, L.s2, 16 * n2, 16 * (j - nd16), lane);
        tc::mma(tp[2 * n2], af[i], bb[0], bb[1]);
        tc::mma(tp[2 * n2 + 1], af[i], bb[2], bb[3]);
      }
    }
    if (j0 < j1) store(j1 - 1 < nd16 ? warp : n_s + warp - w_dp);
    __syncthreads();

    // 2. this thread's pairs: the sums in warp order, p, the keep bit, dS, P keep
#pragma unroll
    for (int q = 0; q < kEpt; ++q) {
      const int e = threadIdx.x + kTcThreads * q;
      float dot = 0.f, dp = 0.f;
      for (int w = 0; w < n_s; ++w) dot += part[w * kTcRows * TR + e];
      for (int w = 0; w < n_dp; ++w) dp += part[(n_s + w) * kTcRows * TR + e];
      const int own = own0 + r + (kTcThreads / TR) * q, str = it * TR + c;
      const int row = DKV ? str : own, key = DKV ? own : str;
      const int state = DKV ? own_state[q] : state_c;
      float pd = 0.f, ds = 0.f;
      if (state >= 0 && row < a.sq)
        ds = pair_grad(a, state, dot, dp, DKV ? lse_c : own_lse[q], DKV ? delta_c : own_delta[q], seed, bh, row,
                       key, pd);
      const int at = (r + (kTcThreads / TR) * q) * L.ps + c;
      const bf16 dsh = __float2bfloat16(ds);
      ds_hi[at] = dsh;
      ds_lo[at] = __float2bfloat16(ds - __bfloat162float(dsh));
      if (DKV) {
        const bf16 pdh = __float2bfloat16(pd);
        pd_hi[at] = pdh;
        pd_lo[at] = __float2bfloat16(pd - __bfloat162float(pdh));
      }
    }
    __syncthreads();

    // 3. this warp's jobs: dK += dS^T q and dV += (P keep)^T dO, or dQ += dS K;
    // A: the hi / lo tile of dS, then of P keep from the first dV job on
    uint32_t ah[TR / 16][4], al[TR / 16][4];
#pragma unroll
    for (int kh = 0; kh < TR / 16; ++kh) {
      tc::load_a(ah[kh], ds_hi, L.ps, 0, 16 * kh, lane);
      tc::load_a(al[kh], ds_lo, L.ps, 0, 16 * kh, lane);
    }
    bool on_p = false;
#pragma unroll
    for (int i = 0; i < KPW; ++i) {
      const int job = warp + kTcWarps * i;
      if (job >= jobs) break;
      const bool first = job < nd16;  // dK or dQ columns; else dV columns
      if (!first && !on_p) {
        on_p = true;
#pragma unroll
        for (int kh = 0; kh < TR / 16; ++kh) {
          tc::load_a(ah[kh], pd_hi, L.ps, 0, 16 * kh, lane);
          tc::load_a(al[kh], pd_lo, L.ps, 0, 16 * kh, lane);
        }
      }
      uint32_t bb[TR / 16][4];
#pragma unroll
      for (int kh = 0; kh < TR / 16; ++kh) {
        if (first)
          tc::load_b_cols(bb[kh], xs1, L.s1, 16 * kh, 16 * job, lane);
        else
          tc::load_b_cols(bb[kh], xs2, L.s2, 16 * kh, 16 * (job - nd16), lane);
      }
#pragma unroll
      for (int kh = 0; kh < TR / 16; ++kh) {
        tc::mma(acc[i][0], ah[kh], bb[kh][0], bb[kh][1]);
        tc::mma(acc[i][1], ah[kh], bb[kh][2], bb[kh][3]);
      }
#pragma unroll
      for (int kh = 0; kh < TR / 16; ++kh) {
        tc::mma(acc[i][0], al[kh], bb[kh][0], bb[kh][1]);
        tc::mma(acc[i][1], al[kh], bb[kh][2], bb[kh][3]);
      }
    }
  }

  // each gradient element written once, in bfloat16
  bf16* g1 = static_cast<bf16*>(DKV ? a.dk : a.dq);
  bf16* g2 = static_cast<bf16*>(a.dv);
  const Strides sg1 = DKV ? a.sk_ : a.sq_;
#pragma unroll
  for (int i = 0; i < KPW; ++i) {
    const int job = warp + kTcWarps * i;
    if (job >= jobs) break;
    const bool first = job < nd16;
    const int col0 = 16 * (first ? job : job - nd16), width = first ? a.d : a.dv_;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int orow = own0 + g + 8 * (e >> 1), col = col0 + 8 * n + 2 * t + (e & 1);
        if (orow >= n_own || col >= width) continue;
        const float x = acc[i][n][e];
        if (first)
          g1[sg1.off(bi, hh, orow) + col] = __float2bfloat16(x);
        else
          g2[a.sv_.off(bi, hh, orow) + col] = __float2bfloat16(x);
      }
  }
}

// ---- bfloat16 on the tensor cores, the wide class: column slices across grid.y
constexpr int kWideTR = 64;                          // streamed rows an iteration: 8 a warp
constexpr int kWideCols = 128;                       // columns a stage
constexpr int kWideChunks = 8;                       // stages of gradient columns a slice
constexpr int kWideSlice = kWideChunks * kWideCols;  // gradient columns a block
constexpr int kWideStride = kWideCols + tc::kPad;
constexpr int kWideSlot = (kTcRows + kWideTR) * kWideStride;  // a stage: 16 own rows, then the streamed rows
constexpr int kWidePs = kWideTR + tc::kPad;
// Shared memory of the wide kernel, in bytes: a 2-slot ring and the hi / lo
// tiles of the slice's gradient factor (dS or P keep). No width enters it.
__host__ __device__ constexpr int tc_wide_smem() { return 2 * 2 * kWideSlot + 2 * 2 * kTcRows * kWidePs; }

// Where flash_two_pass_tc_kernel's widest class (KPW 16) ends, d + dv above
// 2048 (the hidden-1024 cross-attention: d 2048, dv 1024, KPW 24): there its
// accumulators (192 a thread) and A fragments (96) pass the 255 registers a
// thread has, and at hidden 2048 (d 4096, dv 2048) two 16-row stages of all
// columns (394 KB) pass 227 KB. This kernel splits the gradient's columns
// across grid.y instead of staging the accumulators in shared memory, which
// would have to hold 16 x 3072 float32 (196 KB) beside the tiles at that
// site and twice that at hidden 2048; a slice's shared memory does not grow
// with the widths, so every width has a plan. A block owns 16 rows (keys in
// the dkv pass, query rows in the dq pass) and one slice of at most 1024
// gradient columns: of dK or dQ (slices 0..n1-1, whose factor is dS, so
// they need S and dP) or of dV (the dkv pass's slices n1.., factor P keep,
// so S alone). An iteration takes 64 streamed rows in steps through one
// 2-slot cp.async ring, each step 128 columns:
//   1. S (then dP) of the 16 x 64 tile over d (then dv): each step stages
//      the own rows' and the streamed rows' 128 columns; warp w owns streamed
//      rows 8w..8w+7 and keeps their S and dP fragments in registers over
//      all the steps, so no partial sum crosses warps;
//   2. after the last such step each thread turns its 4 pairs into the
//      slice's factor (pair_grad: p, the keep bit of (row, key), dS or P
//      keep), stored as a bf16 hi / lo pair, and every warp reads the 16 x 64
//      hi / lo A fragments;
//   3. each later step stages the streamed rows' next 128 columns of the
//      slice; warp w adds hi and lo times columns 16w..16w+15 into its float32
//      accumulators (64 a thread for a 1024-column slice).
// Each slice recomputes S (and dP) over all of d (and dv): at d 2048, dv
// 1024 the dkv pass's three slices do 2.7x one pass's S and dP products and
// the dq pass's two 2x. The keep bit is a function of (seed, b*h + head,
// row, key) alone, so every slice draws the same mask; every sum runs in a
// fixed order and nothing is atomic, so both layouts still give the same
// bits.
template <bool DKV>
__global__ void __launch_bounds__(kTcThreads) flash_two_pass_tc_wide_kernel(Params a, int n1, int n_sl) {
  const uint32_t seed = philox::load_seed(a.seed, a.drop_threshold);
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);  // [2][16 + 64][kWideStride]
  bf16* f_hi = ring + 2 * kWideSlot;           // (own, streamed) each
  bf16* f_lo = f_hi + kTcRows * kWidePs;

  const bf16* a1 = static_cast<const bf16*>(DKV ? a.k : a.q);  // own rows, d wide
  const bf16* a2 = static_cast<const bf16*>(DKV ? a.v : a.dout);  // own rows, dv wide
  const bf16* x1 = static_cast<const bf16*>(DKV ? a.q : a.k);
  const bf16* x2 = static_cast<const bf16*>(DKV ? a.dout : a.v);
  const Strides sa1 = DKV ? a.sk_ : a.sq_, sa2 = DKV ? a.sv_ : a.so_;
  const Strides sx1 = DKV ? a.sq_ : a.sk_, sx2 = DKV ? a.so_ : a.sv_;
  const int n_own = DKV ? a.sk : a.sq, n_str = DKV ? a.sq : a.sk;

  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int g = lane / 4, t = lane % 4;
  const int own0 = blockIdx.x * kTcRows;
  const int hh = blockIdx.y / n_sl, sl = blockIdx.y - hh * n_sl, bi = blockIdx.z;
  const bool first = sl < n1;  // dK or dQ columns; else dV columns
  const int col0 = (first ? sl : sl - n1) * kWideSlice;
  const int sw = min(kWideSlice, (first ? a.d : a.dv_) - col0);
  const bf16* xg = (first ? x1 : x2) + col0;
  const Strides sxg = first ? sx1 : sx2;
  const uint32_t bh = (uint32_t)(bi * a.num_heads + hh);
  const long stat0 = ((long)bi * a.num_heads + hh) * a.sq;
  const int nd = (a.d + kWideCols - 1) / kWideCols;
  const int n1c = nd + (first ? (a.dv_ + kWideCols - 1) / kWideCols : 0);  // steps of S and dP
  const int n_step = n1c + (sw + kWideCols - 1) / kWideCols;                // ... and of the slice
  const int total = (n_str + kWideTR - 1) / kWideTR * n_step;

  auto load = [&](int s) {
    const int it = s / n_step, j = s - it * n_step, r0 = it * kWideTR;
    bf16* slot = ring + (s & 1) * kWideSlot;
    bf16* str_s = slot + kTcRows * kWideStride;
    if (j < n1c) {
      const bool is_s = j < nd;
      const int c = (is_s ? j : j - nd) * kWideCols, cw = min(kWideCols, (is_s ? a.d : a.dv_) - c);
      const Strides so = is_s ? sa1 : sa2, sx = is_s ? sx1 : sx2;
      tc::load_rows<kTcThreads>(slot, kWideStride, (is_s ? a1 : a2) + so.off(bi, hh, own0) + c, so.s, kTcRows,
                                n_own - own0, cw, a.vec_a);
      tc::load_rows<kTcThreads>(str_s, kWideStride, (is_s ? x1 : x2) + sx.off(bi, hh, r0) + c, sx.s, kWideTR,
                                n_str - r0, cw, a.vec_b);
    } else {
      const int c = (j - n1c) * kWideCols;
      tc::load_rows<kTcThreads>(str_s, kWideStride, xg + sxg.off(bi, hh, r0) + c, sxg.s, kWideTR, n_str - r0,
                                min(kWideCols, sw - c), a.vec_b);
    }
    tc::cp_async_commit();
  };

  auto key_state = [&](int key) {  // 1 valid, 0 masked, -1 past Sk
    return key >= a.sk ? -1 : (a.key_valid == nullptr ? 1 : (a.key_valid[(long)bi * a.sk + key] != 0));
  };
  // own rows g and g + 8: key states (dkv) or lse and delta (dq); the
  // streamed rows 8 warp + 2t (+1) of an iteration: the other, fetched at
  // its first step so the loads' latency hides behind the S steps
  int own_state[2], str_state[2] = {1, 1};
  float own_lse[2], own_delta[2], str_lse[2] = {0.f, 0.f}, str_delta[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int own = own0 + g + 8 * r;
    own_state[r] = DKV ? key_state(own) : 1;
    own_lse[r] = !DKV && own < a.sq ? a.lse[stat0 + own] : 0.f;
    own_delta[r] = !DKV && own < a.sq ? a.delta[stat0 + own] : 0.f;
  }

  float s_acc[4], p_acc[4];
  uint32_t ah[kWideTR / 16][4], al[kWideTR / 16][4];
  float acc[kWideChunks][2][4];
#pragma unroll
  for (int i = 0; i < kWideChunks; ++i)
#pragma unroll
    for (int n = 0; n < 2; ++n) acc[i][n][0] = acc[i][n][1] = acc[i][n][2] = acc[i][n][3] = 0.f;

  load(0);
  for (int s = 0; s < total; ++s) {
    tc::cp_async_wait<0>();
    __syncthreads();  // step s has landed; the other slot is free
    if (s + 1 < total) load(s + 1);
    const int it = s / n_step, j = s - it * n_step;
    const bf16* slot = ring + (s & 1) * kWideSlot;
    const bf16* str_s = slot + kTcRows * kWideStride;
    if (j == 0) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s_acc[e] = p_acc[e] = 0.f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int str = it * kWideTR + 8 * warp + 2 * t + e;
        if (DKV) {
          str_lse[e] = str < a.sq ? a.lse[stat0 + str] : 0.f;
          str_delta[e] = str < a.sq ? a.delta[stat0 + str] : 0.f;
        } else {
          str_state[e] = key_state(str);
        }
      }
    }
    if (j < n1c) {  // 1. S or dP of this warp's 8 streamed rows over the step's columns
      const bool is_s = j < nd;
      const int cw = min(kWideCols, (is_s ? a.d : a.dv_) - (is_s ? j : j - nd) * kWideCols);
#pragma unroll
      for (int kk = 0; kk < kWideCols / 16; ++kk) {
        if (kk * 16 >= cw) break;
        uint32_t af[4], bb[2];
        tc::load_a(af, slot, kWideStride, 0, 16 * kk, lane);
        tc::load_b_rows8(bb, str_s, kWideStride, 8 * warp, 16 * kk, lane);
        if (is_s)
          tc::mma(s_acc, af, bb[0], bb[1]);
        else
          tc::mma(p_acc, af, bb[0], bb[1]);
      }
    }
    if (j == n1c - 1) {  // 2. the slice's factor of this thread's pairs, as hi / lo bf16
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int own_r = g + 8 * (e >> 1), str_c = 8 * warp + 2 * t + (e & 1);
        const int own = own0 + own_r, str = it * kWideTR + str_c;
        const int row = DKV ? str : own, key = DKV ? own : str;
        const int state = DKV ? own_state[e >> 1] : str_state[e & 1];
        float pd = 0.f, ds = 0.f;
        if (state >= 0 && row < a.sq)
          ds = pair_grad(a, state, s_acc[e], p_acc[e], DKV ? str_lse[e & 1] : own_lse[e >> 1],
                         DKV ? str_delta[e & 1] : own_delta[e >> 1], seed, bh, row, key, pd);
        const float x = first ? ds : pd;
        const bf16 hi = __float2bfloat16(x);
        f_hi[own_r * kWidePs + str_c] = hi;
        f_lo[own_r * kWidePs + str_c] = __float2bfloat16(x - __bfloat162float(hi));
      }
      __syncthreads();
#pragma unroll
      for (int kh = 0; kh < kWideTR / 16; ++kh) {
        tc::load_a(ah[kh], f_hi, kWidePs, 0, 16 * kh, lane);
        tc::load_a(al[kh], f_lo, kWidePs, 0, 16 * kh, lane);
      }
    }
    if (j >= n1c) {  // 3. this warp's 16 columns of the step: grad += (hi + lo) x
      const int gc = j - n1c;
      if (gc * kWideCols + 16 * warp < sw) {
        uint32_t bb[kWideTR / 16][4];
#pragma unroll
        for (int kh = 0; kh < kWideTR / 16; ++kh) tc::load_b_cols(bb[kh], str_s, kWideStride, 16 * kh, 16 * warp, lane);
#pragma unroll
        for (int i = 0; i < kWideChunks; ++i) {
          if (i != gc) continue;
#pragma unroll
          for (int kh = 0; kh < kWideTR / 16; ++kh) {
            tc::mma(acc[i][0], ah[kh], bb[kh][0], bb[kh][1]);
            tc::mma(acc[i][1], ah[kh], bb[kh][2], bb[kh][3]);
          }
#pragma unroll
          for (int kh = 0; kh < kWideTR / 16; ++kh) {
            tc::mma(acc[i][0], al[kh], bb[kh][0], bb[kh][1]);
            tc::mma(acc[i][1], al[kh], bb[kh][2], bb[kh][3]);
          }
        }
      }
    }
  }

  // each gradient element of the slice written once, in bfloat16
  bf16* grad = static_cast<bf16*>(DKV ? (first ? a.dk : a.dv) : a.dq);
  const Strides sg = DKV ? (first ? a.sk_ : a.sv_) : a.sq_;
#pragma unroll
  for (int i = 0; i < kWideChunks; ++i)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int orow = own0 + g + 8 * (e >> 1), col = i * kWideCols + 16 * warp + 8 * n + 2 * t + (e & 1);
        if (orow < n_own && col < sw) grad[sg.off(bi, hh, orow) + col0 + col] = __float2bfloat16(acc[i][n][e]);
      }
}

// ---- float32 on the tensor cores, in 3xTF32
constexpr int kF32TR = 8;           // streamed rows a stage: one n-tile of S, one k-step of the gradient
constexpr int kF32Ps = kF32TR + 4;  // row stride of the dS and P keep tiles: rows g apart hit different banks

// Row stride, in floats, of a float32 tile `w` columns wide: 8 mod 32 words,
// so the float2 reads (rows g, columns 2t..2t+1) of S's fragments and the B
// reads (rows t and t + 4, column g) of the gradient's hit different banks.
__host__ __device__ inline int f32_stride(int w) { return round_up(w, 32) + 8; }

// Shared-memory layout of flash_two_pass_f32_kernel, in bytes from the
// start: the 16 own rows' d-wide and dv-wide tiles, 2 stages of the 8
// streamed rows' (d-wide, then dv-wide), the warps' partial S and dP tiles
// ([S, dP][warp][own][streamed]) and the dS and P keep tiles (own x
// streamed).
struct F32Layout {
  int s1, s2;  // row strides of the d-wide and the dv-wide tiles
  size_t own2, str, part, ds, pd, total;
  __host__ __device__ F32Layout(int d, int dv) {
    s1 = f32_stride(d);
    s2 = f32_stride(dv);
    own2 = sizeof(float) * kTcRows * s1;
    str = own2 + sizeof(float) * kTcRows * s2;
    part = str + sizeof(float) * 2 * kF32TR * (s1 + s2);
    ds = part + sizeof(float) * 2 * kTcWarps * kTcRows * kF32TR;
    pd = ds + sizeof(float) * kTcRows * kF32Ps;
    total = pd + sizeof(float) * kTcRows * kF32Ps;
  }
};

// DKV: the dkv pass (own rows are keys; streamed, query rows) or the dq pass
// (own rows are query rows; streamed, keys). JPW: the most 8-column gradient
// jobs a warp holds.
template <bool DKV, int JPW>
__global__ void __launch_bounds__(kTcThreads) flash_two_pass_f32_kernel(Params a) {
  const uint32_t seed = philox::load_seed(a.seed, a.drop_threshold);
  extern __shared__ __align__(16) unsigned char smem[];
  const F32Layout L(a.d, a.dv_);
  float* own1_s = reinterpret_cast<float*>(smem);
  float* own2_s = reinterpret_cast<float*>(smem + L.own2);
  float* str_s = reinterpret_cast<float*>(smem + L.str);  // 2 stages: 8 d-wide rows, then 8 dv-wide
  float* part = reinterpret_cast<float*>(smem + L.part);  // [S, dP][warp][own][streamed]
  float* ds_s = reinterpret_cast<float*>(smem + L.ds);    // (own, streamed) each
  float* pd_s = reinterpret_cast<float*>(smem + L.pd);

  const float* a1 = static_cast<const float*>(DKV ? a.k : a.q);  // own rows, d wide
  const float* a2 = static_cast<const float*>(DKV ? a.v : a.dout);  // own rows, dv wide
  const float* x1 = static_cast<const float*>(DKV ? a.q : a.k);
  const float* x2 = static_cast<const float*>(DKV ? a.dout : a.v);
  const Strides sa1 = DKV ? a.sk_ : a.sq_, sa2 = DKV ? a.sv_ : a.so_;
  const Strides sx1 = DKV ? a.sq_ : a.sk_, sx2 = DKV ? a.so_ : a.sv_;
  const int n_own = DKV ? a.sk : a.sq, n_str = DKV ? a.sq : a.sk;

  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int g = lane / 4, t = lane % 4;
  const int own0 = blockIdx.x * kTcRows;
  const int hh = blockIdx.y, bi = blockIdx.z;
  const uint32_t bh = (uint32_t)(bi * a.num_heads + hh);
  const long stat0 = ((long)bi * a.num_heads + hh) * a.sq;
  const int nd8 = (a.d + 7) / 8, ndv8 = (a.dv_ + 7) / 8;
  const int jobs = DKV ? nd8 + ndv8 : nd8;  // 8-column jobs: dK then dV, or dQ
  const int n_it = (n_str + kF32TR - 1) / kF32TR;
  const int stage = kF32TR * (L.s1 + L.s2);
  // this warp's columns of S's sum (an eighth of d's k-steps) and of dP's (of dv's)
  const int w1 = (nd8 + kTcWarps - 1) / kTcWarps * 8, w2 = (ndv8 + kTcWarps - 1) / kTcWarps * 8;
  const int c1 = min(warp * w1, 8 * nd8), c2 = min(warp * w2, 8 * ndv8);
  const int n1 = min(c1 + w1, 8 * nd8) - c1, n2 = min(c2 + w2, 8 * ndv8) - c2;

  tc::load_rows_f32<0>(own1_s, L.s1, a1 + sa1.off(bi, hh, own0), sa1.s, kTcRows, n_own - own0, a.d, a.vec_a,
                       threadIdx.x, kTcThreads);
  tc::load_rows_f32<0>(own2_s, L.s2, a2 + sa2.off(bi, hh, own0), sa2.s, kTcRows, n_own - own0, a.dv_, a.vec_a,
                       threadIdx.x, kTcThreads);
  auto load = [&](int it) {
    const int r0 = it * kF32TR;
    float* st = str_s + (it & 1) * stage;
    tc::load_rows_f32<0>(st, L.s1, x1 + sx1.off(bi, hh, r0), sx1.s, kF32TR, n_str - r0, a.d, a.vec_b, threadIdx.x,
                         kTcThreads);
    tc::load_rows_f32<0>(st + kF32TR * L.s1, L.s2, x2 + sx2.off(bi, hh, r0), sx2.s, kF32TR, n_str - r0, a.dv_,
                         a.vec_b, threadIdx.x, kTcThreads);
    tc::cp_async_commit();
  };
  load(0);  // with the own rows: one cp.async group

  // step 2's pairs: thread i < 128 takes own row i / 8 and streamed row i % 8
  // of every stage; its own row's key state (dkv) or lse and delta (dq) once,
  // its streamed row's one stage ahead, so the loads' latency hides
  const bool pairs = threadIdx.x < kTcRows * kF32TR;
  const int pr = threadIdx.x / kF32TR, pc = threadIdx.x % kF32TR, own = own0 + pr;
  auto key_state = [&](int key) {  // 1 valid, 0 masked, -1 past Sk
    return key >= a.sk ? -1 : (a.key_valid == nullptr ? 1 : (a.key_valid[(long)bi * a.sk + key] != 0));
  };
  const int own_state = DKV && pairs ? key_state(own) : 1;
  const float own_lse = !DKV && pairs && own < a.sq ? a.lse[stat0 + own] : 0.f;
  const float own_delta = !DKV && pairs && own < a.sq ? a.delta[stat0 + own] : 0.f;
  float nx_lse = 0.f, nx_delta = 0.f;
  int nx_state = 1;
  auto fetch = [&](int it) {
    if (!pairs) return;
    const int str = it * kF32TR + pc;
    if (DKV) {
      nx_lse = str < a.sq ? a.lse[stat0 + str] : 0.f;
      nx_delta = str < a.sq ? a.delta[stat0 + str] : 0.f;
    } else {
      nx_state = key_state(str);
    }
  };
  fetch(0);

  float acc[JPW][4];
#pragma unroll
  for (int i = 0; i < JPW; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    tc::cp_async_wait<0>();
    __syncthreads();  // stage it has landed; the other stage and the partial, dS and P keep tiles are free
    const float lse_c = nx_lse, delta_c = nx_delta;
    const int state_c = nx_state;
    if (it + 1 < n_it) {
      load(it + 1);
      fetch(it + 1);
    }
    const float* st1 = str_s + (it & 1) * stage;
    const float* st2 = st1 + kF32TR * L.s1;

    // 1. this warp's partial S (own x streamed) over its columns of d, and dP of dv
    float sp[4], dpp[4];
    tc::mma_abt_3xtf32(sp, own1_s + c1, L.s1, st1 + c1, L.s1, n1, g, t);
    tc::mma_abt_3xtf32(dpp, own2_s + c2, L.s2, st2 + c2, L.s2, n2, g, t);
    float* mine = part + (warp * kTcRows + g) * kF32TR + 2 * t;
    float* mine_dp = mine + kTcWarps * kTcRows * kF32TR;
    *reinterpret_cast<float2*>(mine) = make_float2(sp[0], sp[1]);
    *reinterpret_cast<float2*>(mine + 8 * kF32TR) = make_float2(sp[2], sp[3]);
    *reinterpret_cast<float2*>(mine_dp) = make_float2(dpp[0], dpp[1]);
    *reinterpret_cast<float2*>(mine_dp + 8 * kF32TR) = make_float2(dpp[2], dpp[3]);
    __syncthreads();

    // 2. the pairs: the partial sums in warp order, p, the keep bit, dS, P keep
    if (pairs) {
      float dot = 0.f, dp = 0.f;
#pragma unroll
      for (int w = 0; w < kTcWarps; ++w) {
        dot += part[w * kTcRows * kF32TR + threadIdx.x];
        dp += part[(kTcWarps + w) * kTcRows * kF32TR + threadIdx.x];
      }
      const int str = it * kF32TR + pc;
      const int row = DKV ? str : own, key = DKV ? own : str;
      const int state = DKV ? own_state : state_c;
      float pd = 0.f, ds = 0.f;
      if (state >= 0 && row < a.sq)
        ds = pair_grad(a, state, dot, dp, DKV ? lse_c : own_lse, DKV ? delta_c : own_delta, seed, bh, row, key, pd);
      ds_s[pr * kF32Ps + pc] = ds;
      if (DKV) pd_s[pr * kF32Ps + pc] = pd;
    }
    __syncthreads();

    // 3. this warp's jobs: dK += dS^T q and dV += (P keep)^T dO, or dQ += dS K;
    // A: the dS (or P keep) tile, k = the stage's 8 streamed rows; each job's
    // product in fresh registers, added to its accumulators in IEEE float32
    uint32_t sb[4], ss[4], pb[4], ps[4];
    const float* fa = ds_s + g * kF32Ps + t;
    tc::split_a(sb, ss, fa[0], fa[8 * kF32Ps], fa[4], fa[8 * kF32Ps + 4]);
    if (DKV) {
      fa = pd_s + g * kF32Ps + t;
      tc::split_a(pb, ps, fa[0], fa[8 * kF32Ps], fa[4], fa[8 * kF32Ps + 4]);
    }
#pragma unroll
    for (int i = 0; i < JPW; ++i) {
      const int job = warp + kTcWarps * i;
      if (job >= jobs) break;
      float c[1][4] = {};
      if (!DKV || job < nd8)  // dK or dQ columns
        tc::mma_row_3xtf32<1>(c, sb, ss, st1 + t * L.s1 + 8 * job + g, L.s1, 8);
      else
        tc::mma_row_3xtf32<1>(c, pb, ps, st2 + t * L.s2 + 8 * (job - nd8) + g, L.s2, 8);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] += c[0][e];
    }
  }

  // each gradient element written once, in float32
  float* g1 = static_cast<float*>(DKV ? a.dk : a.dq);
  float* g2 = static_cast<float*>(a.dv);
  const Strides sg1 = DKV ? a.sk_ : a.sq_;
#pragma unroll
  for (int i = 0; i < JPW; ++i) {
    const int job = warp + kTcWarps * i;
    if (job >= jobs) break;
    const bool first = !DKV || job < nd8;
    const int col0 = 8 * (first ? job : job - nd8), width = first ? a.d : a.dv_;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int orow = own0 + g + 8 * (e >> 1), col = col0 + 2 * t + (e & 1);
      if (orow >= n_own || col >= width) continue;
      if (first)
        g1[sg1.off(bi, hh, orow) + col] = acc[i][e];
      else
        g2[a.sv_.off(bi, hh, orow) + col] = acc[i][e];
    }
  }
}

// ---- float32 on the tensor cores, the wide class: column slices across grid.y
constexpr int kF32WideStride = kWideCols + 8;  // 8 mod 32 words, as f32_stride
constexpr int kF32WideSlot = (kTcRows + kWideTR) * kF32WideStride;  // a stage: 16 own rows, then the streamed rows
constexpr int kF32WidePs = kWideTR + 4;
// Shared memory of the float32 wide kernel, in bytes: a 2-slot ring and the
// tile of the slice's gradient factor (dS or P keep). No width enters it.
__host__ __device__ constexpr int f32_wide_smem() {
  return (int)sizeof(float) * (2 * kF32WideSlot + kTcRows * kF32WidePs);
}

// Where flash_two_pass_f32_kernel's widest class (JPW 24) ends, d / 8 + dv /
// 8 above 192 (hidden 1024's cross-attention: d 2048, dv 1024): there its
// own rows (16 x 3072 float32, 196 KB) leave no room for a stage and its
// accumulators (192 a thread) pass the registers a thread has. The bfloat16
// wide kernel's scheme (flash_two_pass_tc_wide_kernel, which says what it
// costs) in 3xTF32: a block owns 16 rows and one slice of at most 1024
// gradient columns (of dK or dQ, slices 0..n1-1, factor dS; or of dV, factor
// P keep); an iteration takes 64 streamed rows in 128-column steps through a
// 2-slot cp.async ring, float32 throughout:
//   1. S (then dP) of the 16 x 64 tile: warp w owns streamed rows 8w..8w+7,
//      each step's 128 columns in fresh accumulators (tc::mma_abt_3xtf32)
//      added in IEEE float32 to its S and dP fragments;
//   2. after the last such step each thread turns its 4 pairs into the
//      slice's factor (pair_grad), stored in float32, and every warp splits
//      the 16 x 64 factor's A fragments into tf32 halves in registers;
//   3. each later step stages the streamed rows' next 128 columns of the
//      slice; warp w takes columns 16w..16w+15 over the 64 streamed rows (8
//      k-steps) in three fresh accumulators, one a product kind (8 mma
//      each), added in IEEE float32 to its accumulators (64 a thread).
// Every sum runs in a fixed order and nothing is atomic, so both layouts
// give the same bits.
template <bool DKV>
__global__ void __launch_bounds__(kTcThreads) flash_two_pass_f32_wide_kernel(Params a, int n1, int n_sl) {
  const uint32_t seed = philox::load_seed(a.seed, a.drop_threshold);
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);  // [2][16 + 64][kF32WideStride]
  float* f_s = ring + 2 * kF32WideSlot;          // (own, streamed)

  const float* a1 = static_cast<const float*>(DKV ? a.k : a.q);  // own rows, d wide
  const float* a2 = static_cast<const float*>(DKV ? a.v : a.dout);  // own rows, dv wide
  const float* x1 = static_cast<const float*>(DKV ? a.q : a.k);
  const float* x2 = static_cast<const float*>(DKV ? a.dout : a.v);
  const Strides sa1 = DKV ? a.sk_ : a.sq_, sa2 = DKV ? a.sv_ : a.so_;
  const Strides sx1 = DKV ? a.sq_ : a.sk_, sx2 = DKV ? a.so_ : a.sv_;
  const int n_own = DKV ? a.sk : a.sq, n_str = DKV ? a.sq : a.sk;

  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int g = lane / 4, t = lane % 4;
  const int own0 = blockIdx.x * kTcRows;
  const int hh = blockIdx.y / n_sl, sl = blockIdx.y - hh * n_sl, bi = blockIdx.z;
  const bool first = sl < n1;  // dK or dQ columns; else dV columns
  const int col0 = (first ? sl : sl - n1) * kWideSlice;
  const int sw = min(kWideSlice, (first ? a.d : a.dv_) - col0);
  const float* xg = (first ? x1 : x2) + col0;
  const Strides sxg = first ? sx1 : sx2;
  const uint32_t bh = (uint32_t)(bi * a.num_heads + hh);
  const long stat0 = ((long)bi * a.num_heads + hh) * a.sq;
  const int nd = (a.d + kWideCols - 1) / kWideCols;
  const int n1c = nd + (first ? (a.dv_ + kWideCols - 1) / kWideCols : 0);  // steps of S and dP
  const int n_step = n1c + (sw + kWideCols - 1) / kWideCols;                // ... and of the slice
  const int total = (n_str + kWideTR - 1) / kWideTR * n_step;

  auto load = [&](int s) {
    const int it = s / n_step, j = s - it * n_step, r0 = it * kWideTR;
    float* slot = ring + (s & 1) * kF32WideSlot;
    float* str_s = slot + kTcRows * kF32WideStride;
    if (j < n1c) {
      const bool is_s = j < nd;
      const int c = (is_s ? j : j - nd) * kWideCols, cw = min(kWideCols, (is_s ? a.d : a.dv_) - c);
      const Strides so = is_s ? sa1 : sa2, sx = is_s ? sx1 : sx2;
      tc::load_rows_f32<kWideCols>(slot, kF32WideStride, (is_s ? a1 : a2) + so.off(bi, hh, own0) + c, so.s,
                                   kTcRows, n_own - own0, cw, a.vec_a, threadIdx.x, kTcThreads);
      tc::load_rows_f32<kWideCols>(str_s, kF32WideStride, (is_s ? x1 : x2) + sx.off(bi, hh, r0) + c, sx.s,
                                   kWideTR, n_str - r0, cw, a.vec_b, threadIdx.x, kTcThreads);
    } else {
      const int c = (j - n1c) * kWideCols;
      tc::load_rows_f32<kWideCols>(str_s, kF32WideStride, xg + sxg.off(bi, hh, r0) + c, sxg.s, kWideTR,
                                   n_str - r0, min(kWideCols, sw - c), a.vec_b, threadIdx.x, kTcThreads);
    }
    tc::cp_async_commit();
  };

  auto key_state = [&](int key) {  // 1 valid, 0 masked, -1 past Sk
    return key >= a.sk ? -1 : (a.key_valid == nullptr ? 1 : (a.key_valid[(long)bi * a.sk + key] != 0));
  };
  // own rows g and g + 8: key states (dkv) or lse and delta (dq); the
  // streamed rows 8 warp + 2t (+1) of an iteration: the other, fetched at
  // its first step so the loads' latency hides behind the S steps
  int own_state[2], str_state[2] = {1, 1};
  float own_lse[2], own_delta[2], str_lse[2] = {0.f, 0.f}, str_delta[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int own = own0 + g + 8 * r;
    own_state[r] = DKV ? key_state(own) : 1;
    own_lse[r] = !DKV && own < a.sq ? a.lse[stat0 + own] : 0.f;
    own_delta[r] = !DKV && own < a.sq ? a.delta[stat0 + own] : 0.f;
  }

  float s_acc[4], p_acc[4];
  uint32_t fb[kWideTR / 8][4], fs[kWideTR / 8][4];  // the factor's A fragments: tf32 big and small halves
  float acc[kWideChunks][2][4];
#pragma unroll
  for (int i = 0; i < kWideChunks; ++i)
#pragma unroll
    for (int n = 0; n < 2; ++n) acc[i][n][0] = acc[i][n][1] = acc[i][n][2] = acc[i][n][3] = 0.f;

  load(0);
  for (int s = 0; s < total; ++s) {
    tc::cp_async_wait<0>();
    __syncthreads();  // step s has landed; the other slot is free
    if (s + 1 < total) load(s + 1);
    const int it = s / n_step, j = s - it * n_step;
    const float* slot = ring + (s & 1) * kF32WideSlot;
    const float* str_s = slot + kTcRows * kF32WideStride;
    if (j == 0) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s_acc[e] = p_acc[e] = 0.f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int str = it * kWideTR + 8 * warp + 2 * t + e;
        if (DKV) {
          str_lse[e] = str < a.sq ? a.lse[stat0 + str] : 0.f;
          str_delta[e] = str < a.sq ? a.delta[stat0 + str] : 0.f;
        } else {
          str_state[e] = key_state(str);
        }
      }
    }
    if (j < n1c) {  // 1. S or dP of this warp's 8 streamed rows over the step's columns
      const bool is_s = j < nd;
      const int cw = min(kWideCols, (is_s ? a.d : a.dv_) - (is_s ? j : j - nd) * kWideCols);
      float c[4];
      tc::mma_abt_3xtf32(c, slot, kF32WideStride, str_s + 8 * warp * kF32WideStride, kF32WideStride, cw, g, t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (is_s)
          s_acc[e] += c[e];
        else
          p_acc[e] += c[e];
      }
    }
    if (j == n1c - 1) {  // 2. the slice's factor of this thread's pairs, then its A fragments
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int own_r = g + 8 * (e >> 1), str_c = 8 * warp + 2 * t + (e & 1);
        const int own = own0 + own_r, str = it * kWideTR + str_c;
        const int row = DKV ? str : own, key = DKV ? own : str;
        const int state = DKV ? own_state[e >> 1] : str_state[e & 1];
        float pd = 0.f, ds = 0.f;
        if (state >= 0 && row < a.sq)
          ds = pair_grad(a, state, s_acc[e], p_acc[e], DKV ? str_lse[e & 1] : own_lse[e >> 1],
                         DKV ? str_delta[e & 1] : own_delta[e >> 1], seed, bh, row, key, pd);
        f_s[own_r * kF32WidePs + str_c] = first ? ds : pd;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kWideTR / 8; ++kk) {
        const float* fa = f_s + g * kF32WidePs + 8 * kk + t;
        tc::split_a(fb[kk], fs[kk], fa[0], fa[8 * kF32WidePs], fa[4], fa[8 * kF32WidePs + 4]);
      }
    }
    if (j >= n1c) {  // 3. this warp's 16 columns of the step: grad += factor x streamed rows
      const int gc = j - n1c;
      if (gc * kWideCols + 16 * warp < sw) {
        float c[2][3][4] = {};
#pragma unroll
        for (int kk = 0; kk < kWideTR / 8; ++kk) {
          const float* b = str_s + (8 * kk + t) * kF32WideStride + 16 * warp + g;
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            uint32_t bb0, bb1, bs0, bs1;
            tc::split_tf32_trunc(b[8 * n], bb0, bs0);
            tc::split_tf32_trunc(b[4 * kF32WideStride + 8 * n], bb1, bs1);
            tc::mma_tf32(c[n][0], fb[kk], bb0, bb1);
            tc::mma_tf32(c[n][1], fb[kk], bs0, bs1);
            tc::mma_tf32(c[n][2], fs[kk], bb0, bb1);
          }
        }
#pragma unroll
        for (int i = 0; i < kWideChunks; ++i) {
          if (i != gc) continue;
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][n][e] += c[n][0][e] + (c[n][1][e] + c[n][2][e]);
        }
      }
    }
  }

  // each gradient element of the slice written once, in float32
  float* grad = static_cast<float*>(DKV ? (first ? a.dk : a.dv) : a.dq);
  const Strides sg = DKV ? (first ? a.sk_ : a.sv_) : a.sq_;
#pragma unroll
  for (int i = 0; i < kWideChunks; ++i)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int orow = own0 + g + 8 * (e >> 1), col = i * kWideCols + 16 * warp + 8 * n + 2 * t + (e & 1);
        if (orow < n_own && col < sw) grad[sg.off(bi, hh, orow) + col0 + col] = acc[i][n][e];
      }
}
// What a launch of one pass at head widths d, dv runs (two_pass_plan):
// kernel 0 float32 (flash_two_pass_f32_kernel, cls = JPW), 1 float32 wide
// (flash_two_pass_f32_wide_kernel, cls 0), 2 bfloat16
// (flash_two_pass_tc_kernel, cls = KPW), 3 bfloat16 wide (cls 0); rows: the
// streamed rows a tile; slices: blocks along grid.y a head; the dynamic
// shared memory in bytes. Dispatch follows it, and the library exports it
// (odtt_flash_two_pass_plan) for the Python mirror,
// ops/cuda/flash_attention.py::two_pass_plan. Every width has a plan.
struct TwoPassPlan {
  int kernel, cls, rows, slices, smem;
};

int cdiv(int x, int m) { return (x + m - 1) / m; }

TwoPassPlan two_pass_plan(int dtype, bool dq, int d, int dv) {
  const int slices = cdiv(d, kWideSlice) + (dq ? 0 : cdiv(dv, kWideSlice));
  if (dtype == 0) {
    // JPW: 8-column k-steps of S and dP (d / 8 + dv / 8) over the 8 warps, in
    // six width classes; the dkv pass has as many 8-column jobs, the dq pass
    // fewer. The hidden-256 cross site (d 512, dv 256) is class 12, hidden
    // 512's (d 1024, dv 512) class 24
    const int jpw = cdiv(cdiv(d, 8) + cdiv(dv, 8), kTcWarps);
    if (jpw <= 24) {
      const int cls = jpw <= 2 ? 2 : jpw <= 4 ? 4 : jpw <= 8 ? 8 : jpw <= 12 ? 12 : jpw <= 16 ? 16 : 24;
      return {0, cls, kF32TR, 1, (int)F32Layout(d, dv).total};
    }
    return {1, 0, kWideTR, slices, f32_wide_smem()};
  }
  // KPW: k-steps of S and dP (d / 16 + dv / 16) over the 8 warps, in five
  // width classes; the dkv pass has as many 16-column jobs, the dq pass fewer
  const int kpw = (cdiv(d, 16) + cdiv(dv, 16) + kTcWarps - 1) / kTcWarps;
  if (kpw <= 16) {
    // the hidden-256 cross site (d 512, dv 256) is class 8, hidden 512's (d 1024, dv 512) class 12
    const int cls = kpw <= 2 ? 2 : kpw <= 4 ? 4 : kpw <= 8 ? 8 : kpw <= 12 ? 12 : 16;
    return {2, cls, tc_stream_rows(cls), 1, (int)TcLayout(d, dv, tc_stream_rows(cls)).total};
  }
  return {3, 0, kWideTR, slices, tc_wide_smem()};
}

// One launch of a kernel that takes the 16 own rows of grid.x, (head, slice)
// of grid.y and the batch entry of grid.z; the wide kernels' slices also
// take n1, the slices of dK or dQ columns, and their number a head.
template <typename K, typename... Args>
int launch(K kernel, const Params& a, const TwoPassPlan& p, bool dkv, cudaStream_t stream, Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(cdiv(dkv ? a.sk : a.sq, kTcRows), a.num_heads * p.slices, a.b);
  kernel<<<grid, kTcThreads, p.smem, stream>>>(a, args...);
  return (int)cudaGetLastError();
}

template <bool DKV>
int dispatch_plan(const Params& a, const TwoPassPlan& p, cudaStream_t stream) {
  const int n1 = cdiv(a.d, kWideSlice);
  switch (p.kernel * 100 + p.cls) {
    case 2: return launch(flash_two_pass_f32_kernel<DKV, 2>, a, p, DKV, stream);
    case 4: return launch(flash_two_pass_f32_kernel<DKV, 4>, a, p, DKV, stream);
    case 8: return launch(flash_two_pass_f32_kernel<DKV, 8>, a, p, DKV, stream);
    case 12: return launch(flash_two_pass_f32_kernel<DKV, 12>, a, p, DKV, stream);
    case 16: return launch(flash_two_pass_f32_kernel<DKV, 16>, a, p, DKV, stream);
    case 24: return launch(flash_two_pass_f32_kernel<DKV, 24>, a, p, DKV, stream);
    case 100: return launch(flash_two_pass_f32_wide_kernel<DKV>, a, p, DKV, stream, n1, p.slices);
    case 202: return launch(flash_two_pass_tc_kernel<DKV, 2>, a, p, DKV, stream);
    case 204: return launch(flash_two_pass_tc_kernel<DKV, 4>, a, p, DKV, stream);
    case 208: return launch(flash_two_pass_tc_kernel<DKV, 8>, a, p, DKV, stream);
    case 212: return launch(flash_two_pass_tc_kernel<DKV, 12>, a, p, DKV, stream);
    case 216: return launch(flash_two_pass_tc_kernel<DKV, 16>, a, p, DKV, stream);
    case 300: return launch(flash_two_pass_tc_wide_kernel<DKV>, a, p, DKV, stream, n1, p.slices);
    default: return (int)cudaErrorInvalidValue;
  }
}

// 16-byte tile loads: of the block's own operands (vec_a) and of the
// streamed ones (vec_b), each where both of its tensors allow them.
template <typename T>
void set_vec(Params& a, bool dq) {
  a.vec_a = aligned16_strided<T>(dq ? a.q : a.k, a.d, dq ? a.sq_ : a.sk_) &&
            aligned16_strided<T>(dq ? a.dout : a.v, a.dv_, dq ? a.so_ : a.sv_);
  a.vec_b = aligned16_strided<T>(dq ? a.k : a.q, a.d, dq ? a.sk_ : a.sq_) &&
            aligned16_strided<T>(dq ? a.v : a.dout, a.dv_, dq ? a.sv_ : a.so_);
}

}  // namespace

extern "C" {

int odtt_flash_bwd_two_pass_abi_version() { return 5; }

// The launch plan of one pass at head widths d, dv (two_pass_plan):
// out[0..4] = kernel, cls, rows, slices, smem. Returns 0, or
// cudaErrorInvalidValue on a bad argument.
int odtt_flash_two_pass_plan(int dtype, int pass_dq, int d, int dv, long long* out) {
  if ((dtype != 0 && dtype != 1) || d <= 0 || dv <= 0 || out == nullptr) return (int)cudaErrorInvalidValue;
  const TwoPassPlan p = two_pass_plan(dtype, pass_dq != 0, d, dv);
  out[0] = p.kernel;
  out[1] = p.cls;
  out[2] = p.rows;
  out[3] = p.slices;
  out[4] = p.smem;
  return 0;
}

// dtype: 0 float32, 1 bfloat16 (q, k, v, dout and the gradients; both on
// the tensor cores).
// strides: 12 element strides, (batch, head, row) of q (and dq), k (and dk),
// v (and dv), dout, in that order. key_valid: (B, Sk) bytes or null. lse,
// delta: (B, h, Sq) float32, contiguous. dq (dq pass) or dk, dv (dkv pass)
// are written in the input dtype, nothing else. drop_threshold / inv_keep /
// seed as in the forward. Returns cudaGetLastError() after the launch.
int odtt_flash_attention_two_pass(int pass_dq, const void* q, const void* k, const void* v,
                                  const void* key_valid, const void* dout, const void* lse,
                                  const void* delta, void* dq, void* dk, void* dv,
                                  const long long* strides, int dtype, int b, int sq, int sk,
                                  int num_heads, int d, int dv_, float scale, const long long* seed,
                                  unsigned int drop_threshold, float inv_keep, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || num_heads <= 0 || d <= 0 || dv_ <= 0 || strides == nullptr ||
      (dtype != 0 && dtype != 1))
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
  if (dtype == 0)
    set_vec<float>(a, is_dq);
  else
    set_vec<__nv_bfloat16>(a, is_dq);
  const TwoPassPlan p = two_pass_plan(dtype, is_dq, d, dv_);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_dq ? dispatch_plan<false>(a, p, s) : dispatch_plan<true>(a, p, s);
}

}  // extern "C"
