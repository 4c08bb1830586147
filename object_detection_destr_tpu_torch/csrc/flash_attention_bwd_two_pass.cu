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
// Two kernels compute it, chosen by the operand dtype (no fallback between
// them: a bfloat16 call always runs the tensor-core kernel).
//
// bfloat16, flash_two_pass_tc_kernel (both passes, one template). What bounds
// it on this card: at the wide cross-attention (B 16, Sq 600, Sk 400, one
// head, d 1024, dv 512) a pass needs 20-24 GFLOP of bf16 tensor-core work
// and moves about 79 MB, about 0.024 ms either way; the CUDA-core kernels
// below spent 390-530x that on float32 FMAs and warp shuffles. Why two
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
// ldmatrix chains, not by either bound above.
//
// float32, flash_dq_kernel / flash_dkv_kernel (the CUDA-core kernels; the
// tensor-core path for float32 is later work):
//   dq kernel: grid (ceil(Sq / rows), h, B), one warp per query row. The
//     row's q, dO and its dQ accumulator sit in registers (each lane holds
//     its d/32 and dv/32 slices); 32-key K / V tiles are staged in shared
//     memory (192 KB at d 1024, dv 512) and read by the block's rows.
//   dkv kernel: grid (ceil(Sk / 8), h, B), one warp per key. The key's k, v
//     and its dK / dV accumulators sit in registers; 32-row tiles of q, dO,
//     lse and delta are staged in shared memory and read by the block's keys.
// The 32 dot products of a tile are finished by one reduce-scatter
// (flash_common.cuh), so each lane owns one key (dq) or one query row (dkv).
// What bounds them on this card: the float32 CUDA-core arithmetic (s and dp
// are recomputed in both passes), not bytes.

#include <math.h>

#include "flash_common.cuh"
#include "philox.cuh"
#include "tensor_core.cuh"

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
  const long long* seed;  // device memory
  uint32_t drop_threshold;
  float inv_keep;
  // 16-byte tile loads: float32, of the two staged operands; bfloat16, of
  // the block's own operands (vec_a) and of the streamed ones (vec_b)
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

template <typename T, int P>
__global__ void __launch_bounds__(kWarps * kWarp) flash_dq_kernel(Params a) {
  const uint32_t seed = philox::load_seed(a.seed, a.drop_threshold);
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
    if (state >= 0) ds = pair_grad(a, state, dot, dp, lse_i, delta_i, seed, bh, row, t0 + lane, pd);
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
  const uint32_t seed = philox::load_seed(a.seed, a.drop_threshold);
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
    if (row < a.sq) ds = pair_grad(a, state, dot, dp, lse_s[lane], delta_s[lane], seed, bh, row, key, pd);
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

template <bool DKV, int KPW>
int launch_tc(Params a, cudaStream_t stream) {
  const size_t smem = TcLayout(a.d, a.dv_, tc_stream_rows(KPW)).total;
  cudaError_t err = cudaFuncSetAttribute(flash_two_pass_tc_kernel<DKV, KPW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((DKV ? a.sk : a.sq) + kTcRows - 1) / kTcRows, a.num_heads, a.b);
  flash_two_pass_tc_kernel<DKV, KPW><<<grid, kTcThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// KPW: k-steps of S and dP (d / 16 + dv / 16) over the 8 warps, in five
// width classes; the dkv pass has as many 16-column jobs, the dq pass fewer.
template <bool DKV>
int dispatch_tc_kpw(const Params& a, cudaStream_t stream) {
  const int kpw = ((a.d + 15) / 16 + (a.dv_ + 15) / 16 + kTcWarps - 1) / kTcWarps;
  if (kpw <= 2) return launch_tc<DKV, 2>(a, stream);
  if (kpw <= 4) return launch_tc<DKV, 4>(a, stream);
  if (kpw <= 8) return launch_tc<DKV, 8>(a, stream);    // the hidden-256 cross site: d 512, dv 256
  if (kpw <= 12) return launch_tc<DKV, 12>(a, stream);  // the hidden-512 cross site: d 1024, dv 512
  return launch_tc<DKV, 16>(a, stream);
}

int dispatch_tc(Params a, bool dq, cudaStream_t stream) {
  if (a.d > 1024 || a.dv_ > 1024) return (int)cudaErrorInvalidValue;
  const Strides own1 = dq ? a.sq_ : a.sk_, own2 = dq ? a.so_ : a.sv_;
  const Strides str1 = dq ? a.sk_ : a.sq_, str2 = dq ? a.sv_ : a.so_;
  a.vec_a = aligned16_strided<bf16>(dq ? a.q : a.k, a.d, own1) &&
            aligned16_strided<bf16>(dq ? a.dout : a.v, a.dv_, own2);
  a.vec_b = aligned16_strided<bf16>(dq ? a.k : a.q, a.d, str1) &&
            aligned16_strided<bf16>(dq ? a.v : a.dout, a.dv_, str2);
  return dq ? dispatch_tc_kpw<false>(a, stream) : dispatch_tc_kpw<true>(a, stream);
}

}  // namespace

extern "C" {

int odtt_flash_bwd_two_pass_abi_version() { return 3; }

// dtype: 0 float32 (CUDA cores), 1 bfloat16 (tensor cores; q, k, v, dout
// and the gradients).
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
  if (dtype == 1) return dispatch_tc(a, is_dq, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
