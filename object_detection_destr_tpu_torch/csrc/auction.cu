// The Bertsekas forward auction of DESTR's matcher, for Hopper (sm_90a):
// two kernels that share one device solver. CUDA C++ with a plain C
// interface, loaded with ctypes by object_detection_destr_tpu_torch/ops/cuda/
// auction.py.
//
// fused_auction_kernel replaces the TPU kernel
//   object_detection_destr_tpu/ops/pallas/auction.py::_fused_kernel
//   (l.271, with the shared solver _solve l.71; pallas_call l.470, entry
//   hungarian_match_pallas l.371): it builds the matching cost and solves it.
// auction_kernel replaces the TPU kernel
//   object_detection_destr_tpu/ops/pallas/auction.py::_kernel
//   (l.189, with _solve l.71; pallas_call l.247, entry
//   auction_assignment_pallas l.207): it solves a value matrix the wrapper
//   built from a precomputed cost, value[t, n] = col_valid[t] ? -cost[n, t]
//   : 0, as the Pallas wrapper builds it in XLA (l.232); rows that are not
//   real hold -1e9 there too.
// Per problem (one image's T target columns against N query rows):
//   cost[t, n]  = cost_class * pn[label_t, n] + cost_ciou * (1 - CIoU(pred_n, tgt_t))
//   value[t, n] = row_valid[n] ? (col_valid[t] ? -cost : 0) : -1e9
// with CIoU as geometry/boxes.py::pairwise_ciou computes it (clipped
// cxcyhw -> xyxy, centres re-derived through the clipped xyxy -> cxcyhw, the
// aspect term gated at IoU > 0.5, clamp to [-1, 1]). The focal pos - neg
// class terms pn (B, C, N) and the per-box atan(w / h) come from the wrapper
// in PyTorch, as the Pallas wrapper computes them in XLA. Then, exactly as
// _solve:
//   eps = eps_frac * max(vmax - vmin, 1e-6) over real rows and valid columns,
//         with 0 folded in when an invalid column exists;
//   each round every unassigned valid column bids for its best row (the
//   lowest index on ties) by best - max(second, best - range - 1) + eps; a
//   row takes the highest bid, the lowest column on ties, evicting its owner;
//   rounds repeat until every valid column holds a row or max_iters;
//   (the bids made over all rounds are counted, for the kernel's bound);
//   greedy completion then gives every column still without a row, in column
//   order, the first free row of highest value, so the rows are
//   duplicate-free.
// Compiled with -fmad=false so the cost arithmetic rounds after every
// operation, as the plain PyTorch version (ops/cuda/auction.py) does.
//
// Design: one block of 1024 threads per problem, for both kernels. The (T, N) value matrix
// (300 x 400 x 4 B = 480 KB at the training path's shapes) exceeds one SM's
// shared memory, so it is built once into a global scratch (32 problems:
// 15 MB, which stays in the 50 MB L2) and every round streams it from L2;
// prices, owners, the row of each column and the round's bids stay in
// shared memory. A round is: one warp per bidding column scans its row of
// the value matrix for best / second best; the column's bid lands on its row
// with one shared-memory atomicMax of the key (orderable bid bits << 32 |
// ~column), i.e. "highest bid, then lowest column"; then one thread per row
// installs its winner. The completion pass is one warp walking the columns.
// auction_kernel reads its value matrix from the wrapper's (B, T, N) buffer
// the same way.
// What bounds them on this card: latency of the rounds (block barriers and
// L2 reads of the rows that bid), not bytes or operations.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr float kBig = 1e9f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t orderable(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_orderable(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// (best, first index of best, second best over the other indices) merge
__device__ __forceinline__ void merge_best(float& best, int& idx, float& second, float ob,
                                           int oi, float os) {
  if (ob > best || (ob == best && oi < idx)) {
    second = fmaxf(os, best);
    best = ob;
    idx = oi;
  } else {
    second = fmaxf(second, ob);
  }
}

__device__ float block_reduce(float x, bool want_max, float* scratch) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) {
    const float y = __shfl_xor_sync(kFull, x, o);
    x = want_max ? fmaxf(x, y) : fminf(x, y);
  }
  __syncthreads();
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  x = scratch[lane];
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) {
    const float y = __shfl_xor_sync(kFull, x, o);
    x = want_max ? fmaxf(x, y) : fminf(x, y);
  }
  return x;
}

// The solver's per-problem state, in dynamic shared memory.
struct Solver {
  unsigned long long* bidkey;  // (N) this round's best bid key per row
  float* price;                // (N)
  int* owner;                  // (N) column holding the row, or -1
  int* roc;                    // (T) row of each column, or -1
  unsigned char* cvalid;       // (T)
  unsigned char* rfree;        // (N) completion: row not yet taken

  __device__ Solver(unsigned char* smem, int n, int t) {
    bidkey = reinterpret_cast<unsigned long long*>(smem);
    price = reinterpret_cast<float*>(bidkey + n);
    owner = reinterpret_cast<int*>(price + n);
    roc = owner + n;
    cvalid = reinterpret_cast<unsigned char*>(roc + t);
    rfree = cvalid + t;
  }

  static size_t bytes(int n, int t) { return (size_t)n * (8 + 4 + 4 + 1) + (size_t)t * (4 + 1); }

  // Loads the valid columns and resets prices, owners and rows.
  __device__ void init(const uint8_t* colv, int n, int t) {
    for (int j = threadIdx.x; j < t; j += kThreads) {
      cvalid[j] = colv[j] != 0;
      roc[j] = -1;
    }
    for (int i = threadIdx.x; i < n; i += kThreads) {
      price[i] = 0.f;
      owner[i] = -1;
    }
  }
};

// The value range of one problem over real rows and valid columns, with 0
// folded in when an invalid column exists, from each thread's partial
// (vmax, vmin, has_inv); every thread gets max(range, 1e-6).
__device__ float value_range(float vmax, float vmin, bool has_inv, float* scratch) {
  vmax = block_reduce(vmax, true, scratch);
  vmin = block_reduce(vmin, false, scratch);
  if (__syncthreads_or(has_inv)) {
    vmax = fmaxf(vmax, 0.f);
    vmin = fminf(vmin, 0.f);
  }
  return fmaxf(vmax - vmin, 1e-6f);
}

// The bidding rounds and the greedy completion of _solve on one problem's
// (T, N) value matrix; writes the rows of its T columns, its rounds and the
// bids made over them.
__device__ void solve(const float* __restrict__ value, Solver& S, int n, int t,
                      float range, float eps_frac, int max_iters, int* __restrict__ rows_out,
                      int* __restrict__ rounds_out, int* __restrict__ bids_out) {
  __shared__ int bids;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const float eps = eps_frac * range;
  if (threadIdx.x == 0) bids = 0;
  __syncthreads();

  // ---- bidding rounds
  int rounds = 0;
  while (true) {
    bool pending = false;
    for (int j = threadIdx.x; j < t; j += kThreads) pending |= S.cvalid[j] && S.roc[j] < 0;
    for (int i = threadIdx.x; i < n; i += kThreads) S.bidkey[i] = 0ull;
    if (!__syncthreads_or(pending) || rounds >= max_iters) break;
    ++rounds;
    for (int j = warp; j < t; j += kWarps) {
      if (!(S.cvalid[j] && S.roc[j] < 0)) continue;
      const float* vrow = value + (long)j * n;
      float best = -INFINITY, second = -INFINITY;
      int idx = 0x7fffffff;
      for (int i = lane; i < n; i += 32) {
        const float net = vrow[i] - S.price[i];
        merge_best(best, idx, second, net, i, -INFINITY);
      }
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1) {
        const float ob = __shfl_xor_sync(kFull, best, o);
        const int oi = __shfl_xor_sync(kFull, idx, o);
        const float os = __shfl_xor_sync(kFull, second, o);
        merge_best(best, idx, second, ob, oi, os);
      }
      if (lane == 0) {
        second = fmaxf(second, best - range - 1.f);
        const float bid = best - second + eps;
        const float bid_price = S.price[idx] + bid;
        const unsigned long long key =
            ((unsigned long long)orderable(bid_price) << 32) | (0xffffffffu - (uint32_t)j);
        atomicMax(S.bidkey + idx, key);
        atomicAdd(&bids, 1);
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const unsigned long long key = S.bidkey[i];
      if (key == 0ull) continue;
      const int winner = (int)(0xffffffffu - (uint32_t)(key & 0xffffffffull));
      const int old = S.owner[i];
      if (old >= 0) S.roc[old] = -1;  // an owner never bids, so never wins
      S.roc[winner] = i;
      S.owner[i] = winner;
      S.price[i] = from_orderable((uint32_t)(key >> 32));
    }
    __syncthreads();
  }

  // ---- greedy completion, one warp, columns in order
  for (int i = threadIdx.x; i < n; i += kThreads) S.rfree[i] = 1;
  __syncthreads();
  for (int j = threadIdx.x; j < t; j += kThreads)
    if (S.roc[j] >= 0) S.rfree[S.roc[j]] = 0;
  __syncthreads();
  if (warp == 0) {
    for (int j = 0; j < t; ++j) {
      if (S.roc[j] >= 0) continue;  // warp-uniform
      const float* vrow = value + (long)j * n;
      float best = -INFINITY;
      int idx = 0x7fffffff;
      for (int i = lane; i < n; i += 32) {
        const float score = S.rfree[i] ? vrow[i] : -kBig;
        if (score > best) {
          best = score;
          idx = i;
        }
      }
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1) {
        const float ob = __shfl_xor_sync(kFull, best, o);
        const int oi = __shfl_xor_sync(kFull, idx, o);
        if (ob > best || (ob == best && oi < idx)) {
          best = ob;
          idx = oi;
        }
      }
      if (lane == 0) {
        S.roc[j] = idx;
        S.rfree[idx] = 0;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < t; j += kThreads) rows_out[j] = S.roc[j];
  if (threadIdx.x == 0) {
    *rounds_out = rounds;
    *bids_out = bids;
  }
}

__global__ void __launch_bounds__(kThreads) fused_auction_kernel(
    const float* __restrict__ pn, const float* __restrict__ pbox,
    const float* __restrict__ patan, const float* __restrict__ tbox,
    const float* __restrict__ tatan, const int* __restrict__ labels,
    const uint8_t* __restrict__ colv, const uint8_t* __restrict__ rowv,
    float* __restrict__ value_all, int* __restrict__ rows_out, int* __restrict__ rounds_out,
    int* __restrict__ bids_out, int n, int t, int c, float cost_class, float cost_ciou, float eps_frac, int max_iters) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float scratch[32];
  Solver S(smem, n, t);

  const int bi = blockIdx.x;
  const float* pn_b = pn + (long)bi * c * n;
  const float* pbox_b = pbox + (long)bi * n * 4;
  const float* patan_b = patan + (long)bi * n;
  const float* tbox_b = tbox + (long)bi * t * 4;
  const float* tatan_b = tatan + (long)bi * t;
  const uint8_t* rowv_b = rowv + (long)bi * n;
  float* value = value_all + (long)bi * t * n;
  S.init(colv + (long)bi * t, n, t);
  __syncthreads();

  // ---- the value matrix, and its range over real rows and valid columns
  const float four_over_pi2 = 0.40528473456935108578f;  // 4 / pi^2, rounded once
  float vmax = -kBig, vmin = kBig;
  bool has_inv = false;
  for (long idx = threadIdx.x; idx < (long)t * n; idx += kThreads) {
    const int tj = (int)(idx / n), ni = (int)(idx - (long)tj * n);
    const int lab = labels[(long)bi * t + tj];
    const float c_class = (lab >= 0 && lab < c) ? pn_b[(long)lab * n + ni] : 0.f;
    const float cx = pbox_b[ni * 4 + 0], cy = pbox_b[ni * 4 + 1];
    const float h = pbox_b[ni * 4 + 2], w = pbox_b[ni * 4 + 3];
    const float px1 = fmaxf(cx - w / 2.f, 0.f), py1 = fmaxf(cy - h / 2.f, 0.f);
    const float px2 = fminf(cx + w / 2.f, 1.f), py2 = fminf(cy + h / 2.f, 1.f);
    const float tx1 = tbox_b[tj * 4 + 0], ty1 = tbox_b[tj * 4 + 1];
    const float tx2 = tbox_b[tj * 4 + 2], ty2 = tbox_b[tj * 4 + 3];
    const float iw = fmaxf(fminf(px2, tx2) - fmaxf(px1, tx1), 0.f);
    const float ih = fmaxf(fminf(py2, ty2) - fmaxf(py1, ty1), 0.f);
    const float inter = iw * ih;
    const float parea = (px2 - px1) * (py2 - py1);
    const float tarea = (tx2 - tx1) * (ty2 - ty1);
    const float iou = inter / fmaxf(parea + tarea - inter, 1e-6f);
    const float ew = fmaxf(fmaxf(px2, tx2) - fminf(px1, tx1), 0.f);
    const float eh = fmaxf(fmaxf(py2, ty2) - fminf(py1, ty1), 0.f);
    const float diag_sq = ew * ew + eh * eh;
    const float pcx = fminf(fmaxf((px1 + px2) / 2.f, 0.f), 1.f);
    const float pcy = fminf(fmaxf((py1 + py2) / 2.f, 0.f), 1.f);
    const float gcx = fminf(fmaxf((tx1 + tx2) / 2.f, 0.f), 1.f);
    const float gcy = fminf(fmaxf((ty1 + ty2) / 2.f, 0.f), 1.f);
    const float dx = pcx - gcx, dy = pcy - gcy;
    const float center_sq = dx * dx + dy * dy;
    const float da = tatan_b[tj] - patan_b[ni];
    const float v = four_over_pi2 * (da * da);
    const float alpha = iou > 0.5f ? v / (1.f - iou + v) : 0.f;
    const float ciou =
        fminf(fmaxf(iou - center_sq / fmaxf(diag_sq, 1e-6f) - alpha * v, -1.f), 1.f);
    const float cost = cost_class * c_class + cost_ciou * (1.f - ciou);
    const bool col_ok = S.cvalid[tj], row_ok = rowv_b[ni] != 0;
    const float val = row_ok ? (col_ok ? -cost : 0.f) : -kBig;
    value[idx] = val;
    if (row_ok && col_ok) {
      vmax = fmaxf(vmax, val);
      vmin = fminf(vmin, val);
    }
    has_inv |= !col_ok;
  }
  const float range = value_range(vmax, vmin, has_inv, scratch);
  solve(value, S, n, t, range, eps_frac, max_iters, rows_out + (long)bi * t, rounds_out + bi,
        bids_out + bi);
}

// _solve on a given (B, T, N) value matrix (rows that are not real already
// at -1e9, as row_valid says).
__global__ void __launch_bounds__(kThreads) auction_kernel(
    const float* __restrict__ value_all, const uint8_t* __restrict__ colv,
    const uint8_t* __restrict__ rowv, int* __restrict__ rows_out, int* __restrict__ rounds_out,
    int* __restrict__ bids_out, int n, int t, float eps_frac, int max_iters) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float scratch[32];
  Solver S(smem, n, t);

  const int bi = blockIdx.x;
  const float* value = value_all + (long)bi * t * n;
  const uint8_t* rowv_b = rowv + (long)bi * n;
  S.init(colv + (long)bi * t, n, t);
  __syncthreads();

  float vmax = -kBig, vmin = kBig;
  bool has_inv = false;
  for (long idx = threadIdx.x; idx < (long)t * n; idx += kThreads) {
    const int tj = (int)(idx / n), ni = (int)(idx - (long)tj * n);
    const bool col_ok = S.cvalid[tj];
    if (col_ok && rowv_b[ni] != 0) {
      vmax = fmaxf(vmax, value[idx]);
      vmin = fminf(vmin, value[idx]);
    }
    has_inv |= !col_ok;
  }
  const float range = value_range(vmax, vmin, has_inv, scratch);
  solve(value, S, n, t, range, eps_frac, max_iters, rows_out + (long)bi * t, rounds_out + bi,
        bids_out + bi);
}

}  // namespace

extern "C" {

int odtt_auction_abi_version() { return 3; }

// One problem per batch entry. pn (B, C, N), pbox (B, N, 4) cxcyhw,
// patan (B, N), tbox (B, T, 4) xyxy, tatan (B, T): float32. labels (B, T)
// int32, colv (B, T) and rowv (B, N) bytes. value: (B, T, N) float32
// scratch. rows (B, T) int32, rounds (B,) int32 and bids (B,) int32 (the
// bids made over all rounds) out.
// Returns cudaGetLastError() after the launch (0 on success).
int odtt_fused_auction(const void* pn, const void* pbox, const void* patan, const void* tbox,
                       const void* tatan, const void* labels, const void* colv,
                       const void* rowv, void* value, void* rows, void* rounds, void* bids,
                       int b, int n, int t, int c, float cost_class, float cost_ciou,
                       float eps_frac, int max_iters, void* stream) {
  if (b <= 0 || n <= 0 || t <= 0 || c <= 0 || t > n) return (int)cudaErrorInvalidValue;
  const size_t smem = Solver::bytes(n, t);
  cudaError_t err = cudaFuncSetAttribute(
      fused_auction_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_auction_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pn), static_cast<const float*>(pbox),
      static_cast<const float*>(patan), static_cast<const float*>(tbox),
      static_cast<const float*>(tatan), static_cast<const int*>(labels),
      static_cast<const uint8_t*>(colv), static_cast<const uint8_t*>(rowv),
      static_cast<float*>(value), static_cast<int*>(rows), static_cast<int*>(rounds),
      static_cast<int*>(bids), n, t, c, cost_class, cost_ciou, eps_frac, max_iters);
  return (int)cudaGetLastError();
}

// One problem per batch entry. value (B, T, N) float32 benefits (-1e9 on
// rows that are not real), colv (B, T) and rowv (B, N) bytes. rows (B, T)
// int32, rounds (B,) int32 and bids (B,) int32 out, as odtt_fused_auction.
// Returns cudaGetLastError() after the launch (0 on success).
int odtt_auction(const void* value, const void* colv, const void* rowv, void* rows, void* rounds,
                 void* bids, int b, int n, int t, float eps_frac, int max_iters, void* stream) {
  if (b <= 0 || n <= 0 || t <= 0 || t > n) return (int)cudaErrorInvalidValue;
  const size_t smem = Solver::bytes(n, t);
  cudaError_t err =
      cudaFuncSetAttribute(auction_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  auction_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(value), static_cast<const uint8_t*>(colv),
      static_cast<const uint8_t*>(rowv), static_cast<int*>(rows), static_cast<int*>(rounds),
      static_cast<int*>(bids), n, t, eps_frac, max_iters);
  return (int)cudaGetLastError();
}

}  // extern "C"
