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
// An invalid column's values are constants: 0 on real rows and -1e9 on rows
// that are not real (the Pallas kernels build them so, and so does #8's
// wrapper, precomputed_value, with every row real). It never bids, and in
// the completion its argmax over (free ? value : -1e9) is the lowest free
// real row, or row 0 once none is left (every score is -1e9 then). So the
// kernels neither build nor read an invalid column's values.
//
// What bounds them on this card: the latency of the rounds (two barriers,
// a row scan and an atomic each), not bytes or operations: a problem of the
// training step has at most 8 valid targets against 400 rows and takes
// 1-110 rounds. The design, one block of 1024 threads per problem:
//   * warp 0 compacts the valid columns first (ballots over T); only their
//     value rows exist: built by #9 (copied by #8) into shared memory where
//     T_valid x N floats fit the budget the wrapper passes (64 rows at N =
//     400), else into a global scratch (#9) or read in place (#8): the
//     dense setting, 150-300 valid columns;
//   * a round is two barriers: the bids, then the installs. Warp w bids for
//     compacted columns w, w + 32, ..., so up to 32 bidders run at once; a
//     bidder's warp scans its row with 16 independent loads a lane in
//     flight, merged as a tree, and its bid lands on its row by a 64-bit
//     atomicMax of the key (orderable bid bits << 32 | ~column: highest bid,
//     then lowest column); the install pass, a thread a row, installs the
//     winners and clears the keys; a pending count in shared memory
//     replaces a scan over T. The block's size is the dense setting's: a
//     round there has up to 300 bidders, and with 8 warps their scans ran
//     one after another, slower than the old kernel, while the synthetic
//     setting's 8 bidders take the same time with 8 warps or 32;
//   * the completion: with every valid column placed (the rule at <= 8
//     targets), the m-th invalid column in column order takes the m-th free
//     real row (a ballot rank over the free mask), or row 0; at the round cap
//     one warp walks the columns in order as fill does, scanning the rows of
//     the valid columns still without one.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kScan = 16;  // values a lane loads before it merges them
constexpr float kBig = 1e9f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t orderable(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_orderable(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

__device__ __forceinline__ unsigned lanes_below(int lane) { return (1u << lane) - 1u; }

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
  x = lane < kWarps ? scratch[lane] : scratch[0];
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) {
    const float y = __shfl_xor_sync(kFull, x, o);
    x = want_max ? fmaxf(x, y) : fminf(x, y);
  }
  return x;
}

// Scalars of one problem, in static shared memory.
struct Counts {
  int tv;           // valid columns
  int pending;      // valid columns without a row
  int nfree;        // completion: free real rows
  int bids;         // bids over all rounds
  float scratch[32];
};

// The solver's per-problem state, in dynamic shared memory. Columns are
// compacted: cj = 0..tv-1 are the valid columns in column order.
struct Solver {
  unsigned long long* bidkey;  // (N) this round's best bid key per row, 0 if none
  float* price;                // (N)
  int* owner;                  // (N) compacted column holding the row, or -1
  int* freelist;               // (N) completion: free real rows, in order
  int* roc;                    // (T) row of each compacted column, or -1
  int* vcol;                   // (T) column of each compacted column
  int* cmap;                   // (T) compacted index of a valid column; -(rank) - 1 of an invalid one
  float* vals;                 // (rows_smem, N) value rows of compacted columns
  unsigned char* real;         // (N) row is real

  __device__ Solver(unsigned char* smem, int n, int t, int rows_smem) {
    bidkey = reinterpret_cast<unsigned long long*>(smem);
    price = reinterpret_cast<float*>(bidkey + n);
    owner = reinterpret_cast<int*>(price + n);
    freelist = owner + n;
    roc = freelist + n;
    vcol = roc + t;
    cmap = vcol + t;
    vals = reinterpret_cast<float*>(cmap + t);
    real = reinterpret_cast<unsigned char*>(vals + (long)rows_smem * n);
  }

  static size_t bytes(int n, int t, int rows_smem) {
    return (size_t)n * (8 + 3 * 4 + 1) + (size_t)t * 3 * 4 + (size_t)rows_smem * n * 4;
  }

  // Compacts the valid columns (warp 0) and resets prices, owners, keys and
  // counts; the caller syncs.
  __device__ void init(const uint8_t* colv, const uint8_t* rowv, int n, int t, Counts& C) {
    const int lane = threadIdx.x % 32;
    if (threadIdx.x < 32) {
      int count = 0;
      for (int base = 0; base < t; base += 32) {
        const int j = base + lane;
        const bool valid = j < t && colv[j] != 0;
        const unsigned ballot = __ballot_sync(kFull, valid);
        const int before = count + __popc(ballot & lanes_below(lane));
        if (valid) {
          vcol[before] = j;
          cmap[j] = before;
        } else if (j < t) {
          cmap[j] = -(j - before) - 1;
        }
        count += __popc(ballot);
      }
      if (lane == 0) {
        C.tv = C.pending = count;
        C.bids = 0;
      }
    }
    for (int j = threadIdx.x; j < t; j += kThreads) roc[j] = -1;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      price[i] = 0.f;
      owner[i] = -1;
      bidkey[i] = 0ull;
      real[i] = rowv[i] != 0;
    }
  }
};

// The value row of compacted column cj: base + (map ? map[cj] : cj) * n.
struct Rows {
  const float* base;
  const int* map;
  int n;
  __device__ const float* operator()(int cj) const { return base + (long)(map ? map[cj] : cj) * n; }
};

// max(vmax - vmin, 1e-6) over the block's partials, with 0 folded in when
// an invalid column exists (has_inv, uniform); every thread gets it.
__device__ float value_range(float vmax, float vmin, bool has_inv, float* scratch) {
  vmax = block_reduce(vmax, true, scratch);
  vmin = block_reduce(vmin, false, scratch);
  if (has_inv) {
    vmax = fmaxf(vmax, 0.f);
    vmin = fminf(vmin, 0.f);
  }
  return fmaxf(vmax - vmin, 1e-6f);
}

// One warp: best and second best of value - price over a row, and the
// first index of the best; every lane gets them. A lane's kScan values of a
// pass are merged as a binary tree (the lower indices on the left, so ties
// keep them), not as a chain.
__device__ void row_best(const float* __restrict__ vrow, const float* __restrict__ price, int n, int lane,
                         float& best, int& idx, float& second) {
  best = -INFINITY, second = -INFINITY, idx = 0x7fffffff;
  for (int base = 0; base < n; base += 32 * kScan) {
    float b[kScan], s2[kScan];
    int at[kScan];
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      const int i = base + lane + 32 * u;
      b[u] = i < n ? vrow[i] - price[i] : -INFINITY;
      s2[u] = -INFINITY;
      at[u] = i < n ? i : 0x7fffffff;
    }
#pragma unroll
    for (int w = 1; w < kScan; w *= 2)
#pragma unroll
      for (int u = 0; u < kScan; u += 2 * w) {
        if (b[u + w] > b[u]) {
          s2[u] = fmaxf(b[u], s2[u + w]);
          b[u] = b[u + w];
          at[u] = at[u + w];
        } else {
          s2[u] = fmaxf(s2[u], b[u + w]);
        }
      }
    merge_best(best, idx, second, b[0], at[0], s2[0]);
  }
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) {
    const float ob = __shfl_xor_sync(kFull, best, o);
    const int oi = __shfl_xor_sync(kFull, idx, o);
    const float os = __shfl_xor_sync(kFull, second, o);
    merge_best(best, idx, second, ob, oi, os);
  }
}

// One warp: the first free row of highest value (fill's argmax of
// free ? value : -1e9); every lane gets it.
__device__ int free_best(const float* __restrict__ vrow, const int* owner, int n, int lane) {
  float best = -INFINITY;
  int idx = 0x7fffffff;
  for (int i = lane; i < n; i += 32) {
    const float score = owner[i] < 0 ? vrow[i] : -kBig;
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
  return idx;
}

// The bidding rounds and the greedy completion of _solve on one problem's
// compacted value rows; writes the rows of its T columns, its rounds and the
// bids made over them. The caller has synced after init and the rows.
__device__ void solve(const Rows rows, Solver& S, Counts& C, int n, int t, float range, float eps_frac,
                      int max_iters, int* __restrict__ rows_out, int* __restrict__ rounds_out,
                      int* __restrict__ bids_out) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int tv = C.tv;
  const float eps = eps_frac * range;
  int bids = 0;  // this thread's (a warp's lane 0 bids)

  // ---- bidding rounds: two barriers each
  int rounds = 0;
  while (C.pending > 0 && rounds < max_iters) {
    for (int base = 0; base < tv; base += kThreads) {
      const int j = base + warp + kWarps * lane;
      const unsigned bidders = __ballot_sync(kFull, j < tv && S.roc[j] < 0);
      for (unsigned m = bidders; m != 0u; m &= m - 1u) {
        const int cj = base + warp + kWarps * (__ffs(m) - 1);
        float best, second;
        int idx;
        row_best(rows(cj), S.price, n, lane, best, idx, second);
        if (lane == 0) {
          second = fmaxf(second, best - range - 1.f);
          const float bid_price = S.price[idx] + (best - second + eps);
          const unsigned long long key =
              ((unsigned long long)orderable(bid_price) << 32) | (0xffffffffu - (uint32_t)cj);
          atomicMax(S.bidkey + idx, key);
          ++bids;
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const unsigned long long key = S.bidkey[i];
      if (key == 0ull) continue;
      S.bidkey[i] = 0ull;
      const int winner = (int)(0xffffffffu - (uint32_t)(key & 0xffffffffull));
      const int old = S.owner[i];
      if (old >= 0) {
        S.roc[old] = -1;  // an owner never bids, so never wins
      } else {
        atomicSub(&C.pending, 1);
      }
      S.roc[winner] = i;
      S.owner[i] = winner;
      S.price[i] = from_orderable((uint32_t)(key >> 32));
    }
    __syncthreads();
    ++rounds;
  }
  if (bids) atomicAdd(&C.bids, bids);

  // ---- greedy completion: the free real rows in order (warp 0)
  if (warp == 0) {
    int count = 0;
    for (int base = 0; base < n; base += 32) {
      const int i = base + lane;
      const bool free_real = i < n && S.owner[i] < 0 && S.real[i];
      const unsigned ballot = __ballot_sync(kFull, free_real);
      if (free_real) S.freelist[count + __popc(ballot & lanes_below(lane))] = i;
      count += __popc(ballot);
    }
    if (lane == 0) C.nfree = count;
  }
  __syncthreads();
  const int nfree = C.nfree;
  if (C.pending == 0) {
    // every valid column holds a row: the m-th invalid column takes the
    // m-th free real row, or row 0 once they are gone
    for (int j = threadIdx.x; j < t; j += kThreads) {
      const int cj = S.cmap[j];
      rows_out[j] = cj >= 0 ? S.roc[cj] : (-cj - 1 < nfree ? S.freelist[-cj - 1] : 0);
    }
  } else if (warp == 0) {
    // the round cap left valid columns without a row: fill's walk, columns
    // in order, a taken row marked by owner = t
    int next = 0;  // freelist[next] is the lowest free real row once taken ones are skipped
    for (int j = 0; j < t; ++j) {
      const int cj = S.cmap[j];
      int row;
      if (cj >= 0 && S.roc[cj] >= 0) {
        row = S.roc[cj];
      } else {
        if (cj >= 0) {
          row = free_best(rows(cj), S.owner, n, lane);
        } else {
          while (next < nfree && S.owner[S.freelist[next]] >= 0) ++next;
          row = next < nfree ? S.freelist[next] : 0;
        }
        __syncwarp();
        if (lane == 0) S.owner[row] = t;
      }
      if (lane == 0) rows_out[j] = row;
      __syncwarp();
    }
  }
  if (threadIdx.x == 0) {
    *rounds_out = rounds;
    *bids_out = C.bids;
  }
}

__global__ void __launch_bounds__(kThreads) fused_auction_kernel(
    const float* __restrict__ pn, const float* __restrict__ pbox,
    const float* __restrict__ patan, const float* __restrict__ tbox,
    const float* __restrict__ tatan, const int* __restrict__ labels,
    const uint8_t* __restrict__ colv, const uint8_t* __restrict__ rowv,
    float* __restrict__ value_all, int* __restrict__ rows_out, int* __restrict__ rounds_out,
    int* __restrict__ bids_out, int n, int t, int c, float cost_class, float cost_ciou, float eps_frac,
    int max_iters, int rows_smem) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Counts C;
  Solver S(smem, n, t, rows_smem);

  const int bi = blockIdx.x;
  const float* pn_b = pn + (long)bi * c * n;
  const float* pbox_b = pbox + (long)bi * n * 4;
  const float* patan_b = patan + (long)bi * n;
  const float* tbox_b = tbox + (long)bi * t * 4;
  const float* tatan_b = tatan + (long)bi * t;
  S.init(colv + (long)bi * t, rowv + (long)bi * n, n, t, C);
  __syncthreads();
  const int tv = C.tv;
  float* value = tv <= rows_smem ? S.vals : value_all + (long)bi * t * n;

  // ---- the value rows of the valid columns, and their range over real rows
  const float four_over_pi2 = 0.40528473456935108578f;  // 4 / pi^2, rounded once
  float vmax = -kBig, vmin = kBig;
  for (long idx = threadIdx.x; idx < (long)tv * n; idx += kThreads) {
    const int cj = (int)(idx / n), ni = (int)(idx - (long)cj * n);
    const int tj = S.vcol[cj];
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
    const bool row_ok = S.real[ni];
    value[idx] = row_ok ? -cost : -kBig;
    if (row_ok) {
      vmax = fmaxf(vmax, -cost);
      vmin = fminf(vmin, -cost);
    }
  }
  const float range = value_range(vmax, vmin, tv < t, C.scratch);
  __syncthreads();  // the rows are written
  solve(Rows{value, nullptr, n}, S, C, n, t, range, eps_frac, max_iters, rows_out + (long)bi * t,
        rounds_out + bi, bids_out + bi);
}

// _solve on a given (B, T, N) value matrix (rows that are not real already
// at -1e9, invalid columns as the header says; only valid columns are read).
__global__ void __launch_bounds__(kThreads) auction_kernel(
    const float* __restrict__ value_all, const uint8_t* __restrict__ colv,
    const uint8_t* __restrict__ rowv, int* __restrict__ rows_out, int* __restrict__ rounds_out,
    int* __restrict__ bids_out, int n, int t, float eps_frac, int max_iters, int rows_smem) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Counts C;
  Solver S(smem, n, t, rows_smem);

  const int bi = blockIdx.x;
  const float* value = value_all + (long)bi * t * n;
  S.init(colv + (long)bi * t, rowv + (long)bi * n, n, t, C);
  __syncthreads();
  const int tv = C.tv;
  const bool in_smem = tv <= rows_smem;

  float vmax = -kBig, vmin = kBig;
  for (long idx = threadIdx.x; idx < (long)tv * n; idx += kThreads) {
    const int cj = (int)(idx / n), ni = (int)(idx - (long)cj * n);
    const float val = value[(long)S.vcol[cj] * n + ni];
    if (in_smem) S.vals[idx] = val;
    if (S.real[ni]) {
      vmax = fmaxf(vmax, val);
      vmin = fminf(vmin, val);
    }
  }
  const float range = value_range(vmax, vmin, tv < t, C.scratch);
  __syncthreads();  // the rows are copied
  solve(in_smem ? Rows{S.vals, nullptr, n} : Rows{value, S.vcol, n}, S, C, n, t, range, eps_frac, max_iters,
        rows_out + (long)bi * t, rounds_out + bi, bids_out + bi);
}

}  // namespace

extern "C" {

int odtt_auction_abi_version() { return 4; }

// One problem per batch entry. pn (B, C, N), pbox (B, N, 4) cxcyhw,
// patan (B, N), tbox (B, T, 4) xyxy, tatan (B, T): float32. labels (B, T)
// int32, colv (B, T) and rowv (B, N) bytes. rows_smem: value rows a block
// keeps in shared memory (<= T); value: (B, T, N) float32 scratch for the
// problems with more valid columns than that (null when rows_smem == T).
// rows (B, T) int32, rounds (B,) int32 and bids (B,) int32 (the bids made
// over all rounds) out. Returns cudaGetLastError() after the launch (0 on
// success).
int odtt_fused_auction(const void* pn, const void* pbox, const void* patan, const void* tbox,
                       const void* tatan, const void* labels, const void* colv,
                       const void* rowv, void* value, void* rows, void* rounds, void* bids,
                       int b, int n, int t, int c, float cost_class, float cost_ciou,
                       float eps_frac, int max_iters, int rows_smem, void* stream) {
  if (b <= 0 || n <= 0 || t <= 0 || c <= 0 || t > n || rows_smem < 0 || rows_smem > t ||
      (rows_smem < t && value == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = Solver::bytes(n, t, rows_smem);
  cudaError_t err = cudaFuncSetAttribute(
      fused_auction_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_auction_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pn), static_cast<const float*>(pbox),
      static_cast<const float*>(patan), static_cast<const float*>(tbox),
      static_cast<const float*>(tatan), static_cast<const int*>(labels),
      static_cast<const uint8_t*>(colv), static_cast<const uint8_t*>(rowv),
      static_cast<float*>(value), static_cast<int*>(rows), static_cast<int*>(rounds),
      static_cast<int*>(bids), n, t, c, cost_class, cost_ciou, eps_frac, max_iters, rows_smem);
  return (int)cudaGetLastError();
}

// One problem per batch entry. value (B, T, N) float32 benefits (-1e9 on
// rows that are not real), colv (B, T) and rowv (B, N) bytes, rows_smem as
// above. rows (B, T) int32, rounds (B,) int32 and bids (B,) int32 out, as
// odtt_fused_auction. Returns cudaGetLastError() after the launch (0 on
// success).
int odtt_auction(const void* value, const void* colv, const void* rowv, void* rows, void* rounds,
                 void* bids, int b, int n, int t, float eps_frac, int max_iters, int rows_smem, void* stream) {
  if (b <= 0 || n <= 0 || t <= 0 || t > n || rows_smem < 0 || rows_smem > t) return (int)cudaErrorInvalidValue;
  const size_t smem = Solver::bytes(n, t, rows_smem);
  cudaError_t err =
      cudaFuncSetAttribute(auction_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  auction_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(value), static_cast<const uint8_t*>(colv),
      static_cast<const uint8_t*>(rowv), static_cast<int*>(rows), static_cast<int*>(rounds),
      static_cast<int*>(bids), n, t, eps_frac, max_iters, rows_smem);
  return (int)cudaGetLastError();
}

}  // extern "C"
