// Design 2 of flash_two_pass_f32_kernel (tried and not taken; see design2.py):
// the float32 section of csrc/flash_attention_bwd_two_pass.cu with the own
// rows' A fragments in registers, 16-row stages and dK / dV in separate
// column slices. design2.py splices it into a copy of the source.
// ---- float32 on the tensor cores, in 3xTF32
constexpr int kF32TR = 16;           // streamed rows a stage: two n-tiles of S, two k-steps of the gradient
constexpr int kF32Ps = kF32TR + 4;   // row stride of the factor tile: rows g apart hit different banks
constexpr int kF32Slots = kTcWarps + 1;  // partial S / dP tiles: one a warp, two for the warp at the S / dP seam

// Row stride, in floats, of a float32 tile `w` columns wide: 8 mod 32 words,
// so the float2 reads (rows g, columns 2t..2t+1) of S's B fragments and the
// gradient's B reads (rows t and t + 4, column g) hit different banks.
__host__ __device__ inline int f32_stride(int w) { return round_up(w, 32) + 8; }

// Shared-memory layout of flash_two_pass_f32_kernel, in bytes from the
// start: 2 stages of the 16 streamed rows (d-wide, then dv-wide), the
// warps' partial S and dP tiles ([slot][own][streamed]) and the tile of the
// slice's factor (own x streamed: dS or P keep).
struct F32Layout {
  int s1, s2;  // row strides of the d-wide and the dv-wide tiles
  size_t part, f, total;
  __host__ __device__ F32Layout(int d, int dv) {
    s1 = f32_stride(d);
    s2 = f32_stride(dv);
    part = sizeof(float) * 2 * kF32TR * (s1 + s2);
    f = part + sizeof(float) * kF32Slots * kTcRows * kF32TR;
    total = f + sizeof(float) * kTcRows * kF32Ps;
  }
};

// DKV: the dkv pass (own rows are keys; streamed, query rows) or the dq pass
// (own rows are query rows; streamed, keys). KPW: the most 8-column k-steps
// of S and dP a warp takes. A block owns 16 rows and one slice of at most
// 1024 gradient columns (of dK or dQ, slices 0..n1-1, factor dS; or of dV,
// factor P keep, which needs S alone), as the wide kernels' blocks do.
template <bool DKV, int KPW>
__global__ void __launch_bounds__(kTcThreads) flash_two_pass_f32_kernel(Params a, int n1, int n_sl) {
  constexpr int kJobs = KPW < kWideSlice / 8 / kTcWarps ? KPW : kWideSlice / 8 / kTcWarps;  // 8-column jobs a warp
  const uint32_t seed = philox::load_seed(a.seed, a.drop_threshold);
  extern __shared__ __align__(16) unsigned char smem[];
  const F32Layout L(a.d, a.dv_);
  float* str_s = reinterpret_cast<float*>(smem);         // 2 stages: 16 d-wide rows, then 16 dv-wide
  float* part = reinterpret_cast<float*>(smem + L.part);  // [slot][own][streamed]
  float* f_s = reinterpret_cast<float*>(smem + L.f);      // (own, streamed)

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
  const uint32_t bh = (uint32_t)(bi * a.num_heads + hh);
  const long stat0 = ((long)bi * a.num_heads + hh) * a.sq;
  const int nd8 = (a.d + 7) / 8, ndv8 = (a.dv_ + 7) / 8;
  const int ksteps = first ? nd8 + ndv8 : nd8;  // S over d, then dP over dv (P keep needs S alone)
  const int kpw = (ksteps + kTcWarps - 1) / kTcWarps;
  const int jobs = (sw + 7) / 8;  // the slice's 8-column jobs, round robin over the warps
  const int n_it = (n_str + kF32TR - 1) / kF32TR;
  const int stage = kF32TR * (L.s1 + L.s2);
  // this warp's k-steps [j0, j1); the partial slots: S of warps [0, n_s), dP
  // of warps [w_dp, ...) in slots n_s + (w - w_dp)
  const int j0 = min(warp * kpw, ksteps), j1 = min(j0 + kpw, ksteps);
  const int n_s = (nd8 + kpw - 1) / kpw, w_dp = nd8 / kpw;
  const int n_dp = first ? (ksteps + kpw - 1) / kpw - w_dp : 0;

  auto load = [&](int it) {
    const int r0 = it * kF32TR;
    float* st = str_s + (it & 1) * stage;
    tc::load_rows_f32<0>(st, L.s1, x1 + sx1.off(bi, hh, r0), sx1.s, kF32TR, n_str - r0, a.d, a.vec_b, threadIdx.x,
                         kTcThreads);
    tc::load_rows_f32<0>(st + kF32TR * L.s1, L.s2, x2 + sx2.off(bi, hh, r0), sx2.s, kF32TR, n_str - r0, a.dv_,
                         a.vec_b, threadIdx.x, kTcThreads);
    tc::cp_async_commit();
  };
  load(0);

  // this warp's A fragments of the own rows, in float32 registers (split into
  // tf32 halves where they are used): k-step j0 + i, rows g and g + 8,
  // columns 2t and 2t + 1 of its 8 (k slots t and t + 4), zero past the rows
  // and the widths
  float2 oa[KPW][2];
#pragma unroll
  for (int i = 0; i < KPW; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + i, row = own0 + g + 8 * h;
      const bool s_col = j < nd8;
      const int col = (s_col ? 8 * j : 8 * (j - nd8)) + 2 * t, width = s_col ? a.d : a.dv_;
      const float* src = s_col ? a1 + sa1.off(bi, hh, row) : a2 + sa2.off(bi, hh, row);
      const bool in = j < j1 && row < n_own;
      oa[i][h] = make_float2(in && col < width ? src[col] : 0.f, in && col + 1 < width ? src[col + 1] : 0.f);
    }
  }

  // step 2's pairs: thread i takes own row i / 16 and streamed row i % 16 of
  // every stage; its own row's key state (dkv) or lse and delta (dq) once,
  // its streamed row's one stage ahead, so the loads' latency hides
  const int pr = threadIdx.x / kF32TR, pc = threadIdx.x % kF32TR, own = own0 + pr;
  auto key_state = [&](int key) {  // 1 valid, 0 masked, -1 past Sk
    return key >= a.sk ? -1 : (a.key_valid == nullptr ? 1 : (a.key_valid[(long)bi * a.sk + key] != 0));
  };
  const int own_state = DKV ? key_state(own) : 1;
  const float own_lse = !DKV && own < a.sq ? a.lse[stat0 + own] : 0.f;
  const float own_delta = !DKV && own < a.sq ? a.delta[stat0 + own] : 0.f;
  float nx_lse = 0.f, nx_delta = 0.f;
  int nx_state = 1;
  auto fetch = [&](int it) {
    const int str = it * kF32TR + pc;
    if (DKV) {
      nx_lse = str < a.sq ? a.lse[stat0 + str] : 0.f;
      nx_delta = str < a.sq ? a.delta[stat0 + str] : 0.f;
    } else {
      nx_state = key_state(str);
    }
  };
  fetch(0);

  float acc[kJobs][4];
#pragma unroll
  for (int i = 0; i < kJobs; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    tc::cp_async_wait<0>();
    __syncthreads();  // stage it has landed; the other stage and the partial and factor tiles are free
    const float lse_c = nx_lse, delta_c = nx_delta;
    const int state_c = nx_state;
    if (it + 1 < n_it) {
      load(it + 1);
      fetch(it + 1);
    }
    const float* st1 = str_s + (it & 1) * stage;
    const float* st2 = st1 + kF32TR * L.s1;

    // 1. partial S (own x streamed) over this warp's k-steps of d, then dP of
    // dv: each 4 k-steps' products (12 mma an n-tile) in fresh accumulators,
    // added in IEEE float32
    float tp[2][4] = {}, c[2][4] = {};
    auto flush = [&]() {
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          tp[n][e] += c[n][e];
          c[n][e] = 0.f;
        }
    };
    auto store = [&](int slot) {
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; e += 2)
          *reinterpret_cast<float2*>(part + (slot * kTcRows + g + 4 * e) * kF32TR + 8 * n + 2 * t) =
              make_float2(tp[n][e], tp[n][e + 1]);
    };
#pragma unroll
    for (int i = 0; i < KPW; ++i) {
      const int j = j0 + i;
      if (j >= j1) break;
      if (j == nd8 && i > 0) {  // the seam: this warp's S is complete
        flush();
        store(warp);
#pragma unroll
        for (int n = 0; n < 2; ++n) tp[n][0] = tp[n][1] = tp[n][2] = tp[n][3] = 0.f;
      }
      uint32_t ab[4], as[4];
      tc::split_a(ab, as, oa[i][0].x, oa[i][1].x, oa[i][0].y, oa[i][1].y);
      const bool s_col = j < nd8;
      const int sb = s_col ? L.s1 : L.s2;
      const float* xb = (s_col ? st1 + 8 * j : st2 + 8 * (j - nd8)) + g * sb + 2 * t;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const float2 bv = *reinterpret_cast<const float2*>(xb + 8 * n * sb);
        uint32_t bb0, bb1, bs0, bs1;
        tc::split_tf32_trunc(bv.x, bb0, bs0);
        tc::split_tf32_trunc(bv.y, bb1, bs1);
        tc::mma_3xtf32(c[n], ab, as, bb0, bb1, bs0, bs1);
      }
      if ((i & 3) == 3) flush();
    }
    if (j0 < j1) {
      flush();
      store(j1 - 1 < nd8 ? warp : n_s + warp - w_dp);
    }
    __syncthreads();

    // 2. the pairs: the partial sums in warp order, p, the keep bit, and the
    // slice's factor (dS, or P keep)
    {
      float dot = 0.f, dp = 0.f;
      for (int w = 0; w < n_s; ++w) dot += part[w * kTcRows * kF32TR + threadIdx.x];
      for (int w = 0; w < n_dp; ++w) dp += part[(n_s + w) * kTcRows * kF32TR + threadIdx.x];
      const int str = it * kF32TR + pc;
      const int row = DKV ? str : own, key = DKV ? own : str;
      const int state = DKV ? own_state : state_c;
      float pd = 0.f, ds = 0.f;
      if (state >= 0 && row < a.sq)
        ds = pair_grad(a, state, dot, dp, DKV ? lse_c : own_lse, DKV ? delta_c : own_delta, seed, bh, row, key, pd);
      f_s[pr * kF32Ps + pc] = first ? ds : pd;
    }
    __syncthreads();

    // 3. this warp's jobs of the slice: grad += factor x the streamed rows'
    // columns, k = the stage's 16 rows (two k-steps, six mma a job into fresh
    // registers, added to its accumulators in IEEE float32)
    uint32_t fb[2][4], fs[2][4];
#pragma unroll
    for (int kh = 0; kh < 2; ++kh) {
      const float* fa = f_s + g * kF32Ps + 8 * kh + t;
      tc::split_a(fb[kh], fs[kh], fa[0], fa[8 * kF32Ps], fa[4], fa[8 * kF32Ps + 4]);
    }
    const int sg = first ? L.s1 : L.s2;
    const float* xg = (first ? st1 : st2) + col0 + t * sg + g;
#pragma unroll
    for (int i = 0; i < kJobs; ++i) {
      const int job = warp + kTcWarps * i;
      if (job >= jobs) break;
      float cj[1][4] = {};
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) tc::mma_row_3xtf32<1>(cj, fb[kh], fs[kh], xg + 8 * kh * sg + 8 * job, sg, 8);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] += cj[0][e];
    }
  }

  // each gradient element of the slice written once, in float32
  float* grad = static_cast<float*>(DKV ? (first ? a.dk : a.dv) : a.dq);
  const Strides sgr = DKV ? (first ? a.sk_ : a.sv_) : a.sq_;
#pragma unroll
  for (int i = 0; i < kJobs; ++i) {
    const int job = warp + kTcWarps * i;
    if (job >= jobs) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int orow = own0 + g + 8 * (e >> 1), col = 8 * job + 2 * t + (e & 1);
      if (orow < n_own && col < sw) grad[sgr.off(bi, hh, orow) + col0 + col] = acc[i][e];
    }
  }
}

