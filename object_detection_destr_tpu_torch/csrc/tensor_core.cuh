// Warp-level tensor-core building blocks shared by the flash-attention
// kernels (flash_attention_fwd.cu, flash_attention_bwd.cu,
// flash_attention_bwd_two_pass.cu): cp.async 16-byte copies into shared
// memory, ldmatrix, mma.sync.aligned.m16n8k16 with bfloat16 operands and
// float32 sums, and the float32 kernels' (the forward's, the fused
// backward's and the two-pass backward's) mma.sync.aligned.m16n8k8 with tf32
// operands (3xTF32: big / small halves of each float32 operand).
//
// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4), as the PTX ISA
// defines them:
//   A (16 x 16, row-major) a[0]: (g, 2t..2t+1)   a[1]: (g+8, 2t..)
//                          a[2]: (g, 2t+8..)     a[3]: (g+8, 2t+8..)
//   B (16 x 8, k x n)      b[0]: (2t..2t+1, g)   b[1]: (2t+8.., g)
//   C (16 x 8, float32)    c[0], c[1]: (g, 2t), (g, 2t+1)
//                          c[2], c[3]: (g+8, 2t), (g+8, 2t+1)
// Shared-memory tiles are row-major with rows padded by 8 elements (16
// bytes), so the 8 row addresses of an ldmatrix fall in 8 different bank
// groups.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

constexpr int kPad = 8;  // bf16 elements of padding after each shared row

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-fills when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copies `rows` rows of `cols` bf16 values (global row stride `src_stride`)
// into a shared tile with row stride `dst_stride`; rows at or past
// `rows_valid` become zeros. With `vec` (cols a multiple of 8, every row
// start 16-byte aligned) by 16-byte cp.async, which the caller commits and
// waits for; otherwise by plain element copies. Columns from `cols` up to
// the next multiple of 16 become zeros (a ring slot may hold a wider chunk
// from before), so an mma over 16 columns reads no stale values.
template <int kThreads>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, int dst_stride, const __nv_bfloat16* src,
                                          long src_stride, int rows, int rows_valid, int cols, bool vec) {
  const int tail = (cols + 15) / 16 * 16 - cols;
  for (int i = threadIdx.x; i < rows * tail; i += kThreads) {
    const int r = i / tail;
    dst[r * dst_stride + cols + (i - r * tail)] = __float2bfloat16(0.f);
  }
  if (vec) {
    const int per_row = cols / 8;
    for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
      const int r = i / per_row, c = (i - r * per_row) * 8;
      const bool valid = r < rows_valid;
      cp_async16(dst + r * dst_stride + c, src + (valid ? r * src_stride + c : 0), valid);
    }
    return;
  }
  for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
    const int r = i / cols, c = i - r * cols;
    dst[r * dst_stride + c] = r < rows_valid ? src[r * src_stride + c] : __float2bfloat16(0.f);
  }
}

// Four 8x8 bf16 matrices; lane i gives the address of row i % 8 of matrix
// i / 8 and receives element (lane / 4, 2 (lane % 4) ..+1) of each (with
// .trans, element (2 (lane % 4) ..+1, lane / 4)).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a * b on the tensor cores (bf16 x bf16 -> f32).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (lower address)
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment of rows r0..r0+15, columns c0..c0+15 of a row-major tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int stride,
                                       int r0, int c0, int lane) {
  const int row = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int col = c0 + (lane >> 4) * 8;
  ldmatrix_x4(a, tile + row * stride + col);
}

// A fragment (m = column index, k = row index) of the transpose of a
// row-major tile: A[m][k] = tile[k0 + k][m0 + m].
__device__ __forceinline__ void load_a_trans(uint32_t (&a)[4], const __nv_bfloat16* tile, int stride,
                                             int k0, int m0, int lane) {
  const int row = k0 + (lane & 7) + (lane >> 4) * 8;
  const int col = m0 + ((lane >> 3) & 1) * 8;
  ldmatrix_x4_trans(a, tile + row * stride + col);
}

// B fragments of two n-tiles (n0..n0+7 in b[0..1], n0+8..n0+15 in b[2..3])
// when B[k][n] = tile[n][k] (the tile's rows are B's columns: K in Q K^T).
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[4], const __nv_bfloat16* tile, int stride,
                                            int n0, int k0, int lane) {
  const int row = n0 + (lane & 7) + (lane >> 4) * 8;
  const int col = k0 + ((lane >> 3) & 1) * 8;
  ldmatrix_x4(b, tile + row * stride + col);
}

// Two 8x8 bf16 matrices (lanes 0-15 give the row addresses).
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// B fragment of one n-tile (n0..n0+7) when B[k][n] = tile[n][k].
__device__ __forceinline__ void load_b_rows8(uint32_t (&b)[2], const __nv_bfloat16* tile, int stride,
                                             int n0, int k0, int lane) {
  const int row = n0 + (lane & 7);
  const int col = k0 + ((lane >> 3) & 1) * 8;
  ldmatrix_x2(b, tile + row * stride + col);
}

// B fragments of two n-tiles when B[k][n] = tile[k][n] (V in P V).
__device__ __forceinline__ void load_b_cols(uint32_t (&b)[4], const __nv_bfloat16* tile, int stride,
                                            int k0, int n0, int lane) {
  const int row = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int col = n0 + (lane >> 4) * 8;
  ldmatrix_x4_trans(b, tile + row * stride + col);
}

// ---- tf32 (the float32 forward, fused backward and two-pass backward)
// m16n8k8 tf32 fragments (g = lane / 4, t = lane % 4), as the PTX ISA
// defines them; one 32-bit register an element:
//   A (16 x 8)  a[0]: (g, t)  a[1]: (g+8, t)  a[2]: (g, t+4)  a[3]: (g+8, t+4)
//   B (8 x 8)   b[0]: (t, g)  b[1]: (t+4, g)
//   C (16 x 8)  as m16n8k16's.
// A product sums over k, so a kernel may map the 8 k slots to its columns in
// any order that A and B share.

// x rounded to tf32 (10 mantissa bits, to nearest, ties away from zero),
// as the bits of a float32.
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small to within 2^-22 |x|: big = tf32(x), small = tf32(x - big).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

// x = big + small for the tensor cores at two integer / float operations:
// big = x with its 13 low mantissa bits cleared (x truncated to tf32), small
// = x - big (exact) passed whole, of which the tensor cores read the top 19
// bits. x is kept to within 2^-20 |x| (split_tf32's rounding, 2^-22, costs
// two conversions more).
__device__ __forceinline__ void split_tf32_trunc(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// c += a * b on the tensor cores (tf32 x tf32 -> f32).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b in 3xTF32 from split operands: the small x big and big x small
// products first, then big x big; the small x small term (2^-22 of the
// product) is left out. About float32's accuracy at 3 tf32 products.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&a_big)[4], const uint32_t (&a_small)[4],
                                           uint32_t b0_big, uint32_t b1_big, uint32_t b0_small, uint32_t b1_small) {
  mma_tf32(c, a_small, b0_big, b1_big);
  mma_tf32(c, a_big, b0_small, b1_small);
  mma_tf32(c, a_big, b0_big, b1_big);
}

// Copies `rows` rows of `cols` float32 values (global row stride
// `src_stride`) into a shared tile with row stride `dst_stride`, as
// load_rows does for bf16, with `threads` threads of which this is `tid`:
// rows at or past `rows_valid` become zeros, and so do the columns from
// `cols` up to the next multiple of 8 (one tf32 k-step). `vec`: cols a
// multiple of 4 and every row start 16-byte aligned (16-byte cp.async,
// committed and waited for by the caller); otherwise element copies. kFull:
// the usual width, whose pieces a row are a constant (no division), or 0.
template <int kFull>
__device__ __forceinline__ void load_rows_f32(float* dst, int dst_stride, const float* src, long src_stride,
                                              int rows, int rows_valid, int cols, bool vec, int tid, int threads) {
  if constexpr (kFull > 0) {
    if (vec && cols == kFull) {
      constexpr int kPer = kFull / 4;
      for (int i = tid; i < rows * kPer; i += threads) {
        const int r = i / kPer, c = (i % kPer) * 4;
        const bool valid = r < rows_valid;
        cp_async16(dst + r * dst_stride + c, src + (valid ? r * src_stride + c : 0), valid);
      }
      return;
    }
  }
  const int tail = (cols + 7) / 8 * 8 - cols;
  for (int i = tid; i < rows * tail; i += threads) {
    const int r = i / tail;
    dst[r * dst_stride + cols + (i - r * tail)] = 0.f;
  }
  if (vec) {
    const int per_row = cols / 4;
    for (int i = tid; i < rows * per_row; i += threads) {
      const int r = i / per_row, c = (i - r * per_row) * 4;
      const bool valid = r < rows_valid;
      cp_async16(dst + r * dst_stride + c, src + (valid ? r * src_stride + c : 0), valid);
    }
    return;
  }
  for (int i = tid; i < rows * cols; i += threads) {
    const int r = i / cols, c = i - r * cols;
    dst[r * dst_stride + c] = r < rows_valid ? src[r * src_stride + c] : 0.f;
  }
}

// Columns of one chain of mma in mma_abt_3xtf32: the tensor cores' float32
// accumulation is not IEEE round-to-nearest, so chains stay short and are
// summed in IEEE float32.
constexpr int kTf32Chunk = 64;

// c = A B^T in 3xTF32 for A's 16 rows (stride sa) and B's 8 rows (stride
// sb), row-major over `width` columns (zero-padded to a multiple of 8; none
// when width <= 0); g, t as above. k slot t of a k-step holds
// column 2t and slot t + 4 column 2t + 1, so each thread's operand values
// are float2 reads. Each 64-column chunk sums big x big, big x small and
// small x big in three accumulators (8 mma each), added in IEEE float32.
__device__ __forceinline__ void mma_abt_3xtf32(float (&c)[4], const float* a, int sa, const float* b, int sb,
                                               int width, int g, int t) {
  c[0] = c[1] = c[2] = c[3] = 0.f;
  const float* a0 = a + g * sa + 2 * t;
  const float* a1 = a0 + 8 * sa;
  const float* b0 = b + g * sb + 2 * t;
  for (int c0 = 0; c0 < width; c0 += kTf32Chunk) {
    const int steps = (min(kTf32Chunk, width - c0) + 7) / 8;
    float part[3][4] = {};
#pragma unroll
    for (int kk = 0; kk < kTf32Chunk / 8; ++kk) {
      if (kk >= steps) break;
      const int col = c0 + kk * 8;
      const float2 lo = *reinterpret_cast<const float2*>(a0 + col);
      const float2 hi = *reinterpret_cast<const float2*>(a1 + col);
      const float2 bv = *reinterpret_cast<const float2*>(b0 + col);
      uint32_t ab[4], as[4], bb0, bb1, bs0, bs1;
      split_tf32_trunc(lo.x, ab[0], as[0]);
      split_tf32_trunc(hi.x, ab[1], as[1]);
      split_tf32_trunc(lo.y, ab[2], as[2]);
      split_tf32_trunc(hi.y, ab[3], as[3]);
      split_tf32_trunc(bv.x, bb0, bs0);
      split_tf32_trunc(bv.y, bb1, bs1);
      mma_tf32(part[0], ab, bb0, bb1);
      mma_tf32(part[1], ab, bs0, bs1);
      mma_tf32(part[2], as, bb0, bb1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] += part[0][e] + (part[1][e] + part[2][e]);
  }
}

// The A fragment of one k-step (tf32 big and small halves) from four
// float32 values.
__device__ __forceinline__ void split_a(uint32_t (&big)[4], uint32_t (&small)[4], float x0, float x1, float x2,
                                        float x3) {
  split_tf32_trunc(x0, big[0], small[0]);
  split_tf32_trunc(x1, big[1], small[1]);
  split_tf32_trunc(x2, big[2], small[2]);
  split_tf32_trunc(x3, big[3], small[3]);
}

// c[n] += A B[:, 8n..8n+7] in 3xTF32 for the n-tiles below `width`: A's big
// and small fragments given, B's k-step rows t and t + 4 at b[0] and b[4 sb]
// (column g of each n-tile; b points at column g of n-tile 0).
template <int kNt>
__device__ __forceinline__ void mma_row_3xtf32(float (&c)[kNt][4], const uint32_t (&big)[4],
                                               const uint32_t (&small)[4], const float* b, int sb, int width) {
#pragma unroll
  for (int n = 0; n < kNt; ++n) {
    if (n * 8 >= width) break;
    uint32_t bb0, bb1, bs0, bs1;
    split_tf32_trunc(b[8 * n], bb0, bs0);
    split_tf32_trunc(b[4 * sb + 8 * n], bb1, bs1);
    mma_3xtf32(c[n], big, small, bb0, bb1, bs0, bs1);
  }
}

}  // namespace tc
