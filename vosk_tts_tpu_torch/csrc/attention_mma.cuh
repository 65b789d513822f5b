// Helpers shared by the attention kernels (banded_attention.cu,
// global_attention.cu): the 3xTF32 split, the m16n8k8 TF32 tensor-core
// product, cp.async copies and the per-tile core of a flash-attention walk
// (scores, online softmax, P.V) for one warp of 16 query rows; then the
// same core for bf16 operands (the m16n8k16 bf16 product, the end of this
// file).
//
// 3xTF32: x = hi + lo with hi = x rounded to TF32 (as cvt.rna.tf32.f32
// rounds: to nearest, ties away from zero) and lo = x - hi, exact in f32;
// the tensor core reads the top 19 bits of lo, so lo enters as TF32 too.
// a.b ~= a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, summed in f32 by the tensor
// core: the dropped a_lo.b_lo term and the cut of lo leave about 2^-20 of
// |a||b| per product, f32 accuracy, where one TF32 product alone keeps 2^-11
// (tests/test_torch_tf32_split.py emulates both).
//
// mma.m16n8k8 (tf32 in, f32 out) fragment layouts, g = lane / 4 (the
// "group"), t = lane % 4 (the thread in the group):
//   A (16 x 8, row): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4);
//   B (8 x 8, col):  b0 (k t, n g), b1 (k t+4, n g);
//   C (16 x 8):      c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1).
// Which feature or key a k or n index stands for is free, as long as both
// operands agree, and the kernels choose it so that every lane reads its
// operands as 16-byte vectors:
//  * S = Q.K^T: k-step kk's indices t and t+4 stand for features
//    f = 16*(kk/2) + 4t + 2*(kk%2) and f + 1, so a lane reads features
//    16m + 4t .. 16m + 4t + 3 of its key row, two k-steps, in one LDS.128;
//  * P.V: the C fragment of S holds keys 2t and 2t+1 of each 8-key chunk,
//    so the chunk's k indices t and t+4 stand for keys 2t and 2t+1 and P
//    is the A operand as it stands (a0 = c0, a1 = c2, a2 = c1, a3 = c3):
//    P never passes through shared memory. Output n-tile nd's index g
//    stands for column 32*(nd/4) + 4g + nd%4, so a lane reads V columns
//    32c + 4g .. 32c + 4g + 3 of a key row (four n-tiles) in one LDS.128,
//    and a lane's O columns are 32c + 8t + 4h + (0..3), h = 0, 1.
// Shared rows sit at strides that keep those reads free of bank conflicts:
// K at DW + 16 floats (16 mod 32: the 8 lanes of a quarter-warp, rows g
// and g+1, fill the 32 banks), V at DW + 4 (4 mod 16: rows 2t, 2t+2, ...
// fall 8 banks apart).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attn {

constexpr int BQ = 64;      // query rows per block: 4 warps of 16 rows
constexpr int WARPS = 4;    // one warpgroup
constexpr int THREADS = WARPS * 32;
constexpr int BK = 32;      // keys per tile of the ring
constexpr int NT = BK / 8;  // 8-key chunks per tile
constexpr int STAGES = 2;   // tiles in flight: j+1 loads while j computes
constexpr float NEG_INIT = -1e30f;

__host__ __device__ constexpr int k_stride(int dw) { return dw + 16; }
__host__ __device__ constexpr int v_stride(int dw) { return dw + 4; }
// floats of one ring stage (a K tile and a V tile)
__host__ __device__ constexpr int stage_floats(int dw) { return BK * (k_stride(dw) + v_stride(dw)); }

// hi and lo halves of x as TF32 operands: hi rounded as cvt.rna.tf32.f32
// rounds (add half a TF32 ulp to the magnitude's bits, clear the 13 low
// bits: two integer operations), lo = x - hi exact, its low bits left for
// the tensor core to ignore.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a.(b0, b1) in 3xTF32, small terms first.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4], float b0, float b1) {
  uint32_t b_hi[2], b_lo[2];
  split(b0, b_hi[0], b_lo[0]);
  split(b1, b_hi[1], b_lo[1]);
  mma_tf32(c, a_lo, b_hi);
  mma_tf32(c, a_hi, b_lo);
  mma_tf32(c, a_hi, b_hi);
}

__device__ __forceinline__ void split4(const float (&x)[4], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split(x[i], hi[i], lo[i]);
}

// split4 of a fragment that is the same on every key tile (q): the empty asm
// hides that from the compiler, which would otherwise hoist the split out of
// the key loop and hold both halves (twice q's registers, and spills).
__device__ __forceinline__ void split4_here(const float (&x)[4], uint32_t (&hi)[4],
                                            uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float y = x[i];
    asm volatile("" : "+f"(y));
    split(y, hi[i], lo[i]);
  }
}

// The feature that index e (0..3) of a lane's A fragment of q stands for in
// k-step kk (row g for even e, g+8 for odd e).
__device__ __forceinline__ int q_feature(int kk, int t, int e) {
  return 16 * (kk >> 1) + 4 * t + 2 * (kk & 1) + (e >> 1);
}

// cp.async of 16 or 4 bytes; src_bytes 0 fills the destination with zeros
// (rows past T) without reading src.
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage rows [j0, j0 + BK) of a (rows, d) slice whose row j starts at
// src + j * stride into dst (BK rows at stride ld): VEC floats per copy
// (4 when d, the stride and src allow 16-byte copies, else 1), the row cut
// in DW / VEC chunks (a constant, so no division at run time) of which
// those at or past d are skipped; rows at or past n_rows are zero-filled.
// Columns d..DW stay as they were (zeroed once by zero_pad).
template <int VEC, int DW>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src, long long stride,
                                          int j0, int n_rows, int d, int tid) {
  constexpr int CH = DW / VEC;
#pragma unroll 4
  for (int e = tid; e < BK * CH; e += THREADS) {
    const int r = e / CH;
    const int c = (e - r * CH) * VEC;
    if (c >= d) continue;
    const int j = j0 + r;
    const bool valid = j < n_rows;
    cp_async<4 * VEC>(dst + r * ld + c, valid ? src + (size_t)j * stride + c : src, valid);
  }
}

// The K tile and the V tile of ring stage st.
template <int DW>
__device__ __forceinline__ float* k_tile(float* ring, int st) {
  return ring + st * stage_floats(DW);
}
template <int DW>
__device__ __forceinline__ float* v_tile(float* ring, int st) {
  return ring + st * stage_floats(DW) + BK * k_stride(DW);
}

// Issue the cp.async copies of key tile j0 (K and V rows) into ring stage st.
template <int VEC, int DW>
__device__ __forceinline__ void load_stage(float* ring, int st, const float* kb, const float* vb,
                                           long long stride, int j0, int T, int d, int tid) {
  load_tile<VEC, DW>(k_tile<DW>(ring, st), k_stride(DW), kb, stride, j0, T, d, tid);
  load_tile<VEC, DW>(v_tile<DW>(ring, st), v_stride(DW), vb, stride, j0, T, d, tid);
}

// cp.async never writes columns d..DW of the ring: zero them once.
template <int DW>
__device__ __forceinline__ void zero_pad(float* ring, int d, int tid) {
  const int w = DW - d;
  for (int e = tid; e < STAGES * 2 * BK * w; e += THREADS) {
    const int r = e / w;  // per stage: BK rows of K, then BK rows of V
    const int st = r / (2 * BK), row = r % BK;
    float* base = (r / BK) & 1 ? v_tile<DW>(ring, st) + row * v_stride(DW)
                               : k_tile<DW>(ring, st) + row * k_stride(DW);
    base[d + (e - r * w)] = 0.f;
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// s = q.k^T for one warp's 16 rows against the BK keys of tile ks; qf holds
// the rows in the A-fragment layout (features as q_feature); the first n16
// k-step pairs hold features.
template <int NC>
__device__ __forceinline__ void score_tile(float (&s)[NT][4], const float (&qf)[4 * NC][4],
                                           const float* ks, int n16, int g, int t) {
  constexpr int LDK = k_stride(32 * NC);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int m = 0; m < 2 * NC; ++m) {
    if (m >= n16) continue;
    uint32_t ah0[4], al0[4], ah1[4], al1[4];
    split4_here(qf[2 * m], ah0, al0);
    split4_here(qf[2 * m + 1], ah1, al1);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float4 kv = *reinterpret_cast<const float4*>(ks + (nt * 8 + g) * LDK + 16 * m + 4 * t);
      mma_3xtf32(s[nt], ah0, al0, kv.x, kv.y);
      mma_3xtf32(s[nt], ah1, al1, kv.z, kv.w);
    }
  }
}

// The online softmax step of one tile: s (masked scores) becomes p, the
// running max m_i and the lane's partial sums l_i move, o is rescaled.
template <int NC>
__device__ __forceinline__ void softmax_tile(float (&s)[NT][4], float (&m_i)[2], float (&l_i)[2],
                                             float (&o)[4 * NC][4]) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float mx = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * hr], s[nt][2 * hr + 1]));
    mx = quad_max(mx);
    const float m_new = fmaxf(m_i[hr], mx);
    const float alpha = expf(m_i[hr] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = expf(s[nt][2 * hr + e] - m_new);
        s[nt][2 * hr + e] = p;
        sum += p;
      }
    l_i[hr] = l_i[hr] * alpha + sum;
    m_i[hr] = m_new;
#pragma unroll
    for (int nd = 0; nd < 4 * NC; ++nd) {
      o[nd][2 * hr] *= alpha;
      o[nd][2 * hr + 1] *= alpha;
    }
  }
}

// o += p.v over the BK keys of tile vs; p is s after softmax_tile.
template <int NC>
__device__ __forceinline__ void pv_tile(float (&o)[4 * NC][4], const float (&s)[NT][4],
                                        const float* vs, int g, int t) {
  constexpr int LDV = v_stride(32 * NC);
#pragma unroll
  for (int kc = 0; kc < NT; ++kc) {
    const float pa[4] = {s[kc][0], s[kc][2], s[kc][1], s[kc][3]};
    uint32_t ah[4], al[4];
    split4(pa, ah, al);
    const float* v0 = vs + (kc * 8 + 2 * t) * LDV + 4 * g;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float4 x0 = *reinterpret_cast<const float4*>(v0 + 32 * c);
      const float4 x1 = *reinterpret_cast<const float4*>(v0 + LDV + 32 * c);
      mma_3xtf32(o[4 * c], ah, al, x0.x, x1.x);
      mma_3xtf32(o[4 * c + 1], ah, al, x0.y, x1.y);
      mma_3xtf32(o[4 * c + 2], ah, al, x0.z, x1.z);
      mma_3xtf32(o[4 * c + 3], ah, al, x0.w, x1.w);
    }
  }
}

// Rows r0 and r0 + 8 of o / l (D features) to orow0 and orow1, those < T.
template <int NC>
__device__ __forceinline__ void store_rows(const float (&o)[4 * NC][4], const float (&l_i)[2],
                                           float* orow0, float* orow1, int r0, int T, int D,
                                           int t) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const float l = quad_sum(l_i[hr]);
    float* orow = hr ? orow1 : orow0;
    if (r0 + 8 * hr >= T) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = 32 * c + 8 * t + 4 * h + i;
          if (col < D) orow[col] = o[4 * c + i][2 * hr + h] / l;
        }
  }
}

__host__ __device__ inline bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// ---------------------------------------------------------------------------
// bf16: one mma.m16n8k16 (bf16 in, f32 out) a fragment, where f32 takes
// three m16n8k8 TF32 products. Fragment layouts (g = lane / 4, t = lane % 4),
// each register two bf16, the lower index in the low half:
//   A (16 x 16, row): a0 (g, 2t..2t+1), a1 (g+8, 2t..2t+1),
//                     a2 (g, 2t+8..2t+9), a3 (g+8, 2t+8..2t+9);
//   B (16 x 8, col):  b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g);
//   C (16 x 8):       as m16n8k8.
//  * S = Q.K^T: k-step h (0, 1) of 32-feature chunk c takes its indices
//    2t, 2t+1, 2t+8, 2t+9 to stand for features 32c + 8t + 4h + (0..3), so a
//    lane reads features 32c + 8t .. 32c + 8t + 7 of a key row, two k-steps,
//    in one LDS.128 (b0, b1 of step 0 = words 0, 1; of step 1 = words 2, 3);
//  * P.V: the k indices of a 16-key chunk stand for its keys in order, so
//    the A fragment is two n-tiles of S's C fragment, packed to bf16 (p is
//    rounded to bf16 here, as the JAX kernel rounds it before p.v); V
//    enters as B through ldmatrix.trans from its row-major tile, and output
//    n-tile nd is columns 8nd .. 8nd + 7 in order (a lane's: 8nd + 2t, +1).
// Shared rows: K at a stride of 32 mod 64 bf16 (64 mod 128 bytes: rows g
// and g+1 of a quarter-warp's 16-byte reads fall in the two halves of the
// banks), V at DW + 8 (an odd multiple of 16 bytes mod 128: ldmatrix's
// eight rows cover the 32 banks).

__host__ __device__ constexpr int k_stride_h(int dw) { return dw % 64 ? dw : dw + 32; }
__host__ __device__ constexpr int v_stride_h(int dw) { return dw + 8; }
// bf16 values of one ring stage (a K tile and a V tile)
__host__ __device__ constexpr int stage_halves(int dw) { return BK * (k_stride_h(dw) + v_stride_h(dw)); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices, transposed, from the rows whose addresses lanes
// 8m .. 8m + 7 give (matrix m).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* row) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// Stage rows [j0, j0 + BK) of a (rows, d) bf16 slice (row j at src + j *
// stride) into dst (BK rows at stride ld): 16-byte cp.async copies of 8
// values where d, the stride and src allow (VEC 8), else 2-byte loads and
// stores (VEC 1, visible after the caller's barrier); rows at or past
// n_rows are zero-filled. Columns d..DW stay as zero_pad_h left them.
template <int VEC, int DW>
__device__ __forceinline__ void load_tile_h(__nv_bfloat16* dst, int ld, const __nv_bfloat16* src,
                                            long long stride, int j0, int n_rows, int d, int tid) {
  constexpr int CH = DW / VEC;
#pragma unroll 4
  for (int e = tid; e < BK * CH; e += THREADS) {
    const int r = e / CH;
    const int c = (e - r * CH) * VEC;
    if (c >= d) continue;
    const int j = j0 + r;
    const bool valid = j < n_rows;
    if constexpr (VEC == 8) {
      const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst + r * ld + c);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                   "l"(valid ? src + (size_t)j * stride + c : src), "r"(valid ? 16 : 0));
    } else {
      dst[r * ld + c] = valid ? src[(size_t)j * stride + c] : __float2bfloat16(0.f);
    }
  }
}

template <int DW>
__device__ __forceinline__ __nv_bfloat16* k_tile_h(__nv_bfloat16* ring, int st) {
  return ring + st * stage_halves(DW);
}
template <int DW>
__device__ __forceinline__ __nv_bfloat16* v_tile_h(__nv_bfloat16* ring, int st) {
  return ring + st * stage_halves(DW) + BK * k_stride_h(DW);
}

template <int VEC, int DW>
__device__ __forceinline__ void load_stage_h(__nv_bfloat16* ring, int st, const __nv_bfloat16* kb,
                                             const __nv_bfloat16* vb, long long stride, int j0,
                                             int T, int d, int tid) {
  load_tile_h<VEC, DW>(k_tile_h<DW>(ring, st), k_stride_h(DW), kb, stride, j0, T, d, tid);
  load_tile_h<VEC, DW>(v_tile_h<DW>(ring, st), v_stride_h(DW), vb, stride, j0, T, d, tid);
}

// The copies never write columns d..DW of the ring (zero there, so that a
// padded feature adds 0 and never a NaN of stale memory): zero them once.
template <int DW>
__device__ __forceinline__ void zero_pad_h(__nv_bfloat16* ring, int d, int tid) {
  const int w = DW - d;
  for (int e = tid; e < STAGES * 2 * BK * w; e += THREADS) {
    const int r = e / w;  // per stage: BK rows of K, then BK rows of V
    const int st = r / (2 * BK), row = r % BK;
    __nv_bfloat16* base = (r / BK) & 1 ? v_tile_h<DW>(ring, st) + row * v_stride_h(DW)
                                       : k_tile_h<DW>(ring, st) + row * k_stride_h(DW);
    base[d + (e - r * w)] = __float2bfloat16(0.f);
  }
}

// Features 32c + 8t .. 32c + 8t + 7 of q row `row` (D features, zero past D
// or past T) packed as this lane's A fragments of chunk c: words qa[2c][0 or
// 2] (row g's k-step 0, features +0..1 and +2..3) and so on. q_at(i, f)
// reads feature f of row i as a float (rotated and scaled as the caller
// needs); the value is rounded to bf16 here.
template <int NC, typename QAt>
__device__ __forceinline__ void load_q_h(uint32_t (&qa)[2 * NC][4], int r0, int T, int D, int t,
                                         QAt q_at) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {  // rows r0 (a0, a2), r0 + 8 (a1, a3)
      const int i = r0 + 8 * hr;
      float f[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int col = 32 * c + 8 * t + e;
        f[e] = i < T && col < D ? q_at(i, col) : 0.f;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        qa[2 * c + h][hr] = pack_bf16(f[4 * h], f[4 * h + 1]);
        qa[2 * c + h][2 + hr] = pack_bf16(f[4 * h + 2], f[4 * h + 3]);
      }
    }
}

// s = q.k^T for one warp's 16 rows against the BK keys of tile ks; the
// first n32 chunks of 32 features hold features.
template <int NC>
__device__ __forceinline__ void score_tile_h(float (&s)[NT][4], const uint32_t (&qa)[2 * NC][4],
                                             const __nv_bfloat16* ks, int n32, int g, int t) {
  constexpr int LDK = k_stride_h(32 * NC);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (c >= n32) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint4 kv = *reinterpret_cast<const uint4*>(ks + (nt * 8 + g) * LDK + 32 * c + 8 * t);
      mma_bf16(s[nt], qa[2 * c], kv.x, kv.y);
      mma_bf16(s[nt], qa[2 * c + 1], kv.z, kv.w);
    }
  }
}

// o += p.v over the BK keys of tile vs; p is s after softmax_tile, rounded
// to bf16 here. o[nd] is output columns 8nd .. 8nd + 7.
template <int NC>
__device__ __forceinline__ void pv_tile_h(float (&o)[4 * NC][4], const float (&s)[NT][4],
                                          const __nv_bfloat16* vs, int lane) {
  constexpr int LDV = v_stride_h(32 * NC);
  const int m = lane >> 3, r = lane & 7;  // this lane's row address: matrix m, row r
#pragma unroll
  for (int kc = 0; kc < NT / 2; ++kc) {  // 16-key chunks: n-tiles 2kc, 2kc + 1 of s
    const uint32_t pa[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                            pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                            pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                            pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
    // matrices: (keys 0-7, cols 0-7), (keys 8-15, cols 0-7), (keys 0-7, cols
    // 8-15), (keys 8-15, cols 8-15) of each 16-column pair
    const __nv_bfloat16* row = vs + (16 * kc + r + 8 * (m & 1)) * LDV + 8 * (m >> 1);
#pragma unroll
    for (int np = 0; np < 2 * NC; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, row + 16 * np);
      mma_bf16(o[2 * np], pa, b[0], b[1]);
      mma_bf16(o[2 * np + 1], pa, b[2], b[3]);
    }
  }
}

// Rows r0 and r0 + 8 of o / l (D features, D even) to orow0 and orow1 as
// bf16 pairs, those rows < T.
template <int NC>
__device__ __forceinline__ void store_rows_h(const float (&o)[4 * NC][4], const float (&l_i)[2],
                                             __nv_bfloat16* orow0, __nv_bfloat16* orow1, int r0,
                                             int T, int D, int t) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const float inv = 1.f / quad_sum(l_i[hr]);
    __nv_bfloat16* orow = hr ? orow1 : orow0;
    if (r0 + 8 * hr >= T) continue;
#pragma unroll
    for (int nd = 0; nd < 4 * NC; ++nd) {
      const int col = 8 * nd + 2 * t;
      if (col < D)
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack_bf16(o[nd][2 * hr] * inv, o[nd][2 * hr + 1] * inv);
    }
  }
}

}  // namespace attn
