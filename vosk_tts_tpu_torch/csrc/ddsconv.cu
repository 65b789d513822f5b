// Fused DDSConv stack (the stochastic duration predictor's context net).
//
// Replaces the TPU kernel vosk_tts_tpu/ops/ddsconv_fused.py::_kernel
// (wrapper ddsconv_fused). For layers i = 0..L-1 (dilation K^i, 'same'
// zero padding):
//   y = depthwise_conv(x * mask) + sep_b        (K taps, per channel)
//   y = gelu(layer_norm(y))                     (eps 1e-5, exact erf GELU)
//   y = gelu(layer_norm(y @ pw_w^T + pw_b))     (C x C pointwise)
//   x = x + y                                   (residual NOT masked)
// and the output is x * mask.
//
// What bounds it on Hopper: at the shapes the VITS2 path gives it (B1-16,
// T 64-256, C 256, L 3) the work is small (2*B*T*C^2*L products, x and out
// once, 0.8 MB of weights from L2), so its bound is 0.3-6 us, and what the
// card takes is latency: a row tile's serial chain of three layers, each a
// depthwise conv, two LayerNorms over all C channels and a C x C product,
// every step a chain of dependent instructions of a few warps.
// The design shortens that chain and spreads it over more SMs:
//  * channels split across a thread-block cluster: one row tile (a
//    multiple of 16 output rows, the smallest whose clusters run in the
//    fewest waves the card allows: make_plan; plus the halo of
//    sum_i K^i (K-1)/2 rows each side) is computed by a cluster of C/32
//    CTAs, CTA `rank` owning channels [32 rank, 32 rank + 32). The
//    depthwise conv and the residual are per channel, so each CTA keeps
//    only its slice of x. In the row passes a warp takes 4 rows, 8 lanes a
//    row and 4 channels a lane (16-byte accesses); a LayerNorm row's
//    (mean, M2) over the slice is an 8-lane reduction, pushed to every CTA
//    of the cluster through distributed shared memory and merged there
//    (Chan's formula: no E[x^2] - mean^2 cancellation). GELU(LN1) is
//    all-gathered: each CTA stores its slice of every row into every CTA's
//    full-C branch buffer. Each CTA then computes its 32 output channels
//    of the pointwise product into its own slice of that buffer for LN2.
//    Three cluster barriers a layer; LN1 and LN2 partials have buffers of
//    their own, so a CTA that runs ahead never overwrites what another
//    still reads. B1 T64 launches 4 clusters of 8 CTAs (32 SMs), B1 T128 8
//    (16-row tiles), B16 T256 48 (96-row tiles, 4 waves of 15 on an H100 SXM);
//  * the pointwise product on the tensor cores in 3xTF32, at f32 accuracy
//    (the split of attention_mma.cuh): TF32 wgmma m64n32k8, A (the branch
//    rows, K-major) split in registers, B (pw_w is stored (C_out, C_in):
//    K-major too, no transpose) as TF32-rounded high and low halves in
//    shared memory in the 128-byte-swizzled layout its descriptor names;
//    per k-step lo.hi + hi.lo into one sum and hi.hi into another, a 32-
//    channel block's twelve products in one commit group, warpgroups
//    splitting the m-tiles and the k blocks (the shares meet in the slice
//    with the bias). Where a long halo leaves no room for the low halves,
//    mma.sync m16n8k8 takes the product from the same buffers (both
//    operands split in registers). The branch buffer's columns are XORed
//    per row (swz) so that both products' fragment reads are free of bank
//    conflicts;
//  * the weights reach shared memory by cp.async (16-byte copies where
//    pw_w is 16-byte aligned), never through registers: each CTA's 32 x C
//    slice of up to three layers is requested at the start, so the copies
//    overlap layer 0's conv and LN1, and a ring refills the stage of layer
//    i with layer i + S after layer i's product when L > S; the split into
//    halves runs beside the gather. The slice's per-channel parameters
//    (conv taps, biases, LayerNorm affines) come with x where they fit, so
//    no row pass waits on device memory.
// What holds it back now: the chain itself, in comparable shares: the
// three products (wgmma m64n32k8 issues well below the tensor cores' rate
// at N = 32), the ten cluster barriers, and the latency of the row passes
// and the all-gather; at B16 T256 the clusters run in waves.
// 512 threads a CTA (16 warps), one CTA an SM (184-221 KB of shared memory
// at C 256, L 3, 16-96 rows). C % 32 == 0, C <= 256, odd K, any L whose
// window fits; x at any 4-byte alignment.
//
// ddsconv_bf16 (the JAX kernel in bf16): the same cluster walk over bf16 x,
// mask and weights, with the JAX kernel's roundings. x, the mask and the
// per-channel parameters are read as bf16 and widened to f32 in shared
// memory (the parameters always staged there); the depthwise taps read the
// bf16 x * mask and sum in f32; LayerNorm statistics and GELU (a true erf)
// run in f32; the GELU(LN1) rows are rounded to bf16 as the A operand of
// the pointwise product, one bf16 wgmma m64n32k16 a 16-channel k-step
// (where f32 takes three TF32 m64n32k8 products a k8 step) on bf16 weights
// in shared memory (half the bytes of the f32 stages, no low halves), f32
// accumulation, the bias added before the product is rounded to bf16 for
// LN2; the GELU(LN2) rows are rounded to bf16 and the residual x + y rounds
// to bf16 after each layer (x + y in bf16, as JAX adds them); the output is
// bf16.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

#include "attention_mma.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int CS = 32;                    // channels per CTA
constexpr int ROWS_PER_PASS = 4 * WARPS;  // row passes: 4 rows a warp, 8 lanes a row
constexpr int MAX_STAGES = 3;
constexpr size_t SMEM_LIMIT = 227 * 1024;
constexpr long long MAX_HALO = 1 << 20;
constexpr int MAX_ROW_TILE = 256;
constexpr int PLANS = 256;  // plans cached (by device and shape)

__device__ __forceinline__ float sum8(float v) {  // over the 8 lanes of a row
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 4);
}

__device__ __forceinline__ float gelu(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752440f));
}

// Column c of row r of a C-wide shared buffer (C % 32 == 0: every row
// starts at bank 0): the 4-float group of c is XORed with f(r mod 8), a
// bijection whose top bit is r's parity. So a quarter-warp's 16-byte reads
// of rows g, g+1 at columns 4t.. cover the 32 banks, and so do a warp's
// 4-byte reads of rows g = 0..7 at columns t (or t + 4) of an 8-column step.
__device__ __forceinline__ int swz(int r, int c) { return c ^ (((r & 1) << 4) | ((r & 6) << 1)); }

// Element (n, k) of a 32 x C weight slice. For wgmma (WG): K-major blocks of
// 32 channels, each 32 rows of 128 bytes with the 16-byte chunks XORed with
// the row mod 8 (the 128-byte swizzle a wgmma descriptor names), 8-row
// atoms at 1024 bytes. For mma.sync: rows of C at the swizzle above.
template <bool WG>
__device__ __forceinline__ int w_at(int n, int k, int C) {
  if constexpr (WG)
    return ((k >> 5) << 10) + (n << 5) + (((((k >> 2) & 7) ^ (n & 7))) << 2) + (k & 3);
  else
    return n * C + swz(n, k);
}

__device__ __forceinline__ float4& at4(float* p) { return *reinterpret_cast<float4*>(p); }

// cp.async of a CTA's 32 x C weight slice (rows of pw_w, stride C) into dst.
// A thread's copies: rows n0, n0 + dn, ... of a fixed column (two integer
// divisions a call, none a copy).
template <bool WG>
__device__ __forceinline__ void load_weights(float* dst, const float* src, int C, bool vec,
                                             int tid) {
  const int per_row = vec ? C >> 2 : C;  // copies a row
  const int dn = THREADS / per_row, n0 = tid / per_row;
  if (n0 >= dn) return;
  const int k = (tid - n0 * per_row) * (vec ? 4 : 1);
#pragma unroll 1
  for (int n = n0; n < CS; n += dn) {
    if (vec)
      attn::cp_async<16>(dst + w_at<WG>(n, k, C), src + (size_t)n * C + k, true);
    else
      attn::cp_async<4>(dst + w_at<WG>(n, k, C), src + (size_t)n * C + k, true);
  }
}

struct Plan {
  int nc, halo, row_tile, w0, tiles, stages, wg, staged, bf;
  size_t smem;
  int clusters;  // clusters of this geometry the card runs at once
};

// Bytes of one stage of a CTA's 32 x C weights: f32, or bf16 in 64-channel
// blocks (a 128-byte swizzled row holds 64 of them; C % 64 == 32 leaves the
// last block half full).
__host__ __device__ constexpr size_t stage_bytes(int C, bool bf) {
  return bf ? (size_t)2 * CS * ((C + 63) / 64 * 64) : (size_t)4 * CS * C;
}

// Row tile bt: the window, the tiles, the product (wgmma where its buffer of
// the weights' low halves fits, else mma.sync; bf16 takes wgmma, without low
// halves), as many weight stages as fit and, where they fit too, the
// per-channel parameters of every layer (sep_w, sep_b, n1g, n1b, pw_b, n2g,
// n2b of the CTA's 32 channels; bf16 needs them there).
bool fill(Plan& p, int bt, int T, int C, int L, int K) {
  p.row_tile = bt;
  p.w0 = bt + 2 * p.halo;
  const long long tiles = ((long long)T + bt - 1) / bt;
  if (tiles > 65535) return false;
  p.tiles = (int)tiles;
  const size_t stats = p.nc > 1 ? (size_t)4 * p.w0 * p.nc : 0;
  const size_t base = (size_t)p.w0 * C + (size_t)p.w0 * CS + stats + p.w0;
  const size_t params = (size_t)L * CS * (K + 6);
  for (int wg = 1; wg >= (p.bf ? 1 : 0); --wg)
    for (int s = L < MAX_STAGES ? L : MAX_STAGES; s >= 1; --s) {
      p.stages = s;
      p.wg = wg;
      p.smem = (size_t)s * stage_bytes(C, p.bf) + (wg && !p.bf ? stage_bytes(C, false) : 0) +
               sizeof(float) * base;
      if (p.smem > SMEM_LIMIT) continue;
      p.staged = p.smem + sizeof(float) * params <= SMEM_LIMIT;
      if (p.bf && !p.staged) continue;
      if (p.staged) p.smem += sizeof(float) * params;
      return true;
    }
  return false;
}

// (mean, M2) of this lane's row over the CTA's 32 channels to slot `rank`
// of row r in every CTA's stats buffer. Every lane takes part (shuffles).
__device__ __forceinline__ void push_stats(cg::cluster_group& cluster, float2* st, int r, bool ok,
                                           const float4& v, int rank, int nc, int q) {
  const float m = sum8(v.x + v.y + v.z + v.w) * (1.f / CS);
  const float a = v.x - m, b = v.y - m, c = v.z - m, d = v.w - m;
  const float m2 = sum8(a * a + b * b + c * c + d * d);
  if (ok && q < nc) cluster.map_shared_rank(st, q)[r * nc + rank] = make_float2(m, m2);
}

// mean and 1/sqrt(var + eps) of row r over all C = 32 nc channels: merged
// from the cluster's slices (Chan et al.), or from this CTA's own 32 when
// nc == 1.
__device__ __forceinline__ float2 row_stats(const float2* st, int r, bool ok, const float4& v,
                                            int nc) {
  const float inv_nc = 1.f / nc;  // exact for nc = 1, 2, 4, 8; else within an ulp
  float m = 0.f, m2 = 0.f;
  if (nc == 1) {
    m = sum8(v.x + v.y + v.z + v.w) * (1.f / CS);
    const float a = v.x - m, b = v.y - m, c = v.z - m, d = v.w - m;
    m2 = sum8(a * a + b * b + c * c + d * d);
  } else if (ok) {
    float2 p[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) p[k] = k < nc ? st[r * nc + k] : make_float2(0.f, 0.f);
#pragma unroll
    for (int k = 0; k < 8; ++k) m += p[k].x;
    m *= inv_nc;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float dm = p[k].x - m;
      if (k < nc) m2 += p[k].y + CS * dm * dm;
    }
  }
  return make_float2(m, rsqrtf(m2 * inv_nc * (1.f / CS) + 1e-5f));
}

__device__ __forceinline__ float4 norm_gelu(const float4& v, const float2& ms, const float* g,
                                            const float* b) {
  return make_float4(gelu((v.x - ms.x) * ms.y * g[0] + b[0]),
                     gelu((v.y - ms.x) * ms.y * g[1] + b[1]),
                     gelu((v.z - ms.x) * ms.y * g[2] + b[2]),
                     gelu((v.w - ms.x) * ms.y * g[3] + b[3]));
}

// One row's fragment pair (v.x, v.y at columns n, n+1 of the CTA's slice)
// into yb: with the bias on the first k share, added to the others.
__device__ __forceinline__ void put_pair(float* yb, int C, int r, int col, float2 v,
                                         const float* pb, int n, bool first) {
  float2* dst = reinterpret_cast<float2*>(yb + (size_t)r * C + swz(r, col));
  if (first) {
    v.x += pb[n];
    v.y += pb[n + 1];
  } else {
    const float2 p = *dst;
    v.x += p.x;
    v.y += p.y;
  }
  *dst = v;
}

// The pointwise product on mma.sync (plans whose window leaves no room for
// the weights' low halves): a warp takes one 16-row m-tile (from lo), two
// of the four 8-channel n-tiles and a share of the input channels (k-step
// indices t, t+4 standing for channels f, f+1 of a 16-byte read); the
// shares meet in this CTA's slice of yb with the bias.
__device__ __forceinline__ void product_mma(float* yb, const float* wst, const float* pb, int C,
                                            int c0, int lo, int hi, int W0, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int mt_n = (hi - lo + 15) >> 4;
  const int ms_log = mt_n >= 3 ? 2 : mt_n - 1;  // m slots: 1, 2 or 4
  const int ms_n = 1 << ms_log, ks_log = 3 - ms_log, ks_n = 1 << ks_log;  // k shares: 8, 4, 2
  const int nh = warp & 1, slot = (warp >> 1) & (ms_n - 1), ks = (warp >> 1) >> ms_log;
  const int kp = C >> 4;                  // 16-channel k-step pairs
  const int kp0 = (ks * kp) >> ks_log, kp1 = ((ks + 1) * kp) >> ks_log;
  for (int j = 0; j * ms_n < mt_n; ++j) {
    const int mt = slot + j * ms_n;
    const int r0 = lo + 16 * mt;
    // hi.hi and the two small terms in separate sums: four independent chains
    float big[2][4], small[2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) big[u][e] = small[u][e] = 0.f;
    if (mt < mt_n) {
      const int ra = min(r0 + g, W0 - 1), rb = min(r0 + g + 8, W0 - 1);
      const float* ya = yb + (size_t)ra * C;
      const float* y8 = yb + (size_t)rb * C;
#pragma unroll 2
      for (int m = kp0; m < kp1; ++m) {
        const int f = 16 * m + 4 * t;
        const float4 a0 = *reinterpret_cast<const float4*>(ya + swz(ra, f));
        const float4 a8 = *reinterpret_cast<const float4*>(y8 + swz(rb, f));
        // k-step 2m: indices t, t+4 = channels f, f+1; k-step 2m+1: f+2, f+3
        const float x0[4] = {a0.x, a8.x, a0.y, a8.y};
        const float x1[4] = {a0.z, a8.z, a0.w, a8.w};
        uint32_t ah[2][4], al[2][4];
        attn::split4(x0, ah[0], al[0]);
        attn::split4(x1, ah[1], al[1]);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int n = 16 * nh + 8 * u + g;
          const float4 w = *reinterpret_cast<const float4*>(wst + w_at<false>(n, f, C));
          const float wv[2][2] = {{w.x, w.y}, {w.z, w.w}};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t bh[2], bl[2];
            attn::split(wv[h][0], bh[0], bl[0]);
            attn::split(wv[h][1], bh[1], bl[1]);
            attn::mma_tf32(small[u], al[h], bh);
            attn::mma_tf32(small[u], ah[h], bl);
            attn::mma_tf32(big[u], ah[h], bh);
          }
        }
      }
    }
    __syncthreads();  // every warp has read these rows of yb
    for (int s = 0; s < ks_n; ++s) {
      if (ks == s && mt < mt_n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + g + 8 * h;
          if (r >= hi) continue;
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int n = 16 * nh + 8 * u + 2 * t;
            put_pair(yb, C, r, c0 + n,
                     make_float2(big[u][2 * h] + small[u][2 * h],
                                 big[u][2 * h + 1] + small[u][2 * h + 1]),
                     pb, n, s == 0);
          }
        }
      __syncthreads();
    }
  }
}

// The weight stage's f32 values become their TF32-rounded high halves, in
// place, and lo = w - hi is written beside them at the same offsets, for
// wgmma to read both from shared memory (the async proxy: the caller fences).
__device__ __forceinline__ void split_weights(float* w, float* wlo, int C, int tid) {
  for (int e = tid; e < CS * C / 4; e += THREADS) {
    const float4 v = at4(w + 4 * e);
    const float x[4] = {v.x, v.y, v.z, v.w};
    uint32_t h[4], l[4];
    attn::split4(x, h, l);
    at4(w + 4 * e) = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                                 __uint_as_float(h[2]), __uint_as_float(h[3]));
    at4(wlo + 4 * e) = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                                   __uint_as_float(l[2]), __uint_as_float(l[3]));
  }
}

// wgmma shared-memory descriptor of a K-major operand in 128-byte-swizzled
// 8-row atoms 1024 bytes apart.
__device__ __forceinline__ uint64_t wg_desc(const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

// d (64 x 32, f32) += a (64 x 8, TF32 fragments in registers) . b (8 x 32, TF32 in shared memory)
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Keep the compiler from moving accumulator accesses across the async wgmma.
__device__ __forceinline__ void fence_acc(float (&d)[16]) {
#pragma unroll
  for (int e = 0; e < 16; ++e) asm volatile("" : "+f"(d[e])::"memory");
}

// The pointwise product on wgmma: a warpgroup takes one 64-row m-tile (from
// lo; its warps 16 rows each, A split in registers, k-step indices t, t+4
// standing for channels 8s + t, 8s + t + 4 as the descriptor's layout has
// them) and a share of the 32-channel k blocks; per k-step three m64n32k8
// products, lo.hi + hi.lo into one sum and hi.hi into another, a block's
// twelve in one commit group. The shares meet in this CTA's slice of yb
// with the bias.
__device__ __forceinline__ void product_wgmma(float* yb, const float* whi, const float* wlo,
                                              const float* pb, int C, int c0, int lo, int hi,
                                              int W0, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int grp = warp >> 2, wq = warp & 3;
  const int mt_n = (hi - lo + 63) >> 6;
  const int ms_log = mt_n >= 3 ? 2 : mt_n - 1;  // m slots: 1, 2 or 4
  // k shares: 2, 2 or 1 (one m-tile leaves two warpgroups idle: two
  // warpgroups keep the tensor cores as busy, with half the passes below)
  const int ms_n = 1 << ms_log, ks_log = ms_log == 2 ? 0 : 1, ks_n = 1 << ks_log;
  const int slot = grp & (ms_n - 1), ks = grp >> ms_log;
  const int blocks = C >> 5;  // 32-channel k blocks of 4 k-steps
  const int b0 = (ks * blocks) >> ks_log, b1 = ((ks + 1) * blocks) >> ks_log;
  const uint64_t dhi = wg_desc(whi), dlo = wg_desc(wlo);
  for (int j = 0; j * ms_n < mt_n; ++j) {
    const int mt = slot + j * ms_n;
    const int r0 = lo + 64 * mt + 16 * wq;
    float big[16], small[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) big[e] = small[e] = 0.f;
    if (mt < mt_n && ks < ks_n) {  // the same for the whole warpgroup
      const int ra = min(r0 + g, W0 - 1), rb = min(r0 + g + 8, W0 - 1);
      const float* ya = yb + (size_t)ra * C;
      const float* y8 = yb + (size_t)rb * C;
      for (int kb = b0; kb < b1; ++kb) {
        // a block's A fragments first, then its 12 products in one group
        uint32_t ah[4][4], al[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int k = 32 * kb + 8 * q + t;
          const float x[4] = {ya[swz(ra, k)], y8[swz(rb, k)], ya[swz(ra, k + 4)],
                              y8[swz(rb, k + 4)]};
          attn::split4(x, ah[q], al[q]);
        }
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // k-step q of block kb: 4096 bytes a block, 32 bytes a step (16-byte units)
          const uint64_t off = (uint64_t)((kb << 8) + (q << 1));
          wgmma_tf32(small, al[q], dhi + off);
          wgmma_tf32(small, ah[q], dlo + off);
          wgmma_tf32(big, ah[q], dhi + off);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_acc(small);
        fence_acc(big);
      }
    }
    __syncthreads();  // every warp has read these rows of yb
    for (int s = 0; s < ks_n; ++s) {
      if (ks == s && mt < mt_n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + g + 8 * h;
          if (r >= hi) continue;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int n = 8 * u + 2 * t;
            put_pair(yb, C, r, c0 + n,
                     make_float2(big[4 * u + 2 * h] + small[4 * u + 2 * h],
                                 big[4 * u + 2 * h + 1] + small[4 * u + 2 * h + 1]),
                     pb, n, s == 0);
          }
        }
      __syncthreads();
    }
  }
}

// ---- bf16: the weights in shared memory and the product on bf16 wgmma ----

// Element (n, k) of a 32 x C bf16 weight slice: K-major blocks of 64
// channels, each 32 rows of 128 bytes with the 16-byte chunks (8 channels)
// XORed with the row mod 8 (the 128-byte swizzle a wgmma descriptor names),
// 8-row atoms at 1024 bytes, 4096 bytes a block: the f32 layout's bytes.
__device__ __forceinline__ int w_at_h(int n, int k) {
  return ((k >> 6) << 11) + (n << 6) + ((((k >> 3) & 7) ^ (n & 7)) << 3) + (k & 7);
}

// The CTA's 32 x C bf16 weight slice (rows of pw_w, stride C) into dst:
// 16-byte cp.async copies of 8 channels, or 2-byte loads where pw_w is not
// 16-byte aligned.
__device__ __forceinline__ void load_weights_h(bf16* dst, const bf16* src, int C, bool vec,
                                               int tid) {
  const int per_row = vec ? C >> 3 : C;  // copies a row
  const int dn = THREADS / per_row, n0 = tid / per_row;
  if (n0 >= dn) return;
  const int k = (tid - n0 * per_row) * (vec ? 8 : 1);
#pragma unroll 1
  for (int n = n0; n < CS; n += dn) {
    if (vec) {
      const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst + w_at_h(n, k));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                   "l"(src + (size_t)n * C + k));
    } else {
      dst[w_at_h(n, k)] = src[(size_t)n * C + k];
    }
  }
}

// d (64 x 32, f32) += a (64 x 16, bf16 fragments in registers) . b (16 x 32,
// bf16 in shared memory, K-major)
__device__ __forceinline__ void wgmma_bf16(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The pointwise product on bf16 wgmma: a warpgroup takes one 64-row m-tile
// (from lo; its warps 16 rows each, A the yb rows rounded to bf16 in
// registers: k-step kk's indices 2t, 2t+1, 2t+8, 2t+9 are channels 16kk +
// the same, as the descriptor's layout has them) and a share of the
// 16-channel k-steps, four k-steps (one 64-channel block) a commit group,
// one accumulator. The shares meet in this CTA's slice of yb with the bias.
__device__ __forceinline__ void product_wgmma_h(float* yb, const bf16* w, const float* pb, int C,
                                                int c0, int lo, int hi, int W0, int warp,
                                                int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int grp = warp >> 2, wq = warp & 3;
  const int mt_n = (hi - lo + 63) >> 6;
  const int ms_log = mt_n >= 3 ? 2 : mt_n - 1;  // m slots: 1, 2 or 4
  const int ms_n = 1 << ms_log, ks_log = ms_log == 2 ? 0 : 1, ks_n = 1 << ks_log;
  const int slot = grp & (ms_n - 1), ks = grp >> ms_log;
  const int steps = C >> 4;  // 16-channel k-steps
  const int s0 = (ks * steps) >> ks_log, s1 = ((ks + 1) * steps) >> ks_log;
  const uint64_t desc = wg_desc(w);
  for (int j = 0; j * ms_n < mt_n; ++j) {
    const int mt = slot + j * ms_n;
    const int r0 = lo + 64 * mt + 16 * wq;
    float acc[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[e] = 0.f;
    if (mt < mt_n && ks < ks_n) {  // the same for the whole warpgroup
      const int ra = min(r0 + g, W0 - 1), rb = min(r0 + g + 8, W0 - 1);
      const float* ya = yb + (size_t)ra * C;
      const float* y8 = yb + (size_t)rb * C;
      for (int s = s0; s < s1; s += 4) {
        const int n = min(4, s1 - s);  // the same for the whole warpgroup
        uint32_t a[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (q >= n) continue;
          const int k = 16 * (s + q) + 2 * t;  // even: k, k + 1 share a swizzled 4-group
          const float2 x0 = *reinterpret_cast<const float2*>(ya + swz(ra, k));
          const float2 x1 = *reinterpret_cast<const float2*>(y8 + swz(rb, k));
          const float2 x2 = *reinterpret_cast<const float2*>(ya + swz(ra, k + 8));
          const float2 x3 = *reinterpret_cast<const float2*>(y8 + swz(rb, k + 8));
          a[q][0] = attn::pack_bf16(x0.x, x0.y);
          a[q][1] = attn::pack_bf16(x1.x, x1.y);
          a[q][2] = attn::pack_bf16(x2.x, x2.y);
          a[q][3] = attn::pack_bf16(x3.x, x3.y);
        }
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (q >= n) continue;
          // k-step s + q: block (s + q) / 4 at 4096 bytes, step (s + q) % 4 at 32 (16-byte units)
          const int kk = s + q;
          wgmma_bf16(acc, a[q], desc + (uint64_t)(((kk >> 2) << 8) + ((kk & 3) << 1)));
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_acc(acc);
      }
    }
    __syncthreads();  // every warp has read these rows of yb
    for (int sh = 0; sh < ks_n; ++sh) {
      if (ks == sh && mt < mt_n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + g + 8 * h;
          if (r >= hi) continue;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int n = 8 * u + 2 * t;
            put_pair(yb, C, r, c0 + n, make_float2(acc[4 * u + 2 * h], acc[4 * u + 2 * h + 1]),
                     pb, n, sh == 0);
          }
        }
      __syncthreads();
    }
  }
}

__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float rnd(float x) { return __bfloat162float(__float2bfloat16(x)); }
__device__ __forceinline__ float4 rnd4(const float4& v) {
  return make_float4(rnd(v.x), rnd(v.y), rnd(v.z), rnd(v.w));
}

// E: float (ddsconv_f32) or bf16 (ddsconv_bf16, which always takes wgmma
// and staged parameters).
template <int S, bool WG, typename E>
__global__ void __launch_bounds__(THREADS, 1)
ddsconv_kernel(const E* __restrict__ x, const E* __restrict__ mask, const E* __restrict__ sep_w,
               const E* __restrict__ sep_b, const E* __restrict__ pw_w, const E* __restrict__ pw_b,
               const E* __restrict__ n1g, const E* __restrict__ n1b, const E* __restrict__ n2g,
               const E* __restrict__ n2b, E* __restrict__ out, int T, int C, int L, int K, int halo,
               int bt, int staged, int vec_x, int vec_w, int vec_out) {
  constexpr bool BF = sizeof(E) == 2;
  extern __shared__ __align__(1024) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = C / CS;
  const int rank = blockIdx.x % nc;
  const int b = blockIdx.x / nc;
  const int t0 = blockIdx.y * bt;
  const int W0 = bt + 2 * halo;
  // S stages of 32 x C weights (and for f32 wgmma their low halves), then the rest
  float* ws = smem;
  bf16* wsh = reinterpret_cast<bf16*>(smem);  // the bf16 stages, stage_bytes(C, true) each
  // W0 x C   the branch, all channels
  float* yb = reinterpret_cast<float*>(reinterpret_cast<char*>(smem) + S * stage_bytes(C, BF) +
                                       (WG && !BF ? stage_bytes(C, false) : 0));
  float* xs = yb + (size_t)W0 * C;                     // W0 x 32  this CTA's residual slice
  float2* st1 = reinterpret_cast<float2*>(xs + (size_t)W0 * CS);  // W0 x nc  LN1 partials
  float2* st2 = st1 + (nc > 1 ? W0 * nc : 0);          // W0 x nc  LN2 partials
  float* mw = reinterpret_cast<float*>(st2 + (nc > 1 ? W0 * nc : 0));  // W0 mask window
  float* ps = mw + W0;  // staged: L x 32 x K sep_w, then 6 x L x 32 per-channel vectors

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane >> 3, q = lane & 7;      // row passes: row in the group, channel quad
  const int c0 = rank * CS, cl = 4 * q, c = c0 + cl;
  const int g0 = t0 - halo;

  // group 0: the x slice and the mask window (rows outside [0, T) are zero);
  // bf16 x and mask widened to f32 by loads (visible after the first barrier)
  const E* xb = x + (size_t)b * T * C + c0;
  if constexpr (BF) {
    for (int e = tid; e < W0 * (CS / 4); e += THREADS) {
      const int r = e >> 3, k = (e & 7) << 2, gr = g0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gr >= 0 && gr < T) {
        const E* src = xb + (size_t)gr * C + k;
        if (vec_x) {
          const uint2 w = *reinterpret_cast<const uint2*>(src);
          v = make_float4(attn::bf16_lo(w.x), attn::bf16_hi(w.x), attn::bf16_lo(w.y),
                          attn::bf16_hi(w.y));
        } else {
          v = make_float4(ldf(src), ldf(src + 1), ldf(src + 2), ldf(src + 3));
        }
      }
      at4(xs + r * CS + k) = v;
    }
    for (int r = tid; r < W0; r += THREADS) {
      const int gr = g0 + r;
      mw[r] = gr >= 0 && gr < T ? ldf(mask + (size_t)b * T + gr) : 0.f;
    }
  } else if (vec_x) {
    for (int e = tid; e < W0 * (CS / 4); e += THREADS) {
      const int r = e >> 3, k = (e & 7) << 2, gr = g0 + r;
      const bool ok = gr >= 0 && gr < T;
      attn::cp_async<16>(xs + r * CS + k, ok ? xb + (size_t)gr * C + k : xb, ok);
    }
  } else {
    for (int e = tid; e < W0 * CS; e += THREADS) {
      const int r = e >> 5, k = e & 31, gr = g0 + r;
      const bool ok = gr >= 0 && gr < T;
      attn::cp_async<4>(xs + r * CS + k, ok ? xb + (size_t)gr * C + k : xb, ok);
    }
  }
  if constexpr (!BF)
    for (int r = tid; r < W0; r += THREADS) {
      const int gr = g0 + r;
      const bool ok = gr >= 0 && gr < T;
      attn::cp_async<4>(mw + r, ok ? mask + (size_t)b * T + gr : mask, ok);
    }
  // the per-channel parameters: staged in shared memory with x where the
  // plan found room (layer l: 32 x K taps at ps + 32 K l, vector j at
  // pv + 32 (6 l + j)), else read in place (generic loads either way);
  // bf16 ones always staged, widened to f32 by loads
  float* pv = ps + (size_t)L * CS * K;
  if constexpr (BF) {
#pragma unroll 1
    for (int l = 0; l < L; ++l) {
      for (int e = tid; e < CS * K; e += THREADS)
        ps[l * CS * K + e] = ldf(sep_w + ((size_t)l * C + c0) * K + e);
      if (tid < 6 * CS) {
        const int j = tid >> 5;
        const E* src = j == 0 ? sep_b : j == 1 ? n1g : j == 2 ? n1b : j == 3 ? pw_b
                     : j == 4 ? n2g : n2b;
        pv[(6 * l + j) * CS + (tid & 31)] = ldf(src + (size_t)l * C + c0 + (tid & 31));
      }
    }
  } else if (staged) {
#pragma unroll 1
    for (int l = 0; l < L; ++l) {
      for (int e = tid; e < CS * K; e += THREADS)
        attn::cp_async<4>(ps + l * CS * K + e, sep_w + ((size_t)l * C + c0) * K + e, true);
      if (tid < 6 * CS) {
        const int j = tid >> 5;
        const float* src = j == 0 ? sep_b : j == 1 ? n1g : j == 2 ? n1b : j == 3 ? pw_b
                         : j == 4 ? n2g : n2b;
        attn::cp_async<4>(pv + (6 * l + j) * CS + (tid & 31), src + (size_t)l * C + c0 + (tid & 31),
                          true);
      }
    }
  }
  attn::cp_async_commit();
  // groups 1..S: the weight slices of layers 0..S-1 (S <= L)
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if constexpr (BF)
      load_weights_h(wsh + s * stage_bytes(C, true) / 2, pw_w + ((size_t)s * C + c0) * C, C, vec_w,
                     tid);
    else
      load_weights<WG>(ws + s * CS * C, pw_w + ((size_t)s * C + c0) * C, C, vec_w, tid);
    attn::cp_async_commit();
  }
  attn::cp_async_wait<S>();
  cluster.sync();  // x has landed; every CTA of the cluster runs (remote stores are safe)

  int lo = 0;
  int dil = 1;
#pragma unroll 1
  for (int i = 0; i < L; ++i, dil *= K) {
    const int pad = dil * (K - 1) / 2;
    lo += pad;
    const int hi = W0 - lo;
    // vector j (0 sep_b, 1 n1g, 2 n1b, 3 pw_b, 4 n2g, 5 n2b) of layer i, this slice
    const auto vec = [&](int j, const E* src) -> const float* {
      if constexpr (BF)
        return pv + (6 * i + j) * CS;
      else
        return staged ? pv + (6 * i + j) * CS : src + (size_t)i * C + c0;
    };

    // depthwise conv of x * mask plus bias into this CTA's slice of yb; LN1 partials
    {
      const float* wi;
      if constexpr (BF)
        wi = ps + (i * CS + cl) * K;
      else
        wi = staged ? ps + (i * CS + cl) * K : sep_w + ((size_t)i * C + c) * K;
      const float* bi = vec(0, sep_b) + cl;
#pragma unroll 1
      for (int r0 = lo + 4 * warp; r0 < hi; r0 += ROWS_PER_PASS) {
        const int r = r0 + sub;
        const bool ok = r < hi;
        float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
        if (ok) {
          for (int kk = 0; kk < K; ++kk) {
            const int rr = r - pad + kk * dil;
            const float4 xv = at4(xs + rr * CS + cl);
            const float mk = mw[rr];
            s.x = fmaf(xv.x * mk, wi[kk], s.x);
            s.y = fmaf(xv.y * mk, wi[K + kk], s.y);
            s.z = fmaf(xv.z * mk, wi[2 * K + kk], s.z);
            s.w = fmaf(xv.w * mk, wi[3 * K + kk], s.w);
          }
          s.x += bi[0];
          s.y += bi[1];
          s.z += bi[2];
          s.w += bi[3];
          at4(yb + (size_t)r * C + swz(r, c)) = s;
        }
        if (nc > 1) push_stats(cluster, st1, r, ok, s, rank, nc, q);
      }
    }
    attn::cp_async_wait<S - 1>();  // layer i's weights (group 1 + i), seen by all after the barrier
    cluster.sync();
    if constexpr (WG && !BF)  // hi (rounded) in place, lo beside it: beside the gather's latency
      split_weights(ws + (i % S) * CS * C, ws + S * CS * C, C, tid);

    // GELU(LN1), all-gathered into every CTA's yb
#pragma unroll 1
    for (int r0 = lo + 4 * warp; r0 < hi; r0 += ROWS_PER_PASS) {
      const int r = r0 + sub;
      const bool ok = r < hi;
      const int col = ok ? (int)((size_t)r * C + swz(r, c)) : 0;
      const float4 v = ok ? at4(yb + col) : make_float4(0.f, 0.f, 0.f, 0.f);
      const float2 ms = row_stats(st1, r, ok, v, nc);
      if (ok) {
        const float4 y = norm_gelu(v, ms, vec(1, n1g) + cl, vec(2, n1b) + cl);
        for (int k = 0; k < nc; ++k) at4(cluster.map_shared_rank(yb, k) + col) = y;
      }
    }
    if constexpr (WG) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    cluster.sync();

    // pointwise product into this CTA's slice of yb, then the ring: the
    // stage of layer i takes layer i + S (an empty group past L)
    if constexpr (BF)
      product_wgmma_h(yb, wsh + (i % S) * stage_bytes(C, true) / 2, vec(3, pw_b), C, c0, lo, hi,
                      W0, warp, lane);
    else if constexpr (WG)
      product_wgmma(yb, ws + (i % S) * CS * C, ws + S * CS * C, vec(3, pw_b), C, c0, lo, hi, W0,
                    warp, lane);
    else
      product_mma(yb, ws + (i % S) * CS * C, vec(3, pw_b), C, c0, lo, hi, W0, warp, lane);
    if (i + S < L) {
      if constexpr (BF)
        load_weights_h(wsh + (i % S) * stage_bytes(C, true) / 2,
                       pw_w + ((size_t)(i + S) * C + c0) * C, C, vec_w, tid);
      else
        load_weights<WG>(ws + (i % S) * CS * C, pw_w + ((size_t)(i + S) * C + c0) * C, C, vec_w,
                         tid);
    }
    attn::cp_async_commit();

    // LN2 partials
    if (nc > 1)
#pragma unroll 1
      for (int r0 = lo + 4 * warp; r0 < hi; r0 += ROWS_PER_PASS) {
        const int r = r0 + sub;
        const bool ok = r < hi;
        float4 v = ok ? at4(yb + (size_t)r * C + swz(r, c)) : make_float4(0.f, 0.f, 0.f, 0.f);
        if constexpr (BF) v = rnd4(v);  // the product plus bias, rounded to bf16
        push_stats(cluster, st2, r, ok, v, rank, nc, q);
      }
    cluster.sync();

    // x += GELU(LN2)
#pragma unroll 1
    for (int r0 = lo + 4 * warp; r0 < hi; r0 += ROWS_PER_PASS) {
      const int r = r0 + sub;
      const bool ok = r < hi;
      float4 v = ok ? at4(yb + (size_t)r * C + swz(r, c)) : make_float4(0.f, 0.f, 0.f, 0.f);
      if constexpr (BF) v = rnd4(v);
      const float2 ms = row_stats(st2, r, ok, v, nc);
      if (ok) {
        float4 y = norm_gelu(v, ms, vec(4, n2g) + cl, vec(5, n2b) + cl);
        float4& xr = at4(xs + r * CS + cl);
        if constexpr (BF) y = rnd4(y);
        xr.x += y.x;
        xr.y += y.y;
        xr.z += y.z;
        xr.w += y.w;
        if constexpr (BF) xr = rnd4(xr);  // x + y in bf16
      }
    }
    __syncthreads();
  }

  // no remote access after the last cluster barrier: a CTA may exit
  E* ob = out + (size_t)b * T * C + c;
  for (int r0 = halo + 4 * warp; r0 < halo + bt; r0 += ROWS_PER_PASS) {
    const int r = r0 + sub, gr = g0 + r;
    if (r >= halo + bt || gr >= T) continue;
    const float4 xv = at4(xs + r * CS + cl);
    const float mk = mw[r];
    const float4 o = make_float4(xv.x * mk, xv.y * mk, xv.z * mk, xv.w * mk);
    E* dst = ob + (size_t)gr * C;
    if constexpr (BF) {
      const uint32_t lo = attn::pack_bf16(o.x, o.y), hi = attn::pack_bf16(o.z, o.w);
      if (vec_out) {
        *reinterpret_cast<uint2*>(dst) = make_uint2(lo, hi);
      } else {
        reinterpret_cast<uint16_t*>(dst)[0] = (uint16_t)lo;
        reinterpret_cast<uint16_t*>(dst)[1] = (uint16_t)(lo >> 16);
        reinterpret_cast<uint16_t*>(dst)[2] = (uint16_t)hi;
        reinterpret_cast<uint16_t*>(dst)[3] = (uint16_t)(hi >> 16);
      }
    } else if (vec_out) {
      dst[0] = o.x;
      dst[1] = o.y;
      dst[2] = o.z;
      dst[3] = o.w;
    }
  }
}

// The pointers are float (ddsconv_f32) or bf16 (ddsconv_bf16) as the plan's bf says.
struct Args {
  const void *x, *mask, *sep_w, *sep_b, *pw_w, *pw_b, *n1g, *n1b, *n2g, *n2b;
  void* out;
  int B, T, C, L, K;
};

// Launch (or, with max_clusters, ask how many of these clusters fit at once).
template <int S, bool WG, typename E>
cudaError_t launch(const Plan& p, const Args& a, cudaStream_t stream, int* max_clusters) {
  auto kern = ddsconv_kernel<S, WG, E>;
  // the shared-memory allowance, raised once per instantiation and device
  static int allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || (int)p.smem > allowed[dev]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (err != cudaSuccess) return err;
    if (dev < 64) allowed[dev] = (int)p.smem;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.nc * a.B, p.tiles, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters) return cudaOccupancyMaxActiveClusters(max_clusters, kern, &cfg);
  const auto e = [](const void* ptr) { return static_cast<const E*>(ptr); };
  err = cudaLaunchKernelEx(&cfg, kern, e(a.x), e(a.mask), e(a.sep_w), e(a.sep_b), e(a.pw_w),
                           e(a.pw_b), e(a.n1g), e(a.n1b), e(a.n2g), e(a.n2b),
                           static_cast<E*>(a.out), a.T, a.C, a.L, a.K, p.halo, p.row_tile,
                           p.staged, (int)attn::aligned16(a.x), (int)attn::aligned16(a.pw_w),
                           (int)attn::aligned16(a.out));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

cudaError_t dispatch(const Plan& p, const Args& a, cudaStream_t stream, int* max_clusters) {
  if (p.bf) {  // always wgmma
    switch (p.stages) {
      case 1:
        return launch<1, true, bf16>(p, a, stream, max_clusters);
      case 2:
        return launch<2, true, bf16>(p, a, stream, max_clusters);
      default:
        return launch<MAX_STAGES, true, bf16>(p, a, stream, max_clusters);
    }
  }
  switch (p.stages * 2 + p.wg) {
    case 2:
      return launch<1, false, float>(p, a, stream, max_clusters);
    case 3:
      return launch<1, true, float>(p, a, stream, max_clusters);
    case 4:
      return launch<2, false, float>(p, a, stream, max_clusters);
    case 5:
      return launch<2, true, float>(p, a, stream, max_clusters);
    case 6:
      return launch<MAX_STAGES, false, float>(p, a, stream, max_clusters);
    default:
      return launch<MAX_STAGES, true, float>(p, a, stream, max_clusters);
  }
}

// The launch plan, 0; -1 when the kernel cannot take the shape, else the
// occupancy query's CUDA error. The row tile: of 16, 32, ..., 256 rows, the
// tiles that keep the product and the parameters' place of the 32-row tile
// (a wider window may cost the wgmma product or the staged parameters),
// the one whose B * tiles clusters run in the fewest waves of what the card
// holds at once (cudaOccupancyMaxActiveClusters), the smallest of those: a
// cluster's time is mostly latency and grows slowly with its rows, so while
// the clusters fit one wave a smaller tile (less halo) finishes sooner, and
// past one wave the count of waves decides.
int make_plan(int B, int T, int C, int L, int K, int bf, Plan& p) {
  if (B <= 0 || T <= 0 || C <= 0 || C > CS * 8 || C % CS != 0 || K < 1 || K % 2 == 0 || L < 1 ||
      (long long)B * (C / CS) > 0x7fffffffLL)
    return -1;
  long long halo = 0;
  for (long long i = 0, d = 1; i < L; ++i, d *= K) {  // d <= 2^21 while halo <= 2^20
    halo += d * (K - 1) / 2;
    if (halo > MAX_HALO) return -1;
  }
  Plan ref = {};
  ref.nc = C / CS;
  ref.halo = (int)halo;
  ref.bf = bf;
  const Plan base = ref;
  if (!fill(ref, 32, T, C, L, K)) return -1;
  const Args none = {nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                     nullptr, nullptr, nullptr, B, T, C, L, K};
  long long fewest = 0;
  for (int bt = 16; bt <= MAX_ROW_TILE; bt += 16) {
    Plan q = base;
    if (!fill(q, bt, T, C, L, K) || q.wg != ref.wg || q.staged != ref.staged) continue;
    const cudaError_t err = dispatch(q, none, nullptr, &q.clusters);
    if (err != cudaSuccess) return (int)err;
    if (q.clusters < 1) continue;
    const long long waves = ((long long)B * q.tiles + q.clusters - 1) / q.clusters;
    if (!fewest || waves < fewest) {
      p = q;
      fewest = waves;
    }
    if (q.tiles == 1) break;  // a wider tile adds rows, not fewer clusters
  }
  return fewest ? 0 : (int)cudaErrorInvalidConfiguration;
}

// make_plan, once per device and shape: its occupancy queries stay off the
// launches that follow.
int cached_plan(int B, int T, int C, int L, int K, int bf, Plan& p) {
  struct Entry {
    int dev, B, T, C, L, K, bf;
    Plan p;
  };
  static std::mutex mutex;
  static Entry cache[PLANS];
  static int filled = 0;
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  std::lock_guard<std::mutex> lock(mutex);
  for (int i = 0; i < filled && i < PLANS; ++i) {
    const Entry& e = cache[i];
    if (e.dev == dev && e.B == B && e.T == T && e.C == C && e.L == L && e.K == K && e.bf == bf) {
      p = e.p;
      return 0;
    }
  }
  const int r = make_plan(B, T, C, L, K, bf, p);
  if (r == 0) cache[filled++ % PLANS] = {dev, B, T, C, L, K, bf, p};
  return r;
}

int run(const Args& a, int bf, void* stream) {
  if (a.B <= 0 || a.T <= 0) return (int)cudaSuccess;
  Plan p;
  const int r = cached_plan(a.B, a.T, a.C, a.L, a.K, bf, p);
  if (r != 0) return r;
  return (int)dispatch(p, a, (cudaStream_t)stream, nullptr);
}

}  // namespace

// x, out: (B, T, C) contiguous f32; mask: (B, T) f32; sep_w: (L, C, K);
// pw_w: (L, C_out, C_in); sep_b, pw_b, n1g, n1b, n2g, n2b: (L, C).
// Returns 0 on success, -1 for a shape the kernel cannot take (make_plan),
// else a cudaError_t.
extern "C" int ddsconv_f32(const float* x, const float* mask, const float* sep_w,
                           const float* sep_b, const float* pw_w, const float* pw_b,
                           const float* n1g, const float* n1b, const float* n2g,
                           const float* n2b, float* out, int B, int T, int C, int L, int K,
                           void* stream) {
  return run({x, mask, sep_w, sep_b, pw_w, pw_b, n1g, n1b, n2g, n2b, out, B, T, C, L, K}, 0,
             stream);
}

// The bf16 form: every pointer bf16, shapes as ddsconv_f32. Returns as ddsconv_f32.
extern "C" int ddsconv_bf16(const bf16* x, const bf16* mask, const bf16* sep_w, const bf16* sep_b,
                            const bf16* pw_w, const bf16* pw_b, const bf16* n1g, const bf16* n1b,
                            const bf16* n2g, const bf16* n2b, bf16* out, int B, int T, int C, int L,
                            int K, void* stream) {
  return run({x, mask, sep_w, sep_b, pw_w, pw_b, n1g, n1b, n2g, n2b, out, B, T, C, L, K}, 1,
             stream);
}

// The launch geometry make_plan gives a shape, into out[0..9]: grid x, grid
// y, cluster size, dynamic shared bytes, weight stages, halo rows, row
// tile, the product (1 wgmma, 0 mma.sync), whether the per-channel
// parameters are staged in shared memory, and how many such clusters the
// card runs at once (cudaOccupancyMaxActiveClusters); bf: the plan of
// ddsconv_bf16 (1) or of ddsconv_f32 (0). Returns as ddsconv_f32.
extern "C" int ddsconv_plan(int B, int T, int C, int L, int K, int bf, int* out) {
  Plan p;
  const int r = cached_plan(B, T, C, L, K, bf, p);
  if (r != 0) return r;
  const int vals[10] = {p.nc * B, p.tiles, p.nc, (int)p.smem, p.stages, p.halo, p.row_tile,
                        p.wg, p.staged, p.clusters};
  for (int i = 0; i < 10; ++i) out[i] = vals[i];
  return 0;
}
