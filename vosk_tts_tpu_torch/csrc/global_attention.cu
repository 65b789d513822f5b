// Global self-attention over channels-last q, k, v with optional in-kernel
// RoPE (StableTTS DiT attention).
//
// Replaces the TPU kernels in vosk_tts_tpu/ops/flash_attention.py:
//   _global_rope_kernel (wrapper global_flash_attention_rope), d_rope > 0;
//   _global_kernel (wrappers global_flash_attention_packed and
//   global_flash_attention), d_rope = 0.
// Per batch item b, head h and query row i < T:
//   q', k' = q, k of the head with the first d_rope features rotated
//            (rotate-half RoPE at absolute positions 0..T-1, from the
//            (T, d_rope/2) cos/sin tables the wrapper builds);
//   s[i,j] = sm_scale * q'[i].k'[j];   s[i,j] = -30000 for j >= kv_len[b]
//   out[i] = softmax_j(s[i,:]) . v
// Rows at or past kv_len are computed like the others (the caller masks
// them); kv_len <= 0 masks every key, so every row averages all T values.
// q, k and v are read through (batch, row) strides, so the packed (B, T, 3C)
// output of a fused qkv projection and separate (B, T, C) tensors both work;
// out is (B, T, C), the o projection's input.
//
// What bounds it on Hopper: 4*H*D*T*sum(kv_len) operations, done on the
// tensor cores in 3xTF32 (attention_mma.cuh): three TF32 products per
// fragment pair keep f32 accuracy, so the ceiling is 495/3 = 165 TFLOP/s,
// against 67 TFLOP/s for f32 FMA on the CUDA cores. q, k, v and out
// (16*B*T*C bytes) are small next to that at the DiT shapes: it is bound by
// operations.
//
// Design:
//  * grid (ceil(T/64), H, B); one warpgroup (4 warps) per 64-row query
//    tile, each warp owning 16 rows; a warp's q rows are rotated and scaled
//    by sm_scale as they are read and stay in registers in the A-fragment
//    layout, split into hi/lo at each use (holding both halves would take
//    twice the registers and cost the third block on the SM);
//  * K and V tiles of 32 keys arrive through a two-stage cp.async ring
//    (tile j+1 loads while tile j computes), 16-byte copies where D, the
//    strides and the pointers allow, else 4-byte copies; D is zero-padded
//    to DW (a multiple of 32) and rows sit at strides that keep the
//    16-byte fragment reads free of bank conflicts (attention_mma.cuh).
//    Two stages take 54,272 bytes at D = 96, so three blocks (12 warps)
//    fit on an SM;
//  * with RoPE (a template flag, so the d_rope = 0 forms carry none of it),
//    each k tile is rotated in place in shared memory once it has landed
//    (one pass over 32 x d_rope between two barriers); cos/sin come from
//    the wrapper's table (the plain version's formula), not from __sinf,
//    and a warp issues all its table reads of the pass before the first
//    write, so the pass waits on one memory round trip, not eight;
//  * S = Q.K^T and O += P.V run as mma.m16n8k8 in 3xTF32 (attention_mma.cuh:
//    the split costs three integer/f32 operations per operand, no cvt),
//    S and O stay in registers in the C-fragment layout, the online softmax
//    (expf) reduces each row over the 4 lanes of a quad, and P feeds the
//    second product from its registers; a tile whose keys are all valid
//    skips the mask;
//  * the walk stops after the last tile holding a key below kv_len: every
//    later key scores -30000 and gets p = 0 exactly in f32, so skipping is
//    exact; keys past T do not exist and get p = 0; any T >= 1 works.
// wgmma (TF32 operands K-major, so V^T in shared memory) is the next step.
//
// global_attention_bf16 (the JAX kernels in bf16) is written for Hopper's
// TMA and wgmma. Same walk and arithmetic as above, over bf16 q, k, v in the
// three forms. What bounds it: the 4*H*D*T*sum(kv_len) operations on the bf16
// tensor cores (989 TFLOP/s) at the batched DiT and flow shapes, then one
// exp a score on the SFU; at one request's shapes, the host's launch.
//  * A block is one producer warpgroup and nwg = 1 or 2 consumer warpgroups,
//    each taking 64 query rows of one (batch item, head); one block an SM.
//    A block is 64 rows where twice the blocks of 128 rows still fit on the
//    SMs at once, else 128: B2 T512 H4 gives 32 blocks of 128 rows, so 64
//    of 64 on 64 SMs. The wrapper's `global_block_rows` chooses. The keys
//    are not split, so no second pass merges partial rows.
//  * Warp 0 of the producer: one lane loads the block's q rows once, then
//    K and V tiles of 64 keys into a ring of 4 stages, all by TMA
//    (cp.async.bulk.tensor). Each stage completes on an mbarrier, and a
//    stage is refilled once every consumer has released it (a second
//    mbarrier). The tensor maps view q, k and v as (D, H, T, B) through
//    their strides: the packed (B, T, 3C) projection and separate (B, T, C)
//    tensors alike. A box past T or past D comes zero-filled from the TMA
//    unit, with no padding in memory and no masked copies. Q and K boxes
//    are 64 features (128 bytes, the 128-byte swizzle; D96 takes two). V
//    boxes are W = 64, 32 or 16 features, the widest dividing DP (D rounded
//    up to 16), so that each V box is one swizzle atom of the transposed
//    operand and DP is a whole number of atoms. The maps are encoded for
//    each call on the host
//    (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint: the
//    build links no libcuda) and passed as __grid_constant__ parameters.
//  * Warps 1-3 of the producer (RoPE only) rotate the landed q rows once and
//    each landed K tile in place, in f32 from the f32 tables, rounded to
//    bf16. They then fence.proxy.async and release the tile to the
//    consumers (a third mbarrier a stage), so the rotation is off the
//    consumers' path.
//  * A consumer warpgroup: S = Q.K^T as DP/16 wgmma m64n64k16 (both
//    operands in shared memory, K-major). sm_scale and the key mask act on
//    the f32 scores, as in the plain version (the mask at -30000 / sm_scale
//    on the raw score, sm_scale x log2 e folded into the exponent: one FFMA
//    and one ex2 a score). The online softmax runs in f32. p is rounded to
//    bf16 in registers and is the A operand of O += P.V: one wgmma
//    m64nDPk16 a 16-key step, V the B operand read transposed (MN-major)
//    from the stage. D48 pads to 48, not 64. The product of S for tile j is
//    issued together with P.V of tile j - 1, and the softmax of tile j runs
//    while P.V of tile j - 1 does. O, the running max and the row sums stay
//    in registers; the output is written once, in bf16.
// The masks and the walk are the f32 kernel's: -30000 on the f32 scores at
// or past kv_len, -inf past T, a stop after the last tile below kv_len, and
// kv_len <= 0 attends to all T keys. TMA needs q, k and v to start on 16
// bytes and their batch and row strides to be multiples of 8 values; the
// wrapper raises ValueError otherwise. D is a multiple of 8, at most 128.

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

#include "attention_mma.cuh"

namespace {

using namespace attn;

constexpr float MASK_VALUE = -30000.f;
constexpr int TMA_ENCODE_ERROR = 100000;  // + a CUresult: see global_attention_bf16

// Feature c of one head's row at position t (src: the row's first feature of
// the head), rotated when c < d_rope: x*cos + rotate_half(x)*sin, with
// rotate_half(x) = (-x[d2:d_rope], x[:d2]).
__device__ __forceinline__ float roped(const float* __restrict__ src, int c, int d_rope,
                                       const float* __restrict__ cs,
                                       const float* __restrict__ sn, int t) {
  if (c >= d_rope) return src[c];
  const int d2 = d_rope >> 1;
  const int j = c < d2 ? c : c - d2;
  const float cv = __ldg(cs + (size_t)t * d2 + j);
  const float sv = __ldg(sn + (size_t)t * d2 + j);
  const float other = c < d2 ? -src[c + d2] : src[j];
  return src[c] * cv + other * sv;
}

template <int NC, int VEC, bool ROPE>
__global__ void __launch_bounds__(THREADS, NC <= 3 ? 3 : 2)
global_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ cos_t,
                        const float* __restrict__ sin_t, const int* __restrict__ kv_len,
                        float* __restrict__ out, int H, int T, int D, int d_rope,
                        long long stride_b, long long stride_t, float sm_scale) {
  constexpr int DW = 32 * NC;  // padded head width
  constexpr int ND = DW / 8;   // 8-feature k-steps of q.k, 8-column n-tiles of o
  constexpr int LDK = k_stride(DW);
  extern __shared__ __align__(16) float ring[];  // STAGES x (K tile, V tile)

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int len = kv_len[b];
  const int kv_end = len > 0 ? min(len, T) : T;  // no valid key: every key counts
  const int unmasked = len > 0 ? min(len, T) : 0;  // keys below it need no mask
  const size_t head = (size_t)b * stride_b + (size_t)h * D;
  const float* qb = q + head;
  const float* kb = k + head;
  const float* vb = v + head;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n16 = (D + 15) / 16;  // k-step pairs that hold features

  if (!ROPE) d_rope = 0;  // the compiler drops every RoPE path
  const int d2 = d_rope >> 1;

  zero_pad<DW>(ring, D, tid);
  const int n_tiles = (kv_end + BK - 1) / BK;
  load_stage<VEC, DW>(ring, 0, kb, vb, stride_t, 0, T, D, tid);
  cp_async_commit();

  // this warp's q rows r0 and r0 + 8 in the A-fragment layout, rotated and
  // scaled by sm_scale
  const int r0 = q0 + warp * 16 + g;
  float qf[ND][4];
#pragma unroll
  for (int kk = 0; kk < ND; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = r0 + 8 * (e & 1);
      const int c = q_feature(kk, t, e);
      qf[kk][e] = i < T && c < D
                      ? sm_scale * roped(qb + (size_t)i * stride_t, c, d_rope, cos_t, sin_t, i)
                      : 0.f;
    }
  }

  float m_i[2] = {NEG_INIT, NEG_INIT}, l_i[2] = {0.f, 0.f}, o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int j0 = it * BK;
    if (it + 1 < n_tiles)
      load_stage<VEC, DW>(ring, (it + 1) % STAGES, kb, vb, stride_t, j0 + BK, T, D, tid);
    cp_async_commit();
    cp_async_wait<1>();  // tile it has landed; tile it+1 may be in flight
    __syncthreads();
    float* ks = k_tile<DW>(ring, it % STAGES);
    if (d2 > 0) {  // rotate the k tile in place: a warp's rows BK/WARPS apart
      constexpr int RW = BK / WARPS;
      for (int c0 = 0; c0 < d2; c0 += 32) {
        const int c = c0 + lane;
        float cv[RW], sv[RW];  // every table read of the warp in flight at once
#pragma unroll
        for (int i = 0; i < RW; ++i) {
          const int j = j0 + warp + WARPS * i;
          const bool ok = j < T && c < d2;
          cv[i] = ok ? __ldg(cos_t + (size_t)j * d2 + c) : 0.f;
          sv[i] = ok ? __ldg(sin_t + (size_t)j * d2 + c) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < RW; ++i) {
          const int r = warp + WARPS * i;
          if (j0 + r >= T || c >= d2) continue;
          float* row = ks + r * LDK;
          const float x0 = row[c], x1 = row[c + d2];
          row[c] = x0 * cv[i] + (-x1) * sv[i];
          row[c + d2] = x1 * cv[i] + x0 * sv[i];
        }
      }
      __syncthreads();
    }

    float s[NT][4];
    score_tile<NC>(s, qf, ks, n16, g, t);
    if (j0 + BK > unmasked) {  // a key of this tile is masked or past T
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + nt * 8 + 2 * t + (e & 1);
          if (j >= len) s[nt][e] = MASK_VALUE;
          if (j >= T) s[nt][e] = -INFINITY;
        }
    }
    softmax_tile<NC>(s, m_i, l_i, o);
    pv_tile<NC>(o, s, v_tile<DW>(ring, it % STAGES), g, t);
    __syncthreads();  // this stage is consumed before it is refilled
  }

  const size_t C = (size_t)H * D;
  float* orow0 = out + ((size_t)b * T + r0) * C + (size_t)h * D;
  store_rows<NC>(o, l_i, orow0, orow0 + 8 * C, r0, T, D, t);
}

template <int NC, int VEC, bool ROPE>
cudaError_t launch(const float* q, const float* k, const float* v, const float* cos_t,
                   const float* sin_t, const int* kv_len, float* out, int B, int H, int T,
                   int D, int d_rope, long long stride_b, long long stride_t, float sm_scale,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * STAGES * stage_floats(32 * NC);
  cudaError_t err = cudaFuncSetAttribute(global_attention_kernel<NC, VEC, ROPE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T + BQ - 1) / BQ, H, B);
  global_attention_kernel<NC, VEC, ROPE><<<grid, THREADS, smem, stream>>>(
      q, k, v, cos_t, sin_t, kv_len, out, H, T, D, d_rope, stride_b, stride_t, sm_scale);
  return cudaGetLastError();
}

template <int NC>
cudaError_t launch_nc(bool vec, const float* q, const float* k, const float* v,
                      const float* cos_t, const float* sin_t, const int* kv_len, float* out,
                      int B, int H, int T, int D, int d_rope, long long stride_b,
                      long long stride_t, float sm_scale, cudaStream_t s) {
  auto go = [&](auto kernel_launch) {
    return kernel_launch(q, k, v, cos_t, sin_t, kv_len, out, B, H, T, D, d_rope, stride_b,
                         stride_t, sm_scale, s);
  };
  if (d_rope > 0) return vec ? go(launch<NC, 4, true>) : go(launch<NC, 1, true>);
  return vec ? go(launch<NC, 4, false>) : go(launch<NC, 1, false>);
}

// ---------------------------------------------------------------------------
// global_attention_bf16 on Hopper: TMA, mbarriers and wgmma.

using bf16 = __nv_bfloat16;

namespace hop {

constexpr int BN = 64;         // keys a tile
constexpr int RING = 4;        // ring stages
constexpr int BOX = 64 * 128;  // bytes of a Q or K box: 64 rows of 128 bytes (64 features)
constexpr float LOG2E = 1.4426950408889634f;

// V's box width in features: the widest of 64, 32, 16 that divides dp (one
// swizzle atom of the transposed operand a box, so a product's N is one box)
__host__ __device__ constexpr int v_width(int dp) {
  return dp % 64 == 0 ? 64 : dp % 32 == 0 ? 32 : 16;
}
__host__ __device__ constexpr int k_bytes(int dp) { return (dp + 63) / 64 * BOX; }
__host__ __device__ constexpr int stage_bytes(int dp) { return k_bytes(dp) + dp * BN * 2; }
// dynamic shared memory: alignment slack, q of two consumer warpgroups, the
// ring, the mbarriers (q landed, q rotated; landed, rotated, released a stage)
__host__ __device__ constexpr int smem_bytes(int dp) {
  return 1024 + 2 * k_bytes(dp) + RING * stage_bytes(dp) + 8 * (2 + 3 * RING);
}

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(saddr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(saddr(bar)) : "memory");
}
// arrive and expect `bytes` more from the TMA unit before the phase completes
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(saddr(bar)),
               "r"(bytes)
               : "memory");
}
// wait until the phase of parity `parity` has completed; a wait of more than
// 2^35 clocks (~20 s) traps, so that a fault in the protocol ends the launch
// with an error instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const long long start = clock64();
  uint32_t done;
  do {
    if (clock64() - start > (1ll << 35)) __trap();
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(saddr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// the box of `map` at (feature c0, head c1, row c2, batch item c3) into dst,
// completing on bar; boxes past the tensor's ends are zero-filled
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(saddr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// shared-memory writes of this thread before it become visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of this warpgroup's products are pending
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator accesses across the wait
template <int N>
__device__ __forceinline__ void keep(float (&d)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) asm volatile("" : "+f"(d[e])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// descriptor of a K-major operand in 128-byte-swizzled 8-row atoms 1024 bytes apart
__device__ __forceinline__ uint64_t desc_k(const void* p) {
  return (uint64_t)((saddr(p) & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}
// descriptor of an MN-major (transposed) operand: atoms of W features x 8 key
// rows of 2W bytes (the 2W-byte swizzle); the leading offset is the stride
// from one atom to the next along N (a TMA box of BN rows), the stride
// offset that from one 8-row group to the next along K (16W bytes)
template <int W>
__device__ __forceinline__ uint64_t desc_mn(const void* p) {
  constexpr uint64_t layout = W == 64 ? 1 : W == 32 ? 2 : 3;  // 128-, 64-, 32-byte swizzle
  constexpr uint64_t atom = (BN * 2 * W) >> 4, group = (16 * W) >> 4;
  return (uint64_t)((saddr(p) & 0x3FFFF) >> 4) | (atom << 16) | (group << 32) | (layout << 62);
}

// d (64 x 64, f32) = a (64 x 16) . b (16 x 64) (+ d where add): bf16, both in shared memory,
// K-major
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t a, uint64_t b, bool add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"((int)add));
}

// d (64 x N, f32) += a (64 x 16, bf16 in registers) . b (16 x N, bf16 in shared
// memory, MN-major: read transposed); N = 16 .. 128, as the accumulator's size says
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[24], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[40], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[48], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[56], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Feature c of row r of a 128-byte-swizzled K-major tile (boxes of 64 rows x 64
// features, BOX bytes apart; 16-byte chunks XORed with the row mod 8, as the
// TMA unit writes them and wgmma reads them).
__device__ __forceinline__ bf16* swizzled(uint8_t* tile, int r, int c) {
  return reinterpret_cast<bf16*>(tile + (c >> 6) * BOX + r * 128 +
                                 ((((c >> 3) & 7) ^ (r & 7)) << 4) + ((c & 7) << 1));
}

// Rotate the first 2*d2 features of rows [0, n) in place: row r (at tile +
// (r / 64) * stride, row r % 64) holds position pos0 + r; rows at or past T
// are zeros and stay so. In f32 from the f32 tables, rounded to bf16; thread
// i of n_thr. Where d2 is a multiple of 8, an item is a 16-byte chunk of 8
// features and its partner chunk d2 further (one 16-byte shared load and
// two 32-byte table loads each), two items' loads in flight together; else
// an item is one feature.
__device__ __forceinline__ void rotate_rows(uint8_t* tile, int stride, int n, int pos0, int T,
                                            int d2, const float* __restrict__ cos_t,
                                            const float* __restrict__ sin_t, int i, int n_thr) {
  if (d2 % 8) {
    for (int e = i; e < n * d2; e += n_thr) {
      const int r = e / d2, c = e - r * d2, pos = pos0 + r;
      if (pos >= T) continue;
      uint8_t* base = tile + (r >> 6) * stride;
      bf16* p0 = swizzled(base, r & 63, c);
      bf16* p1 = swizzled(base, r & 63, c + d2);
      const float cv = __ldg(cos_t + (size_t)pos * d2 + c);
      const float sv = __ldg(sin_t + (size_t)pos * d2 + c);
      const float x0 = __bfloat162float(*p0), x1 = __bfloat162float(*p1);
      *p0 = __float2bfloat16(x0 * cv + (-x1) * sv);
      *p1 = __float2bfloat16(x1 * cv + x0 * sv);
    }
    return;
  }
  constexpr int U = 2;  // items a thread holds at once
  const int per_row = d2 >> 3, items = n * per_row;
  for (int e0 = i; e0 < items; e0 += U * n_thr) {
    uint4* x0[U];
    uint4* x1[U];
    uint4 a[U], b[U];
    float4 cv[U][2], sv[U][2];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * n_thr, r = e / per_row, c = (e - r * per_row) * 8;
      ok[u] = e < items && pos0 + r < T;
      if (!ok[u]) continue;
      uint8_t* base = tile + (r >> 6) * stride;
      x0[u] = reinterpret_cast<uint4*>(swizzled(base, r & 63, c));
      x1[u] = reinterpret_cast<uint4*>(swizzled(base, r & 63, c + d2));
      a[u] = *x0[u];
      b[u] = *x1[u];
      const float4* ct = reinterpret_cast<const float4*>(cos_t + (size_t)(pos0 + r) * d2 + c);
      const float4* st = reinterpret_cast<const float4*>(sin_t + (size_t)(pos0 + r) * d2 + c);
      cv[u][0] = __ldg(ct);
      cv[u][1] = __ldg(ct + 1);
      sv[u][0] = __ldg(st);
      sv[u][1] = __ldg(st + 1);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!ok[u]) continue;
      const uint32_t wa[4] = {a[u].x, a[u].y, a[u].z, a[u].w};
      const uint32_t wb[4] = {b[u].x, b[u].y, b[u].z, b[u].w};
      const float c8[8] = {cv[u][0].x, cv[u][0].y, cv[u][0].z, cv[u][0].w,
                           cv[u][1].x, cv[u][1].y, cv[u][1].z, cv[u][1].w};
      const float s8[8] = {sv[u][0].x, sv[u][0].y, sv[u][0].z, sv[u][0].w,
                           sv[u][1].x, sv[u][1].y, sv[u][1].z, sv[u][1].w};
      uint32_t ya[4], yb[4];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float a0 = bf16_lo(wa[w]), a1 = bf16_hi(wa[w]);
        const float b0 = bf16_lo(wb[w]), b1 = bf16_hi(wb[w]);
        const float c0 = c8[2 * w], c1 = c8[2 * w + 1], s0 = s8[2 * w], s1 = s8[2 * w + 1];
        ya[w] = pack_bf16(a0 * c0 + (-b0) * s0, a1 * c1 + (-b1) * s1);
        yb[w] = pack_bf16(b0 * c0 + a0 * s0, b1 * c1 + a1 * s1);
      }
      *x0[u] = make_uint4(ya[0], ya[1], ya[2], ya[3]);
      *x1[u] = make_uint4(yb[0], yb[1], yb[2], yb[3]);
    }
  }
}

}  // namespace hop

// One block: a producer warpgroup (warp 0 loads, warps 1-3 rotate) and nwg =
// blockDim.x / 128 - 1 consumer warpgroups of 64 query rows of item
// blockIdx.z, head blockIdx.y. DP: D rounded up to 16.
template <int DP>
__global__ void __launch_bounds__(384, 1)
global_attention_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                             const int* __restrict__ kv_len, bf16* __restrict__ out, int H,
                             int T, int D, int d_rope, float sm_scale) {
  using namespace hop;
  constexpr int W = v_width(DP), NV = DP / W, KB = k_bytes(DP), SB = stage_bytes(DP);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);  // 1024-byte aligned
  uint8_t* ring = qs + 2 * KB;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(ring + RING * SB);
  uint64_t* qready = qfull + 1;
  uint64_t* full = qfull + 2;       // stage s has landed
  uint64_t* ready = full + RING;    // ... and its K tile is rotated (RoPE)
  uint64_t* empty = ready + RING;   // every consumer has read stage s

  const int nwg = blockDim.x / 128 - 1;
  const int q0 = blockIdx.x * 64 * nwg, h = blockIdx.y, b = blockIdx.z;
  const int len = kv_len[b];
  const int kv_end = len > 0 ? min(len, T) : T;    // no valid key: every key counts
  const int unmasked = len > 0 ? min(len, T) : 0;  // keys below it need no mask
  const int n_tiles = (kv_end + BN - 1) / BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int d2 = d_rope >> 1;

  if (tid == 0) {
    mbar_init(qfull, 1);
    mbar_init(qready, 96);
    for (int s = 0; s < RING; ++s) {
      mbar_init(full + s, 1);
      mbar_init(ready + s, 96);
      mbar_init(empty + s, nwg);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {  // the producer warp: one lane issues every load
    if (lane == 0) {
      mbar_expect_tx(qfull, nwg * KB);
      for (int w = 0; w < nwg; ++w)
        for (int c = 0; c < DP; c += 64)
          tma_load(qs + w * KB + c / 64 * BOX, &qmap, qfull, c, h, q0 + 64 * w, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % RING;
        if (it >= RING) mbar_wait(empty + s, (it / RING + 1) & 1);  // tile it - RING is read
        uint8_t* st = ring + s * SB;
        mbar_expect_tx(full + s, SB);
        for (int c = 0; c < DP; c += 64)
          tma_load(st + c / 64 * BOX, &kmap, full + s, c, h, it * BN, b);
        for (int c = 0; c < NV; ++c)
          tma_load(st + KB + c * BN * 2 * W, &vmap, full + s, c * W, h, it * BN, b);
      }
    }
    return;
  }
  if (warp < 4) {  // the rotating warps (RoPE only)
    if (d2 == 0) return;
    const int i = tid - 32;
    mbar_wait(qfull, 0);
    rotate_rows(qs, KB, 64 * nwg, q0, T, d2, cos_t, sin_t, i, 96);
    fence_async_shared();
    mbar_arrive(qready);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % RING;
      mbar_wait(full + s, (it / RING) & 1);
      rotate_rows(ring + s * SB, 0, BN, it * BN, T, d2, cos_t, sin_t, i, 96);
      fence_async_shared();
      mbar_arrive(ready + s);
    }
    return;
  }

  // a consumer warpgroup: rows q0 + 64 cw + 16 wq + g (+ 8) of its warps.
  // S of tile it is issued with P.V of tile it - 1 and its softmax runs while
  // that product does; a lane's score e is row g + 8 ((e >> 1) & 1), key j0 +
  // 8 (e >> 2) + 2t + (e & 1)
  const int cw = (warp >> 2) - 1, wq = warp & 3, g = lane >> 2, t = lane & 3;
  uint64_t* landed = d2 > 0 ? ready : full;
  mbar_wait(d2 > 0 ? qready : qfull, 0);
  const uint64_t qd = desc_k(qs + cw * KB);
  const float sl = sm_scale * LOG2E;
  const float masked_raw = MASK_VALUE / sm_scale;  // a raw score that scales to -30000
  float o[DP / 2];  // O: 64 rows x DP features, f32, element e at column 8 (e >> 2) + 2t + (e & 1)
#pragma unroll
  for (int e = 0; e < DP / 2; ++e) o[e] = 0.f;
  float m_i[2] = {NEG_INIT, NEG_INIT}, l_i[2] = {0.f, 0.f}, alpha[2];
  float sc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) sc[e] = 0.f;
  uint32_t pa[BN / 16][4];  // p of the previous tile, bf16: the A operand of its P.V

  // S = Q.K^T of tile it (64 rows x 64 keys, f32): DP/16 wgmma, 16 features a
  // step (box kk / 4, 32 bytes a step in it); committed, not waited for
  auto issue_scores = [&](int it) {
    const uint64_t kd = desc_k(ring + (it % RING) * SB);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint64_t off = (uint64_t)(((kk >> 2) * BOX + (kk & 3) * 32) >> 4);
      wgmma_ss64(sc, qd + off, kd + off, kk > 0);  // the first step overwrites sc
    }
    wg_commit();
  };
  // O += P.V of tile it: one wgmma m64nDPk16 a 16-key step (2 8-row groups
  // along K), V the B operand read transposed; committed, not waited for
  auto issue_pv = [&](int it) {
    const uint64_t vd = desc_mn<W>(ring + (it % RING) * SB + KB);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs(o, pa[kk], vd + (uint64_t)((kk * 32 * W) >> 4));
    wg_commit();
  };
  // the key mask and the online softmax of tile it on the raw scores sc (rows
  // g, g + 8, reduced over the quad; the running max m_i in log2 units): sc
  // becomes p = 2^(sc sl - m_i), l_i and m_i move, alpha is O's scale
  auto softmax = [&](int it) {
    const int j0 = it * BN;
    if (j0 + BN > unmasked) {  // a key of this tile is masked or past T
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int j = j0 + 8 * (e >> 2) + 2 * t + (e & 1);
        if (j >= len) sc[e] = masked_raw;
        if (j >= T) sc[e] = -INFINITY;
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        mx = fmaxf(mx, fmaxf(sc[4 * i + 2 * hr], sc[4 * i + 2 * hr + 1]));
      const float m_new = fmaxf(m_i[hr], quad_max(mx) * sl);  // sl > 0: the max commutes
      alpha[hr] = ex2(m_i[hr] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = ex2(fmaf(sc[4 * i + 2 * hr + e], sl, -m_new));
          sc[4 * i + 2 * hr + e] = p;
          sum += p;
        }
      l_i[hr] = l_i[hr] * alpha[hr] + sum;
      m_i[hr] = m_new;
    }
  };
  // O *= alpha; p rounded to bf16 into pa (n-tiles 2kk, 2kk + 1 of S: step kk)
  auto rescale_and_pack = [&]() {
#pragma unroll
    for (int e = 0; e < DP / 2; ++e) o[e] *= alpha[(e >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
  };
  // this warpgroup is done with the stage of tile it
  auto release = [&](int it) {
    if (wq == 0 && lane == 0) mbar_arrive(empty + it % RING);
  };

  mbar_wait(landed, 0);
  wg_fence();
  issue_scores(0);
  wg_wait<0>();
  keep(sc);
  softmax(0);
  rescale_and_pack();
  for (int it = 1; it < n_tiles; ++it) {
    mbar_wait(landed + it % RING, (it / RING) & 1);
    wg_fence();
    issue_scores(it);
    issue_pv(it - 1);
    wg_wait<1>();  // S of tile it is in; P.V of tile it - 1 may still run
    keep(sc);
    softmax(it);
    wg_wait<0>();
    keep(o);
    release(it - 1);
    rescale_and_pack();
  }
  wg_fence();
  issue_pv(n_tiles - 1);
  wg_wait<0>();
  keep(o);
  release(n_tiles - 1);

  const size_t C = (size_t)H * D;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const float inv = 1.f / quad_sum(l_i[hr]);
    const int row = q0 + 64 * cw + 16 * wq + g + 8 * hr;
    if (row >= T) continue;
    bf16* orow = out + ((size_t)b * T + row) * C + (size_t)h * D;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      const int col = 8 * i + 2 * t;  // D is a multiple of 8: col + 1 < D too
      if (col < D)
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack_bf16(o[4 * i + 2 * hr] * inv, o[4 * i + 2 * hr + 1] * inv);
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime (the build links no libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The (D, H, T, B) view of q, k or v at ptr (row and batch strides in values),
// boxes of box_w features x 64 rows under the (2 box_w)-byte swizzle.
CUresult encode(CUtensorMap* map, const bf16* ptr, int B, int H, int T, int D,
                long long stride_b, long long stride_t, int box_w) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)stride_t * 2,
                                 (cuuint64_t)stride_b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box_w, 1, 64, 1}, unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = box_w == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : box_w == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                   : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<bf16*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int DP>
cudaError_t launch_h(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
                     const float* cos_t, const float* sin_t, const int* kv_len, bf16* out, int B,
                     int H, int T, int D, int d_rope, float sm_scale, int nwg,
                     cudaStream_t stream) {
  constexpr int smem = hop::smem_bytes(DP);
  static std::atomic<unsigned long long> sized{0};  // a bit a device: the attribute is set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(sized.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(global_attention_bf16_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    sized.fetch_or(bit);
  }
  const dim3 grid((T + 64 * nwg - 1) / (64 * nwg), H, B);
  global_attention_bf16_kernel<DP><<<grid, 128 * (nwg + 1), smem, stream>>>(
      qm, km, vm, cos_t, sin_t, kv_len, out, H, T, D, d_rope, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: head h of row t of item b at ptr + b*stride_b + t*stride_t + h*D
// (f32); cos_t, sin_t: (T, d_rope/2) f32, unused when d_rope = 0; kv_len: (B,)
// int32; out: (B, T, H*D) contiguous f32. Returns a cudaError_t (0 on success).
extern "C" int global_attention_f32(const float* q, const float* k, const float* v,
                                    const float* cos_t, const float* sin_t, const int* kv_len,
                                    float* out, int B, int H, int T, int D, int d_rope,
                                    long long stride_b, long long stride_t, float sm_scale,
                                    void* stream) {
  if (B <= 0 || H <= 0 || T <= 0) return (int)cudaSuccess;
  if (D <= 0 || D > 128 || d_rope < 0 || d_rope > D || (d_rope & 1) ||
      (d_rope > 0 && (cos_t == nullptr || sin_t == nullptr)) || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  // 16-byte copies of k and v rows: every row start 16-byte aligned
  const bool vec = D % 4 == 0 && stride_b % 4 == 0 && stride_t % 4 == 0 && aligned16(k) &&
                   aligned16(v);
  cudaStream_t s = (cudaStream_t)stream;
  switch ((D + 31) / 32) {
    case 1: return (int)launch_nc<1>(vec, q, k, v, cos_t, sin_t, kv_len, out, B, H, T, D, d_rope, stride_b, stride_t, sm_scale, s);
    case 2: return (int)launch_nc<2>(vec, q, k, v, cos_t, sin_t, kv_len, out, B, H, T, D, d_rope, stride_b, stride_t, sm_scale, s);
    case 3: return (int)launch_nc<3>(vec, q, k, v, cos_t, sin_t, kv_len, out, B, H, T, D, d_rope, stride_b, stride_t, sm_scale, s);
    default: return (int)launch_nc<4>(vec, q, k, v, cos_t, sin_t, kv_len, out, B, H, T, D, d_rope, stride_b, stride_t, sm_scale, s);
  }
}

// The bf16 form: q, k, v as above in bf16 (D a multiple of 8, at most 128;
// q, k and v 16-byte aligned and stride_b, stride_t multiples of 8, as TMA
// needs); cos_t, sin_t (T, d_rope/2) f32; kv_len (B,) int32; out (B, T, H*D)
// contiguous bf16; block_rows 64 or 128 query rows a block. Returns a
// cudaError_t (0 on success), or TMA_ENCODE_ERROR + the CUresult with which
// cuTensorMapEncodeTiled refused a tensor map (TMA_ENCODE_ERROR alone: no
// cuTensorMapEncodeTiled was found).
extern "C" int global_attention_bf16(const bf16* q, const bf16* k, const bf16* v,
                                     const float* cos_t, const float* sin_t, const int* kv_len,
                                     bf16* out, int B, int H, int T, int D, int d_rope,
                                     long long stride_b, long long stride_t, float sm_scale,
                                     int block_rows, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0) return (int)cudaSuccess;
  if (D <= 0 || D > 128 || D % 8 || d_rope < 0 || d_rope > D || (d_rope & 1) ||
      (d_rope > 0 && (cos_t == nullptr || sin_t == nullptr)) || B > 65535 || H > 65535 ||
      (block_rows != 64 && block_rows != 128))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || stride_b % 8 || stride_t % 8)
    return (int)cudaErrorMisalignedAddress;
  if (encode_tiled() == nullptr) return TMA_ENCODE_ERROR;
  const int dp = (D + 15) / 16 * 16;
  CUtensorMap qm, km, vm;
  CUresult r = encode(&qm, q, B, H, T, D, stride_b, stride_t, 64);
  if (r == CUDA_SUCCESS) r = encode(&km, k, B, H, T, D, stride_b, stride_t, 64);
  if (r == CUDA_SUCCESS) r = encode(&vm, v, B, H, T, D, stride_b, stride_t, hop::v_width(dp));
  if (r != CUDA_SUCCESS) return TMA_ENCODE_ERROR + (int)r;
  static constexpr decltype(&launch_h<16>) by_width[] = {
      launch_h<16>, launch_h<32>, launch_h<48>, launch_h<64>,
      launch_h<80>, launch_h<96>, launch_h<112>, launch_h<128>};
  return (int)by_width[dp / 16 - 1](qm, km, vm, cos_t, sin_t, kv_len, out, B, H, T, D, d_rope,
                                    sm_scale, block_rows / 64, (cudaStream_t)stream);
}
