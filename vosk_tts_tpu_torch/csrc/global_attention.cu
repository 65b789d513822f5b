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
// tensor cores in 3xTF32 (attention_mma.cuh's split: three TF32 products a
// pair of operands keep f32 accuracy), so the ceiling is 495/3 = 165
// TFLOP/s; q, k, v and out (16*B*T*C bytes) are small next to that at the
// DiT shapes. What holds it below that: the CUDA-core work that turns each
// f32 K and V tile into TF32 operands (the split, V's transpose, RoPE).
//
// global_attention_f32, the TMA route (global_attention_tf32_kernel<DP>, DP
// = D rounded up to 16), for q, k and v that start on 16 bytes with batch
// and row strides and D multiples of 4 values (every serving path's):
//  * grid (ceil(T/64), H, B); a block is a producer warpgroup and one
//    consumer warpgroup of 64 query rows, one block an SM (256 threads;
//    the consumer keeps q, O, S and P in ~225 registers at D96, which two
//    consumer warpgroups under a 384-thread block's 168 would spill);
//  * warp 0 of the producer: one lane loads the block's q rows once, then K
//    and V tiles of 32 keys, by TMA (f32 tensor maps viewing q, k and v as
//    (D, H, T, B) through their strides; boxes of 32 features, one 128-byte
//    swizzle atom, zero-filled past D and T). K lands in a ring of stages
//    (3 at D96, 2 at D112-128, 4 below), V in 4 landing buffers, the
//    tile's cos/sin rows (RoPE where d_rope / 2 is a multiple of 4) in the
//    stage's K-lo tile; a stage completes on a "landed" mbarrier and is
//    refilled once the consumers have "released" it (and the V landing
//    once the helpers have read it);
//  * warps 1-3, the helpers, make each landed tile the two TF32 operands of
//    wgmma, which are both K-major for TF32: K rotated (RoPE) and split
//    into hi (rounded, in place) and lo = x - hi (exact in f32); V
//    transposed into V^T hi and lo, keys contiguous, in each 8-key group
//    the keys in the order 0 2 4 6 1 3 5 7, so that P's accumulator
//    registers are P.V's A fragment as they stand (k index t = key 2t,
//    t + 4 = key 2t + 1). A helper's items are the same every tile (offsets
//    computed once a block), the loads of several issued before the first
//    use; then fence.proxy.async and a "ready" mbarrier release the stage to
//    the consumer, so that the consumer's path holds no CUDA-core
//    preparation. q is rotated once in place; the consumer splits it into
//    registers;
//  * the consumer: S = Q.K^T as 3 wgmma m64n32k8 a k-step of 8 features (q
//    hi/lo from registers, K hi/lo from the stage: q_lo.K_hi + q_hi.K_lo +
//    q_hi.K_hi), O += P.V as 3 wgmma m64nDPk8 a step of 8 keys (P split in
//    registers, V^T hi/lo), all accumulating in f32; S of tile j is issued
//    with P.V of tile j - 1 and its online softmax (sm_scale x log2 e in
//    one FFMA, one ex2 a score, the mask at -30000 on the scaled score)
//    runs while that product does;
//  * the walk stops after the last tile holding a key below kv_len: every
//    later key scores -30000 and gets p = 0 exactly in f32, so skipping is
//    exact; keys past T do not exist and get p = 0; any T >= 1 works.
// The general route (global_attention_f32_general, the kernel
// global_attention_kernel<NC, VEC, ROPE>) takes the layouts TMA cannot load
// (a start off the 16-byte grid, an odd stride or D): one warpgroup per 64
// rows, K/V tiles of 32 keys through a two-stage cp.async ring (16- or
// 4-byte copies), RoPE in place in shared memory, both products as 3xTF32
// mma.sync m16n8k8 (attention_mma.cuh). The wrapper chooses the route from
// the layout alone (ops/flash_attention.global_f32_route).
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
//    operand and DP is a whole number of atoms. The maps are encoded on the
//    host (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint:
//    the build links no libcuda; `encode` keeps the last 32 by their
//    arguments, as for f32) and passed as __grid_constant__ parameters.
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
#include <mutex>

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


// ---- the f32 kernel's (global_attention_tf32_kernel) 3xTF32 wgmma

// d (64 x N, f32) += a (64 x 8, TF32 in registers) . b (8 x N, TF32 in shared
// memory, K-major), N = 2 x d's size; scale_d 0 overwrites d. TF32 operands
// have no transposed form: both are K-major. a's layout is mma.m16n8k8's A
// for each warp's 16 rows (a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8,
// t+4)), d's that of the bf16 products above.
__device__ __forceinline__ void wgmma_tf32(float (&d)[8], const uint32_t (&a)[4], uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[24], const uint32_t (&a)[4], uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[40], const uint32_t (&a)[4], uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[48], const uint32_t (&a)[4], uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[56], const uint32_t (&a)[4], uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}


// d += a.b in 3xTF32 (attention_mma.cuh's split): a_lo.b_hi + a_hi.b_lo +
// a_hi.b_hi, small terms first; b_hi and b_lo are descriptors of two tiles of
// one layout; overwrite: the first product replaces d
template <int R>
__device__ __forceinline__ void wgmma_3x(float (&d)[R], const uint32_t (&a_hi)[4],
                                         const uint32_t (&a_lo)[4], uint64_t b_hi, uint64_t b_lo,
                                         bool overwrite) {
  wgmma_tf32(d, a_lo, b_hi, overwrite ? 0 : 1);
  wgmma_tf32(d, a_hi, b_lo, 1);
  wgmma_tf32(d, a_hi, b_hi, 1);
}

// barrier 1 among the 96 threads of warps 1-3
__device__ __forceinline__ void helpers_sync() { asm volatile("bar.sync 1, 96;\n" ::: "memory"); }

// Byte offset of feature f of row r in a 128-byte-swizzled K-major f32 tile:
// boxes of 32 features (128-byte rows), box bytes apart; 16-byte chunks XORed
// with the row mod 8, as TMA writes them and wgmma reads them.
__device__ __forceinline__ int swz(int r, int f, int box) {
  return (f >> 5) * box + r * 128 + ((((f >> 2) & 7) ^ (r & 7)) << 4) + ((f & 3) << 2);
}

// x split into hi (rounded to TF32) at hi and lo = x - hi at lo: 16 bytes each
__device__ __forceinline__ void store_split(uint8_t* hi, uint8_t* lo, float4 x) {
  uint32_t h[4], l[4];
  split(x.x, h[0], l[0]);
  split(x.y, h[1], l[1]);
  split(x.z, h[2], l[2]);
  split(x.w, h[3], l[3]);
  *reinterpret_cast<uint4*>(hi) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(lo) = make_uint4(l[0], l[1], l[2], l[3]);
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

// The (D, H, T, B) view of q, k or v at ptr (row and batch strides in values
// of elem bytes), boxes of box_w features x box_rows rows; swizzled: the
// swizzle of the box's row width (128, 64 or 32 bytes), else none.
CUresult encode_uncached(CUtensorMap* map, const void* ptr, CUtensorMapDataType type, int elem,
                         int B, int H, int T, int D, long long stride_b, long long stride_t,
                         int box_w, int box_rows, bool swizzled) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * elem, (cuuint64_t)stride_t * elem,
                                 (cuuint64_t)stride_b * elem};
  const cuuint32_t box[4] = {(cuuint32_t)box_w, 1, (cuuint32_t)box_rows, 1}, unit[4] = {1, 1, 1, 1};
  const int row = box_w * elem;
  const CUtensorMapSwizzle swizzle = !swizzled    ? CU_TENSOR_MAP_SWIZZLE_NONE
                                     : row == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : row == 64  ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode_tiled()(map, type, 4, const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// encode_uncached, remembered, for the f32 and bf16 launchers alike: a map is
// a function of these arguments alone, so the one encoded before for the same
// arguments is the same map. Each encode costs a few microseconds of the
// host's time a call, and the caching allocator hands a layer's projection
// the same address call after call.
CUresult encode(CUtensorMap* map, const void* ptr, CUtensorMapDataType type, int elem, int B,
                int H, int T, int D, long long stride_b, long long stride_t, int box_w,
                int box_rows, bool swizzled) {
  struct Entry {
    const void* ptr;
    long long stride_b, stride_t;
    int type, B, H, T, D, box_w, box_rows, swizzled;
    CUtensorMap map;
  };
  constexpr int N = 32;
  static std::mutex lock;
  static Entry cache[N];
  static int filled = 0, next = 0;
  const Entry key{ptr, stride_b, stride_t, (int)type, B, H, T, D, box_w, box_rows, swizzled, {}};
  auto same = [&](const Entry& e) {
    return e.ptr == key.ptr && e.stride_b == key.stride_b && e.stride_t == key.stride_t &&
           e.type == key.type && e.B == key.B && e.H == key.H && e.T == key.T && e.D == key.D &&
           e.box_w == key.box_w && e.box_rows == key.box_rows && e.swizzled == key.swizzled;
  };
  std::lock_guard<std::mutex> guard(lock);
  for (int i = 0; i < filled; ++i)
    if (same(cache[i])) {
      *map = cache[i].map;
      return CUDA_SUCCESS;
    }
  const CUresult r =
      encode_uncached(map, ptr, type, elem, B, H, T, D, stride_b, stride_t, box_w, box_rows,
                      swizzled);
  if (r == CUDA_SUCCESS) {
    cache[next] = key;
    cache[next].map = *map;
    next = (next + 1) % N;
    filled = filled < N ? filled + 1 : N;
  }
  return r;
}

// cudaFuncSetAttribute(kernel, MaxDynamicSharedMemorySize, smem) once a device
// (a bit a device in sized: the attribute is set)
cudaError_t allow_smem(const void* kernel, int smem, std::atomic<unsigned long long>& sized) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (sized.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) sized.fetch_or(bit);
  return err;
}

template <int DP>
cudaError_t launch_h(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
                     const float* cos_t, const float* sin_t, const int* kv_len, bf16* out, int B,
                     int H, int T, int D, int d_rope, float sm_scale, int nwg,
                     cudaStream_t stream) {
  constexpr int smem = hop::smem_bytes(DP);
  static std::atomic<unsigned long long> sized{0};
  const cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(global_attention_bf16_kernel<DP>), smem, sized);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + 64 * nwg - 1) / (64 * nwg), H, B);
  global_attention_bf16_kernel<DP><<<grid, 128 * (nwg + 1), smem, stream>>>(
      qm, km, vm, cos_t, sin_t, kv_len, out, H, T, D, d_rope, sm_scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// global_attention_f32 on Hopper: the bf16 kernel's roles and ring, f32
// tiles, 3xTF32 wgmma, one consumer warpgroup.

namespace tf {

constexpr int BN = 32;            // keys a tile
constexpr int QBOX = 64 * 128;    // bytes of a q box: 64 rows of 32 features
constexpr int KBOX = BN * 128;    // bytes of a K or V box: BN rows of 32 features
constexpr int NL = 4;             // V landing buffers
constexpr int U = 4;              // items a helper thread has in flight at once
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may have

__host__ __device__ constexpr int boxes(int dp) { return (dp + 31) / 32; }
// a stage: K hi and K lo (boxes of KBOX), then V^T hi and V^T lo (dp rows of 128 bytes)
__host__ __device__ constexpr int stage_bytes(int dp) {
  return 2 * boxes(dp) * KBOX + 2 * dp * 128;
}
// alignment slack, q, the V landings, the mbarriers
__host__ __device__ constexpr int fixed_bytes(int dp) {
  return 1024 + boxes(dp) * QBOX + NL * boxes(dp) * KBOX + 256;
}
// ring stages: as many as fit, at most 4 (3 at D96, 2 at D112-128)
__host__ __device__ constexpr int ring(int dp) {
  return (SMEM_MAX - fixed_bytes(dp)) / stage_bytes(dp) < 4
             ? (SMEM_MAX - fixed_bytes(dp)) / stage_bytes(dp)
             : 4;
}
__host__ __device__ constexpr int smem_bytes(int dp) {
  return fixed_bytes(dp) + ring(dp) * stage_bytes(dp);
}

// Rotate the first 2 d2 features of rows [0, n) (n <= 64) in place
// (rotate-half RoPE in f32 from the f32 tables in global memory): row r of a
// swizzled tile of boxes `box` bytes apart, at position pos0 + r; rows at or
// past T are skipped. Thread i of n_thr; 16-byte items (4 features and their
// partners d2 further) where d2 is a multiple of 4, else one feature. Used
// once a block for q, and for K tiles where d2 is not a multiple of 4.
__device__ __forceinline__ void rotate(uint8_t* tile, int box, int n, int pos0, int T, int d2,
                                       const float* __restrict__ cos_t,
                                       const float* __restrict__ sin_t, int i, int n_thr) {
  using hop::swz;
  if (d2 % 4) {
    for (int e = i; e < n * d2; e += n_thr) {
      const int r = e / d2, c = e - r * d2, pos = pos0 + r;
      if (pos >= T) continue;
      float* p0 = reinterpret_cast<float*>(tile + swz(r, c, box));
      float* p1 = reinterpret_cast<float*>(tile + swz(r, c + d2, box));
      const float cv = __ldg(cos_t + (size_t)pos * d2 + c);
      const float sv = __ldg(sin_t + (size_t)pos * d2 + c);
      const float x0 = *p0, x1 = *p1;
      *p0 = x0 * cv + (-x1) * sv;
      *p1 = x1 * cv + x0 * sv;
    }
    return;
  }
  const int per_row = d2 >> 2;
  for (int e = i; e < n * per_row; e += n_thr) {
    const int r = e / per_row, c = (e - r * per_row) * 4, pos = pos0 + r;
    if (pos >= T) continue;
    float4* p0 = reinterpret_cast<float4*>(tile + swz(r, c, box));
    float4* p1 = reinterpret_cast<float4*>(tile + swz(r, c + d2, box));
    const float4 cv = __ldg(reinterpret_cast<const float4*>(cos_t + (size_t)pos * d2 + c));
    const float4 sv = __ldg(reinterpret_cast<const float4*>(sin_t + (size_t)pos * d2 + c));
    const float4 x0 = *p0, x1 = *p1;
    *p0 = make_float4(x0.x * cv.x + (-x1.x) * sv.x, x0.y * cv.y + (-x1.y) * sv.y,
                      x0.z * cv.z + (-x1.z) * sv.z, x0.w * cv.w + (-x1.w) * sv.w);
    *p1 = make_float4(x1.x * cv.x + x0.x * sv.x, x1.y * cv.y + x0.y * sv.y,
                      x1.z * cv.z + x0.z * sv.z, x1.w * cv.w + x0.w * sv.w);
  }
}

// A helper thread's share of every tile (the same items each tile, so their
// offsets are computed once a block). K: the landed tile (BN rows, DP
// features in boxes of KBOX) becomes the two TF32 operands, hi in place and
// lo at the same offset of the lo tile; the first 2 d2 features rotated on
// the way where d2 is a multiple of 4 (pair items: 4 features below d2 and
// their partners d2 further, from the tile's cos rows at the lo tile and its
// sin rows BN * d2 further, d2 values a row, zero past T as the K rows are),
// the rest split as they are (single items of 4 features). V: the landed
// tile (BN keys x 32 features a box, KBOX bytes apart, unswizzled) to V^T hi
// and lo, DP rows (features) of BN keys, 128-byte swizzled, K-major for P.V.
// In each 8-key group of V^T the keys sit in the order 0 2 4 6 1 3 5 7: k
// index u of a step stands for key 2u (u < 4) or 2u - 7, the keys that P's
// accumulator registers hold for lane t at u = t and t + 4, so P is the A
// operand as it stands. A V item is 4 keys of the warp's 32 features (lane =
// feature), one 16-byte chunk of each of 32 V^T rows.
template <int DP>
struct Helper {
  static constexpr int PMAX = (BN * (DP / 8) + 95) / 96;  // pair items (d2 <= DP / 2)
  static constexpr int SMAX = (BN * (DP / 4) + 95) / 96;  // single items
  static constexpr int VMAX = (boxes(DP) * 8 + 2) / 3;    // V items a warp
  int np = 0, ns = 0, nv = 0;
  int p0[PMAX], p1[PMAX], pt[PMAX];  // a pair's offsets, its partners', its table values'
  int s0[SMAX];
  int vs[VMAX], vd[VMAX];  // a V item's first value in the landing, its V^T chunk

  // helper thread i of 96 (warp w of 3, lane), rotating pairs = d2 / 4 pairs a row
  __device__ __forceinline__ Helper(int i, int w, int lane, int pairs, int d2) {
    using hop::swz;
#pragma unroll
    for (int u = 0; u < PMAX; ++u) {
      const int e = i + 96 * u;
      if (e >= BN * pairs) break;
      const int r = e / pairs, c = 4 * (e - r * pairs);
      p0[u] = swz(r, c, KBOX);
      p1[u] = swz(r, c + d2, KBOX);
      pt[u] = r * d2 + c;
      np = u + 1;
    }
    const int lead = 2 * pairs, rest = DP / 4 - lead;
#pragma unroll
    for (int u = 0; u < SMAX; ++u) {
      const int e = i + 96 * u;
      if (e >= BN * rest) break;
      const int r = e / rest;
      s0[u] = swz(r, 4 * (lead + e - r * rest), KBOX);
      ns = u + 1;
    }
#pragma unroll
    for (int u = 0; u < VMAX; ++u) {
      const int e = w + 3 * u, a = e >> 3, c = e & 7, n = 32 * a + lane;
      if (e >= boxes(DP) * 8) break;
      const int k0 = 8 * (c >> 1) + (c & 1);  // keys k0, k0 + 2, k0 + 4, k0 + 6
      vs[u] = a * KBOX + k0 * 128 + lane * 4;
      vd[u] = n < DP ? n * 128 + ((c ^ (n & 7)) << 4) : -1;
      nv = u + 1;
    }
  }

  // K of the tile at kt (hi) and kl (lo); every load of a group is issued
  // before the first use; with pairs, every table value is read before lo is
  // written over the tables
  __device__ __forceinline__ void k_tile(uint8_t* kt, uint8_t* kl, int d2) const {
    using hop::store_split;
    if (np) {
      float4 cv[PMAX], sv[PMAX], x0[PMAX], x1[PMAX];
      const float* tab = reinterpret_cast<const float*>(kl);
#pragma unroll
      for (int u = 0; u < PMAX; ++u) {
        if (u >= np) break;
        cv[u] = *reinterpret_cast<const float4*>(tab + pt[u]);
        sv[u] = *reinterpret_cast<const float4*>(tab + BN * d2 + pt[u]);
        x0[u] = *reinterpret_cast<const float4*>(kt + p0[u]);
        x1[u] = *reinterpret_cast<const float4*>(kt + p1[u]);
      }
      hop::helpers_sync();
#pragma unroll
      for (int u = 0; u < PMAX; ++u) {
        if (u >= np) break;
        const float4 a = x0[u], b = x1[u], cs = cv[u], sn = sv[u];
        store_split(kt + p0[u], kl + p0[u],
                    make_float4(a.x * cs.x + (-b.x) * sn.x, a.y * cs.y + (-b.y) * sn.y,
                                a.z * cs.z + (-b.z) * sn.z, a.w * cs.w + (-b.w) * sn.w));
        store_split(kt + p1[u], kl + p1[u],
                    make_float4(b.x * cs.x + a.x * sn.x, b.y * cs.y + a.y * sn.y,
                                b.z * cs.z + a.z * sn.z, b.w * cs.w + a.w * sn.w));
      }
    } else if (d2 > 0) {
      hop::helpers_sync();  // the caller rotated apart
    }
#pragma unroll
    for (int u0 = 0; u0 < SMAX; u0 += U) {
      float4 x[U];
#pragma unroll
      for (int u = u0; u < u0 + U && u < SMAX; ++u)
        if (u < ns) x[u - u0] = *reinterpret_cast<const float4*>(kt + s0[u]);
#pragma unroll
      for (int u = u0; u < u0 + U && u < SMAX; ++u)
        if (u < ns) store_split(kt + s0[u], kl + s0[u], x[u - u0]);
    }
  }

  // V of the landing at land to V^T hi at vh and lo at vl
  __device__ __forceinline__ void v_tile(const uint8_t* land, uint8_t* vh, uint8_t* vl) const {
#pragma unroll
    for (int u0 = 0; u0 < VMAX; u0 += U) {
      float4 x[U];
#pragma unroll
      for (int u = u0; u < u0 + U && u < VMAX; ++u) {
        if (u >= nv) break;
        const float* src = reinterpret_cast<const float*>(land + vs[u]);
        x[u - u0] = make_float4(src[0], src[64], src[128], src[192]);
      }
#pragma unroll
      for (int u = u0; u < u0 + U && u < VMAX; ++u)
        if (u < nv && vd[u] >= 0) hop::store_split(vh + vd[u], vl + vd[u], x[u - u0]);
    }
  }
};

}  // namespace tf

// One block: a producer warpgroup (warp 0 loads; warps 1-3 rotate, split and
// transpose) and one consumer warpgroup of the 64 query rows from
// blockIdx.x * 64 of item blockIdx.z, head blockIdx.y. DP: D rounded up to 16.
// cmap and smap: the cos and sin tables as (d2, 1, T, 1), read where d2 is a
// multiple of 4 (else the tables are read from cos_t, sin_t).
template <int DP>
__global__ void __launch_bounds__(256, 1)
global_attention_tf32_kernel(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             const __grid_constant__ CUtensorMap cmap,
                             const __grid_constant__ CUtensorMap smap,
                             const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                             const int* __restrict__ kv_len, float* __restrict__ out, int H,
                             int T, int D, int d_rope, float sm_scale) {
  using namespace hop;
  using tf::BN;
  using tf::KBOX;
  constexpr int NB = tf::boxes(DP), RING = tf::ring(DP), SB = tf::stage_bytes(DP);
  constexpr int KT = NB * KBOX;  // bytes of a K tile (hi or lo), of a V landing
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);  // 1024-byte aligned
  uint8_t* ring = qs + NB * tf::QBOX;
  uint8_t* land = ring + RING * SB;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(land + tf::NL * KT);
  uint64_t* qready = qfull + 1;
  uint64_t* full = qfull + 2;      // stage s: K (and its tables) and V have landed
  uint64_t* ready = full + RING;   // ... and are rotated, split and transposed
  uint64_t* empty = ready + RING;  // the consumers have read stage s
  uint64_t* vfree = empty + RING;  // V landing l is read

  const int q0 = blockIdx.x * 64, h = blockIdx.y, b = blockIdx.z;
  const int len = kv_len[b];
  const int kv_end = len > 0 ? min(len, T) : T;    // no valid key: every key counts
  const int unmasked = len > 0 ? min(len, T) : 0;  // keys below it need no mask
  const int n_tiles = (kv_end + BN - 1) / BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int d2 = d_rope >> 1;
  const bool tables = d2 > 0 && d2 % 4 == 0;  // the tile's tables arrive by TMA

  if (tid == 0) {
    mbar_init(qfull, 1);
    mbar_init(qready, 96);
    for (int s = 0; s < RING; ++s) {
      mbar_init(full + s, 1);
      mbar_init(ready + s, 96);
      mbar_init(empty + s, 1);
    }
    for (int l = 0; l < tf::NL; ++l) mbar_init(vfree + l, 96);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {  // the producer warp: one lane issues every load
    if (lane == 0) {
      mbar_expect_tx(qfull, NB * tf::QBOX);
      for (int c = 0; c < NB; ++c) tma_load(qs + c * tf::QBOX, &qmap, qfull, 32 * c, h, q0, b);
      const int tab_bytes = tables ? BN * d2 * 4 : 0;  // one table's rows of a tile
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % RING, l = it % tf::NL;
        if (it >= RING) mbar_wait(empty + s, (it / RING + 1) & 1);     // tile it - RING is read
        if (it >= tf::NL) mbar_wait(vfree + l, (it / tf::NL + 1) & 1);  // and it - NL transposed
        uint8_t* st = ring + s * SB;
        mbar_expect_tx(full + s, 2 * KT + 2 * tab_bytes);
        for (int c = 0; c < NB; ++c) {
          tma_load(st + c * KBOX, &kmap, full + s, 32 * c, h, it * BN, b);
          tma_load(land + l * KT + c * KBOX, &vmap, full + s, 32 * c, h, it * BN, b);
        }
        if (tables) {  // into the K lo tile, which the helpers write once they have read them
          tma_load(st + KT, &cmap, full + s, 0, 0, it * BN, 0);
          tma_load(st + KT + tab_bytes, &smap, full + s, 0, 0, it * BN, 0);
        }
      }
    }
    return;
  }
  if (warp < 4) {  // warps 1-3: rotate q once; each tile: K to its hi and lo, V to V^T
    const int i = tid - 32;
    if (d2 > 0) {
      mbar_wait(qfull, 0);
      tf::rotate(qs, tf::QBOX, 64, q0, T, d2, cos_t, sin_t, i, 96);
      mbar_arrive(qready);
    }
    const tf::Helper<DP> part(i, warp - 1, lane, tables ? d2 >> 2 : 0, d2);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % RING, l = it % tf::NL;
      mbar_wait(full + s, (it / RING) & 1);
      uint8_t* st = ring + s * SB;
      if (d2 > 0 && !tables)  // rotated apart, from the tables in global memory
        tf::rotate(st, KBOX, BN, it * BN, T, d2, cos_t, sin_t, i, 96);
      part.k_tile(st, st + KT, d2);
      part.v_tile(land + l * KT, st + 2 * KT, st + 2 * KT + DP * 128);
      mbar_arrive(vfree + l);
      fence_async_shared();
      mbar_arrive(ready + s);
    }
    return;
  }

  // the consumer warpgroup: rows q0 + 16 wq + g (+ 8) of its warps. S of tile
  // it is issued with P.V of tile it - 1 and its softmax runs while that
  // product does; a lane's score e is row g + 8 ((e >> 1) & 1), key j0 + 8 (e
  // >> 2) + 2t + (e & 1)
  const int wq = warp & 3, g = lane >> 2, t = lane & 3;
  mbar_wait(d2 > 0 ? qready : qfull, 0);
  // q of this warp's rows as A fragments, split once: k-step kk is features 8kk .. 8kk + 7
  uint32_t qh[DP / 8][4], ql[DP / 8][4];
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * wq + g + 8 * (e & 1), f = 8 * kk + t + 4 * (e >> 1);
      split(*reinterpret_cast<const float*>(qs + swz(r, f, tf::QBOX)), qh[kk][e], ql[kk][e]);
    }
  const float sl = sm_scale * LOG2E;
  const float masked_raw = MASK_VALUE / sm_scale;  // a raw score that scales to -30000
  float o[DP / 2];  // O: 64 rows x DP features, element e at column 8 (e >> 2) + 2t + (e & 1)
#pragma unroll
  for (int e = 0; e < DP / 2; ++e) o[e] = 0.f;
  float m_i[2] = {NEG_INIT, NEG_INIT}, l_i[2] = {0.f, 0.f}, alpha[2];
  float sc[BN / 2];
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) sc[e] = 0.f;
  uint32_t ph[BN / 8][4], pl[BN / 8][4];  // p of the previous tile: the A operand of its P.V

  // S = Q.K^T of tile it (64 rows x BN keys): DP/8 k-steps of 8 features (box
  // kk / 4, 32 bytes a step in it), three wgmma m64n32k8 each; committed
  auto issue_scores = [&](int it) {
    const uint8_t* st = ring + (it % RING) * SB;
    const uint64_t kh = desc_k(st), kl = desc_k(st + KT);
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
      const uint64_t off = (uint64_t)(((kk >> 2) * KBOX + (kk & 3) * 32) >> 4);
      wgmma_3x(sc, qh[kk], ql[kk], kh + off, kl + off, kk == 0);
    }
    wg_commit();
  };
  // O += P.V of tile it: BN/8 k-steps of 8 keys, three wgmma m64nDPk8 each
  // (V^T hi and lo the B operands); committed
  auto issue_pv = [&](int it) {
    const uint8_t* vt = ring + (it % RING) * SB + 2 * KT;
    const uint64_t vh = desc_k(vt), vl = desc_k(vt + DP * 128);
#pragma unroll
    for (int kk = 0; kk < BN / 8; ++kk) wgmma_3x(o, ph[kk], pl[kk], vh + 2 * kk, vl + 2 * kk, false);
    wg_commit();
  };
  // the key mask and the online softmax of tile it on the raw scores sc (rows
  // g, g + 8, reduced over the quad; the running max m_i in log2 units): sc
  // becomes p = 2^(sc sl - m_i), l_i and m_i move, alpha is O's scale
  auto softmax = [&](int it) {
    const int j0 = it * BN;
    if (j0 + BN > unmasked) {  // a key of this tile is masked or past T
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) {
        const int j = j0 + 8 * (e >> 2) + 2 * t + (e & 1);
        if (j >= len) sc[e] = masked_raw;
        if (j >= T) sc[e] = -INFINITY;
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i)
        mx = fmaxf(mx, fmaxf(sc[4 * i + 2 * hr], sc[4 * i + 2 * hr + 1]));
      const float m_new = fmaxf(m_i[hr], quad_max(mx) * sl);  // sl > 0: the max commutes
      alpha[hr] = ex2(m_i[hr] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i)
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
  // O *= alpha; p split into the A fragments of P.V: step kk is keys 8kk ..
  // 8kk + 7, its k index t key 2t (registers 4kk, 4kk + 2: rows g, g + 8) and
  // t + 4 key 2t + 1 (4kk + 1, 4kk + 3), as V^T orders them
  auto rescale_and_split = [&]() {
#pragma unroll
    for (int e = 0; e < DP / 2; ++e) o[e] *= alpha[(e >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < BN / 8; ++kk) {
      const float pa[4] = {sc[4 * kk], sc[4 * kk + 2], sc[4 * kk + 1], sc[4 * kk + 3]};
      split4(pa, ph[kk], pl[kk]);
    }
  };
  // the consumers are done with the stage of tile it
  auto release = [&](int it) {
    if (wq == 0 && lane == 0) mbar_arrive(empty + it % RING);
  };

  mbar_wait(ready, 0);
  wg_fence();
  issue_scores(0);
  wg_wait<0>();
  keep(sc);
  softmax(0);
  rescale_and_split();
  for (int it = 1; it < n_tiles; ++it) {
    mbar_wait(ready + it % RING, (it / RING) & 1);
    wg_fence();
    issue_scores(it);
    issue_pv(it - 1);
    wg_wait<1>();  // S of tile it is in; P.V of tile it - 1 may still run
    keep(sc);
    softmax(it);
    wg_wait<0>();
    keep(o);
    release(it - 1);
    rescale_and_split();
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
    const int row = q0 + 16 * wq + g + 8 * hr;
    if (row >= T) continue;
    float* orow = out + ((size_t)b * T + row) * C + (size_t)h * D;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      const int col = 8 * i + 2 * t;  // D is a multiple of 4: col + 1 < D too
      if (col < D)
        *reinterpret_cast<float2*>(orow + col) =
            make_float2(o[4 * i + 2 * hr] * inv, o[4 * i + 2 * hr + 1] * inv);
    }
  }
}

template <int DP>
cudaError_t launch_tf(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
                      const CUtensorMap& cm, const CUtensorMap& sm, const float* cos_t,
                      const float* sin_t, const int* kv_len, float* out, int B, int H, int T,
                      int D, int d_rope, float sm_scale, cudaStream_t stream) {
  constexpr int smem = tf::smem_bytes(DP);
  static_assert(smem <= tf::SMEM_MAX, "the f32 kernel's shared memory");
  static std::atomic<unsigned long long> sized{0};
  const cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(global_attention_tf32_kernel<DP>), smem, sized);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + 63) / 64, H, B);
  global_attention_tf32_kernel<DP><<<grid, 256, smem, stream>>>(
      qm, km, vm, cm, sm, cos_t, sin_t, kv_len, out, H, T, D, d_rope, sm_scale);
  return cudaGetLastError();
}

// c (64 x N) = a (64 x 96) . b (N x 96)^T, both row-major f32, by the f32
// kernel's product: a split into hi and lo in registers, b as hi and lo tiles
// in its swizzled K-major layout, three wgmma m64nNk8 a k-step. N = 32 is S's
// shape, N = 96 P.V's at D96. One warpgroup, a check of the product alone.
template <int N>
__global__ void __launch_bounds__(128)
tf32x3_tile_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ c) {
  using namespace hop;
  constexpr int K = 96, BOXB = N * 128;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* bh = smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);
  uint8_t* bl = bh + (K / 32) * BOXB;
  const int tid = threadIdx.x, wq = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  for (int e = tid; e < N * K / 4; e += 128) {
    const int r = e / (K / 4), f = 4 * (e - r * (K / 4));
    const int off = swz(r, f, BOXB);
    store_split(bh + off, bl + off, *reinterpret_cast<const float4*>(b + r * K + f));
  }
  fence_async_shared();
  __syncthreads();
  uint32_t ah[K / 8][4], al[K / 8][4];
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split(a[(16 * wq + g + 8 * (e & 1)) * K + 8 * kk + t + 4 * (e >> 1)], ah[kk][e], al[kk][e]);
  float d[N / 2];
#pragma unroll
  for (int e = 0; e < N / 2; ++e) d[e] = 0.f;
  const uint64_t dh = desc_k(bh), dl = desc_k(bl);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    const uint64_t off = (uint64_t)(((kk >> 2) * BOXB + (kk & 3) * 32) >> 4);
    wgmma_3x(d, ah[kk], al[kk], dh + off, dl + off, kk == 0);
  }
  wg_commit();
  wg_wait<0>();
  keep(d);
#pragma unroll
  for (int e = 0; e < N / 2; ++e)
    c[(16 * wq + g + 8 * ((e >> 1) & 1)) * N + 8 * (e >> 2) + 2 * t + (e & 1)] = d[e];
}

}  // namespace

// q, k, v: head h of row t of item b at ptr + b*stride_b + t*stride_t + h*D
// (f32); cos_t, sin_t: (T, d_rope/2) f32, unused when d_rope = 0; kv_len: (B,)
// int32; out: (B, T, H*D) contiguous f32. The TMA route: q, k and v start on 16
// bytes, stride_b, stride_t and D are multiples of 4 (cudaErrorMisalignedAddress
// otherwise: the general route takes those). Returns a cudaError_t (0 on
// success), or TMA_ENCODE_ERROR + the CUresult with which
// cuTensorMapEncodeTiled refused a tensor map.
extern "C" int global_attention_f32(const float* q, const float* k, const float* v,
                                    const float* cos_t, const float* sin_t, const int* kv_len,
                                    float* out, int B, int H, int T, int D, int d_rope,
                                    long long stride_b, long long stride_t, float sm_scale,
                                    void* stream) {
  if (B <= 0 || H <= 0 || T <= 0) return (int)cudaSuccess;
  if (D <= 0 || D > 128 || d_rope < 0 || d_rope > D || (d_rope & 1) ||
      (d_rope > 0 && (cos_t == nullptr || sin_t == nullptr)) || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || stride_b % 4 || stride_t % 4 || D % 4)
    return (int)cudaErrorMisalignedAddress;
  if (encode_tiled() == nullptr) return TMA_ENCODE_ERROR;
  constexpr CUtensorMapDataType F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const int d2 = d_rope / 2;
  CUtensorMap qm, km, vm, cm, sm;
  CUresult r = encode(&qm, q, F32, 4, B, H, T, D, stride_b, stride_t, 32, 64, true);
  if (r == CUDA_SUCCESS)
    r = encode(&km, k, F32, 4, B, H, T, D, stride_b, stride_t, 32, tf::BN, true);
  if (r == CUDA_SUCCESS)
    r = encode(&vm, v, F32, 4, B, H, T, D, stride_b, stride_t, 32, tf::BN, false);
  if (d2 > 0 && d2 % 4 == 0) {  // the tables as (d2, 1, T, 1): a tile's BN rows a box
    const long long n = (long long)T * d2;
    if (r == CUDA_SUCCESS)
      r = encode(&cm, cos_t, F32, 4, 1, 1, T, d2, n, d2, d2, tf::BN, false);
    if (r == CUDA_SUCCESS)
      r = encode(&sm, sin_t, F32, 4, 1, 1, T, d2, n, d2, d2, tf::BN, false);
  } else {
    cm = sm = km;  // not read
  }
  if (r != CUDA_SUCCESS) return TMA_ENCODE_ERROR + (int)r;
  static constexpr decltype(&launch_tf<16>) by_width[] = {
      launch_tf<16>, launch_tf<32>, launch_tf<48>, launch_tf<64>,
      launch_tf<80>, launch_tf<96>, launch_tf<112>, launch_tf<128>};
  return (int)by_width[(D + 15) / 16 - 1](qm, km, vm, cm, sm, cos_t, sin_t, kv_len, out, B, H, T,
                                          D, d_rope, sm_scale, (cudaStream_t)stream);
}

// The general route: global_attention_f32's arguments in any layout (4-byte
// copies where a start, a stride or D is off the 16-byte grid).
extern "C" int global_attention_f32_general(const float* q, const float* k, const float* v,
                                            const float* cos_t, const float* sin_t,
                                            const int* kv_len, float* out, int B, int H, int T,
                                            int D, int d_rope, long long stride_b,
                                            long long stride_t, float sm_scale, void* stream) {
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

// c (64 x n) = a (64 x 96) . b (n x 96)^T through the f32 kernel's 3xTF32
// wgmma product alone, n 32 or 96 (contiguous f32; one warpgroup): a check of
// the product's accuracy. Returns a cudaError_t.
extern "C" int tf32x3_wgmma_tile(const float* a, const float* b, float* c, int n, void* stream) {
  if (n != 32 && n != 96) return (int)cudaErrorInvalidValue;
  const int smem = 1024 + 2 * 3 * n * 128;
  const void* kernel = n == 32 ? reinterpret_cast<const void*>(tf32x3_tile_kernel<32>)
                               : reinterpret_cast<const void*>(tf32x3_tile_kernel<96>);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (n == 32)
    tf32x3_tile_kernel<32><<<1, 128, smem, (cudaStream_t)stream>>>(a, b, c);
  else
    tf32x3_tile_kernel<96><<<1, 128, smem, (cudaStream_t)stream>>>(a, b, c);
  return (int)cudaGetLastError();
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
  constexpr CUtensorMapDataType BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUresult r = encode(&qm, q, BF16, 2, B, H, T, D, stride_b, stride_t, 64, 64, true);
  if (r == CUDA_SUCCESS) r = encode(&km, k, BF16, 2, B, H, T, D, stride_b, stride_t, 64, 64, true);
  if (r == CUDA_SUCCESS)
    r = encode(&vm, v, BF16, 2, B, H, T, D, stride_b, stride_t, hop::v_width(dp), 64, true);
  if (r != CUDA_SUCCESS) return TMA_ENCODE_ERROR + (int)r;
  static constexpr decltype(&launch_h<16>) by_width[] = {
      launch_h<16>, launch_h<32>, launch_h<48>, launch_h<64>,
      launch_h<80>, launch_h<96>, launch_h<112>, launch_h<128>};
  return (int)by_width[dp / 16 - 1](qm, km, vm, cos_t, sin_t, kv_len, out, B, H, T, D, d_rope,
                                    sm_scale, block_rows / 64, (cudaStream_t)stream);
}
