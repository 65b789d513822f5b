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
// global_attention_bf16 (the JAX kernels in bf16): the same walk over bf16
// q, k, v (the three forms as above). q.k and p.v take one mma.m16n8k16
// bf16 product a fragment with f32 accumulation (attention_mma.cuh), so the
// ceiling is the 989 TFLOP/s of the bf16 tensor cores; K and V tiles are
// bf16 in shared memory (25,600 bytes for two stages at D = 96), V entering
// the product through ldmatrix.trans. RoPE rotates in f32 from the f32
// tables and rounds the rotated q and k to bf16 (k in place in the tile);
// sm_scale multiplies the f32 scores; the scores, the running max, the row
// sums and the accumulator stay f32 (the JAX kernel keeps its score tile
// and max in bf16, a TPU economy not carried over); p is rounded to bf16
// before p.v; the key mask (-30000) is applied to the f32 scores; the
// output is bf16. D a multiple of 8.

#include <cuda_runtime.h>
#include <math.h>

#include "attention_mma.cuh"

namespace {

using namespace attn;

constexpr float MASK_VALUE = -30000.f;

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

using bf16 = __nv_bfloat16;

// roped() of a bf16 row: the rotation in f32 (rounded to bf16 by the caller).
__device__ __forceinline__ float roped_h(const bf16* __restrict__ src, int c, int d_rope,
                                         const float* __restrict__ cs,
                                         const float* __restrict__ sn, int t) {
  const float x = __bfloat162float(src[c]);
  if (c >= d_rope) return x;
  const int d2 = d_rope >> 1;
  const int j = c < d2 ? c : c - d2;
  const float cv = __ldg(cs + (size_t)t * d2 + j);
  const float sv = __ldg(sn + (size_t)t * d2 + j);
  const float other = c < d2 ? -__bfloat162float(src[c + d2]) : __bfloat162float(src[j]);
  return x * cv + other * sv;
}

template <int NC, int VEC, bool ROPE>
__global__ void __launch_bounds__(THREADS, NC <= 3 ? 3 : 2)
global_attention_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const float* __restrict__ cos_t,
                             const float* __restrict__ sin_t, const int* __restrict__ kv_len,
                             bf16* __restrict__ out, int H, int T, int D, int d_rope,
                             long long stride_b, long long stride_t, float sm_scale) {
  constexpr int DW = 32 * NC;  // padded head width
  constexpr int ND = DW / 8;   // 8-column n-tiles of o
  constexpr int LDK = k_stride_h(DW);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // STAGES x (K tile, V tile)

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int len = kv_len[b];
  const int kv_end = len > 0 ? min(len, T) : T;    // no valid key: every key counts
  const int unmasked = len > 0 ? min(len, T) : 0;  // keys below it need no mask
  const size_t head = (size_t)b * stride_b + (size_t)h * D;
  const bf16* qb = q + head;
  const bf16* kb = k + head;
  const bf16* vb = v + head;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n32 = (D + 31) / 32;  // 32-feature chunks that hold features

  if (!ROPE) d_rope = 0;  // the compiler drops every RoPE path
  const int d2 = d_rope >> 1;

  zero_pad_h<DW>(ring, D, tid);
  const int n_tiles = (kv_end + BK - 1) / BK;
  load_stage_h<VEC, DW>(ring, 0, kb, vb, stride_t, 0, T, D, tid);
  cp_async_commit();

  // this warp's q rows r0 and r0 + 8, rotated, as bf16 A fragments
  const int r0 = q0 + warp * 16 + g;
  uint32_t qa[2 * NC][4];
  load_q_h<NC>(qa, r0, T, D, t, [&](int i, int c) {
    return roped_h(qb + (size_t)i * stride_t, c, d_rope, cos_t, sin_t, i);
  });

  float m_i[2] = {NEG_INIT, NEG_INIT}, l_i[2] = {0.f, 0.f}, o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int j0 = it * BK;
    if (it + 1 < n_tiles)
      load_stage_h<VEC, DW>(ring, (it + 1) % STAGES, kb, vb, stride_t, j0 + BK, T, D, tid);
    cp_async_commit();
    cp_async_wait<1>();  // tile it has landed; tile it+1 may be in flight
    __syncthreads();
    bf16* ks = k_tile_h<DW>(ring, it % STAGES);
    if (d2 > 0) {  // rotate the k tile in place, in f32, rounded back to bf16
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
          bf16* row = ks + r * LDK;
          const float x0 = __bfloat162float(row[c]), x1 = __bfloat162float(row[c + d2]);
          row[c] = __float2bfloat16(x0 * cv[i] + (-x1) * sv[i]);
          row[c + d2] = __float2bfloat16(x1 * cv[i] + x0 * sv[i]);
        }
      }
      __syncthreads();
    }

    float s[NT][4];
    score_tile_h<NC>(s, qa, ks, n32, g, t);
    const bool masked = j0 + BK > unmasked;  // a key of this tile is masked or past T
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] *= sm_scale;
        if (masked) {
          const int j = j0 + nt * 8 + 2 * t + (e & 1);
          if (j >= len) s[nt][e] = MASK_VALUE;
          if (j >= T) s[nt][e] = -INFINITY;
        }
      }
    softmax_tile<NC>(s, m_i, l_i, o);
    pv_tile_h<NC>(o, s, v_tile_h<DW>(ring, it % STAGES), lane);
    __syncthreads();  // this stage is consumed before it is refilled
  }

  const size_t C = (size_t)H * D;
  bf16* orow0 = out + ((size_t)b * T + r0) * C + (size_t)h * D;
  store_rows_h<NC>(o, l_i, orow0, orow0 + 8 * C, r0, T, D, t);
}

template <int NC, int VEC, bool ROPE>
cudaError_t launch_h(const bf16* q, const bf16* k, const bf16* v, const float* cos_t,
                     const float* sin_t, const int* kv_len, bf16* out, int B, int H, int T, int D,
                     int d_rope, long long stride_b, long long stride_t, float sm_scale,
                     cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * STAGES * stage_halves(32 * NC);
  cudaError_t err = cudaFuncSetAttribute(global_attention_bf16_kernel<NC, VEC, ROPE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T + BQ - 1) / BQ, H, B);
  global_attention_bf16_kernel<NC, VEC, ROPE><<<grid, THREADS, smem, stream>>>(
      q, k, v, cos_t, sin_t, kv_len, out, H, T, D, d_rope, stride_b, stride_t, sm_scale);
  return cudaGetLastError();
}

template <int NC>
cudaError_t launch_nc_h(bool vec, const bf16* q, const bf16* k, const bf16* v,
                        const float* cos_t, const float* sin_t, const int* kv_len, bf16* out,
                        int B, int H, int T, int D, int d_rope, long long stride_b,
                        long long stride_t, float sm_scale, cudaStream_t s) {
  auto go = [&](auto kernel_launch) {
    return kernel_launch(q, k, v, cos_t, sin_t, kv_len, out, B, H, T, D, d_rope, stride_b,
                         stride_t, sm_scale, s);
  };
  if (d_rope > 0) return vec ? go(launch_h<NC, 8, true>) : go(launch_h<NC, 1, true>);
  return vec ? go(launch_h<NC, 8, false>) : go(launch_h<NC, 1, false>);
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

// The bf16 form: q, k, v as above in bf16 (D a multiple of 8); cos_t, sin_t
// (T, d_rope/2) f32; kv_len (B,) int32; out (B, T, H*D) contiguous bf16.
// Returns a cudaError_t (0 on success).
extern "C" int global_attention_bf16(const bf16* q, const bf16* k, const bf16* v,
                                     const float* cos_t, const float* sin_t, const int* kv_len,
                                     bf16* out, int B, int H, int T, int D, int d_rope,
                                     long long stride_b, long long stride_t, float sm_scale,
                                     void* stream) {
  if (B <= 0 || H <= 0 || T <= 0) return (int)cudaSuccess;
  if (D <= 0 || D > 128 || D % 8 || d_rope < 0 || d_rope > D || (d_rope & 1) ||
      (d_rope > 0 && (cos_t == nullptr || sin_t == nullptr)) || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  // 16-byte copies of k and v rows: every row start 16-byte aligned
  const bool vec = stride_b % 8 == 0 && stride_t % 8 == 0 && aligned16(k) && aligned16(v);
  cudaStream_t s = (cudaStream_t)stream;
  switch ((D + 31) / 32) {
    case 1: return (int)launch_nc_h<1>(vec, q, k, v, cos_t, sin_t, kv_len, out, B, H, T, D, d_rope, stride_b, stride_t, sm_scale, s);
    case 2: return (int)launch_nc_h<2>(vec, q, k, v, cos_t, sin_t, kv_len, out, B, H, T, D, d_rope, stride_b, stride_t, sm_scale, s);
    case 3: return (int)launch_nc_h<3>(vec, q, k, v, cos_t, sin_t, kv_len, out, B, H, T, D, d_rope, stride_b, stride_t, sm_scale, s);
    default: return (int)launch_nc_h<4>(vec, q, k, v, cos_t, sin_t, kv_len, out, B, H, T, D, d_rope, stride_b, stride_t, sm_scale, s);
  }
}
