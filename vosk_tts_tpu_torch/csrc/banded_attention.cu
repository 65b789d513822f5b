// Banded relative-position self-attention (VITS2 text encoder and flow).
//
// Replaces the TPU kernel vosk_tts_tpu/ops/flash_attention.py::_kernel
// (wrapper banded_flash_attention). Computes, per (batch, head):
//   s[i,j] = q[i].k[j] + [|j-i| <= w] q[i].rel_k[j-i+w]     (q pre-scaled)
//   s[i,j] = -1e4                                         for j >= kv_len
//   p = softmax_j(s)
//   out[i] = sum_j p[i,j] v[j] + sum_{|j-i|<=w} p[i,j] rel_v[j-i+w]
// Every row i < T attends to the valid keys; rows past kv_len are masked
// by the caller. kv_len <= 0 masks every key, so every row attends to all T.
//
// What bounds it on Hopper: 4*B*H*T*kv_len*D operations for the two
// products, done on the tensor cores in 3xTF32 (attention_mma.cuh): three
// TF32 products per fragment pair keep f32 accuracy, so the ceiling is
// 495/3 = 165 TFLOP/s, against 67 TFLOP/s for f32 FMA on the CUDA cores.
// The band terms (2w+1 per row) and the bytes (q, k, v, out) are small next
// to that: it is bound by operations.
//
// Design:
//  * grid (B*H, ceil(T/64)); one warpgroup (4 warps) per 64-row query tile,
//    each warp owning 16 rows, its q rows held in registers in the
//    A-fragment layout;
//  * K and V tiles of 32 keys arrive through a two-stage cp.async ring
//    (16-byte copies where D and the pointers allow, else 4-byte copies),
//    D zero-padded to DW (a multiple of 32), rows at strides that keep the
//    16-byte fragment reads free of bank conflicts; at D = 96 the ring
//    takes 54,272 bytes and the band tables (rel_k, rel_v, logits, p)
//    ~11 KB, so three blocks fit on an SM;
//  * S = Q.K^T and O += P.V run as mma.m16n8k8 in 3xTF32 with S and O in
//    registers and P fed from its registers, the tile core shared with
//    global_attention.cu (attention_mma.cuh);
//  * the key walk stops after the last tile holding a key below kv_len (all
//    T tiles when kv_len <= 0): a later key scores -1e4 and gets p = 0
//    exactly in f32 once a valid score exists, so skipping is exact;
//  * the (64, 2w+1) band logits q.rel_k are computed once per block (a
//    quad reduction over the q fragments) and added only on the key tiles
//    that meet [q0-w, q0+63+w]; on those tiles alone the band's p go to a
//    per-warp table and the rel_v term (sum_m p_band[m] rel_v[m], linear in
//    p) is added in f32 after O's rescaling; other tiles whose keys are all
//    valid skip the mask;
//  * keys at or past kv_len score -1e4 (finite, as the reference), keys past
//    T do not exist and get p = 0; any T >= 1 and a ragged last tile work.
//
// banded_attention_bf16 (the JAX kernel in bf16): the same walk over bf16
// q, k, v, rel_k and rel_v. q.k and p.v take one mma.m16n8k16 bf16 product
// a fragment with f32 accumulation (attention_mma.cuh), so the ceiling is
// the 989 TFLOP/s of the bf16 tensor cores; the K and V tiles are bf16 in
// shared memory (half the f32 ring: 25,600 bytes at D = 96), V entering the
// product through ldmatrix.trans. The scores, the running max, the row sums
// and the output accumulator stay f32 (the JAX kernel keeps its score tile
// and max in bf16, a TPU economy not carried over); p is rounded to bf16
// before p.v and before the band's p.rel_v (rel_k and rel_v staged as f32,
// the band logits q.rel_k in f32); the output is bf16. D a multiple of 8.

#include <cuda_runtime.h>
#include <math.h>

#include "attention_mma.cuh"

namespace {

using namespace attn;

constexpr float MASK_VALUE = -1e4f;

template <int NC>
constexpr size_t smem_floats(int m) {
  // the ring, rel_k and rel_v (M x DW each), band logits (BQ x M), band p (BQ x M)
  return (size_t)STAGES * stage_floats(32 * NC) + 2 * (size_t)m * 32 * NC + 2 * (size_t)BQ * m;
}

template <int NC, int VEC>
__global__ void __launch_bounds__(THREADS, NC <= 3 ? 3 : 2)
banded_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ rel_k,
                        const float* __restrict__ rel_v, const int* __restrict__ kv_len,
                        float* __restrict__ out, int H, int T, int D, int window, int n_rel) {
  constexpr int DW = 32 * NC;  // padded head width
  constexpr int ND = DW / 8;   // 8-feature k-steps of q.k, 8-column n-tiles of o
  const int M = 2 * window + 1;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                                // STAGES x (K tile, V tile)
  float* relk_s = ring + STAGES * stage_floats(DW);  // M x DW
  float* relv_s = relk_s + M * DW;                   // M x DW
  float* band_s = relv_s + M * DW;                   // BQ x M: q.rel_k
  float* pb_s = band_s + BQ * M;                     // BQ x M: the band's p of one tile

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * BQ;
  const int len = kv_len[b];
  const int kv_end = len > 0 ? min(len, T) : T;  // no valid key: every key counts
  const int unmasked = len > 0 ? min(len, T) : 0;  // keys below it need no mask
  const size_t base = (size_t)bh * T * D;
  const float* qb = q + base;
  const float* kb = k + base;
  const float* vb = v + base;
  const int rel = n_rel > 1 ? h : 0;
  const float* relk_g = rel_k + (size_t)rel * M * D;
  const float* relv_g = rel_v + (size_t)rel * M * D;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n16 = (D + 15) / 16;  // k-step pairs that hold features

  zero_pad<DW>(ring, D, tid);
#pragma unroll 4
  for (int e = tid; e < M * DW; e += THREADS) {
    const int m = e / DW, c = e - m * DW;
    relk_s[e] = c < D ? relk_g[(size_t)m * D + c] : 0.f;
    relv_s[e] = c < D ? relv_g[(size_t)m * D + c] : 0.f;
  }
  const int n_tiles = (kv_end + BK - 1) / BK;
  load_stage<VEC, DW>(ring, 0, kb, vb, D, 0, T, D, tid);
  cp_async_commit();

  // this warp's q rows r0 and r0 + 8 in the A-fragment layout
  const int r0 = q0 + warp * 16 + g;
  float qf[ND][4];
#pragma unroll
  for (int kk = 0; kk < ND; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = r0 + 8 * (e & 1);
      const int c = q_feature(kk, t, e);
      qf[kk][e] = i < T && c < D ? qb[(size_t)i * D + c] : 0.f;
    }
  }

  // band logits of rows r0, r0 + 8: each lane's features, summed over the quad
  __syncthreads();  // rel_k staged
  float* band0 = band_s + (warp * 16 + g) * M;
  float* band1 = band0 + 8 * M;
  for (int m = 0; m < M; ++m) {
    const float* rk = relk_s + m * DW;
    float p0 = 0.f, p1 = 0.f;
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      const int c = q_feature(kk, t, 0);
      const float k0 = rk[c], k1 = rk[c + 1];
      p0 = fmaf(qf[kk][0], k0, fmaf(qf[kk][2], k1, p0));
      p1 = fmaf(qf[kk][1], k0, fmaf(qf[kk][3], k1, p1));
    }
    p0 = quad_sum(p0);
    p1 = quad_sum(p1);
    if (t == 0) {
      band0[m] = p0;
      band1[m] = p1;
    }
  }
  float* pb0 = pb_s + (warp * 16 + g) * M;
  float* pb1 = pb0 + 8 * M;
  float* pb_w = pb_s + warp * 16 * M;
  __syncwarp();

  float m_i[2] = {NEG_INIT, NEG_INIT}, l_i[2] = {0.f, 0.f}, o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int j0 = it * BK;
    if (it + 1 < n_tiles)
      load_stage<VEC, DW>(ring, (it + 1) % STAGES, kb, vb, D, j0 + BK, T, D, tid);
    cp_async_commit();
    cp_async_wait<1>();  // tile it has landed; tile it+1 may be in flight
    __syncthreads();
    // does the band of any row of this query tile reach into this key tile?
    const bool band_tile = j0 <= q0 + BQ - 1 + window && j0 + BK - 1 >= q0 - window;

    float s[NT][4];
    score_tile<NC>(s, qf, k_tile<DW>(ring, it % STAGES), n16, g, t);
    if (band_tile || j0 + BK > unmasked) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + nt * 8 + 2 * t + (e & 1);
          const int off = j - (r0 + 8 * (e >> 1));
          if (band_tile && off >= -window && off <= window)
            s[nt][e] += (e >> 1 ? band1 : band0)[off + window];
          if (j >= len) s[nt][e] = MASK_VALUE;
          if (j >= T) s[nt][e] = -INFINITY;
        }
    }
    softmax_tile<NC>(s, m_i, l_i, o);
    pv_tile<NC>(o, s, v_tile<DW>(ring, it % STAGES), g, t);

    if (band_tile) {  // o += sum_m p_band[m] rel_v[m] over this tile's band keys
      for (int e = lane; e < 16 * M; e += 32) pb_w[e] = 0.f;
      __syncwarp();
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int off = j0 + nt * 8 + 2 * t + (e & 1) - (r0 + 8 * (e >> 1));
          if (off >= -window && off <= window) (e >> 1 ? pb1 : pb0)[off + window] = s[nt][e];
        }
      __syncwarp();
      for (int m = 0; m < M; ++m) {
        const float p0 = pb0[m], p1 = pb1[m];
        const float* rv = relv_s + m * DW + 8 * t;
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {  // columns 32c + 8t + 4hh + (0..3)
            const float4 r = *reinterpret_cast<const float4*>(rv + 32 * c + 4 * hh);
            const float rr[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              o[4 * c + i][hh] = fmaf(p0, rr[i], o[4 * c + i][hh]);
              o[4 * c + i][2 + hh] = fmaf(p1, rr[i], o[4 * c + i][2 + hh]);
            }
          }
      }
      __syncwarp();
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

  float* orow0 = out + base + (size_t)r0 * D;
  store_rows<NC>(o, l_i, orow0, orow0 + 8 * D, r0, T, D, t);
}

template <int NC, int VEC>
cudaError_t launch(const float* q, const float* k, const float* v, const float* rel_k,
                   const float* rel_v, const int* kv_len, float* out, int B, int H, int T,
                   int D, int window, int n_rel, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<NC>(2 * window + 1);
  cudaError_t err = cudaFuncSetAttribute(banded_attention_kernel<NC, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (T + BQ - 1) / BQ);
  banded_attention_kernel<NC, VEC><<<grid, THREADS, smem, stream>>>(
      q, k, v, rel_k, rel_v, kv_len, out, H, T, D, window, n_rel);
  return cudaGetLastError();
}

template <int NC>
cudaError_t launch_nc(bool vec, const float* q, const float* k, const float* v,
                      const float* rel_k, const float* rel_v, const int* kv_len, float* out,
                      int B, int H, int T, int D, int window, int n_rel, cudaStream_t s) {
  return vec ? launch<NC, 4>(q, k, v, rel_k, rel_v, kv_len, out, B, H, T, D, window, n_rel, s)
             : launch<NC, 1>(q, k, v, rel_k, rel_v, kv_len, out, B, H, T, D, window, n_rel, s);
}

using bf16 = __nv_bfloat16;

template <int NC>
constexpr size_t smem_bytes_h(int m) {
  // the bf16 ring, then f32 rel_k and rel_v (M x DW each), band logits and band p (BQ x M)
  return sizeof(bf16) * STAGES * stage_halves(32 * NC) +
         sizeof(float) * (2 * (size_t)m * 32 * NC + 2 * (size_t)BQ * m);
}

__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16(x)); }

template <int NC, int VEC>
__global__ void __launch_bounds__(THREADS, NC <= 3 ? 3 : 2)
banded_attention_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const bf16* __restrict__ rel_k,
                             const bf16* __restrict__ rel_v, const int* __restrict__ kv_len,
                             bf16* __restrict__ out, int H, int T, int D, int window, int n_rel) {
  constexpr int DW = 32 * NC;  // padded head width
  constexpr int ND = DW / 8;   // 8-column n-tiles of o
  const int M = 2 * window + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);                          // STAGES x (K, V)
  float* relk_s = reinterpret_cast<float*>(ring + STAGES * stage_halves(DW));  // M x DW
  float* relv_s = relk_s + M * DW;                                         // M x DW
  float* band_s = relv_s + M * DW;                                         // BQ x M: q.rel_k
  float* pb_s = band_s + BQ * M;  // BQ x M: the band's p of one tile

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * BQ;
  const int len = kv_len[b];
  const int kv_end = len > 0 ? min(len, T) : T;    // no valid key: every key counts
  const int unmasked = len > 0 ? min(len, T) : 0;  // keys below it need no mask
  const size_t base = (size_t)bh * T * D;
  const bf16* qb = q + base;
  const bf16* kb = k + base;
  const bf16* vb = v + base;
  const int rel = n_rel > 1 ? h : 0;
  const bf16* relk_g = rel_k + (size_t)rel * M * D;
  const bf16* relv_g = rel_v + (size_t)rel * M * D;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n32 = (D + 31) / 32;  // 32-feature chunks that hold features

  zero_pad_h<DW>(ring, D, tid);
#pragma unroll 4
  for (int e = tid; e < M * DW; e += THREADS) {
    const int m = e / DW, c = e - m * DW;
    relk_s[e] = c < D ? __bfloat162float(relk_g[(size_t)m * D + c]) : 0.f;
    relv_s[e] = c < D ? __bfloat162float(relv_g[(size_t)m * D + c]) : 0.f;
  }
  const int n_tiles = (kv_end + BK - 1) / BK;
  load_stage_h<VEC, DW>(ring, 0, kb, vb, D, 0, T, D, tid);
  cp_async_commit();

  // this warp's q rows r0 and r0 + 8 as bf16 A fragments
  const int r0 = q0 + warp * 16 + g;
  uint32_t qa[2 * NC][4];
  load_q_h<NC>(qa, r0, T, D, t,
               [&](int i, int c) { return __bfloat162float(qb[(size_t)i * D + c]); });

  // band logits of rows r0, r0 + 8 in f32: each lane's 8 features a chunk,
  // summed over the quad
  __syncthreads();  // rel_k staged
  float* band0 = band_s + (warp * 16 + g) * M;
  float* band1 = band0 + 8 * M;
  for (int m = 0; m < M; ++m) {
    const float* rk = relk_s + m * DW;
    float p0 = 0.f, p1 = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float* kk = rk + 32 * c + 8 * t + 4 * hh;
        const uint32_t* a = qa[2 * c + hh];
        p0 = fmaf(bf16_lo(a[0]), kk[0], fmaf(bf16_hi(a[0]), kk[1], p0));
        p0 = fmaf(bf16_lo(a[2]), kk[2], fmaf(bf16_hi(a[2]), kk[3], p0));
        p1 = fmaf(bf16_lo(a[1]), kk[0], fmaf(bf16_hi(a[1]), kk[1], p1));
        p1 = fmaf(bf16_lo(a[3]), kk[2], fmaf(bf16_hi(a[3]), kk[3], p1));
      }
    p0 = quad_sum(p0);
    p1 = quad_sum(p1);
    if (t == 0) {
      band0[m] = p0;
      band1[m] = p1;
    }
  }
  float* pb0 = pb_s + (warp * 16 + g) * M;
  float* pb1 = pb0 + 8 * M;
  float* pb_w = pb_s + warp * 16 * M;
  __syncwarp();

  float m_i[2] = {NEG_INIT, NEG_INIT}, l_i[2] = {0.f, 0.f}, o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int j0 = it * BK;
    if (it + 1 < n_tiles)
      load_stage_h<VEC, DW>(ring, (it + 1) % STAGES, kb, vb, D, j0 + BK, T, D, tid);
    cp_async_commit();
    cp_async_wait<1>();  // tile it has landed; tile it+1 may be in flight
    __syncthreads();
    const bool band_tile = j0 <= q0 + BQ - 1 + window && j0 + BK - 1 >= q0 - window;

    float s[NT][4];
    score_tile_h<NC>(s, qa, k_tile_h<DW>(ring, it % STAGES), n32, g, t);
    if (band_tile || j0 + BK > unmasked) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + nt * 8 + 2 * t + (e & 1);
          const int off = j - (r0 + 8 * (e >> 1));
          if (band_tile && off >= -window && off <= window)
            s[nt][e] += (e >> 1 ? band1 : band0)[off + window];
          if (j >= len) s[nt][e] = MASK_VALUE;
          if (j >= T) s[nt][e] = -INFINITY;
        }
    }
    softmax_tile<NC>(s, m_i, l_i, o);
    pv_tile_h<NC>(o, s, v_tile_h<DW>(ring, it % STAGES), lane);

    if (band_tile) {  // o += sum_m p_band[m] rel_v[m], p rounded to bf16 as in p.v
      for (int e = lane; e < 16 * M; e += 32) pb_w[e] = 0.f;
      __syncwarp();
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int off = j0 + nt * 8 + 2 * t + (e & 1) - (r0 + 8 * (e >> 1));
          if (off >= -window && off <= window)
            (e >> 1 ? pb1 : pb0)[off + window] = round_bf16(s[nt][e]);
        }
      __syncwarp();
      for (int m = 0; m < M; ++m) {
        const float p0 = pb0[m], p1 = pb1[m];
        const float* rv = relv_s + m * DW + 2 * t;
#pragma unroll
        for (int nd = 0; nd < ND; ++nd) {  // columns 8nd + 2t, 8nd + 2t + 1
          const float2 r = *reinterpret_cast<const float2*>(rv + 8 * nd);
          o[nd][0] = fmaf(p0, r.x, o[nd][0]);
          o[nd][1] = fmaf(p0, r.y, o[nd][1]);
          o[nd][2] = fmaf(p1, r.x, o[nd][2]);
          o[nd][3] = fmaf(p1, r.y, o[nd][3]);
        }
      }
      __syncwarp();
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

  bf16* orow0 = out + base + (size_t)r0 * D;
  store_rows_h<NC>(o, l_i, orow0, orow0 + 8 * D, r0, T, D, t);
}

template <int NC, int VEC>
cudaError_t launch_h(const bf16* q, const bf16* k, const bf16* v, const bf16* rel_k,
                     const bf16* rel_v, const int* kv_len, bf16* out, int B, int H, int T, int D,
                     int window, int n_rel, cudaStream_t stream) {
  const size_t smem = smem_bytes_h<NC>(2 * window + 1);
  cudaError_t err = cudaFuncSetAttribute(banded_attention_bf16_kernel<NC, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (T + BQ - 1) / BQ);
  banded_attention_bf16_kernel<NC, VEC><<<grid, THREADS, smem, stream>>>(
      q, k, v, rel_k, rel_v, kv_len, out, H, T, D, window, n_rel);
  return cudaGetLastError();
}

template <int NC>
cudaError_t launch_nc_h(bool vec, const bf16* q, const bf16* k, const bf16* v, const bf16* rel_k,
                        const bf16* rel_v, const int* kv_len, bf16* out, int B, int H, int T,
                        int D, int window, int n_rel, cudaStream_t s) {
  return vec ? launch_h<NC, 8>(q, k, v, rel_k, rel_v, kv_len, out, B, H, T, D, window, n_rel, s)
             : launch_h<NC, 1>(q, k, v, rel_k, rel_v, kv_len, out, B, H, T, D, window, n_rel, s);
}

}  // namespace

// q, k, v, out: (B, H, T, D) contiguous f32, q pre-scaled by D^-1/2;
// rel_k, rel_v: (n_rel, 2*window+1, D) with n_rel 1 (shared) or H;
// kv_len: (B,) int32. Returns a cudaError_t (0 on success).
extern "C" int banded_attention_f32(const float* q, const float* k, const float* v,
                                    const float* rel_k, const float* rel_v, const int* kv_len,
                                    float* out, int B, int H, int T, int D, int window,
                                    int n_rel, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0) return (int)cudaSuccess;
  if (D <= 0 || D > 128 || window < 0 || window > 64) return (int)cudaErrorInvalidValue;
  // 16-byte copies of k and v rows: every row start 16-byte aligned
  const bool vec = D % 4 == 0 && aligned16(k) && aligned16(v);
  cudaStream_t s = (cudaStream_t)stream;
  switch ((D + 31) / 32) {
    case 1: return (int)launch_nc<1>(vec, q, k, v, rel_k, rel_v, kv_len, out, B, H, T, D, window, n_rel, s);
    case 2: return (int)launch_nc<2>(vec, q, k, v, rel_k, rel_v, kv_len, out, B, H, T, D, window, n_rel, s);
    case 3: return (int)launch_nc<3>(vec, q, k, v, rel_k, rel_v, kv_len, out, B, H, T, D, window, n_rel, s);
    default: return (int)launch_nc<4>(vec, q, k, v, rel_k, rel_v, kv_len, out, B, H, T, D, window, n_rel, s);
  }
}

// The bf16 form: q, k, v, out (B, H, T, D) contiguous bf16, q pre-scaled;
// rel_k, rel_v (n_rel, 2*window+1, D) bf16; kv_len (B,) int32; D a multiple
// of 8. Returns a cudaError_t (0 on success).
extern "C" int banded_attention_bf16(const bf16* q, const bf16* k, const bf16* v,
                                     const bf16* rel_k, const bf16* rel_v, const int* kv_len,
                                     bf16* out, int B, int H, int T, int D, int window, int n_rel,
                                     void* stream) {
  if (B <= 0 || H <= 0 || T <= 0) return (int)cudaSuccess;
  if (D <= 0 || D > 128 || D % 8 || window < 0 || window > 64) return (int)cudaErrorInvalidValue;
  // 16-byte copies of k and v rows: every row start 16-byte aligned (D % 8 == 0)
  const bool vec = aligned16(k) && aligned16(v);
  cudaStream_t s = (cudaStream_t)stream;
  switch ((D + 31) / 32) {
    case 1: return (int)launch_nc_h<1>(vec, q, k, v, rel_k, rel_v, kv_len, out, B, H, T, D, window, n_rel, s);
    case 2: return (int)launch_nc_h<2>(vec, q, k, v, rel_k, rel_v, kv_len, out, B, H, T, D, window, n_rel, s);
    case 3: return (int)launch_nc_h<3>(vec, q, k, v, rel_k, rel_v, kv_len, out, B, H, T, D, window, n_rel, s);
    default: return (int)launch_nc_h<4>(vec, q, k, v, rel_k, rel_v, kv_len, out, B, H, T, D, window, n_rel, s);
  }
}
