// Banded relative-position self-attention (VITS2 text encoder and flow).
//
// Replaces the TPU kernel vosk_tts_tpu/ops/flash_attention.py::_kernel
// (wrapper banded_flash_attention). Computes, per (batch, head):
//   s[i,j] = q[i].k[j] + [|j-i| <= w] q[i].rel_k[j-i+w]     (q pre-scaled)
//   s[i,j] = -1e4                                         for j >= kv_len
//   p = softmax_j(s)
//   out[i] = sum_j p[i,j] v[j] + sum_{|j-i|<=w} p[i,j] rel_v[j-i+w]
// Every row i < T attends to the valid keys; rows past kv_len are masked
// by the caller.
//
// What bounds it on Hopper: 4*B*H*T^2*D floating-point operations in f32.
// Scores stay in f32 on the CUDA cores (no TF32) so the result matches the
// f32 reference; at f32 the card's peak is 67 TFLOP/s (no tensor cores), and
// the bytes (q, k, v, out) are small next to that, so it is compute-bound.
//
// Design (simple first; wgmma/TMA/bf16 are later work):
//  * grid (B*H, ceil(T/64)); a block of 8 warps stages 64 query rows in
//    shared memory and walks the keys in tiles of 64 (an online softmax, the
//    loop taking the place of the TPU's sequential grid axis);
//  * each warp owns 8 query rows; a lane scores keys lane and lane+32 and
//    owns output columns lane, lane+32, ... (D is a runtime value <= 128,
//    NC = ceil(D/32) a template parameter);
//  * q/k rows sit at a stride of D+1 floats so the per-lane key reads are
//    free of bank conflicts;
//  * the (64, 2w+1) band logits q.rel_k are computed once per block; the
//    rel_v term is linear in p, so it is added per tile with the same
//    rescaling as v. No band-exclusion or signed correction pass is needed
//    (the TPU kernel had one because compare/select is expensive there);
//  * keys at or past kv_len score -1e4 (finite, as the reference), keys past
//    T do not exist and get p = 0; any T >= 1 and a ragged last tile work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int WARPS = 8;
constexpr int ROWS = BQ / WARPS;
constexpr float MASK_VALUE = -1e4f;
constexpr float NEG_INIT = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int NC>
__global__ void __launch_bounds__(WARPS * 32)
banded_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ rel_k,
                        const float* __restrict__ rel_v, const int* __restrict__ kv_len,
                        float* __restrict__ out, int H, int T, int D, int window, int n_rel) {
  extern __shared__ __align__(16) float smem[];
  const int DP = D + 1;
  const int M = 2 * window + 1;
  float* q_s = smem;                 // BQ x DP
  float* k_s = q_s + BQ * DP;        // BK x DP
  float* v_s = k_s + BK * DP;        // BK x D
  float* relv_s = v_s + BK * D;      // M x D
  float* band_s = relv_s + M * D;    // BQ x M
  float* p_s = band_s + BQ * M;      // WARPS x ROWS x BK

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * BQ;
  const int len = kv_len[b];
  const size_t base = (size_t)bh * T * D;
  const int rel = n_rel > 1 ? h : 0;
  const float* relk_g = rel_k + (size_t)rel * M * D;
  const float* relv_g = rel_v + (size_t)rel * M * D;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = warp * ROWS;

  for (int e = tid; e < BQ * D; e += blockDim.x) {
    const int r = e / D, c = e - r * D;
    const int i = q0 + r;
    q_s[r * DP + c] = i < T ? q[base + (size_t)i * D + c] : 0.f;
  }
  for (int e = tid; e < M * D; e += blockDim.x) relv_s[e] = relv_g[e];
  __syncthreads();
  for (int e = tid; e < BQ * M; e += blockDim.x) {
    const int r = e / M, m = e - r * M;
    const float* qr = q_s + r * DP;
    const float* kr = relk_g + (size_t)m * D;
    float s = 0.f;
    for (int c = 0; c < D; ++c) s = fmaf(qr[c], __ldg(kr + c), s);
    band_s[e] = s;
  }

  float m_i[ROWS], l_i[ROWS], acc[ROWS][NC];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m_i[r] = NEG_INIT;
    l_i[r] = 0.f;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) acc[r][cc] = 0.f;
  }
  float* p_w = p_s + warp * ROWS * BK;

  for (int j0 = 0; j0 < T; j0 += BK) {
    __syncthreads();  // previous tile consumed; band_s complete
    for (int e = tid; e < BK * D; e += blockDim.x) {
      const int r = e / D, c = e - r * D;
      const int j = j0 + r;
      float kv = 0.f, vv = 0.f;
      if (j < T) {
        kv = k[base + (size_t)j * D + c];
        vv = v[base + (size_t)j * D + c];
      }
      k_s[r * DP + c] = kv;
      v_s[r * D + c] = vv;
    }
    __syncthreads();

    float s[ROWS][2];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r][0] = s[r][1] = 0.f;
    const float* k0p = k_s + lane * DP;
    const float* k1p = k_s + (lane + 32) * DP;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      const float k0 = k0p[c], k1 = k1p[c];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float qv = q_s[(row0 + r) * DP + c];
        s[r][0] = fmaf(qv, k0, s[r][0]);
        s[r][1] = fmaf(qv, k1, s[r][1]);
      }
    }

#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int i = q0 + row0 + r;
      float mx = -INFINITY;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j = j0 + lane + 32 * t;
        float val = s[r][t];
        const int off = j - i;
        if (off >= -window && off <= window) val += band_s[(row0 + r) * M + off + window];
        if (j >= len) val = MASK_VALUE;
        if (j >= T) val = -INFINITY;
        s[r][t] = val;
        mx = fmaxf(mx, val);
      }
      mx = warp_max(mx);
      const float m_new = fmaxf(m_i[r], mx);
      const float alpha = expf(m_i[r] - m_new);
      const float p0 = expf(s[r][0] - m_new);
      const float p1 = expf(s[r][1] - m_new);
      l_i[r] = l_i[r] * alpha + p0 + p1;
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) acc[r][cc] *= alpha;
      m_i[r] = m_new;
      p_w[r * BK + lane] = p0;
      p_w[r * BK + lane + 32] = p1;
    }
    __syncwarp();

    const int nk = min(BK, T - j0);
    for (int jj = 0; jj < nk; ++jj) {
      float vv[NC];
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const int c = lane + 32 * cc;
        vv[cc] = c < D ? v_s[jj * D + c] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float p = p_w[r * BK + jj];
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) acc[r][cc] = fmaf(p, vv[cc], acc[r][cc]);
      }
    }

#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int i = q0 + row0 + r;
      for (int m = 0; m < M; ++m) {
        const int jj = i + m - window - j0;
        if (jj < 0 || jj >= nk) continue;
        const float p = p_w[r * BK + jj];
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          const int c = lane + 32 * cc;
          if (c < D) acc[r][cc] = fmaf(p, relv_s[m * D + c], acc[r][cc]);
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const float l = warp_sum(l_i[r]);
    const int i = q0 + row0 + r;
    if (i >= T) continue;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int c = lane + 32 * cc;
      if (c < D) out[base + (size_t)i * D + c] = acc[r][cc] / l;
    }
  }
}

template <int NC>
cudaError_t launch(const float* q, const float* k, const float* v, const float* rel_k,
                   const float* rel_v, const int* kv_len, float* out, int B, int H, int T,
                   int D, int window, int n_rel, cudaStream_t stream) {
  const int M = 2 * window + 1;
  const size_t smem = sizeof(float) * (size_t)(BQ * (D + 1) + BK * (D + 1) + BK * D + M * D +
                                               BQ * M + WARPS * ROWS * BK);
  cudaError_t err = cudaFuncSetAttribute(banded_attention_kernel<NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (T + BQ - 1) / BQ);
  banded_attention_kernel<NC><<<grid, WARPS * 32, smem, stream>>>(
      q, k, v, rel_k, rel_v, kv_len, out, H, T, D, window, n_rel);
  return cudaGetLastError();
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
  cudaStream_t s = (cudaStream_t)stream;
  switch ((D + 31) / 32) {
    case 1: return (int)launch<1>(q, k, v, rel_k, rel_v, kv_len, out, B, H, T, D, window, n_rel, s);
    case 2: return (int)launch<2>(q, k, v, rel_k, rel_v, kv_len, out, B, H, T, D, window, n_rel, s);
    case 3: return (int)launch<3>(q, k, v, rel_k, rel_v, kv_len, out, B, H, T, D, window, n_rel, s);
    default: return (int)launch<4>(q, k, v, rel_k, rel_v, kv_len, out, B, H, T, D, window, n_rel, s);
  }
}
