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
// them). q, k and v are read through (batch, row) strides, so the packed
// (B, T, 3C) output of a fused qkv projection and separate (B, T, C)
// tensors both work; out is (B, T, C), the o projection's input.
//
// What bounds it on Hopper: 4*H*D*T*sum(kv_len) floating-point operations in
// f32. Scores and sums stay in f32 on the CUDA cores (FMA, no TF32) so the
// result matches the f32 reference to ~1e-6; at f32 the card's peak is
// 67 TFLOP/s, and q, k, v and out (16*B*T*C bytes) are small next to that at
// the DiT shapes, so it is compute-bound.
//
// Design (simple first; wgmma/TMA/bf16 are later work):
//  * grid (ceil(T/64), H, B); a block of 8 warps stages 64 query rows in
//    shared memory, RoPE applied as they are staged, and walks the key tiles
//    of 64 with an online softmax (the loop takes the place of the TPU's
//    sequential grid axis);
//  * each k tile is rotated as it is staged; cos/sin come from the wrapper's
//    table (the plain version's formula), not from fast-math __sinf;
//  * each warp owns 8 query rows; a lane scores keys lane and lane+32 and
//    owns output columns lane, lane+32, ... (D <= 128 a runtime value,
//    NC = ceil(D/32) a template parameter); q/k rows at a stride of D+1
//    floats keep the per-lane key reads free of bank conflicts;
//  * the walk stops after the last tile holding a key below kv_len: every
//    later key scores -30000 and gets p = 0 exactly in f32, so skipping is
//    exact; keys past T do not exist and get p = 0; any T >= 1 works.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int WARPS = 8;
constexpr int ROWS = BQ / WARPS;
constexpr float MASK_VALUE = -30000.f;
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

template <int NC>
__global__ void __launch_bounds__(WARPS * 32)
global_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ cos_t,
                        const float* __restrict__ sin_t, const int* __restrict__ kv_len,
                        float* __restrict__ out, int H, int T, int D, int d_rope,
                        long long stride_b, long long stride_t, float sm_scale) {
  extern __shared__ __align__(16) float smem[];
  const int DP = D + 1;
  float* q_s = smem;             // BQ x DP
  float* k_s = q_s + BQ * DP;    // BK x DP
  float* v_s = k_s + BK * DP;    // BK x D
  float* p_s = v_s + BK * D;     // WARPS x ROWS x BK

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int len = kv_len[b];
  const int kv_end = len > 0 ? min(len, T) : T;  // no valid key: every key counts
  const size_t head = (size_t)b * stride_b + (size_t)h * D;
  const float* qb = q + head;
  const float* kb = k + head;
  const float* vb = v + head;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = warp * ROWS;

  for (int e = tid; e < BQ * D; e += blockDim.x) {
    const int r = e / D, c = e - r * D;
    const int i = q0 + r;
    q_s[r * DP + c] = i < T ? roped(qb + (size_t)i * stride_t, c, d_rope, cos_t, sin_t, i) : 0.f;
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

  for (int j0 = 0; j0 < kv_end; j0 += BK) {
    __syncthreads();  // q staged; previous tile consumed
    for (int e = tid; e < BK * D; e += blockDim.x) {
      const int r = e / D, c = e - r * D;
      const int j = j0 + r;
      float kv = 0.f, vv = 0.f;
      if (j < T) {
        kv = roped(kb + (size_t)j * stride_t, c, d_rope, cos_t, sin_t, j);
        vv = vb[(size_t)j * stride_t + c];
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
      float mx = -INFINITY;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j = j0 + lane + 32 * t;
        float val = s[r][t] * sm_scale;
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
    __syncwarp();
  }

  const size_t C = (size_t)H * D;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const float l = warp_sum(l_i[r]);
    const int i = q0 + row0 + r;
    if (i >= T) continue;
    float* o = out + ((size_t)b * T + i) * C + (size_t)h * D;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int c = lane + 32 * cc;
      if (c < D) o[c] = acc[r][cc] / l;
    }
  }
}

template <int NC>
cudaError_t launch(const float* q, const float* k, const float* v, const float* cos_t,
                   const float* sin_t, const int* kv_len, float* out, int B, int H, int T,
                   int D, int d_rope, long long stride_b, long long stride_t, float sm_scale,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (size_t)(BQ * (D + 1) + BK * (D + 1) + BK * D + WARPS * ROWS * BK);
  cudaError_t err = cudaFuncSetAttribute(global_attention_kernel<NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T + BQ - 1) / BQ, H, B);
  global_attention_kernel<NC><<<grid, WARPS * 32, smem, stream>>>(
      q, k, v, cos_t, sin_t, kv_len, out, H, T, D, d_rope, stride_b, stride_t, sm_scale);
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
  cudaStream_t s = (cudaStream_t)stream;
  switch ((D + 31) / 32) {
    case 1: return (int)launch<1>(q, k, v, cos_t, sin_t, kv_len, out, B, H, T, D, d_rope, stride_b, stride_t, sm_scale, s);
    case 2: return (int)launch<2>(q, k, v, cos_t, sin_t, kv_len, out, B, H, T, D, d_rope, stride_b, stride_t, sm_scale, s);
    case 3: return (int)launch<3>(q, k, v, cos_t, sin_t, kv_len, out, B, H, T, D, d_rope, stride_b, stride_t, sm_scale, s);
    default: return (int)launch<4>(q, k, v, cos_t, sin_t, kv_len, out, B, H, T, D, d_rope, stride_b, stride_t, sm_scale, s);
  }
}
