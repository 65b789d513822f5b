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
// What bounds it on Hopper: the pointwise products, 2*B*T*C^2*L f32
// operations on the CUDA cores (no TF32, for f32 parity); the bytes are
// x and out once plus the L*C^2 weights, which stay in the 50 MB L2.
//
// Design (simple first): the TPU kernel kept a whole (T, C) row in VMEM;
// one Hopper block holds at most 227 KB, so T is tiled instead.
//  * grid (B, ceil(T/32)); a block loads rows [t0 - halo, t0 + 32 + halo)
//    with halo = sum_i K^i (K-1)/2 (13 for L=3, K=3); rows outside [0, T)
//    are zero with mask 0, which is the conv's zero padding;
//  * layer i runs over a window that shrinks by its own padding at each
//    edge, so the last layer produces exactly the block's 32 rows;
//  * layer norms are warp reductions over C; GELU uses erff;
//  * the pointwise product is computed in the body: each thread owns one
//    output channel and up to 64 rows of accumulators; the weight (stored
//    (C_out, C_in)) is streamed through shared memory 32 input channels at
//    a time, transposed on the way in (row stride C+1: no bank conflicts).
// 256 threads, C <= 256 and C % 32 == 0.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BT = 32;
constexpr int THREADS = 256;
constexpr int RC = 64;   // rows per pointwise pass
constexpr int CK = 32;   // input channels per staged weight tile

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float gelu(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752440f));
}

// rows [lo, hi) of buf (stride C): buf = gelu(layer_norm(buf)), or, with
// residual, res += gelu(layer_norm(buf)). One warp per row.
__device__ void norm_gelu(float* buf, float* res, int lo, int hi, int C, const float* g,
                          const float* bta) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int r = lo + warp; r < hi; r += THREADS / 32) {
    float* row = buf + (size_t)r * C;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += row[c];
    const float mean = warp_sum(s) / C;
    float s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = row[c] - mean;
      s2 += d * d;
    }
    const float rstd = rsqrtf(warp_sum(s2) / C + 1e-5f);
    for (int c = lane; c < C; c += 32) {
      const float y = gelu((row[c] - mean) * rstd * g[c] + bta[c]);
      if (res)
        res[(size_t)r * C + c] += y;
      else
        row[c] = y;
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
ddsconv_kernel(const float* __restrict__ x, const float* __restrict__ mask,
               const float* __restrict__ sep_w, const float* __restrict__ sep_b,
               const float* __restrict__ pw_w, const float* __restrict__ pw_b,
               const float* __restrict__ n1g, const float* __restrict__ n1b,
               const float* __restrict__ n2g, const float* __restrict__ n2b,
               float* __restrict__ out, int T, int C, int L, int K, int halo) {
  extern __shared__ __align__(16) float smem[];
  const int W0 = BT + 2 * halo;
  float* xw = smem;                       // W0 x C   the residual stream
  float* yb = xw + (size_t)W0 * C;        // W0 x C   the branch
  float* ws = yb + (size_t)W0 * C;        // CK x (C+1) weight tile
  float* mw = ws + (size_t)CK * (C + 1);  // W0       mask window

  const int b = blockIdx.x;
  const int t0 = blockIdx.y * BT;
  const int g0 = t0 - halo;
  const int tid = threadIdx.x;
  const float* xb = x + (size_t)b * T * C;

  for (int e = tid; e < W0 * C; e += THREADS) {
    const int r = e / C, c = e - r * C;
    const int g = g0 + r;
    xw[e] = (g >= 0 && g < T) ? xb[(size_t)g * C + c] : 0.f;
  }
  for (int r = tid; r < W0; r += THREADS) {
    const int g = g0 + r;
    mw[r] = (g >= 0 && g < T) ? mask[(size_t)b * T + g] : 0.f;
  }
  __syncthreads();

  int lo = 0;
  int dil = 1;
  for (int i = 0; i < L; ++i, dil *= K) {
    const int pad = dil * (K - 1) / 2;
    lo += pad;
    const int hi = W0 - lo;
    const float* wi = sep_w + (size_t)i * C * K;

    // depthwise conv of x * mask, then bias
    for (int e = tid; e < (hi - lo) * C; e += THREADS) {
      const int r = lo + e / C, c = e % C;
      float s = 0.f;
      for (int kk = 0; kk < K; ++kk) {
        const int rr = r - pad + kk * dil;
        s = fmaf(xw[(size_t)rr * C + c] * mw[rr], wi[c * K + kk], s);
      }
      yb[(size_t)r * C + c] = s + sep_b[i * C + c];
    }
    __syncthreads();
    norm_gelu(yb, nullptr, lo, hi, C, n1g + i * C, n1b + i * C);

    // pointwise C x C product, rows [lo, hi) in passes of RC rows
    const float* wp = pw_w + (size_t)i * C * C;
    for (int r0 = lo; r0 < hi; r0 += RC) {
      const int nr = min(RC, hi - r0);
      float acc[RC];
#pragma unroll
      for (int rr = 0; rr < RC; ++rr) acc[rr] = 0.f;
      for (int c0 = 0; c0 < C; c0 += CK) {
        __syncthreads();  // branch rows complete; previous tile consumed
        for (int e = tid; e < C * CK; e += THREADS) {
          const int o = e / CK, cc = e - o * CK;
          ws[cc * (C + 1) + o] = wp[(size_t)o * C + c0 + cc];
        }
        __syncthreads();
        if (tid < C) {
#pragma unroll
          for (int cc = 0; cc < CK; cc += 4) {
            const float w0 = ws[(cc + 0) * (C + 1) + tid];
            const float w1 = ws[(cc + 1) * (C + 1) + tid];
            const float w2 = ws[(cc + 2) * (C + 1) + tid];
            const float w3 = ws[(cc + 3) * (C + 1) + tid];
#pragma unroll
            for (int rr = 0; rr < RC; ++rr) {
              if (rr < nr) {
                const float4 y4 =
                    *reinterpret_cast<const float4*>(yb + (size_t)(r0 + rr) * C + c0 + cc);
                float a = acc[rr];
                a = fmaf(y4.x, w0, a);
                a = fmaf(y4.y, w1, a);
                a = fmaf(y4.z, w2, a);
                a = fmaf(y4.w, w3, a);
                acc[rr] = a;
              }
            }
          }
        }
      }
      __syncthreads();  // every thread has read these branch rows
      if (tid < C) {
        const float bias = pw_b[i * C + tid];
#pragma unroll
        for (int rr = 0; rr < RC; ++rr)
          if (rr < nr) yb[(size_t)(r0 + rr) * C + tid] = acc[rr] + bias;
      }
    }
    __syncthreads();
    norm_gelu(yb, xw, lo, hi, C, n2g + i * C, n2b + i * C);
    __syncthreads();
  }

  float* ob = out + (size_t)b * T * C;
  for (int e = tid; e < BT * C; e += THREADS) {
    const int r = e / C, c = e - r * C;
    const int g = t0 + r;
    if (g < T) ob[(size_t)g * C + c] = xw[(size_t)(halo + r) * C + c] * mw[halo + r];
  }
}

}  // namespace

// x, out: (B, T, C) contiguous f32; mask: (B, T) f32; sep_w: (L, C, K);
// pw_w: (L, C_out, C_in); sep_b, pw_b, n1g, n1b, n2g, n2b: (L, C).
// Returns a cudaError_t (0 on success).
extern "C" int ddsconv_f32(const float* x, const float* mask, const float* sep_w,
                           const float* sep_b, const float* pw_w, const float* pw_b,
                           const float* n1g, const float* n1b, const float* n2g,
                           const float* n2b, float* out, int B, int T, int C, int L, int K,
                           void* stream) {
  if (B <= 0 || T <= 0) return (int)cudaSuccess;
  if (C <= 0 || C > THREADS || C % CK != 0 || K < 1 || K % 2 == 0 || L < 1)
    return (int)cudaErrorInvalidValue;
  int halo = 0;
  for (int i = 0, d = 1; i < L; ++i, d *= K) halo += d * (K - 1) / 2;
  const int W0 = BT + 2 * halo;
  const size_t smem = sizeof(float) * ((size_t)2 * W0 * C + (size_t)CK * (C + 1) + W0 + 4);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ddsconv_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, (T + BT - 1) / BT);
  ddsconv_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x, mask, sep_w, sep_b, pw_w, pw_b, n1g, n1b, n2g, n2b, out, T, C, L, K, halo);
  return (int)cudaGetLastError();
}
