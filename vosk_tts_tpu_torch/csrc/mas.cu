// Monotonic alignment search (VITS2 training): the hard path that
// maximises the summed log-likelihood neg_cent over monotonic alignments.
//
// The port's own kernel: the JAX package runs this DP on the device as a
// lax.scan wavefront plus a reverse scan (vosk_tts_tpu/ops/mas.py, no
// Pallas kernel), and the reference in Cython on the host. Same semantics,
// per batch row b with t_y = t_ys[b] rows and t_x = t_xs[b] columns valid:
//   band(y)    = [max(0, t_x + y - t_y), min(t_x, y + 1))
//   v[-1][x]   = NEG (-1e9)
//   stay       = x == y ? NEG : v[y-1][x]
//   left       = x == 0 ? (y == 0 ? 0 : NEG) : v[y-1][x-1]
//   v[y][x]    = x in band(y) ? neg_cent[y][x] + max(stay, left) : NEG
//   backtrack from idx = t_x - 1 at y = t_y - 1: path[y][idx] = 1, then
//   idx -= 1 when y > 0, idx != 0 and (idx == y or v[y-1][idx] <
//   v[y-1][idx-1]) (a strict <: ties stay); rows at or past t_y are 0.
//
// What bounds it on Hopper: the bytes are neg_cent read once and the path
// written once (15.7 MB at B24 T_y 512 T_x 160, 4.7 us at 3.35 TB/s), but
// the recurrence is a serial chain of t_y dependent rows, and nothing else
// can run beside a row within a batch row. So it is bound by latency: one
// barrier a row.
//
// Design:
//  * one CTA per batch row (B CTAs), up to 256 threads, each thread
//    owning the columns x = tid + c * blockDim (c < 16, so T_x <= 4096);
//  * the running row v lives in shared memory as two rows (ping-pong),
//    so one __syncthreads a row separates its reads from the next writes;
//  * the thread loads its neg_cent values of row y + 1 into registers
//    before it computes row y, so the global load's latency overlaps the
//    row's compute and barrier;
//  * the backtrack decision of every (y, x) depends only on row y - 1, so
//    it is taken while row y is computed, packed into one bit a cell with
//    __ballot_sync (one 32-bit word a warp and row, written by lane 0):
//    t_y * ceil(T_x / 32) words of shared memory (22.4 KB at 800 x 200);
//  * one thread walks the bits back from (t_y - 1, t_x - 1) and stores
//    each row's column; then every thread writes the path (B, T_y, T_x)
//    row by row, zeros and one 1, coalesced.
// The sums and maxima are the plain version's f32 operations in the same
// order, so the path equals it bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr float NEG = -1e9f;
constexpr int MAX_THREADS = 256;
constexpr int MAX_CHUNKS = 16;

__global__ void __launch_bounds__(MAX_THREADS)
mas_kernel(const float* __restrict__ neg_cent, const int* __restrict__ t_ys,
           const int* __restrict__ t_xs, float* __restrict__ path, int Ty, int Tx) {
  extern __shared__ unsigned char smem[];
  const int words = (Tx + 31) >> 5;
  float* v = reinterpret_cast<float*>(smem);                   // [2][Tx]
  int* cols = reinterpret_cast<int*>(v + 2 * Tx);              // [Ty]
  unsigned* bits = reinterpret_cast<unsigned*>(cols + Ty);     // [Ty][words]

  const int b = blockIdx.x;
  const int tid = threadIdx.x, nthreads = blockDim.x, lane = tid & 31;
  const int ty = min(max(t_ys[b], 0), Ty);
  const int tx = min(max(t_xs[b], 0), Tx);
  const int chunks = (words * 32 + nthreads - 1) / nthreads;
  const float* nc = neg_cent + (size_t)b * Ty * Tx;
  float* out = path + (size_t)b * Ty * Tx;

  if (ty > 0 && tx > 0) {
    for (int x = tid; x < Tx; x += nthreads) v[Tx + x] = NEG;  // row -1, read by row 0
    float cur_nc[MAX_CHUNKS];
#pragma unroll
    for (int c = 0; c < MAX_CHUNKS; ++c) {
      const int x = tid + c * nthreads;
      cur_nc[c] = (c < chunks && x < Tx) ? nc[x] : 0.f;
    }
    __syncthreads();
    for (int y = 0; y < ty; ++y) {
      float next_nc[MAX_CHUNKS];
#pragma unroll
      for (int c = 0; c < MAX_CHUNKS; ++c) {
        const int x = tid + c * nthreads;
        next_nc[c] = (c < chunks && x < Tx && y + 1 < ty) ? nc[(size_t)(y + 1) * Tx + x] : 0.f;
      }
      const float* prev = v + ((y + 1) & 1) * Tx;
      float* cur = v + (y & 1) * Tx;
      const int x_lo = max(0, tx + y - ty), x_hi = min(tx, y + 1);
#pragma unroll
      for (int c = 0; c < MAX_CHUNKS; ++c) {
        const int x = tid + c * nthreads;
        if (c < chunks && x < words * 32) {  // whole warps: the ballot needs all 32 lanes
          bool move = false;
          if (x < Tx) {
            const float stay = x == y ? NEG : prev[x];
            const float left = x == 0 ? (y == 0 ? 0.f : NEG) : prev[x - 1];
            const float val = cur_nc[c] + fmaxf(stay, left);
            cur[x] = (x >= x_lo && x < x_hi) ? val : NEG;
            move = x != 0 && (x == y || prev[x] < prev[x - 1]);
          }
          const unsigned word = __ballot_sync(0xffffffffu, move);
          if (lane == 0) bits[y * words + (x >> 5)] = word;
        }
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < MAX_CHUNKS; ++c) cur_nc[c] = next_nc[c];
    }
    if (tid == 0) {
      int idx = tx - 1;
      for (int y = ty - 1; y >= 0; --y) {
        cols[y] = idx;
        if (y > 0 && ((bits[y * words + (idx >> 5)] >> (idx & 31)) & 1u)) --idx;
      }
    }
    __syncthreads();
  }
  for (int y = 0; y < Ty; ++y) {
    const int sel = (y < ty && tx > 0) ? cols[y] : -1;
    for (int x = tid; x < Tx; x += nthreads) out[(size_t)y * Tx + x] = x == sel ? 1.f : 0.f;
  }
}

size_t smem_bytes(int Ty, int Tx) {
  return sizeof(float) * 2 * (size_t)Tx + sizeof(int) * (size_t)Ty
         + sizeof(unsigned) * (size_t)Ty * ((Tx + 31) / 32);
}

}  // namespace

// neg_cent, path: (B, Ty, Tx) f32 contiguous; t_ys, t_xs: (B,) int32.
// Returns a cudaError_t: cudaErrorInvalidValue for a shape the kernel does
// not take (T_x > 4096, or more shared memory than a block may have).
extern "C" int mas_f32(const float* neg_cent, const int* t_ys, const int* t_xs, float* path,
                       int B, int Ty, int Tx, void* stream) {
  if (B <= 0 || Ty <= 0 || Tx <= 0) return (int)cudaSuccess;
  const int padded = (Tx + 31) / 32 * 32;
  const int threads = padded < MAX_THREADS ? padded : MAX_THREADS;
  if ((padded + threads - 1) / threads > MAX_CHUNKS) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(Ty, Tx);
  int device = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(mas_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  mas_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(neg_cent, t_ys, t_xs, path, Ty, Tx);
  return (int)cudaGetLastError();
}
