// backtrack_resnorm: ||r0 - d @ W||^2 per layer, the data-fit term of phi at
// one trial of the projected (pdADMM-G-Q) p-update. Replaces the Pallas
// kernel repro/kernels/backtrack_phi.py:_resnorm_kernel.
//
// Pass 1 (resnorm_partials_kernel): one block per 64 x 64 output tile and
// layer (blockIdx.z), the d@W tile accumulated in registers by the shared
// tile core; the epilogue forms r = r0 - acc, squares it and reduces it in
// the block (warp shuffles, then shared memory), so only one f32 partial per
// (layer, m-tile, n-tile) reaches device memory. A layer whose `active`
// entry is 0 writes a zero partial and returns before any load.
// Pass 2 (resnorm_sum_kernel): one block per layer sums that layer's
// partials in a fixed order. No atomics: the same inputs give the same bits
// on every run, which the backtracking accept test needs.
#include "matmul_tile.cuh"

namespace {

constexpr int WARPS = rt::THREADS / 32;
constexpr int SUM_THREADS = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(rt::THREADS)
resnorm_partials_kernel(const float* __restrict__ r0,
                        const float* __restrict__ d,
                        const float* __restrict__ W,
                        const int* __restrict__ active,
                        float* __restrict__ partials, int M, int K, int N,
                        long long sr, long long sd, long long sw) {
  const long long layer = blockIdx.z;
  const int tiles = gridDim.x * gridDim.y;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  float* slot = partials + layer * tiles + tile;
  if (active != nullptr && active[layer] == 0) {  // uniform over the block
    if (threadIdx.x == 0) *slot = 0.f;
    return;
  }
  r0 += layer * sr;
  d += layer * sd;
  W += layer * sw;
  const int m0 = blockIdx.y * rt::BM, n0 = blockIdx.x * rt::BN;

  float acc[rt::TM][rt::TN];
  rt::matmul_tile<false>(d, W, M, N, K, K, N, m0, n0, acc);

  const int ty = threadIdx.x / (rt::BN / rt::TN);
  const int tx = threadIdx.x % (rt::BN / rt::TN);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < rt::TM; ++i) {
    const int gm = m0 + ty * rt::TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < rt::TN; ++j) {
      const int gn = n0 + tx * rt::TN + j;
      if (gn >= N) continue;
      const float r = r0[(long long)gm * N + gn] - acc[i][j];
      s = fmaf(r, r, s);
    }
  }
  __shared__ float warp_part[WARPS];
  s = warp_sum(s);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) warp_part[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < WARPS ? warp_part[lane] : 0.f;
    s = warp_sum(s);
    if (lane == 0) *slot = s;
  }
}

__global__ void __launch_bounds__(SUM_THREADS)
resnorm_sum_kernel(const float* __restrict__ partials, float* __restrict__ out,
                   int tiles) {
  const float* p = partials + (long long)blockIdx.x * tiles;
  float s = 0.f;
  for (int i = threadIdx.x; i < tiles; i += SUM_THREADS) s += p[i];
  __shared__ float buf[SUM_THREADS];
  buf[threadIdx.x] = s;
  __syncthreads();
#pragma unroll
  for (int half = SUM_THREADS / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) buf[threadIdx.x] += buf[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = buf[0];
}

}  // namespace

// r0 [batch, M, N], d [batch, M, K], W [batch, K, N] (per-layer strides sr,
// sd, sw in elements), active [batch] int32 or null (all active). partials
// is scratch of batch * ceil(M/64) * ceil(N/64) floats; out receives batch
// floats. Returns cudaGetLastError() after the two launches.
extern "C" int backtrack_resnorm_f32(const float* r0, const float* d,
                                     const float* W, const int* active,
                                     float* partials, float* out, int batch,
                                     int M, int K, int N, long long sr,
                                     long long sd, long long sw,
                                     void* stream) {
  if (batch < 1 || M < 1 || K < 1 || N < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid = rt::tile_grid(batch, M, N);
  cudaStream_t s = (cudaStream_t)stream;
  resnorm_partials_kernel<<<grid, rt::THREADS, 0, s>>>(
      r0, d, W, active, partials, M, K, N, sr, sd, sw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  resnorm_sum_kernel<<<batch, SUM_THREADS, 0, s>>>(partials, out,
                                                   (int)(grid.x * grid.y));
  return (int)cudaGetLastError();
}
