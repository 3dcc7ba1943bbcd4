// backtrack_resnorm: ||r0 - d @ W||^2 per layer, the data-fit term of phi at
// one trial of the projected (pdADMM-G-Q) p-update. Replaces the Pallas
// kernel repro/kernels/backtrack_phi.py:_resnorm_kernel.
//
// Pass 1 writes one f32 partial per (layer, block): the block's share of
// d@W stays in registers, the epilogue forms r = r0 - acc, squares it and
// reduces it in the block (warp shuffles, then shared memory). Two routes,
// chosen by the wrapper from N:
// - N > 16 (the hidden layers' [2485, 1000] @ [1000, 1000]): bound by
//   operations, so the 3xTF32 tensor-core tile core (matmul_tf32x3.cuh),
//   one block per 128 x 128 output tile and layer (blockIdx.z); r0 is read
//   at the accumulator positions, two columns at a time. K is not split:
//   the square needs the whole residual.
// - N <= 16 (the last layer's [2485, 1000] @ [1000, 7]): bound by the bytes
//   of d, so the row-parallel f32 core (matmul_rows.cuh), one block per 32
//   rows and layer.
// A layer whose `active` entry is 0 writes a zero partial and returns
// before any load.
// Pass 2 (resnorm_sum_kernel): one block per layer sums that layer's
// partials in a fixed order. No atomics: the same inputs give the same bits
// on every run, which the backtracking accept test needs.
#include "matmul_rows.cuh"
#include "matmul_tf32x3.cuh"

namespace {

constexpr int SUM_THREADS = 256;

struct Args {
  const float* r0;
  const float* d;
  const float* W;
  const int* active;     // [batch] or null (all active)
  float* partials;       // [batch, gridDim.x * gridDim.y]
  int M, K, N;
  long long sr, sd, sw;  // per-layer strides (elements)
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// This block's partial: the 256 threads' sums added in a fixed order.
__device__ __forceinline__ void block_partial(float s, float* slot) {
  constexpr int WARPS = 256 / 32;
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

// The block's partial slot; true (after writing 0 there) where the layer's
// search has stopped. Uniform over the block.
__device__ __forceinline__ bool skipped(const Args& a, float*& slot) {
  const long long layer = blockIdx.z;
  const int per_layer = gridDim.x * gridDim.y;
  slot = a.partials + layer * per_layer + blockIdx.y * gridDim.x + blockIdx.x;
  if (a.active == nullptr || a.active[layer] != 0) return false;
  if (threadIdx.x == 0) *slot = 0.f;
  return true;
}

__global__ void __launch_bounds__(tf32x3::THREADS, 1)
resnorm_partials_tc(Args a) {
  extern __shared__ __align__(128) float smem[];
  float* slot;
  if (skipped(a, slot)) return;
  const long long layer = blockIdx.z;
  const float* r0 = a.r0 + layer * a.sr;
  const int m0 = blockIdx.y * tf32x3::BM, n0 = blockIdx.x * tf32x3::BN;
  const int nk = (a.K + tf32x3::BK - 1) / tf32x3::BK;

  float acc[tf32x3::NACC];
  tf32x3::tile<false>(a.d + layer * a.sd, a.W + layer * a.sw, a.M, a.N, a.K,
                      m0, n0, 0, nk, acc, smem);

  const int N = a.N;
  const bool pairs =   // 8-byte loads where every row and r0 allow them
      N % 2 == 0 && reinterpret_cast<uintptr_t>(r0) % 8 == 0;
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < tf32x3::NACC; j += 2) {
    const int gm = m0 + tf32x3::acc_row(j);
    const int gn = n0 + tf32x3::acc_col(j);
    if (gm >= a.M || gn >= N) continue;
    const long long o = (long long)gm * N + gn;
    float x0, x1 = 0.f, y1 = 0.f;
    if (pairs) {
      const float2 v = *reinterpret_cast<const float2*>(r0 + o);
      x0 = v.x;
      x1 = v.y;
      y1 = acc[j + 1];
    } else {
      x0 = r0[o];
      if (gn + 1 < N) {
        x1 = r0[o + 1];
        y1 = acc[j + 1];
      }
    }
    const float e0 = x0 - acc[j], e1 = x1 - y1;
    s = fmaf(e0, e0, s);
    s = fmaf(e1, e1, s);
  }
  block_partial(s, slot);
}

// Dynamic shared memory: Wᵀ, rows::smem_bytes(N).
template <int VEC>
__global__ void __launch_bounds__(rows::THREADS)
resnorm_partials_rows(Args a) {
  extern __shared__ __align__(16) float Wt[];
  float* slot;
  if (skipped(a, slot)) return;
  const long long layer = blockIdx.z;
  const float* r0 = a.r0 + layer * a.sr;
  const int M = a.M, N = a.N;
  const int lane = threadIdx.x % 32, row0 = rows::first_row();

  float acc[rows::ROWS][rows::MAX_N];
  rows::products<VEC>(a.d + layer * a.sd, a.W + layer * a.sw, M, a.K, N,
                      row0, acc, Wt);
  float s = 0.f;
#pragma unroll
  for (int r = 0; r < rows::ROWS; ++r) {
    const int row = row0 + r;
#pragma unroll
    for (int n = 0; n < rows::MAX_N; ++n) {
      const float v = rows::lane_sum(acc[r][n]);
      if (lane == n && n < N && row < M) {
        const float e = r0[(long long)row * N + n] - v;
        s = fmaf(e, e, s);
      }
    }
  }
  block_partial(s, slot);
}

__global__ void __launch_bounds__(SUM_THREADS)
resnorm_sum_kernel(const float* __restrict__ partials, float* __restrict__ out,
                   int per_layer) {
  const float* p = partials + (long long)blockIdx.x * per_layer;
  float s = 0.f;
  for (int i = threadIdx.x; i < per_layer; i += SUM_THREADS) s += p[i];
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
// sd, sw in elements), active [batch] int32 or null (all active).
// tensor_cores: 1 for the 3xTF32 route, 0 for the row-parallel one (the
// wrapper's route(N)). partials is scratch of batch * per_layer floats,
// per_layer being the route's blocks per layer (the wrapper's
// partials_per_layer(M, N); any other value is refused); out receives batch
// floats. Returns cudaGetLastError() after the two launches.
extern "C" int backtrack_resnorm_f32(const float* r0, const float* d,
                                     const float* W, const int* active,
                                     float* partials, float* out, int batch,
                                     int M, int K, int N, long long sr,
                                     long long sd, long long sw,
                                     int tensor_cores, int per_layer,
                                     void* stream) {
  if (batch < 1 || M < 1 || K < 1 || N < 1 || batch > 65535 ||
      (!tensor_cores && N > rows::MAX_N))
    return (int)cudaErrorInvalidValue;
  const dim3 grid = tensor_cores ? tf32x3::grid(batch, M, N)
                                 : rows::grid(batch, M);
  if ((long long)grid.x * grid.y != per_layer)
    return (int)cudaErrorInvalidValue;
  // The shared-memory opt-ins, once per device (as fused_linear_f32's).
  static bool opted_in[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !opted_in[dev]) {
    e = cudaFuncSetAttribute(resnorm_partials_rows<4>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             rows::SMEM_MAX);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(resnorm_partials_rows<1>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               rows::SMEM_MAX);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(resnorm_partials_tc,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               tf32x3::SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) opted_in[dev] = true;
  }
  const Args a{r0, d, W, active, partials, M, K, N, sr, sd, sw};
  cudaStream_t s = (cudaStream_t)stream;
  if (tensor_cores) {
    resnorm_partials_tc<<<grid, tf32x3::THREADS, tf32x3::SMEM_BYTES, s>>>(a);
  } else {
    auto kernel = rows::vec4(d, K) ? resnorm_partials_rows<4>
                                   : resnorm_partials_rows<1>;
    kernel<<<grid, rows::THREADS, rows::smem_bytes(N), s>>>(a);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  resnorm_sum_kernel<<<batch, SUM_THREADS, 0, s>>>(partials, out, per_layer);
  return (int)cudaGetLastError();
}
