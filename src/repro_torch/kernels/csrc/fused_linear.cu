// fused_linear: out = p @ W + b (linear) or out = z - (p @ W + b) (residual),
// batched over a leading layer axis (blockIdx.z), epilogue in registers.
// Replaces the Pallas kernel repro/kernels/fused_linear.py:_matmul_kernel.
#include "matmul_tile.cuh"

namespace {

__global__ void __launch_bounds__(rt::THREADS)
fused_linear_kernel(const float* __restrict__ p, const float* __restrict__ W,
                    const float* __restrict__ b, const float* __restrict__ z,
                    float* __restrict__ out, int M, int K, int N,
                    long long sp, long long sw, long long sb, long long sz,
                    long long so, int residual) {
  const long long layer = blockIdx.z;
  p += layer * sp;
  W += layer * sw;
  out += layer * so;
  if (b != nullptr) b += layer * sb;
  if (z != nullptr) z += layer * sz;
  const int m0 = blockIdx.y * rt::BM, n0 = blockIdx.x * rt::BN;

  float acc[rt::TM][rt::TN];
  rt::matmul_tile<false>(p, W, M, N, K, K, N, m0, n0, acc);

  const int ty = threadIdx.x / (rt::BN / rt::TN);
  const int tx = threadIdx.x % (rt::BN / rt::TN);
#pragma unroll
  for (int i = 0; i < rt::TM; ++i) {
    const int gm = m0 + ty * rt::TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < rt::TN; ++j) {
      const int gn = n0 + tx * rt::TN + j;
      if (gn >= N) continue;
      float v = acc[i][j];
      if (b != nullptr) v += b[gn];
      const long long o = (long long)gm * N + gn;
      out[o] = residual ? z[o] - v : v;
    }
  }
}

}  // namespace

// b may be null (no bias). z is read only when residual != 0. Strides are
// per layer, in elements. Returns cudaGetLastError() after the launch.
extern "C" int fused_linear_f32(const float* p, const float* W, const float* b,
                                const float* z, float* out, int batch, int M,
                                int K, int N, long long sp, long long sw,
                                long long sb, long long sz, long long so,
                                int residual, void* stream) {
  if (batch < 1 || M < 1 || K < 1 || N < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  fused_linear_kernel<<<rt::tile_grid(batch, M, N), rt::THREADS, 0,
                        (cudaStream_t)stream>>>(p, W, b, z, out, M, K, N, sp,
                                                sw, sb, sz, so, residual);
  return (int)cudaGetLastError();
}
