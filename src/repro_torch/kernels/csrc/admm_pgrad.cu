// admm_pgrad: g = -nu * (r @ Wᵀ) + u + rho * (p - q), batched over a leading
// layer axis (blockIdx.z). Wᵀ is never formed: the tile core loads it from
// rows of W. Replaces the Pallas kernel repro/kernels/admm_pgrad.py:admm_pgrad.
#include "matmul_tile.cuh"

namespace {

__global__ void __launch_bounds__(rt::THREADS)
admm_pgrad_kernel(const float* __restrict__ r, const float* __restrict__ W,
                  const float* __restrict__ u, const float* __restrict__ p,
                  const float* __restrict__ q, float* __restrict__ out, int V,
                  int n_out, int n_in, long long sr, long long sw,
                  long long sv, float nu, float rho) {
  const long long layer = blockIdx.z;
  r += layer * sr;
  W += layer * sw;
  u += layer * sv;
  p += layer * sv;
  q += layer * sv;
  out += layer * sv;
  const int m0 = blockIdx.y * rt::BM, n0 = blockIdx.x * rt::BN;

  // out[V, n_in] = r[V, n_out] @ Wᵀ, W row-major [n_in, n_out]
  float acc[rt::TM][rt::TN];
  rt::matmul_tile<true>(r, W, V, n_in, n_out, n_out, n_out, m0, n0, acc);

  const int ty = threadIdx.x / (rt::BN / rt::TN);
  const int tx = threadIdx.x % (rt::BN / rt::TN);
#pragma unroll
  for (int i = 0; i < rt::TM; ++i) {
    const int gm = m0 + ty * rt::TM + i;
    if (gm >= V) continue;
#pragma unroll
    for (int j = 0; j < rt::TN; ++j) {
      const int gn = n0 + tx * rt::TN + j;
      if (gn >= n_in) continue;
      const long long o = (long long)gm * n_in + gn;
      out[o] = (-nu) * acc[i][j] + u[o] + rho * (p[o] - q[o]);
    }
  }
}

}  // namespace

// r: [batch, V, n_out], W: [batch, n_in, n_out], u/p/q/out: [batch, V, n_in];
// strides are per layer, in elements (sv for u, p, q and out alike).
extern "C" int admm_pgrad_f32(const float* r, const float* W, const float* u,
                              const float* p, const float* q, float* out,
                              int batch, int V, int n_out, int n_in,
                              long long sr, long long sw, long long sv,
                              float nu, float rho, void* stream) {
  if (batch < 1 || V < 1 || n_out < 1 || n_in < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  admm_pgrad_kernel<<<rt::tile_grid(batch, V, n_in), rt::THREADS, 0,
                      (cudaStream_t)stream>>>(r, W, u, p, q, out, V, n_out,
                                              n_in, sr, sw, sv, nu, rho);
  return (int)cudaGetLastError();
}
