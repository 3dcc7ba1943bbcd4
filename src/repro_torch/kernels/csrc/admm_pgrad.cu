// admm_pgrad: g = -nu * (r @ Wᵀ) + u + rho * (p - q), batched over a leading
// layer axis (blockIdx.z). Wᵀ is never formed: both routes load it from rows
// of W. Replaces the Pallas kernel repro/kernels/admm_pgrad.py:admm_pgrad.
//
// Two routes of one function, chosen by the wrapper from n_out (the K of the
// product):
// - n_out > 16 (the hidden layers' [V, 1000] @ [1000, 1000]ᵀ): bound by
//   operations, so the 3xTF32 tensor-core tile core (matmul_tf32x3.cuh)
//   with a transposed B: 128 x 128 output tiles, rows of W copied as
//   K-major slabs. The epilogue runs from the accumulator registers and
//   reads u, p and q once, two columns at a time. The main path's calls
//   are stacked (x8: 1280 tiles, x10: 1600 on 132 SMs), so K is not split.
// - n_out <= 16 (the last layer's [V, 7] @ [1000, 7]ᵀ): bound by the bytes
//   of u, p, q and the output; the 64 x 64 SIMT f32 tile (matmul_tile.cuh)
//   with K = 7 is one slab.
#include "matmul_tf32x3.cuh"
#include "matmul_tile.cuh"

namespace {

struct Args {
  const float* r;
  const float* W;
  const float* u;
  const float* p;
  const float* q;
  float* out;
  int V, n_out, n_in;
  long long sr, sw, sv;   // per-layer strides (sv for u, p, q and out)
  float nu, rho;
};

__device__ __forceinline__ float pgrad(const Args& a, float acc, float u,
                                       float p, float q) {
  return (-a.nu) * acc + u + a.rho * (p - q);
}

__global__ void __launch_bounds__(tf32x3::THREADS, 1)
admm_pgrad_tc(Args a) {
  extern __shared__ __align__(128) float smem[];
  const long long layer = blockIdx.z;
  const long long ov = layer * a.sv;
  const float* u = a.u + ov;
  const float* p = a.p + ov;
  const float* q = a.q + ov;
  float* out = a.out + ov;
  const int m0 = blockIdx.y * tf32x3::BM, n0 = blockIdx.x * tf32x3::BN;
  const int nk = (a.n_out + tf32x3::BK - 1) / tf32x3::BK;

  // [V, n_in] = r[V, n_out] @ Wᵀ, W row-major [n_in, n_out]
  float acc[tf32x3::NACC];
  tf32x3::tile<true>(a.r + layer * a.sr, a.W + layer * a.sw, a.V, a.n_in,
                     a.n_out, m0, n0, 0, nk, acc, smem);

  const int N = a.n_in;
  // 8-byte loads and stores where every row and operand allows them
  const uintptr_t addr =
      reinterpret_cast<uintptr_t>(u) | reinterpret_cast<uintptr_t>(p) |
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(out);
  const bool pairs = N % 2 == 0 && addr % 8 == 0;
#pragma unroll
  for (int j = 0; j < tf32x3::NACC; j += 2) {
    const int gm = m0 + tf32x3::acc_row(j);
    const int gn = n0 + tf32x3::acc_col(j);
    if (gm >= a.V || gn >= N) continue;
    const long long o = (long long)gm * N + gn;
    if (pairs) {
      const float2 u2 = *reinterpret_cast<const float2*>(u + o);
      const float2 p2 = *reinterpret_cast<const float2*>(p + o);
      const float2 q2 = *reinterpret_cast<const float2*>(q + o);
      *reinterpret_cast<float2*>(out + o) =
          make_float2(pgrad(a, acc[j], u2.x, p2.x, q2.x),
                      pgrad(a, acc[j + 1], u2.y, p2.y, q2.y));
    } else {
      out[o] = pgrad(a, acc[j], u[o], p[o], q[o]);
      if (gn + 1 < N)
        out[o + 1] = pgrad(a, acc[j + 1], u[o + 1], p[o + 1], q[o + 1]);
    }
  }
}

__global__ void __launch_bounds__(rt::THREADS) admm_pgrad_simt(Args a) {
  const long long layer = blockIdx.z;
  const long long ov = layer * a.sv;
  const int m0 = blockIdx.y * rt::BM, n0 = blockIdx.x * rt::BN;

  float acc[rt::TM][rt::TN];
  rt::matmul_tile(a.r + layer * a.sr, a.W + layer * a.sw, a.V, a.n_in,
                  a.n_out, m0, n0, acc);

  const int ty = threadIdx.x / (rt::BN / rt::TN);
  const int tx = threadIdx.x % (rt::BN / rt::TN);
#pragma unroll
  for (int i = 0; i < rt::TM; ++i) {
    const int gm = m0 + ty * rt::TM + i;
    if (gm >= a.V) continue;
#pragma unroll
    for (int j = 0; j < rt::TN; ++j) {
      const int gn = n0 + tx * rt::TN + j;
      if (gn >= a.n_in) continue;
      const long long o = ov + (long long)gm * a.n_in + gn;
      a.out[o] = pgrad(a, acc[i][j], a.u[o], a.p[o], a.q[o]);
    }
  }
}

}  // namespace

// r: [batch, V, n_out], W: [batch, n_in, n_out], u/p/q/out: [batch, V, n_in];
// strides are per layer, in elements (sv for u, p, q and out alike).
// tensor_cores: 1 for the 3xTF32 route, 0 for the SIMT tile (the wrapper's
// route(n_out)). Returns cudaGetLastError() after the launch.
extern "C" int admm_pgrad_f32(const float* r, const float* W, const float* u,
                              const float* p, const float* q, float* out,
                              int batch, int V, int n_out, int n_in,
                              long long sr, long long sw, long long sv,
                              float nu, float rho, int tensor_cores,
                              void* stream) {
  if (batch < 1 || V < 1 || n_out < 1 || n_in < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{r, W, u, p, q, out, V, n_out, n_in, sr, sw, sv, nu, rho};
  cudaStream_t s = (cudaStream_t)stream;
  if (!tensor_cores) {
    admm_pgrad_simt<<<rt::tile_grid(batch, V, n_in), rt::THREADS, 0, s>>>(a);
    return (int)cudaGetLastError();
  }
  // The shared-memory opt-in, once per device (as fused_linear_f32's).
  static bool opted_in[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !opted_in[dev]) {
    e = cudaFuncSetAttribute(admm_pgrad_tc,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             tf32x3::SMEM_BYTES_T);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) opted_in[dev] = true;
  }
  admm_pgrad_tc<<<tf32x3::grid(batch, V, n_in), tf32x3::THREADS,
                  tf32x3::SMEM_BYTES_T, s>>>(a);
  return (int)cudaGetLastError();
}
