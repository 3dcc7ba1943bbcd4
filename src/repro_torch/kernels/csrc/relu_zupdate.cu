// relu_zupdate: the closed-form ReLU z-update of Eq. 6, elementwise over a
// flattened tensor. Replaces the Pallas kernel
// repro/kernels/relu_zupdate.py:_zupdate_kernel.
//
// The _rn intrinsics keep every operation separately rounded (no FMA
// contraction) and the divisions IEEE, so the branch choice is made on the
// same objective values the plain version computes.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sq(float x) { return __fmul_rn(x, x); }

// min(x, 0) and max(x, 0) that carry a NaN through, as jnp/torch do
__device__ __forceinline__ float min0(float x) { return x > 0.f ? 0.f : x; }
__device__ __forceinline__ float max0(float x) { return x < 0.f ? 0.f : x; }

// (zz - a)² + (q - relu(zz))² + (zz - z0)²
__device__ __forceinline__ float branch_obj(float zz, float a, float q,
                                            float z0) {
  const float t1 = sq(__fsub_rn(zz, a));
  const float t2 = sq(__fsub_rn(q, max0(zz)));
  const float t3 = sq(__fsub_rn(zz, z0));
  return __fadd_rn(__fadd_rn(t1, t2), t3);
}

__global__ void relu_zupdate_kernel(const float* __restrict__ a,
                                    const float* __restrict__ q,
                                    const float* __restrict__ z_old,
                                    float* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float av = a[i], qv = q[i], zv = z_old[i];
    const float zn = min0(__fdiv_rn(__fadd_rn(av, zv), 2.f));
    const float zp = max0(__fdiv_rn(__fadd_rn(__fadd_rn(av, qv), zv), 3.f));
    out[i] = branch_obj(zn, av, qv, zv) <= branch_obj(zp, av, qv, zv) ? zn : zp;
  }
}

}  // namespace

extern "C" int relu_zupdate_f32(const float* a, const float* q,
                                const float* z_old, float* out, long long n,
                                void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond 32 blocks/SM
  relu_zupdate_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      a, q, z_old, out, n);
  return (int)cudaGetLastError();
}
