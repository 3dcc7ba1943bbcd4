// fused_linear: out = p @ W + b (linear) or out = z - (p @ W + b) (residual),
// batched over a leading layer axis (blockIdx.z), epilogue in registers.
// Replaces the Pallas kernel repro/kernels/fused_linear.py:_matmul_kernel.
//
// Two shapes of one function, chosen by N:
// - N > 16: the 3xTF32 tensor-core tile core (matmul_tf32x3.cuh), 128 x 128
//   output tiles. Bound by operations: 3 TF32 products per f32 product at
//   495 TFLOP/s. A grid too small to fill the card evenly (layer 0's
//   [2485, 5732] @ [5732, 1000]: 160 tiles, one block per SM, 132 SMs, so
//   a second wave of 28) is split over K into `splits` parts whose f32
//   partial products go to a scratch buffer; a second kernel adds the parts
//   in order and applies the epilogue (the same sum on every run).
// - N <= 16 (the last layer's [V, h] @ [h, C]): bound by the bytes of p, so
//   the row-parallel f32 core (matmul_rows.cuh): Wᵀ staged in shared memory,
//   each warp walking four rows of p, the N sums reduced with shuffles.
#include "matmul_rows.cuh"
#include "matmul_tf32x3.cuh"

namespace {

struct Args {
  const float* p;
  const float* W;
  const float* b;
  const float* z;
  float* out;
  int M, K, N;
  long long sp, sw, sb, sz, so;   // per-layer strides (elements)
  int residual;
  float* part;                    // [splits, batch, M, N] when splits > 1
  int splits;
};

__device__ __forceinline__ float epilogue(const Args& a, long long o,
                                          const float* b, int gn, float v) {
  if (b != nullptr) v += b[gn];
  return a.residual ? a.z[o] - v : v;
}

__global__ void __launch_bounds__(tf32x3::THREADS, 1)
fused_linear_tc(Args a) {
  extern __shared__ __align__(128) float smem[];
  const long long layer = blockIdx.z / a.splits;
  const int split = blockIdx.z % a.splits;
  const float* p = a.p + layer * a.sp;
  const float* W = a.W + layer * a.sw;
  const float* b = a.b == nullptr ? nullptr : a.b + layer * a.sb;
  a.out += layer * a.so;
  if (a.z != nullptr) a.z += layer * a.sz;
  const int m0 = blockIdx.y * tf32x3::BM, n0 = blockIdx.x * tf32x3::BN;
  const int nk = (a.K + tf32x3::BK - 1) / tf32x3::BK;
  const int per = (nk + a.splits - 1) / a.splits;
  const int kb0 = split * per, kb1 = min(nk, kb0 + per);

  float acc[tf32x3::NACC];
  tf32x3::tile(p, W, a.M, a.N, a.K, m0, n0, kb0, kb1, acc, smem);

  const int N = a.N;
  if (a.splits > 1) {   // raw partial product; fused_linear_reduce finishes
    float* part = a.part + ((long long)split * (gridDim.z / a.splits) + layer) *
                               a.M * N;
#pragma unroll
    for (int j = 0; j < tf32x3::NACC; ++j) {
      const int gm = m0 + tf32x3::acc_row(j);
      const int gn = n0 + tf32x3::acc_col(j);
      if (gm < a.M && gn < N) part[(long long)gm * N + gn] = acc[j];
    }
    return;
  }
  const bool pairs = N % 2 == 0;   // 8-byte stores stay aligned
#pragma unroll
  for (int j = 0; j < tf32x3::NACC; j += 2) {
    const int gm = m0 + tf32x3::acc_row(j);
    const int gn = n0 + tf32x3::acc_col(j);
    if (gm >= a.M || gn >= N) continue;
    const long long o = (long long)gm * N + gn;
    const float v0 = epilogue(a, o, b, gn, acc[j]);
    if (pairs) {
      const float v1 = epilogue(a, o + 1, b, gn + 1, acc[j + 1]);
      *reinterpret_cast<float2*>(a.out + o) = make_float2(v0, v1);
    } else {
      a.out[o] = v0;
      if (gn + 1 < N) a.out[o + 1] = epilogue(a, o + 1, b, gn + 1, acc[j + 1]);
    }
  }
}

// out = epilogue(part[0] + part[1] + ...), the parts added in order.
__global__ void fused_linear_reduce(Args a, int batch) {
  const long long mn = (long long)a.M * a.N;
  const long long total = batch * mn;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    float v = a.part[i];
    for (int s = 1; s < a.splits; ++s) v += a.part[s * total + i];
    const long long layer = i / mn, o = i % mn;
    const float* b = a.b == nullptr ? nullptr : a.b + layer * a.sb;
    if (b != nullptr) v += b[o % a.N];
    a.out[layer * a.so + o] = a.residual ? a.z[layer * a.sz + o] - v : v;
  }
}

// Dynamic shared memory: Wᵀ, rows::smem_bytes(N).
template <int VEC>
__global__ void __launch_bounds__(rows::THREADS)
fused_linear_narrow(Args a) {
  extern __shared__ __align__(16) float Wt[];
  const long long layer = blockIdx.z;
  const float* b = a.b == nullptr ? nullptr : a.b + layer * a.sb;
  a.out += layer * a.so;
  if (a.z != nullptr) a.z += layer * a.sz;
  const int M = a.M, N = a.N;
  const int lane = threadIdx.x % 32, row0 = rows::first_row();

  float acc[rows::ROWS][rows::MAX_N];
  rows::products<VEC>(a.p + layer * a.sp, a.W + layer * a.sw, M, a.K, N,
                      row0, acc, Wt);
#pragma unroll
  for (int r = 0; r < rows::ROWS; ++r) {
    const int row = row0 + r;
#pragma unroll
    for (int n = 0; n < rows::MAX_N; ++n) {
      const float s = rows::lane_sum(acc[r][n]);
      if (lane == n && n < N && row < M) {
        const long long o = (long long)row * N + n;
        a.out[o] = epilogue(a, o, b, n, s);
      }
    }
  }
}

}  // namespace

// b may be null (no bias). z is read only when residual != 0. Strides are
// per layer, in elements. Returns cudaGetLastError() after the launch.
// part: scratch of splits·batch·M·N floats when splits > 1 (N > 16 only).
extern "C" int fused_linear_f32(const float* p, const float* W, const float* b,
                                const float* z, float* out, int batch, int M,
                                int K, int N, long long sp, long long sw,
                                long long sb, long long sz, long long so,
                                int residual, float* part, int splits,
                                void* stream) {
  if (batch < 1 || M < 1 || K < 1 || N < 1 || splits < 1 ||
      (long long)batch * splits > 65535 || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{p, W, b, residual ? z : nullptr, out, M, K, N,
               sp, sw, sb, sz, so, residual, part, splits};
  // The shared-memory opt-ins, once per device (set on every call they
  // cost about as much host time as the N = 7 kernel takes on the card).
  static bool opted_in[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !opted_in[dev]) {
    e = cudaFuncSetAttribute(fused_linear_narrow<4>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             rows::SMEM_MAX);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(fused_linear_narrow<1>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               rows::SMEM_MAX);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(fused_linear_tc,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               tf32x3::SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) opted_in[dev] = true;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (N <= rows::MAX_N) {
    auto kernel = rows::vec4(p, K) ? fused_linear_narrow<4>
                                   : fused_linear_narrow<1>;
    kernel<<<rows::grid(batch, M), rows::THREADS, rows::smem_bytes(N), s>>>(a);
    return (int)cudaGetLastError();
  }
  fused_linear_tc<<<tf32x3::grid(batch * splits, M, N), tf32x3::THREADS,
                    tf32x3::SMEM_BYTES, s>>>(a);
  if (splits > 1) {
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    fused_linear_reduce<<<1024, 256, 0, s>>>(a, batch);
  }
  return (int)cudaGetLastError();
}
