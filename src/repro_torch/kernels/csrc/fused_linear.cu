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
// - N <= 16 (the last layer's [V, h] @ [h, C]): bound by the bytes of p (a
//   128 x 128 tile would waste 121 of 128 columns and launch 20 blocks), so
//   rows are spread over warps: Wᵀ is staged in shared memory in K chunks,
//   each warp walks four rows of p once, side by side, with 16-byte loads
//   (4-byte where the row stride does not allow), keeps N f32 partial sums
//   per row per lane and reduces them with shuffles. Plain f32 FMAs.
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

constexpr int NARROW_N = 16;
constexpr int NARROW_THREADS = 256;
constexpr int NARROW_ROWS = 4;                             // rows per warp
constexpr int NARROW_BLOCK_ROWS = NARROW_ROWS * NARROW_THREADS / 32;
constexpr int NARROW_KC = 1024;   // K chunk of Wᵀ in shared memory

// Dynamic shared memory: Wᵀ, N x NARROW_KC floats (at most 64 KB).
template <int VEC>
__global__ void __launch_bounds__(NARROW_THREADS)
fused_linear_narrow(Args a) {
  extern __shared__ __align__(16) float Wt[];
  const long long layer = blockIdx.z;
  const float* p = a.p + layer * a.sp;
  const float* W = a.W + layer * a.sw;
  const float* b = a.b == nullptr ? nullptr : a.b + layer * a.sb;
  a.out += layer * a.so;
  if (a.z != nullptr) a.z += layer * a.sz;
  const int M = a.M, K = a.K, N = a.N;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int row0 = blockIdx.x * NARROW_BLOCK_ROWS + warp * NARROW_ROWS;

  float acc[NARROW_ROWS][NARROW_N];
#pragma unroll
  for (int r = 0; r < NARROW_ROWS; ++r)
#pragma unroll
    for (int n = 0; n < NARROW_N; ++n) acc[r][n] = 0.f;

  for (int k0 = 0; k0 < K; k0 += NARROW_KC) {
    const int kc = min(NARROW_KC, K - k0);
    __syncthreads();    // the previous chunk's readers are done
    for (int f = threadIdx.x; f < kc * N; f += NARROW_THREADS) {
      const int k = f % kc, n = f / kc;   // conflict-free stores
      Wt[n * NARROW_KC + k] = W[(long long)(k0 + k) * N + n];
    }
    __syncthreads();
    // k outer, rows inner: the rows' loads are in flight together and each
    // Wᵀ read serves every row
    for (int k = VEC * lane; k < kc; k += 32 * VEC) {
      float x[NARROW_ROWS][VEC];
#pragma unroll
      for (int r = 0; r < NARROW_ROWS; ++r) {
        const int row = min(row0 + r, M - 1);   // rows past M are not stored
        const float* pr = p + (long long)row * K + k0 + k;
        if constexpr (VEC == 4) {
          const float4 v = *reinterpret_cast<const float4*>(pr);
          x[r][0] = v.x; x[r][1] = v.y; x[r][2] = v.z; x[r][3] = v.w;
        } else {
          x[r][0] = *pr;
        }
      }
#pragma unroll
      for (int n = 0; n < NARROW_N; ++n) {
        if (n >= N) break;
        float w[VEC];
        if constexpr (VEC == 4) {
          const float4 v =
              *reinterpret_cast<const float4*>(&Wt[n * NARROW_KC + k]);
          w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
        } else {
          w[0] = Wt[n * NARROW_KC + k];
        }
#pragma unroll
        for (int r = 0; r < NARROW_ROWS; ++r)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[r][n] = fmaf(x[r][e], w[e], acc[r][n]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < NARROW_ROWS; ++r) {
    const int row = row0 + r;
#pragma unroll
    for (int n = 0; n < NARROW_N; ++n) {
      float s = acc[r][n];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
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
    const int narrow = NARROW_N * NARROW_KC * (int)sizeof(float);
    e = cudaFuncSetAttribute(fused_linear_narrow<4>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             narrow);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(fused_linear_narrow<1>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               narrow);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(fused_linear_tc,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               tf32x3::SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) opted_in[dev] = true;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (N <= NARROW_N) {
    const dim3 grid((M + NARROW_BLOCK_ROWS - 1) / NARROW_BLOCK_ROWS, 1, batch);
    const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
    auto kernel = vec ? fused_linear_narrow<4> : fused_linear_narrow<1>;
    kernel<<<grid, NARROW_THREADS, N * NARROW_KC * (int)sizeof(float), s>>>(a);
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
