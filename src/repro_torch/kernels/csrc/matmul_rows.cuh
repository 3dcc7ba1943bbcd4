// Row-parallel f32 product core for outputs of at most 16 columns, used by
// fused_linear.cu (the last layer's p @ W + b) and backtrack_resnorm.cu (its
// ||r0 − d @ W||²).
//
// [M, K] @ [K, N] with N <= 16 is bound by the bytes of the [M, K] operand
// (a 128 x 128 tensor-core tile would waste 121 of 128 columns and launch
// 20 blocks), so rows are spread over warps: Wᵀ is staged in shared memory
// in K chunks, each warp walks ROWS rows of A once, side by side, with
// 16-byte loads (4-byte where the row stride or pointer does not allow),
// and each lane keeps N f32 partial sums per row; lane_sum adds them over
// the warp with shuffles. Plain f32 FMAs.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rows {

constexpr int MAX_N = 16;
constexpr int THREADS = 256;
constexpr int ROWS = 4;                             // rows per warp
constexpr int BLOCK_ROWS = ROWS * THREADS / 32;
constexpr int KC = 1024;                            // K chunk of Wᵀ
// Dynamic shared memory: Wᵀ, N x KC floats (at most 64 KB).
constexpr int SMEM_MAX = MAX_N * KC * (int)sizeof(float);

inline int smem_bytes(int N) { return N * KC * (int)sizeof(float); }
inline dim3 grid(int batch, int M) {
  return dim3((M + BLOCK_ROWS - 1) / BLOCK_ROWS, 1, batch);
}
// 16-byte loads of A's rows (products<4>) where K and the pointer allow.
inline bool vec4(const float* A, int K) {
  return K % 4 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0;
}

// The first of this warp's ROWS rows.
__device__ __forceinline__ int first_row() {
  return blockIdx.x * BLOCK_ROWS + (threadIdx.x / 32) * ROWS;
}

// acc[r][n] = this lane's share of A[row0 + r, :] · W[:, n] for n < N (A
// row-major [M, K], W row-major [K, N]); rows past M repeat row M - 1 and
// must not be stored. Every thread of the block must call it.
template <int VEC>
__device__ __forceinline__ void products(const float* __restrict__ A,
                                         const float* __restrict__ W, int M,
                                         int K, int N, int row0,
                                         float (&acc)[ROWS][MAX_N],
                                         float* Wt) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int n = 0; n < MAX_N; ++n) acc[r][n] = 0.f;

  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kc = min(KC, K - k0);
    __syncthreads();    // the previous chunk's readers are done
    for (int f = threadIdx.x; f < kc * N; f += THREADS) {
      const int k = f % kc, n = f / kc;   // conflict-free stores
      Wt[n * KC + k] = W[(long long)(k0 + k) * N + n];
    }
    __syncthreads();
    // k outer, rows inner: the rows' loads are in flight together and each
    // Wᵀ read serves every row
    for (int k = VEC * lane; k < kc; k += 32 * VEC) {
      float x[ROWS][VEC];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int row = min(row0 + r, M - 1);
        const float* ar = A + (long long)row * K + k0 + k;
        if constexpr (VEC == 4) {
          const float4 v = *reinterpret_cast<const float4*>(ar);
          x[r][0] = v.x; x[r][1] = v.y; x[r][2] = v.z; x[r][3] = v.w;
        } else {
          x[r][0] = *ar;
        }
      }
#pragma unroll
      for (int n = 0; n < MAX_N; ++n) {
        if (n >= N) break;
        float w[VEC];
        if constexpr (VEC == 4) {
          const float4 v = *reinterpret_cast<const float4*>(&Wt[n * KC + k]);
          w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
        } else {
          w[0] = Wt[n * KC + k];
        }
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[r][n] = fmaf(x[r][e], w[e], acc[r][n]);
      }
    }
  }
}

// v summed over the warp's lanes, in every lane (a fixed order).
__device__ __forceinline__ float lane_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace rows
