// f32 SIMT matmul tile with a transposed B, for admm_pgrad.cu's narrow
// route (r [V, n_out] @ Wᵀ with n_out <= 16, bound by the bytes of its
// epilogue; the wide products run on the 3xTF32 core, matmul_tf32x3.cuh).
//
// One block of 256 threads computes a BM x BN = 64 x 64 output tile; each
// thread owns a TM x TN = 4 x 4 patch held in registers. The K loop stages
// a BM x BK slab of A and a BK x BN slab of B through shared memory, BK = 16.
// Every load is masked, so ragged M, N and K (V = 2485, n_out = 7) need no
// padding. Products are plain f32 FMAs, as in the reference.
#pragma once

#include <cuda_runtime.h>

namespace rt {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
// +4 floats of row padding: keeps the float4 reads aligned and spreads the
// transposing stores over more banks.
constexpr int PAD = 4;

// acc = A[m0:m0+BM, :] @ Wᵀ[:, n0:n0+BN], rows/cols past M/N read as 0.
//   A: row-major [M, K]; W: row-major [N, K], so B = Wᵀ is loaded from
//   rows of W (coalesced along K) and never formed.
__device__ __forceinline__ void matmul_tile(const float* __restrict__ A,
                                            const float* __restrict__ W,
                                            int M, int N, int K, int m0,
                                            int n0, float (&acc)[TM][TN]) {
  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN + PAD];
  const int tid = threadIdx.x;
  const int ty = tid / (BN / TN);
  const int tx = tid % (BN / TN);

#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < (BM * BK) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / BK, c = e % BK;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? A[(long long)gm * K + gk] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < (BK * BN) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int c = e / BK, r = e % BK;
      const int gk = k0 + r, gn = n0 + c;
      Bs[r][c] = (gk < K && gn < N) ? W[(long long)gn * K + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[k][ty * TM]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[k][tx * TN]);
      const float a[TM] = {a4.x, a4.y, a4.z, a4.w};
      const float b[TN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// Grid for a [batch, M, N] output: x over N tiles, y over M tiles, z = layer.
inline dim3 tile_grid(int batch, int M, int N) {
  return dim3((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
}

}  // namespace rt
