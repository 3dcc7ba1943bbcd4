// f32-accurate matmul tile core on Hopper's tensor cores (3xTF32), used by
// fused_linear.cu, admm_pgrad.cu and backtrack_resnorm.cu.
//
// Each element x of A and B is split into two TF32 values, hi =
// rna_tf32(x) and lo = rna_tf32(x − hi), and every product is accumulated
// in f32 as lo_a·hi_b + hi_a·lo_b + hi_a·hi_b, the small terms first (as
// CUTLASS's OpMultiplyAddFastF32 does). The dropped lo_a·lo_b is about
// 2^-22 of the product, so the result keeps about 22 of f32's 24 mantissa
// bits, where a single TF32 pass keeps 11.
//
// One block of 256 threads (two warpgroups) computes a BM x BN = 128 x 128
// output tile; warpgroup w owns rows 64w .. 64w + 63 as 64 f32 accumulator
// registers per thread (the layout in wgmma.cuh). Per BK = 32 slab of K:
//   1. cp.async copies the raw f32 slabs of A ([BM, BK] of row-major A)
//      and B into a ring of four stages, three slabs ahead (about 105 KB
//      in flight per SM: with fewer, the copies' latency, not the tensor
//      cores, set the pace). B's slab is [BK, BN] of row-major B, or, with
//      B_TRANS (B = Wᵀ, W row-major [N, K], as admm_pgrad's r·Wᵀ), [BN, BK]
//      of rows of W. 16-byte chunks where the row stride and pointer allow
//      (K or N a multiple of 4), else 4-byte copies, so ragged and
//      unaligned operands (K = 130, N = 7) need no padding; out-of-range
//      elements are zero-filled;
//   2. all threads split B's slab into hi and lo tiles in wgmma's K-major
//      no-swizzle layout (TF32 wgmma takes only K-major shared-memory
//      operands: row-major B is transposed on the way, rows of W are
//      K-major already), double-buffered so that the split runs under the
//      previous slab's products; each thread splits its own A fragments in
//      registers (wgmma takes A from registers);
//   3. each warpgroup issues 4 k-steps x 3 wgmma m64n128k8 (tf32) into a
//      zeroed partial accumulator and does not wait for them; a slab later,
//      the partial is added to the result with one rounded f32 add per
//      element. (wgmma's f32 accumulation truncates: chained over all of
//      K = 5732 it drifted past the 1e-5 of the largest output that the
//      plain f32 product is held to.)
//
// Shared memory: 4 x (18,432 + 16,896) B of raw slabs + 2 x 32,768 B of
// B's hi/lo tiles = 206,848 B; with B_TRANS the raw B slab is 18,432 B
// (rows of BK + 4 floats), 212,992 B in all. One block per SM.
#pragma once

#include "wgmma.cuh"

namespace tf32x3 {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int STAGES = 4;
constexpr int LDA = BK + 4;    // raw A row pitch (floats): conflict-free fragment reads
constexpr int LDB = BN + 4;    // raw B row pitch (floats), 16-byte rows
constexpr int LDBT = BK + 4;   // raw rows-of-W pitch (B_TRANS), as LDA
constexpr int RAW_A = BM * LDA;
constexpr int TILE = BN * BK;  // one hi or lo tile of B
constexpr int NACC = BN / 2;   // accumulator registers per thread

__host__ __device__ constexpr int raw_b_size(bool b_trans) {
  return b_trans ? BN * LDBT : BK * LDB;
}
__host__ __device__ constexpr int smem_bytes(bool b_trans) {
  return 4 * (STAGES * (RAW_A + raw_b_size(b_trans)) + 2 * 2 * TILE);
}
constexpr int SMEM_BYTES = smem_bytes(false);
constexpr int SMEM_BYTES_T = smem_bytes(true);

// Shared memory: [raw A, raw B] x STAGES, then [B hi, B lo] x 2 buffers.
template <bool B_TRANS>
__device__ __forceinline__ float* raw_a(float* smem, int st) {
  return smem + st * (RAW_A + raw_b_size(B_TRANS));
}
template <bool B_TRANS>
__device__ __forceinline__ float* raw_b(float* smem, int st) {
  return raw_a<B_TRANS>(smem, st) + RAW_A;
}
template <bool B_TRANS>
__device__ __forceinline__ float* b_tiles(float* smem, int buf) {
  return smem + STAGES * (RAW_A + raw_b_size(B_TRANS)) + buf * 2 * TILE;
}

// Offset (floats) of element (n, k) in a K-major core-matrix tile of
// BK = 32 columns: 8-row groups 1024 B apart, 4-float chunks 128 B apart.
__device__ __forceinline__ int kmajor(int n, int k) {
  return (n / 8) * 256 + (k / 4) * 32 + (n % 8) * 4;
}

// Copy the raw slabs at K offset k0 into stage `st`.
template <bool B_TRANS>
__device__ __forceinline__ void load_slab(float* smem, int st,
                                          const float* __restrict__ A,
                                          const float* __restrict__ B, int M,
                                          int N, int K, int m0, int n0, int k0,
                                          bool vec_a, bool vec_b) {
  const int tid = threadIdx.x;
  float* ra = raw_a<B_TRANS>(smem, st);
  float* rb = raw_b<B_TRANS>(smem, st);
  if (vec_a) {
#pragma unroll
    for (int i = 0; i < BM * BK / 4 / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / (BK / 4), c = 4 * (e % (BK / 4));
      const bool in = m0 + r < M && k0 + c < K;
      wg::cp_async16(ra + r * LDA + c,
                     in ? A + (long long)(m0 + r) * K + k0 + c : A, in);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < BM * BK / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / BK, c = e % BK;
      const bool in = m0 + r < M && k0 + c < K;
      wg::cp_async4(ra + r * LDA + c,
                    in ? A + (long long)(m0 + r) * K + k0 + c : A, in);
    }
  }
  if constexpr (B_TRANS) {   // [BN, BK]: rows n0 .. n0 + BN - 1 of W
    if (vec_b) {
#pragma unroll
      for (int i = 0; i < BN * BK / 4 / THREADS; ++i) {
        const int e = tid + i * THREADS;
        const int r = e / (BK / 4), c = 4 * (e % (BK / 4));
        const bool in = n0 + r < N && k0 + c < K;
        wg::cp_async16(rb + r * LDBT + c,
                       in ? B + (long long)(n0 + r) * K + k0 + c : B, in);
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < BN * BK / THREADS; ++i) {
        const int e = tid + i * THREADS;
        const int r = e / BK, c = e % BK;
        const bool in = n0 + r < N && k0 + c < K;
        wg::cp_async4(rb + r * LDBT + c,
                      in ? B + (long long)(n0 + r) * K + k0 + c : B, in);
      }
    }
  } else if (vec_b) {   // [BK, BN] of row-major B
#pragma unroll
    for (int i = 0; i < BK * BN / 4 / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / (BN / 4), c = 4 * (e % (BN / 4));
      const bool in = k0 + r < K && n0 + c < N;
      wg::cp_async16(rb + r * LDB + c,
                     in ? B + (long long)(k0 + r) * N + n0 + c : B, in);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < BK * BN / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / BN, c = e % BN;
      const bool in = k0 + r < K && n0 + c < N;
      wg::cp_async4(rb + r * LDB + c,
                    in ? B + (long long)(k0 + r) * N + n0 + c : B, in);
    }
  }
}

// Split B's raw slab in stage `st` into the hi/lo tiles of buffer `buf`.
template <bool B_TRANS>
__device__ __forceinline__ void split_b(float* smem, int st, int buf) {
  const float* rb = raw_b<B_TRANS>(smem, st);
  float* hi = b_tiles<B_TRANS>(smem, buf);
  float* lo = hi + TILE;
#pragma unroll
  for (int i = 0; i < BN * BK / 4 / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int n = e % BN, kq = e / BN;      // a warp: 32 columns, one k-quad
    float h[4], l[4];
    if constexpr (B_TRANS) {   // 4 consecutive k of row n: one float4
      const float4 v = *reinterpret_cast<const float4*>(rb + n * LDBT + 4 * kq);
      const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        h[j] = wg::tf32_rna(x[j]);
        l[j] = wg::tf32_rna(x[j] - h[j]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = rb[(4 * kq + j) * LDB + n];
        h[j] = wg::tf32_rna(x);
        l[j] = wg::tf32_rna(x - h[j]);
      }
    }
    *reinterpret_cast<float4*>(hi + kmajor(n, 4 * kq)) =
        make_float4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<float4*>(lo + kmajor(n, 4 * kq)) =
        make_float4(l[0], l[1], l[2], l[3]);
  }
}

// acc = A[m0:m0+BM, k] @ B[k, n0:n0+BN] over the K slabs [kb0, kb1) (k
// from kb0·BK to min(kb1·BK, K)), for this thread's warpgroup rows; A
// row-major [M, K]; B row-major [K, N], or with B_TRANS B = Wᵀ for W
// row-major [N, K]; rows/cols past M/N are 0. `smem` is
// smem_bytes(B_TRANS) of dynamic shared memory. Every thread of the block
// must call it.
template <bool B_TRANS = false>
__device__ __forceinline__ void tile(const float* __restrict__ A,
                                     const float* __restrict__ B, int M,
                                     int N, int K, int m0, int n0, int kb0,
                                     int kb1, float (&acc)[NACC],
                                     float* smem) {
  const int t = threadIdx.x;
  // this thread's A fragment rows (and +8) and column (and +4) in a slab
  const int a_off = (64 * (t / 128) + 16 * ((t % 128) / 32) + (t % 32) / 4) *
                        LDA + t % 4;
  const bool vec_a = K % 4 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0;
  const bool vec_b = (B_TRANS ? K : N) % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(B) % 16 == 0;
  const int nk = kb1 - kb0;
  float part[NACC];   // slab kb - 1's products, added at slab kb
#pragma unroll
  for (int j = 0; j < NACC; ++j) acc[j] = part[j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      load_slab<B_TRANS>(smem, s, A, B, M, N, K, m0, n0, (kb0 + s) * BK,
                         vec_a, vec_b);
    wg::cp_async_commit();
  }

  for (int kb = 0; kb < nk; ++kb) {
    const int st = kb % STAGES, buf = kb & 1;
    wg::cp_async_wait<STAGES - 2>();   // slab kb has landed (own copies)
    __syncthreads();                   // ... and every thread's
    split_b<B_TRANS>(smem, st, buf);   // buffer buf was last read by kb - 2
    wg::fence_proxy_async();
    wg::wait<0>();                     // this warpgroup's products of kb - 1
    wg::fence_regs(part);
#pragma unroll
    for (int j = 0; j < NACC; ++j) acc[j] += part[j];
    uint32_t a_hi[BK / 8][4], a_lo[BK / 8][4];
    const float* ra = raw_a<B_TRANS>(smem, st) + a_off;
#pragma unroll
    for (int s = 0; s < BK / 8; ++s)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float v = ra[(x & 1) * 8 * LDA + 8 * s + (x >> 1) * 4];
        const float h = wg::tf32_rna(v);
        a_hi[s][x] = __float_as_uint(h);
        a_lo[s][x] = __float_as_uint(wg::tf32_rna(v - h));
      }
    __syncthreads();   // B's tiles visible; stage (kb - 1) % STAGES is free

    const float* b_hi = b_tiles<B_TRANS>(smem, buf);
    const float* b_lo = b_hi + TILE;
    wg::fence();
#pragma unroll
    for (int s = 0; s < BK / 8; ++s) {   // k8 steps: 2 chunks of 4 floats
      const int o = 64 * s;
      wg::mma_rs_tf32(part, a_lo[s], wg::desc(b_hi + o, 128, 1024), s > 0);
      wg::mma_rs_tf32(part, a_hi[s], wg::desc(b_lo + o, 128, 1024), 1);
      wg::mma_rs_tf32(part, a_hi[s], wg::desc(b_hi + o, 128, 1024), 1);
    }
    wg::commit();
    // refill the stage read at kb - 1 while the products run
    if (kb + STAGES - 1 < nk)
      load_slab<B_TRANS>(smem, (kb + STAGES - 1) % STAGES, A, B, M, N, K,
                         m0, n0, (kb0 + kb + STAGES - 1) * BK, vec_a, vec_b);
    wg::cp_async_commit();
  }
  wg::wait<0>();
  wg::fence_regs(part);
#pragma unroll
  for (int j = 0; j < NACC; ++j) acc[j] += part[j];
}

// Row and column (within the block's tile) of accumulator register j.
__device__ __forceinline__ int acc_row(int j) {
  const int t = threadIdx.x;
  return 64 * (t / 128) + 16 * ((t % 128) / 32) + (t % 32) / 4 +
         8 * ((j / 2) % 2);
}
__device__ __forceinline__ int acc_col(int j) {
  return 8 * (j / 4) + 2 * (threadIdx.x % 4) + j % 2;
}

inline dim3 grid(int batch, int M, int N) {
  return dim3((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
}

}  // namespace tf32x3
