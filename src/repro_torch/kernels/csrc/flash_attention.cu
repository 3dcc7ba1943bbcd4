// flash_attention: exact softmax attention with an online softmax, for the
// LM prefill. Replaces the Pallas kernel
// repro/kernels/flash_attention.py:_flash_kernel (entry flash_attention).
//
// Function: for each (batch b, query head h, query row i), the softmax over
// keys j of (q_i . k_j)·D^-0.5, times V, where the keys are j <= i +
// q_offset (causal) or all j < T, and head h reads KV head h / (Hq / Hkv)
// (GQA by indexing: K/V are never expanded). Logits, softmax statistics and
// the accumulator are f32; the output is cast to q's dtype (f32 or bf16).
// q is [B, S, Hq, D], k and v [B, T, Hkv, D], each with its own batch, row
// and head strides (the last dimension contiguous); o is written at its
// strides.
//
// What bounds it on the H100: operations. One (b, h) pair does about
// 2 S T D flops causal (QK^T and PV, each halved); at the prefill's
// B 4, S = T = 2048, Hq 32, D 64 that is 69 GFLOP per layer against 8 MB
// of q/k/v/o: 0.07 ms at the 989 TFLOP/s bf16 tensor-core rate.
//
// Two routes, by dtype:
//
// bf16 (the prefill): tensor cores. A block of two warpgroups owns 128
// query rows (64 each) of one (b, h); the tiles that see the most keys are
// launched first. Q and 64-key K/V tiles are copied with cp.async (16-byte
// chunks, so every row stride must be a multiple of 8 elements and the
// pointers 16-byte aligned; ragged rows are zero-filled) into wgmma's
// no-swizzle core-matrix layout, K/V through a ring of two stages: the next
// tile's copy runs under the current tile's products. S = Q·Kᵀ is
// wgmma m64n64k16 with both operands in shared memory (K's rows are already
// K-major); the online softmax runs on the accumulator registers (a row's
// 64 logits lie in the 4 lanes of a quad), and P, rounded to bf16 as the
// model's own attention rounds p before its PV product, goes to
// O += P·V as wgmma's A operand straight from registers, with V the
// MN-major ("transposed") B operand in its natural [key][dim] layout. Key
// tiles wholly above a warpgroup's diagonal are skipped; the mask is applied
// only on tiles that cross the diagonal or the end of the keys.
//
// f32: SIMT, kept from the first port (no f32 tensor-core path): one block
// of 128 threads per (b*Hq + h, 64-row query tile). The pre-scaled Q tile
// stays in shared memory; 64-key K/V tiles are staged there (masked loads
// for ragged S and T, zeros past the end). Threads form 16 groups of 8
// lanes; a group owns 4 query rows: lane l8 scores keys l8 + 8c (c < 8),
// reading Q and K rows as float4 (row stride D + 4: conflict-free), the row
// max and sum reduced over the group's 8 lanes with shuffles, and
// accumulates output columns VEC*l8 + 8*VEC*jj + e in registers. P goes
// through shared memory, within the group's own warp.
//
// Both: key tiles wholly above the diagonal are never loaded; inside a
// tile the mask sets the logit to -inf, so exp gives 0. The running max
// starts at -1e30, so a row with no key yet has corr = 1 and p = 0, and
// the final divide uses max(l, 1e-30) as the Pallas kernel does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma.cuh"

namespace {

struct Strides {
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

// ---------------------------------------------------------------------------
// f32: SIMT
// ---------------------------------------------------------------------------
namespace simt {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 128;    // 16 groups of 8 lanes, 4 rows per group
constexpr int LDP = BK + 4;     // row stride of the P tile (floats)
constexpr float NEG = -1e30f;

__device__ __forceinline__ float neg_inf() { return __uint_as_float(0xff800000u); }

template <int D>
constexpr int smem_floats() {
  return 3 * BQ * (D + 4) + BQ * LDP;   // Q, K, V tiles and P
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S,
                       int T_len, int Hq, int group, int causal, int q_offset,
                       float scale, Strides st) {
  constexpr int LD = D + 4;                 // Q/K/V tile row stride (floats)
  constexpr int VEC = D / 8 < 4 ? D / 8 : 4;  // adjacent output columns
  constexpr int NJ = D / (8 * VEC);         // column groups per lane
  constexpr int NC = NJ * VEC;              // output columns per lane

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;

  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh % Hq, hk = h / group;
  const int i0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int tid = threadIdx.x;
  const int g = tid >> 3;     // rows 4g .. 4g+3 of the tile
  const int l8 = tid & 7;

  const float* qp = q + b * st.qb + h * st.qh;
  const float* kp = k + b * st.kb + hk * st.kh;
  const float* vp = v + b * st.vb + hk * st.vh;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e % D, i = i0 + r;
    Qs[r * LD + d] = i < S ? qp[i * st.qs + d] * scale : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // causal: no key past the tile's last row (+ q_offset) is loaded
  int kend = T_len;
  if (causal) kend = min(kend, min(i0 + BQ, S) + q_offset);
  const int n_kt = (kend + BK - 1) / BK;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int j0 = kt * BK;
    __syncthreads();   // every reader of the previous tile is done
    for (int e = tid; e < BK * D; e += THREADS) {
      const int r = e / D, d = e % D, j = j0 + r;
      const bool in = j < T_len;
      Ks[r * LD + d] = in ? kp[j * st.ks + d] : 0.f;
      Vs[r * LD + d] = in ? vp[j * st.vs + d] : 0.f;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[i][c] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(4 * g + i) * LD + d]);
#pragma unroll
      for (int c = 0; c < 8; ++c)
        kv[c] = *reinterpret_cast<const float4*>(&Ks[(l8 + 8 * c) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          float a = s[i][c];
          a = fmaf(qv[i].x, kv[c].x, a);
          a = fmaf(qv[i].y, kv[c].y, a);
          a = fmaf(qv[i].z, kv[c].z, a);
          a = fmaf(qv[i].w, kv[c].w, a);
          s[i][c] = a;
        }
    }

    // online softmax, one row at a time; the 8 lanes of a group hold a row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = i0 + 4 * g + i;
      float mx = NEG;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int j = j0 + l8 + 8 * c;
        const bool keep = j < T_len && (!causal || j <= qi + q_offset);
        s[i][c] = keep ? s[i][c] : neg_inf();
        mx = fmaxf(mx, s[i][c]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float corr = __expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float p = __expf(s[i][c] - m_new);   // masked: exp(-inf) = 0
        Ps[(4 * g + i) * LDP + l8 + 8 * c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncwarp();   // a group reads back only the P rows its own lanes wrote

#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&Ps[(4 * g + i) * LDP + kk]);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float* vrow = &Vs[(kk + t) * LD + VEC * l8];
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          float vv[VEC];
          if constexpr (VEC == 4) {
            const float4 x = *reinterpret_cast<const float4*>(vrow + 32 * jj);
            vv[0] = x.x; vv[1] = x.y; vv[2] = x.z; vv[3] = x.w;
          } else {
            const float2 x = *reinterpret_cast<const float2*>(vrow + 8 * VEC * jj);
            vv[0] = x.x; vv[1] = x.y;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = t == 0 ? pv[i].x : t == 1 ? pv[i].y
                          : t == 2 ? pv[i].z : pv[i].w;
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[i][jj * VEC + e] = fmaf(p, vv[e], acc[i][jj * VEC + e]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = i0 + 4 * g + i;
    if (qi >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* orow = o + b * st.ob + qi * st.os + h * st.oh;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        orow[8 * VEC * jj + VEC * l8 + e] = acc[i][jj * VEC + e] / den;
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B, int S,
           int T_len, int Hq, int Hkv, int causal, int q_offset, float scale,
           const Strides& st, cudaStream_t stream) {
  const int bytes = smem_floats<D>() * (int)sizeof(float);
  auto kernel = flash_f32_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * Hq), (unsigned)((S + BQ - 1) / BQ));
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, T_len, Hq, Hq / Hkv,
      causal, q_offset, scale, st);
  return (int)cudaGetLastError();
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), K/V through a two-stage cp.async ring
// ---------------------------------------------------------------------------
namespace tc {

constexpr int BM = 128;        // query rows per block: two warpgroups of 64
constexpr int BN = 64;         // keys per K/V tile (wgmma N of S = Q·Kᵀ)
constexpr int STAGES = 2;      // K/V tiles in the cp.async ring
constexpr int THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {   // 2^x; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A rows x D bf16 tile is kept in the no-swizzle core-matrix layout:
// (r, d) at element (r/8)·8D + (d/8)·64 + (r%8)·8 + d%8. Core matrices
// adjacent along D are 128 B apart, along the rows 16·D bytes.
template <int D>
constexpr int smem_bytes() {
  return 2 * (BM * D + STAGES * 2 * BN * D);  // Q, STAGES x (K, V)
}

// Issue the cp.async copies of `rows` rows (from row0, of n_rows valid) of
// a [rows, D] slice at row stride `rs` into the core-matrix layout. Chunk e
// (16 bytes) lands at element 8e: consecutive threads fill consecutive
// shared memory, and rows past the end are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long rs, int rows, int row0,
                                          int n_rows) {
  constexpr int CH = D / 8;   // 16-byte chunks per row
  for (int e = threadIdx.x; e < rows * CH; e += THREADS) {
    const int r = (e / (8 * CH)) * 8 + e % 8;
    const int dc = (e / 8) % CH;
    const bool in = row0 + r < n_rows;
    const __nv_bfloat16* g = in ? src + (long long)(row0 + r) * rs + dc * 8
                                : src;
    wg::cp_async16(dst + 8 * e, g, in);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, D <= 64 ? 2 : 1)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, int S, int T_len, int Hq,
                  int group, int causal, int q_offset, float scale,
                  Strides st) {
  constexpr int NS = BN / 2;    // S accumulator registers per thread
  constexpr int NO = D / 2;     // O accumulator registers per thread
  constexpr uint32_t ROW_GROUP = 16 * D;   // bytes between 8-row groups

  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BM * D;           // [STAGES][BN x D]
  __nv_bfloat16* Vs = Ks + STAGES * BN * D;  // [STAGES][BN x D]

  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh % Hq, hk = h / group;
  const int i0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int tid = threadIdx.x;
  const int wgi = tid / 128;                 // warpgroup: rows 64·wgi ...
  const int t = tid % 128;
  const int row_a = 16 * (t / 32) + (t % 32) / 4;   // and row_a + 8
  const int quad = t % 4;
  const int r0 = i0 + 64 * wgi;              // the warpgroup's first row

  const __nv_bfloat16* qp = q + b * st.qb + h * st.qh;
  const __nv_bfloat16* kp = k + b * st.kb + hk * st.kh;
  const __nv_bfloat16* vp = v + b * st.vb + hk * st.vh;

  int kend = T_len;
  if (causal) kend = min(kend, min(i0 + BM, S) + q_offset);
  const int n_kt = (kend + BN - 1) / BN;

  load_tile<D>(Qs, qp, st.qs, BM, i0, S);
  wg::cp_async_commit();
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {   // tiles 0 .. STAGES - 2
    if (t < n_kt) {
      load_tile<D>(Ks + t * BN * D, kp, st.ks, BN, t * BN, T_len);
      load_tile<D>(Vs + t * BN * D, vp, st.vs, BN, t * BN, T_len);
    }
    wg::cp_async_commit();
  }

  float oacc[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) oacc[j] = 0.f;
  float m[2] = {-1e30f, -1e30f};   // running max, in log2 units
  float l[2] = {0.f, 0.f};         // this thread's share of the row sums
  const float sl2 = scale * LOG2E;
  const int last_row = min(r0 + 63, S - 1);  // the warpgroup's last real row

  for (int kt = 0; kt < n_kt; ++kt) {
    const int j0 = kt * BN;
    const int stage = kt % STAGES;
    const int ahead = kt + STAGES - 1;   // into the stage released at kt - 1
    if (ahead < n_kt) {
      load_tile<D>(Ks + (ahead % STAGES) * BN * D, kp, st.ks, BN, ahead * BN,
                   T_len);
      load_tile<D>(Vs + (ahead % STAGES) * BN * D, vp, st.vs, BN, ahead * BN,
                   T_len);
    }
    wg::cp_async_commit();
    wg::cp_async_wait<STAGES - 1>();   // Q and tile kt have landed
    wg::fence_proxy_async();
    __syncthreads();

    const bool active = r0 < S && (!causal || j0 <= last_row + q_offset);
    if (active) {
      const __nv_bfloat16* Kt = Ks + stage * BN * D;
      const __nv_bfloat16* Vt = Vs + stage * BN * D;
      // S = Q Kᵀ: 64 x BN per warpgroup, D/16 steps of k16
      float s[NS];
      wg::fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wg::mma_ss_bf16(
            s, wg::desc(Qs + 64 * D * wgi + 128 * ks, 128, ROW_GROUP),
            wg::desc(Kt + 128 * ks, 128, ROW_GROUP), ks > 0);
      wg::commit();
      wg::wait<0>();
      wg::fence_regs(s);

      // mask (only tiles that cross the diagonal or the end of the keys)
      const bool edge = j0 + BN > T_len ||
                        (causal && j0 + BN - 1 > r0 + q_offset);
      if (edge) {
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const int key = j0 + 8 * (j / 4) + 2 * quad + (j % 2);
          const int qi = r0 + row_a + 8 * ((j / 2) % 2);
          if (key >= T_len || (causal && key > qi + q_offset))
            s[j] = __uint_as_float(0xff800000u);   // -inf
        }
      }
      // online softmax in log2 units; a row lives in the 4 lanes of a quad
      float mx[2] = {-1e30f, -1e30f};
#pragma unroll
      for (int j = 0; j < NS; ++j)
        mx[(j / 2) % 2] = fmaxf(mx[(j / 2) % 2], s[j] * sl2);
      float corr[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 1));
        mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 2));
        const float m_new = fmaxf(m[x], mx[x]);
        corr[x] = ex2(m[x] - m_new);
        m[x] = m_new;
        l[x] *= corr[x];
      }
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int x = (j / 2) % 2;
        s[j] = ex2(fmaf(s[j], sl2, -m[x]));   // masked: exp2(-inf) = 0
        l[x] += s[j];
      }
#pragma unroll
      for (int j = 0; j < NO; ++j) oacc[j] *= corr[(j / 2) % 2];
      // P (rounded to bf16, as the model's p.to(v.dtype)) as the A operand
      // from registers: the accumulator's layout is the fragment's
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          pa[kk][x] = wg::pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
      // O += P V: V MN-major, key groups 16·D bytes apart, dim chunks 128
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wg::mma_rs_bf16_tb<D>(oacc, pa[kk],
                              wg::desc(Vt + 16 * D * kk, ROW_GROUP, 128), 1);
      wg::commit();
      wg::wait<0>();
      wg::fence_regs(oacc);
    }
    __syncthreads();   // every warpgroup is done with this stage
  }

#pragma unroll
  for (int x = 0; x < 2; ++x) {
    l[x] += __shfl_xor_sync(0xffffffffu, l[x], 1);
    l[x] += __shfl_xor_sync(0xffffffffu, l[x], 2);
    l[x] = 1.f / fmaxf(l[x], 1e-30f);
  }
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int qi = r0 + row_a + 8 * x;
    if (qi >= S) continue;
    __nv_bfloat16* orow = o + b * st.ob + qi * st.os + h * st.oh;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const int j = 4 * c + 2 * x;
      *reinterpret_cast<uint32_t*>(orow + 8 * c + 2 * quad) =
          wg::pack_bf16(oacc[j] * l[x], oacc[j + 1] * l[x]);
    }
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int S, int T_len, int Hq, int Hkv, int causal, int q_offset,
                float scale, const Strides& st, cudaStream_t stream) {
  const int bytes = smem_bytes<D>();
  auto kernel = flash_bf16_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * Hq), (unsigned)((S + BM - 1) / BM));
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      S, T_len, Hq, Hq / Hkv, causal, q_offset, scale, st);
  return (int)cudaGetLastError();
}

}  // namespace tc

template <int D>
int launch(bool bf16, const void* q, const void* k, const void* v, void* o,
           int B, int S, int T_len, int Hq, int Hkv, int causal, int q_offset,
           float scale, const Strides& st, cudaStream_t stream) {
  return bf16 ? tc::launch_bf16<D>(q, k, v, o, B, S, T_len, Hq, Hkv, causal,
                                   q_offset, scale, st, stream)
              : simt::launch_f32<D>(q, k, v, o, B, S, T_len, Hq, Hkv, causal,
                                    q_offset, scale, st, stream);
}

}  // namespace

// strides: 12 element strides, (batch, row, head) of q, k, v and o in turn.
// bf16 = 0: f32 operands (SIMT); 1: bf16 operands (tensor cores), whose
// batch, row and head strides must be multiples of 8 and pointers 16-byte
// aligned (cp.async moves 16-byte chunks).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int bf16, int B, int S, int T_len,
                                   int Hq, int Hkv, int D, int causal,
                                   int q_offset, float scale,
                                   const long long* strides, void* stream) {
  if (B < 1 || S < 1 || T_len < 1 || Hkv < 1 || Hq % Hkv != 0 ||
      q_offset < 0 || (S + simt::BQ - 1) / simt::BQ > 65535 ||
      (long long)B * Hq > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  if (bf16) {
    for (int i = 0; i < 12; ++i)
      if (strides[i] % 8 != 0) return (int)cudaErrorInvalidValue;
    const void* ptrs[4] = {q, k, v, o};
    for (const void* p : ptrs)
      if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
        return (int)cudaErrorInvalidValue;
  }
  const Strides st{strides[0], strides[1], strides[2], strides[3],
                   strides[4], strides[5], strides[6], strides[7],
                   strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch<16>(bf16, q, k, v, o, B, S, T_len, Hq, Hkv, causal, q_offset, scale, st, s);
    case 32: return launch<32>(bf16, q, k, v, o, B, S, T_len, Hq, Hkv, causal, q_offset, scale, st, s);
    case 64: return launch<64>(bf16, q, k, v, o, B, S, T_len, Hq, Hkv, causal, q_offset, scale, st, s);
    case 96: return launch<96>(bf16, q, k, v, o, B, S, T_len, Hq, Hkv, causal, q_offset, scale, st, s);
    case 128: return launch<128>(bf16, q, k, v, o, B, S, T_len, Hq, Hkv, causal, q_offset, scale, st, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
