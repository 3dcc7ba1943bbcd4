// flash_attention: exact softmax attention with an online softmax, for the
// LM prefill. Replaces the Pallas kernel
// repro/kernels/flash_attention.py:_flash_kernel (entry flash_attention).
//
// Function: for each (batch b, query head h, query row i), the softmax over
// keys j of (q_i * D^-0.5) . k_j, times V, where the keys are j <= i +
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
// of q/k/v/o. This first version is SIMT f32 (no tensor cores): its roof is
// the 67 TFLOP/s f32 rate, not the 989 TFLOP/s bf16 one.
//
// Design: one block of 128 threads per (b*Hq + h, 64-row query tile); the
// tiles that see the most keys are launched first. The pre-scaled Q tile
// stays in shared memory; 64-key K/V tiles are staged there in f32 (masked
// loads for ragged S and T, zeros past the end). Threads form 16 groups of
// 8 lanes; a group owns 4 query rows: lane l8 scores keys l8 + 8c (c < 8),
// reading Q and K rows as float4 (row stride D + 4: conflict-free), the
// row max and sum reduced over the group's 8 lanes with shuffles, and
// accumulates output columns VEC*l8 + 8*VEC*jj + e in registers. P goes
// through shared memory, within the group's own warp. Key tiles wholly
// above the diagonal are never loaded; inside the last one the mask sets
// the logit to -inf, so exp gives 0. The running max starts at -1e30, so a
// row with no key yet has corr = 1 and p = 0, and the final divide uses
// max(l, 1e-30) as the Pallas kernel does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 128;    // 16 groups of 8 lanes, 4 rows per group
constexpr int LDP = BK + 4;     // row stride of the P tile (floats)
constexpr float NEG = -1e30f;

__device__ __forceinline__ float neg_inf() { return __uint_as_float(0xff800000u); }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int D>
constexpr int smem_floats() {
  return 3 * BQ * (D + 4) + BQ * LDP;   // Q, K, V tiles and P
}

struct Strides {
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
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

  const T* qp = q + b * st.qb + h * st.qh;
  const T* kp = k + b * st.kb + hk * st.kh;
  const T* vp = v + b * st.vb + hk * st.vh;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e % D, i = i0 + r;
    Qs[r * LD + d] = i < S ? to_f32(qp[i * st.qs + d]) * scale : 0.f;
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
      Ks[r * LD + d] = in ? to_f32(kp[j * st.ks + d]) : 0.f;
      Vs[r * LD + d] = in ? to_f32(vp[j * st.vs + d]) : 0.f;
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
    T* orow = o + b * st.ob + qi * st.os + h * st.oh;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        store(&orow[8 * VEC * jj + VEC * l8 + e], acc[i][jj * VEC + e] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int T_len, int Hq, int Hkv, int causal, int q_offset, float scale,
           const Strides& st, cudaStream_t stream) {
  const int bytes = smem_floats<D>() * (int)sizeof(float);
  auto kernel = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * Hq), (unsigned)((S + BQ - 1) / BQ));
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, T_len, Hq, Hq / Hkv,
      causal, q_offset, scale, st);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int S, int T_len, int Hq, int Hkv, int D, int causal,
             int q_offset, float scale, const Strides& st,
             cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, S, T_len, Hq, Hkv, causal, q_offset, scale, st, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, S, T_len, Hq, Hkv, causal, q_offset, scale, st, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, S, T_len, Hq, Hkv, causal, q_offset, scale, st, stream);
    case 96: return launch<T, 96>(q, k, v, o, B, S, T_len, Hq, Hkv, causal, q_offset, scale, st, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, S, T_len, Hq, Hkv, causal, q_offset, scale, st, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 12 element strides, (batch, row, head) of q, k, v and o in turn.
// bf16 = 0: f32 operands; 1: bf16 operands.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int bf16, int B, int S, int T_len,
                                   int Hq, int Hkv, int D, int causal,
                                   int q_offset, float scale,
                                   const long long* strides, void* stream) {
  if (B < 1 || S < 1 || T_len < 1 || Hkv < 1 || Hq % Hkv != 0 ||
      q_offset < 0 || (S + BQ - 1) / BQ > 65535 || (long long)B * Hq > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const Strides st{strides[0], strides[1], strides[2], strides[3],
                   strides[4], strides[5], strides[6], strides[7],
                   strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, B, S, T_len, Hq, Hkv, D,
                                        causal, q_offset, scale, st, s)
              : dispatch<float>(q, k, v, o, B, S, T_len, Hq, Hkv, D, causal,
                                q_offset, scale, st, s);
}
