// pack_codes: integer wire codes into their physical uint8 container, and
// back. Replaces the Pallas kernels repro/kernels/pack_codes.py:
// _pack4_kernel, _unpack4_kernel, _pack16_kernel and _unpack16_kernel.
//
// Layout (the wire contract, comm/codecs.pack_codes_jnp), per row of n codes:
//   4-bit : h = ceil(n / 2) bytes; byte i = (code i << 4) | (code i+h & 0xF),
//           where code n (odd n) reads as 0 — no padded copy of the input.
//   16-bit: 2n bytes of big-endian planes: all high bytes, then all low.
//   8-bit is the identity and has no kernel.
// A launch packs `rows` independent rows: row r of the input starts ld_in
// elements after row r-1, row r of the output ld_out elements after it, so
// one launch formats every shard's boundary slab, and unpacking reads the
// head of each row of a wider wire container in place.
//
// Pure data movement: each thread formats 16 packed bytes per step (16
// codes for the 16-bit planes). Each stream of a row takes the widest
// access its row's address allows (128, 64 or 32 bits, bytes otherwise),
// found on the device per row: the ring's rows are 2,485,000 codes, so
// the odd rows of a batch sit 8 bytes off a 16-byte boundary and the 4-bit
// half-split's second stream 4 bytes off. A scalar tail takes the last
// partial chunk of a row.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS_X = 132 * 8;

union Bytes16 {
  uint4 v;
  uint2 d[2];
  uint32_t w[4];
  uint8_t b[16];
};

union Halves16 {
  Bytes16 q[2];
  uint16_t h[16];
};

// The widest access (16, 8, 4 or 1 bytes) the address is aligned for. A
// chunk starts a multiple of 16 bytes into its stream, so the stream's row
// start decides for every chunk of the row.
__device__ __forceinline__ int align_of(const void* p) {
  const unsigned a = (unsigned)reinterpret_cast<uintptr_t>(p);
  return (a & 15u) == 0 ? 16 : (a & 7u) == 0 ? 8 : (a & 3u) == 0 ? 4 : 1;
}

__device__ __forceinline__ void load16(const uint8_t* p, int al,
                                       Bytes16& x) {
  if (al == 16) {
    x.v = *reinterpret_cast<const uint4*>(p);
  } else if (al == 8) {
    const uint2* q = reinterpret_cast<const uint2*>(p);
    x.d[0] = q[0];
    x.d[1] = q[1];
  } else if (al == 4) {
    const uint32_t* q = reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int j = 0; j < 4; ++j) x.w[j] = q[j];
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) x.b[j] = p[j];
  }
}

__device__ __forceinline__ void store16(uint8_t* p, int al,
                                        const Bytes16& x) {
  if (al == 16) {
    *reinterpret_cast<uint4*>(p) = x.v;
  } else if (al == 8) {
    uint2* q = reinterpret_cast<uint2*>(p);
    q[0] = x.d[0];
    q[1] = x.d[1];
  } else if (al == 4) {
    uint32_t* q = reinterpret_cast<uint32_t*>(p);
#pragma unroll
    for (int j = 0; j < 4; ++j) q[j] = x.w[j];
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) p[j] = x.b[j];
  }
}

struct Job {
  long long rows, n, half, ld_in, ld_out;
};

// streams: 0 = codes (first half), 1 = codes (second half), 2 = out
__global__ void __launch_bounds__(THREADS)
pack4_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
             Job job) {
  const long long h = job.half, n = job.n;
  const long long chunks = (h + 15) / 16;
  for (long long r = blockIdx.y; r < job.rows; r += gridDim.y) {
    const uint8_t* src = in + r * job.ld_in;
    uint8_t* dst = out + r * job.ld_out;
    const int a_hi = align_of(src), a_lo = align_of(src + h),
              a_out = align_of(dst);
    for (long long c = (long long)blockIdx.x * THREADS + threadIdx.x;
         c < chunks; c += (long long)gridDim.x * THREADS) {
      const long long i0 = c * 16;
      if (i0 + 16 <= h && i0 + 16 + h <= n) {
        Bytes16 hi, lo, o;
        load16(src + i0, a_hi, hi);
        load16(src + h + i0, a_lo, lo);
#pragma unroll
        for (int j = 0; j < 16; ++j)
          o.b[j] = (uint8_t)((hi.b[j] << 4) | (lo.b[j] & 0xF));
        store16(dst + i0, a_out, o);
      } else {
        for (long long i = i0; i < i0 + 16 && i < h; ++i) {
          const int lo = i + h < n ? src[i + h] : 0;
          dst[i] = (uint8_t)((src[i] << 4) | (lo & 0xF));
        }
      }
    }
  }
}

// streams: 0 = packed, 1 = out (first half), 2 = out (second half)
__global__ void __launch_bounds__(THREADS)
unpack4_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
               Job job) {
  const long long h = job.half, n = job.n;
  const long long chunks = (h + 15) / 16;
  for (long long r = blockIdx.y; r < job.rows; r += gridDim.y) {
    const uint8_t* src = in + r * job.ld_in;
    uint8_t* dst = out + r * job.ld_out;
    const int a_in = align_of(src), a_hi = align_of(dst),
              a_lo = align_of(dst + h);
    for (long long c = (long long)blockIdx.x * THREADS + threadIdx.x;
         c < chunks; c += (long long)gridDim.x * THREADS) {
      const long long i0 = c * 16;
      if (i0 + 16 <= h && i0 + 16 + h <= n) {
        Bytes16 b, hi, lo;
        load16(src + i0, a_in, b);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          hi.b[j] = (b.b[j] >> 4) & 0xF;
          lo.b[j] = b.b[j] & 0xF;
        }
        store16(dst + i0, a_hi, hi);
        store16(dst + h + i0, a_lo, lo);
      } else {
        for (long long i = i0; i < i0 + 16 && i < h; ++i) {
          const uint8_t b = src[i];
          dst[i] = (b >> 4) & 0xF;
          if (i + h < n) dst[i + h] = b & 0xF;
        }
      }
    }
  }
}

// streams: 0 = codes (uint16), 1 = high plane, 2 = low plane
__global__ void __launch_bounds__(THREADS)
pack16_kernel(const uint16_t* __restrict__ in, uint8_t* __restrict__ out,
              Job job) {
  const long long n = job.n;
  const long long chunks = (n + 15) / 16;
  for (long long r = blockIdx.y; r < job.rows; r += gridDim.y) {
    const uint16_t* src = in + r * job.ld_in;
    uint8_t* dst = out + r * job.ld_out;
    const int a_in = align_of(src), a_hi = align_of(dst),
              a_lo = align_of(dst + n);
    for (long long c = (long long)blockIdx.x * THREADS + threadIdx.x;
         c < chunks; c += (long long)gridDim.x * THREADS) {
      const long long i0 = c * 16;
      if (i0 + 16 <= n) {
        Halves16 x;
        const uint8_t* p = reinterpret_cast<const uint8_t*>(src + i0);
        load16(p, a_in, x.q[0]);
        load16(p + 16, a_in, x.q[1]);
        Bytes16 hi, lo;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          hi.b[j] = (uint8_t)(x.h[j] >> 8);
          lo.b[j] = (uint8_t)(x.h[j] & 0xFF);
        }
        store16(dst + i0, a_hi, hi);
        store16(dst + n + i0, a_lo, lo);
      } else {
        for (long long i = i0; i < n; ++i) {
          dst[i] = (uint8_t)(src[i] >> 8);
          dst[n + i] = (uint8_t)(src[i] & 0xFF);
        }
      }
    }
  }
}

// streams: 0 = high plane, 1 = low plane, 2 = codes (uint16)
__global__ void __launch_bounds__(THREADS)
unpack16_kernel(const uint8_t* __restrict__ in, uint16_t* __restrict__ out,
                Job job) {
  const long long n = job.n;
  const long long chunks = (n + 15) / 16;
  for (long long r = blockIdx.y; r < job.rows; r += gridDim.y) {
    const uint8_t* src = in + r * job.ld_in;
    uint16_t* dst = out + r * job.ld_out;
    const int a_hi = align_of(src), a_lo = align_of(src + n),
              a_out = align_of(dst);
    for (long long c = (long long)blockIdx.x * THREADS + threadIdx.x;
         c < chunks; c += (long long)gridDim.x * THREADS) {
      const long long i0 = c * 16;
      if (i0 + 16 <= n) {
        Bytes16 hi, lo;
        load16(src + i0, a_hi, hi);
        load16(src + n + i0, a_lo, lo);
        Halves16 x;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          x.h[j] = (uint16_t)((hi.b[j] << 8) | lo.b[j]);
        uint8_t* p = reinterpret_cast<uint8_t*>(dst + i0);
        store16(p, a_out, x.q[0]);
        store16(p + 16, a_out, x.q[1]);
      } else {
        for (long long i = i0; i < n; ++i)
          dst[i] = (uint16_t)((src[i] << 8) | src[n + i]);
      }
    }
  }
}

template <typename In, typename Out>
int launch(void (*kernel)(const In*, Out*, Job), const In* in, Out* out,
           Job job, long long chunks, void* stream) {
  if (job.rows < 1 || job.n < 1) return (int)cudaErrorInvalidValue;
  long long bx = (chunks + THREADS - 1) / THREADS;
  if (bx > MAX_BLOCKS_X) bx = MAX_BLOCKS_X;
  const long long by = job.rows < 65535 ? job.rows : 65535;
  kernel<<<dim3((unsigned)bx, (unsigned)by), THREADS, 0,
           (cudaStream_t)stream>>>(in, out, job);
  return (int)cudaGetLastError();
}

}  // namespace

// codes [rows, >= n] uint8 (row stride ld_in) -> out [rows, >= ceil(n/2)]
// (row stride ld_out).
extern "C" int pack_codes4(const uint8_t* codes, uint8_t* out,
                           long long rows, long long n, long long ld_in,
                           long long ld_out, void* stream) {
  const long long h = (n + 1) / 2;
  return launch(pack4_kernel, codes, out, Job{rows, n, h, ld_in, ld_out},
                (h + 15) / 16, stream);
}

// packed [rows, >= ceil(n/2)] -> codes [rows, >= n] uint8
extern "C" int unpack_codes4(const uint8_t* packed, uint8_t* out,
                             long long rows, long long n, long long ld_in,
                             long long ld_out, void* stream) {
  const long long h = (n + 1) / 2;
  return launch(unpack4_kernel, packed, out, Job{rows, n, h, ld_in, ld_out},
                (h + 15) / 16, stream);
}

// codes [rows, >= n] uint16 (ld_in in codes) -> out [rows, >= 2n] uint8
extern "C" int pack_codes16(const uint16_t* codes, uint8_t* out,
                            long long rows, long long n, long long ld_in,
                            long long ld_out, void* stream) {
  return launch(pack16_kernel, codes, out, Job{rows, n, n, ld_in, ld_out},
                (n + 15) / 16, stream);
}

// packed [rows, >= 2n] uint8 -> codes [rows, >= n] uint16 (ld_out in codes)
extern "C" int unpack_codes16(const uint8_t* packed, uint16_t* out,
                              long long rows, long long n, long long ld_in,
                              long long ld_out, void* stream) {
  return launch(unpack16_kernel, packed, out, Job{rows, n, n, ld_in, ld_out},
                (n + 15) / 16, stream);
}
