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
// Pure data movement, bound by bytes.
// Packing: each thread formats 16 packed bytes per step (16 codes for the
// 16-bit planes). Each stream of a row takes the widest access its row's
// address allows (128, 64 or 32 bits, bytes otherwise), found on the
// device per row: the ring's rows are 2,485,000 codes, so the odd rows of
// a batch sit 8 bytes off a 16-byte boundary and the 4-bit half-split's
// second stream 4 bytes off. A scalar tail takes the last partial chunk.
// Unpacking: every global load and store of a row's bulk is 16 bytes wide
// and 16-byte aligned, whatever n and the row stride; consecutive threads
// store consecutive chunks. Each output stream is cut into its aligned
// 16-byte chunks; the input bytes a chunk needs start at the input's own
// offset, which an odd n or a row of a wider container leaves off a
// 16-byte boundary, and are realigned with funnel shifts:
// - unpack4 (one input stream, two outputs): in registers. Lane k of a
//   warp loads aligned input chunk k, takes chunks k + 1 and k + 2 from
//   the lanes above with shuffles and cuts both output chunks from them;
//   a warp has 64 chunks of each stream in flight, two a lane, and no
//   block-wide barrier stands between its loads and its stores.
// - unpack16 (two input planes, 8 codes an output chunk): in shared
//   memory. A block stages the aligned span of both planes that its 512
//   output chunks read with cp.async (2 or 3 chunks in flight a thread)
//   and each thread reads its 8 + 8 bytes at the planes' own offsets.
// Each stream's head before its first 16-byte boundary and its ragged
// tail (under 16 bytes each) are written byte by byte, one slot a thread,
// by the warp or block that takes the row's first chunks, their loads
// issued with its chunks'.
#include <cstdint>

#include <cuda_runtime.h>

#include "wgmma.cuh"   // wg::cp_async16 and its commit / wait

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

// --- unpacking ------------------------------------------------------------

namespace un {

constexpr int THREADS = 256;
constexpr int CPT = 2;                  // output chunks a thread and stream
constexpr int TC = THREADS * CPT;       // output chunks of a tile and stream
// unpack4: blocks of four warps, each warp 2 steps of 32 chunks at once
constexpr int WARPS4 = 4;
constexpr int STEPS4 = 2;
constexpr int SPAN4 = 32 * STEPS4;      // chunks of a warp's work item

// An output stream of `len` bytes at dst: `head` bytes before its first
// 16-byte boundary (or all of it, if it holds none), then `full` whole
// chunks, then the tail.
struct Span {
  long long head, full;
};

__device__ __forceinline__ Span span_of(const void* dst, long long len) {
  const long long to16 = (16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15;
  const long long head = to16 < len ? to16 : len;
  return {head, (len - head) / 16};
}

__device__ __forceinline__ const uint8_t* align_down(const uint8_t* p) {
  return reinterpret_cast<const uint8_t*>(reinterpret_cast<uintptr_t>(p) &
                                          ~uintptr_t(15));
}

// Copy `count` aligned 16-byte chunks from g to s, THREADS-strided.
__device__ __forceinline__ void stage(uint4* s, const uint8_t* g, int count) {
  for (int c = threadIdx.x; c < count; c += THREADS)
    wg::cp_async16(&s[c], g + 16 * c, true);
}

__device__ __forceinline__ uint32_t pick(const uint32_t (&w)[8], int k,
                                         int q) {
  return q == 0 ? w[k] : q == 1 ? w[k + 1] : q == 2 ? w[k + 2] : w[k + 3];
}

// The 16 bytes that start d bytes (0..15, the same for every lane of a
// stream, so the branch does not diverge) into the 32 bytes a, b.
__device__ __forceinline__ uint4 window16(uint4 a, uint4 b, int d) {
  if (d == 0) return a;
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  const int q = d >> 2;
  const unsigned sh = 8 * (d & 3);
  uint32_t v[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) v[k] = pick(w, k, q);
  return make_uint4(__funnelshift_r(v[0], v[1], sh),
                    __funnelshift_r(v[1], v[2], sh),
                    __funnelshift_r(v[2], v[3], sh),
                    __funnelshift_r(v[3], v[4], sh));
}

__device__ __forceinline__ uint4 shfl4(uint4 v, int lane) {
  return make_uint4(__shfl_sync(0xffffffffu, v.x, lane),
                    __shfl_sync(0xffffffffu, v.y, lane),
                    __shfl_sync(0xffffffffu, v.z, lane),
                    __shfl_sync(0xffffffffu, v.w, lane));
}

__device__ __forceinline__ uint4 shfl_down4(uint4 v, int by) {
  return make_uint4(__shfl_down_sync(0xffffffffu, v.x, by),
                    __shfl_down_sync(0xffffffffu, v.y, by),
                    __shfl_down_sync(0xffffffffu, v.z, by),
                    __shfl_down_sync(0xffffffffu, v.w, by));
}

// The aligned 16-byte chunk at p if `in` (it holds bytes of the row), else 0.
__device__ __forceinline__ uint4 chunk(const uint8_t* p, bool in) {
  return in ? __ldg(reinterpret_cast<const uint4*>(p))
            : make_uint4(0u, 0u, 0u, 0u);
}

// The 8 bytes at byte offset `off` of the staged chunks s, as two words
// (off % 8 the same for every thread of a stream).
__device__ __forceinline__ uint2 window8(const uint4* s, int off) {
  const uint2* s2 = reinterpret_cast<const uint2*>(s);
  const uint2 a = s2[off >> 3];
  const int d = off & 7;
  if (d == 0) return a;
  const uint2 b = s2[(off >> 3) + 1];
  const unsigned long long lo = (unsigned long long)a.y << 32 | a.x;
  const unsigned long long hi = (unsigned long long)b.y << 32 | b.x;
  const unsigned long long x = lo >> (8 * d) | hi << (64 - 8 * d);
  return make_uint2((uint32_t)x, (uint32_t)(x >> 32));
}

__device__ __forceinline__ uint4 high_nibbles(uint4 x) {
  return make_uint4(x.x >> 4 & 0x0F0F0F0Fu, x.y >> 4 & 0x0F0F0F0Fu,
                    x.z >> 4 & 0x0F0F0F0Fu, x.w >> 4 & 0x0F0F0F0Fu);
}

__device__ __forceinline__ uint4 low_nibbles(uint4 x) {
  return make_uint4(x.x & 0x0F0F0F0Fu, x.y & 0x0F0F0F0Fu,
                    x.z & 0x0F0F0F0Fu, x.w & 0x0F0F0F0Fu);
}

}  // namespace un

// Grid (items, rows): a warp's work item t of row r is the row's output
// chunks [SPAN4·t, SPAN4·t + SPAN4) of each of its two streams (codes
// [0, h) and [h, n)). Both read the packed bytes [0, h): chunk k of the
// hi stream starts eh (0..30) bytes into packed chunk k (counted from the
// row's first aligned chunk), the lo stream's el, so lane k loads
// packed chunk k, takes chunks k + 1 and k + 2 from the lanes above (lanes
// 30 and 31 load chunks 32 and 33 too) and cuts both windows in registers.
// The warp of item 0 also takes each stream's head and tail bytes, one
// slot a lane (head byte l for lanes l < 16, tail byte l - 16 above),
// loaded with its chunks and stored after them.
__global__ void __launch_bounds__(un::WARPS4 * 32)
unpack4_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
               Job job, long long items) {
  using namespace un;
  const long long h = job.half, n = job.n;
  const int lane = threadIdx.x & 31;
  const long long t = (long long)blockIdx.x * WARPS4 + threadIdx.x / 32;
  if (t >= items) return;   // whole warps
  for (long long r = blockIdx.y; r < job.rows; r += gridDim.y) {
    const uint8_t* src = in + r * job.ld_in;
    uint8_t* dst = out + r * job.ld_out;
    const Span hi = span_of(dst, h), lo = span_of(dst + h, n - h);
    // item 0's byte slots: each stream's index and whether it is one
    const long long ih = lane < 16 ? lane : hi.head + 16 * hi.full + lane - 16;
    const long long il = lane < 16 ? lane : lo.head + 16 * lo.full + lane - 16;
    const bool bh = t == 0 && (lane < 16 ? ih < hi.head : ih < h);
    const bool bl = t == 0 && (lane < 16 ? il < lo.head : il < n - h);
    const uint8_t ph = bh ? src[ih] : 0, pl = bl ? src[il] : 0;
    const int s0 = (int)(reinterpret_cast<uintptr_t>(src) & 15);
    const int eh = s0 + (int)hi.head, el = s0 + (int)lo.head;
    const uint8_t* base = align_down(src);
    const long long avail = s0 + h;   // chunk c holds packed bytes: 16c < avail
    uint4 x[STEPS4], e[STEPS4];
#pragma unroll
    for (int u = 0; u < STEPS4; ++u) {   // every load in flight first
      const long long c = SPAN4 * t + 32 * u + lane;
      x[u] = chunk(base + 16 * c, 16 * c < avail);
      e[u] = chunk(base + 16 * (c + 2), lane >= 30 && 16 * (c + 2) < avail);
    }
#pragma unroll
    for (int u = 0; u < STEPS4; ++u) {
      const long long k = SPAN4 * t + 32 * u + lane;
      uint4 n1 = shfl_down4(x[u], 1), n2 = shfl_down4(x[u], 2);
      const uint4 e30 = shfl4(e[u], 30);
      if (lane == 31) n1 = e30;
      if (lane >= 30) n2 = e[u];
      if (k < hi.full)
        *reinterpret_cast<uint4*>(dst + hi.head + 16 * k) = high_nibbles(
            eh >= 16 ? window16(n1, n2, eh & 15) : window16(x[u], n1, eh));
      if (k < lo.full)
        *reinterpret_cast<uint4*>(dst + h + lo.head + 16 * k) = low_nibbles(
            el >= 16 ? window16(n1, n2, el & 15) : window16(x[u], n1, el));
    }
    if (bh) dst[ih] = ph >> 4 & 0xF;
    if (bl) dst[h + il] = pl & 0xF;
  }
}

// Grid (tiles, rows): tile t of row r is the row's output chunks [TC·t,
// TC·t + TC), 8 codes a chunk. Each reads 8 bytes of the high plane
// (packed bytes [0, n)) and 8 of the low plane ([n, 2n)) at the planes'
// own offsets; each plane's span is TC / 2 + 1 staged chunks. The block of
// tile 0 also takes the head and tail codes, one slot a thread (head code
// i for threads i < 8, tail code i - 8 for threads 8..15), loaded before
// the staging and stored after it.
__global__ void __launch_bounds__(un::THREADS)
unpack16_kernel(const uint8_t* __restrict__ in, uint16_t* __restrict__ out,
                Job job, long long tiles) {
  using namespace un;
  __shared__ uint4 hs[TC / 2 + 1], ls[TC / 2 + 1];
  const long long n = job.n;
  const long long t = blockIdx.x;
  const int i = threadIdx.x;
  for (long long r = blockIdx.y; r < job.rows; r += gridDim.y) {
    const uint8_t* src = in + r * job.ld_in;
    uint16_t* dst = out + r * job.ld_out;
    const Span o = span_of(dst, 2 * n);   // dst is 2-byte aligned: head even
    const long long ic = i < 8 ? i : o.head / 2 + 8 * o.full + i - 8;
    const bool slot = t == 0 && i < 16 && (i < 8 ? ic < o.head / 2 : ic < n);
    const uint16_t code =
        slot ? (uint16_t)((src[ic] << 8) | src[n + ic]) : (uint16_t)0;
    const int cnt = (int)min((long long)TC, o.full - TC * t);
    const long long c0 = o.head / 2 + 8LL * TC * t;   // the tile's first code
    const int oh = (int)(reinterpret_cast<uintptr_t>(src + c0) & 15);
    const int ol = (int)(reinterpret_cast<uintptr_t>(src + n + c0) & 15);
    if (cnt > 0) {
      stage(hs, align_down(src + c0), (oh + 8 * cnt + 15) / 16);
      stage(ls, align_down(src + n + c0), (ol + 8 * cnt + 15) / 16);
      wg::cp_async_commit();
      wg::cp_async_wait<0>();
    }
    __syncthreads();
    uint8_t* d8 = reinterpret_cast<uint8_t*>(dst) + o.head;
#pragma unroll
    for (int m = 0; m < CPT; ++m) {
      const int k = i + m * un::THREADS;
      if (k < cnt) {
        const uint2 hb = window8(hs, oh + 8 * k), lb = window8(ls, ol + 8 * k);
        // code j = high byte j << 8 | low byte j, little-endian in memory
        *reinterpret_cast<uint4*>(d8 + 16 * (TC * t + k)) = make_uint4(
            __byte_perm(lb.x, hb.x, 0x5140), __byte_perm(lb.x, hb.x, 0x7362),
            __byte_perm(lb.y, hb.y, 0x5140), __byte_perm(lb.y, hb.y, 0x7362));
      }
    }
    if (slot) dst[ic] = code;
    __syncthreads();   // the next row restages hs and ls
  }
}

// Grid (items, rows): an item of `per_item` whole output chunks of the
// row's widest stream for each `team` of threads, rows strided past 65535.
template <typename Out>
int launch_unpack(void (*kernel)(const uint8_t*, Out*, Job, long long),
                  const uint8_t* in, Out* out, Job job, long long len,
                  int per_item, int team, int threads, void* stream) {
  if (job.rows < 1 || job.n < 1) return (int)cudaErrorInvalidValue;
  long long items = (len / 16 + per_item - 1) / per_item;
  if (items < 1) items = 1;
  const int per_block = threads / team;
  const long long bx = (items + per_block - 1) / per_block;
  const long long by = job.rows < 65535 ? job.rows : 65535;
  if (bx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<dim3((unsigned)bx, (unsigned)by), threads, 0,
           (cudaStream_t)stream>>>(in, out, job, items);
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
  return launch_unpack(unpack4_kernel, packed, out,
                       Job{rows, n, h, ld_in, ld_out}, h, un::SPAN4, 32,
                       un::WARPS4 * 32, stream);
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
  return launch_unpack(unpack16_kernel, packed, out,
                       Job{rows, n, n, ld_in, ld_out}, 2 * n, un::TC,
                       un::THREADS, un::THREADS, stream);
}
