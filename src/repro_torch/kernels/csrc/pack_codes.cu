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
// Pure data movement, bound by bytes. Every global load and store of a
// row's bulk is 16 bytes wide and 16-byte aligned, whatever n and the row
// stride; consecutive threads store consecutive chunks. Each output stream
// is cut into a head before its first 16-byte boundary, its aligned 16-byte
// chunks and a tail. The input bytes a chunk needs start at the input's own
// offset, which an odd n, a row stride or a row of a wider container leaves
// off a 16-byte boundary, so each input stream is loaded as aligned chunks
// and realigned with funnel shifts:
// - pack4 (two input halves, one output): in registers. Lane k of a warp
//   loads aligned chunk k of each half, takes chunk k + 1 from the lane
//   above by a shuffle, and joins the two windows' nibbles on 32-bit words.
// - pack16 (one input, two output planes, 32 input bytes an output chunk):
//   in registers. Lane k loads aligned chunks 2k and 2k + 1 of the row,
//   takes 2k + 2 .. 2k + 4 from the lanes above, and each plane cuts its
//   32 bytes at its own offset (an odd n gives the planes different heads)
//   and picks its bytes with __byte_perm. The loads depend on the row's
//   address alone, so they issue before the planes' spans are known.
// - unpack4 (one input stream, two outputs): in registers. Lane k loads
//   aligned input chunk k, takes chunks k + 1 and k + 2 from the lanes
//   above and cuts both output chunks from them.
// - unpack16 (two input planes, 8 codes an output chunk): in shared
//   memory. A block stages the aligned span of both planes that its 512
//   output chunks read with cp.async (2 or 3 chunks in flight a thread)
//   and each thread reads its 8 + 8 bytes at the planes' own offsets.
// The register kernels give a warp 64 chunks of each stream, two a lane,
// with no block-wide barrier between its loads and its stores. Each
// stream's head and ragged tail are written byte by byte, one slot a
// thread, by the warp or block that takes the row's first chunks, their
// loads issued with its chunks'. Rows run on blockIdx.y.
//
// Each kernel has a row-predicated form (SEL), for the mixed-width ring's
// padded wire: a device table `sel` holds one width index per stage, row r
// belongs to stage r % stages, and a block whose row's sel is not k skips
// the row before it loads anything. One launch per packed width of the
// wire covers every stage, whatever the table says.
#include <cstdint>

#include <cuda_runtime.h>

#include "wgmma.cuh"   // wg::cp_async16 and its commit / wait

namespace {

// the register kernels: blocks of four warps, each warp 2 steps of 32
// chunks of each stream at once
constexpr int WARPS = 4;
constexpr int STEPS = 2;
constexpr int SPAN = 32 * STEPS;        // chunks of a warp's work item
// unpack16: blocks of 256 threads, 2 output chunks a thread
constexpr int THREADS = 256;
constexpr int CPT = 2;
constexpr int TC = THREADS * CPT;       // output chunks of a tile

struct Job {
  long long rows, n, half, ld_in, ld_out;
  const int* sel;         // the predicated form's width index per stage
  int k;                  // the width index its rows run at
  long long stages;       // row r belongs to stage r % stages
};

// Whether the predicated form skips row r.
template <bool SEL>
__device__ __forceinline__ bool skip_row(const Job& job, long long r) {
  return SEL && job.sel[r % job.stages] != job.k;
}

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

// An input stream read as aligned 16-byte chunks from `base`: its bytes
// start d (0..15) bytes in, and a chunk that starts at or past `avail`
// bytes holds none of them and is not loaded.
struct Stream {
  const uint8_t* base;
  int d;
  long long avail;
};

// The stream of the `len` bytes at p.
__device__ __forceinline__ Stream stream_at(const uint8_t* p, long long len) {
  const int d = (int)(reinterpret_cast<uintptr_t>(p) & 15);
  return {p - d, d, d + len};
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

// Chunk j of stream s, if it holds bytes of the stream.
__device__ __forceinline__ uint4 chunk_of(const Stream& s, long long j,
                                          bool want = true) {
  return chunk(s.base + 16 * j, want && 16 * j < s.avail);
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

// Bytewise (hi << 4) | (lo & 0xF) on four bytes of each.
__device__ __forceinline__ uint4 nibbles(uint4 hi, uint4 lo) {
  return make_uint4((hi.x << 4 & 0xF0F0F0F0u) | (lo.x & 0x0F0F0F0Fu),
                    (hi.y << 4 & 0xF0F0F0F0u) | (lo.y & 0x0F0F0F0Fu),
                    (hi.z << 4 & 0xF0F0F0F0u) | (lo.z & 0x0F0F0F0Fu),
                    (hi.w << 4 & 0xF0F0F0F0u) | (lo.w & 0x0F0F0F0Fu));
}

// One byte of each of the 16 little-endian uint16 codes in the words
// v[Q .. Q + 8] shifted right by sh bits: selector 0x7531 picks the high
// bytes, 0x6420 the low.
template <int Q>
__device__ __forceinline__ uint4 plane_at(const uint32_t (&v)[20],
                                          unsigned sh, unsigned sel) {
  uint32_t y[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    y[j] = __funnelshift_r(v[Q + j], v[Q + j + 1], sh);
  return make_uint4(__byte_perm(y[0], y[1], sel), __byte_perm(y[2], y[3], sel),
                    __byte_perm(y[4], y[5], sel), __byte_perm(y[6], y[7], sel));
}

// plane_at of the 16 codes that start o (0..47, the same for every lane
// of a row, so the switch does not diverge) bytes into the chunks w.
__device__ __forceinline__ uint4 plane(const uint4 (&w)[5], int o,
                                       unsigned sel) {
  const uint32_t v[20] = {w[0].x, w[0].y, w[0].z, w[0].w, w[1].x, w[1].y,
                          w[1].z, w[1].w, w[2].x, w[2].y, w[2].z, w[2].w,
                          w[3].x, w[3].y, w[3].z, w[3].w, w[4].x, w[4].y,
                          w[4].z, w[4].w};
  const unsigned sh = 8 * (o & 3);
  switch (o >> 2) {
    case 0: return plane_at<0>(v, sh, sel);
    case 1: return plane_at<1>(v, sh, sel);
    case 2: return plane_at<2>(v, sh, sel);
    case 3: return plane_at<3>(v, sh, sel);
    case 4: return plane_at<4>(v, sh, sel);
    case 5: return plane_at<5>(v, sh, sel);
    case 6: return plane_at<6>(v, sh, sel);
    case 7: return plane_at<7>(v, sh, sel);
    case 8: return plane_at<8>(v, sh, sel);
    case 9: return plane_at<9>(v, sh, sel);
    case 10: return plane_at<10>(v, sh, sel);
    default: return plane_at<11>(v, sh, sel);
  }
}

__device__ __forceinline__ uint4 high_nibbles(uint4 x) {
  return make_uint4(x.x >> 4 & 0x0F0F0F0Fu, x.y >> 4 & 0x0F0F0F0Fu,
                    x.z >> 4 & 0x0F0F0F0Fu, x.w >> 4 & 0x0F0F0F0Fu);
}

__device__ __forceinline__ uint4 low_nibbles(uint4 x) {
  return make_uint4(x.x & 0x0F0F0F0Fu, x.y & 0x0F0F0F0Fu,
                    x.z & 0x0F0F0F0Fu, x.w & 0x0F0F0F0Fu);
}

// Grid (items, rows): a warp's work item t of row r is the row's output
// chunks [SPAN·t, SPAN·t + SPAN). Output chunk k (bytes head + 16k on)
// reads 16 codes of each half, [head + 16k, ..) and [h + head + 16k, ..),
// each half a Stream: lane k loads its aligned chunk k, takes chunk k + 1
// from the lane above (lane 31 loads chunk 32 too) and cuts its window. An
// odd n's last byte, whose low nibble is the code past the end, is left to
// the tail, so no chunk reads that code. The warp of item 0 also takes the
// head and tail bytes, one slot a lane (head byte l for lanes l < 16, tail
// byte l - 16 above: the tail holds at most 16), loaded with its chunks
// and stored after them.
template <bool SEL>
__global__ void __launch_bounds__(WARPS * 32)
pack4_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
             Job job, long long items) {
  const long long h = job.half, n = job.n;
  const int lane = threadIdx.x & 31;
  const long long t = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (t >= items) return;   // whole warps
  for (long long r = blockIdx.y; r < job.rows; r += gridDim.y) {
    if (skip_row<SEL>(job, r)) continue;
    const uint8_t* src = in + r * job.ld_in;
    uint8_t* dst = out + r * job.ld_out;
    const Span o = span_of(dst, h - (n & 1));
    const long long i = lane < 16 ? lane : o.head + 16 * o.full + lane - 16;
    const bool slot = t == 0 && (lane < 16 ? i < o.head : i < h);
    const uint8_t bh = slot ? src[i] : 0;
    const uint8_t bl = slot && i + h < n ? src[i + h] : 0;
    const Stream a = stream_at(src + o.head, 16 * o.full),
                 b = stream_at(src + h + o.head, 16 * o.full);
    uint4 xa[STEPS], ea[STEPS], xb[STEPS], eb[STEPS];
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {   // every load in flight first
      const long long c = SPAN * t + 32 * u + lane;
      xa[u] = chunk_of(a, c);
      xb[u] = chunk_of(b, c);
      ea[u] = chunk_of(a, c + 1, lane == 31 && a.d != 0);
      eb[u] = chunk_of(b, c + 1, lane == 31 && b.d != 0);
    }
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {
      const long long k = SPAN * t + 32 * u + lane;
      uint4 na = shfl_down4(xa[u], 1), nb = shfl_down4(xb[u], 1);
      if (lane == 31) {
        na = ea[u];
        nb = eb[u];
      }
      if (k < o.full)
        *reinterpret_cast<uint4*>(dst + o.head + 16 * k) = nibbles(
            window16(xa[u], na, a.d), window16(xb[u], nb, b.d));
    }
    if (slot) dst[i] = (uint8_t)(bh << 4 | (bl & 0xF));
  }
}

// Grid (items, rows): a warp's work item t of row r is the output chunks
// [SPAN·t, SPAN·t + SPAN) of each plane. Chunk k of a plane is its
// codes [head + 16k, ..), with the plane's own head (an odd n, or a row
// that is not 16-byte aligned, gives the planes different heads): 32
// input bytes. Both planes are cut from the row's input read as aligned
// chunks from its first code's chunk, so the loads wait on nothing but
// the row's address: a plane's bytes start o = s0 + 2·head (0..45) bytes
// past that chunk (s0 the row's offset), and its chunk k lies in the
// aligned chunks 2k .. 2k + 4. Lane k loads chunks 2k and 2k + 1, takes
// 2k + 2 and 2k + 3 from the lane above and 2k + 4 from the lane two
// above (lane 31 loads the three past the warp, lane 30 takes its fifth
// from them), and picks each plane's bytes with __byte_perm. The warp of item 0 also takes each plane's head
// and tail bytes, one slot a lane and plane.
// At least 8 blocks an SM (64 registers): at 95 registers, 5 blocks an SM,
// the multi-row batches ran ~4% slower.
template <bool SEL>
__global__ void __launch_bounds__(WARPS * 32, 8)
pack16_kernel(const uint16_t* __restrict__ in, uint8_t* __restrict__ out,
              Job job, long long items) {
  const long long n = job.n;
  const int lane = threadIdx.x & 31;
  const long long t = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (t >= items) return;   // whole warps
  for (long long r = blockIdx.y; r < job.rows; r += gridDim.y) {
    if (skip_row<SEL>(job, r)) continue;
    const uint16_t* src = in + r * job.ld_in;
    uint8_t* dst = out + r * job.ld_out;
    const Stream s = stream_at(reinterpret_cast<const uint8_t*>(src), 2 * n);
    uint4 x[STEPS][2], e[STEPS][3];
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {   // every load in flight first
      const long long c = SPAN * t + 32 * u + lane;
      x[u][0] = chunk_of(s, 2 * c);
      x[u][1] = chunk_of(s, 2 * c + 1);
#pragma unroll
      for (int j = 0; j < 3; ++j)
        e[u][j] = chunk_of(s, 2 * c + 2 + j, lane == 31);
    }
    const Span hi = span_of(dst, n), lo = span_of(dst + n, n);
    const long long ih = lane < 16 ? lane : hi.head + 16 * hi.full + lane - 16;
    const long long il = lane < 16 ? lane : lo.head + 16 * lo.full + lane - 16;
    const bool bh = t == 0 && (lane < 16 ? ih < hi.head : ih < n);
    const bool bl = t == 0 && (lane < 16 ? il < lo.head : il < n);
    const uint16_t ch = bh ? src[ih] : 0, cl = bl ? src[il] : 0;
    const int oh = s.d + 2 * (int)hi.head, ol = s.d + 2 * (int)lo.head;
    const bool far = oh >= 32 || ol >= 32;   // chunk 2k + 4 is read
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {
      const long long k = SPAN * t + 32 * u + lane;
      uint4 w[5] = {x[u][0], x[u][1], shfl_down4(x[u][0], 1),
                    shfl_down4(x[u][1], 1), e[u][2]};
      if (far) {
        w[4] = shfl_down4(x[u][0], 2);
        const uint4 e31 = shfl4(e[u][0], 31);
        if (lane == 30) w[4] = e31;
      }
      if (lane == 31) {
        w[2] = e[u][0];
        w[3] = e[u][1];
        w[4] = e[u][2];
      }
      if (k < hi.full)
        *reinterpret_cast<uint4*>(dst + hi.head + 16 * k) =
            plane(w, oh, 0x7531);
      if (k < lo.full)
        *reinterpret_cast<uint4*>(dst + n + lo.head + 16 * k) =
            plane(w, ol, 0x6420);
    }
    if (bh) dst[ih] = (uint8_t)(ch >> 8);
    if (bl) dst[n + il] = (uint8_t)(cl & 0xFF);
  }
}

// Grid (items, rows): a warp's work item t of row r is the row's output
// chunks [SPAN·t, SPAN·t + SPAN) of each of its two streams (codes
// [0, h) and [h, n)). Both read the packed bytes [0, h): chunk k of the
// hi stream starts eh (0..30) bytes into packed chunk k (counted from the
// row's first aligned chunk), the lo stream's el, so lane k loads
// packed chunk k, takes chunks k + 1 and k + 2 from the lanes above (lanes
// 30 and 31 load chunks 32 and 33 too) and cuts both windows in registers.
// The warp of item 0 also takes each stream's head and tail bytes, one
// slot a lane (head byte l for lanes l < 16, tail byte l - 16 above),
// loaded with its chunks and stored after them.
template <bool SEL>
__global__ void __launch_bounds__(WARPS * 32)
unpack4_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
               Job job, long long items) {
  const long long h = job.half, n = job.n;
  const int lane = threadIdx.x & 31;
  const long long t = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (t >= items) return;   // whole warps
  for (long long r = blockIdx.y; r < job.rows; r += gridDim.y) {
    if (skip_row<SEL>(job, r)) continue;
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
    uint4 x[STEPS], e[STEPS];
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {   // every load in flight first
      const long long c = SPAN * t + 32 * u + lane;
      x[u] = chunk(base + 16 * c, 16 * c < avail);
      e[u] = chunk(base + 16 * (c + 2), lane >= 30 && 16 * (c + 2) < avail);
    }
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {
      const long long k = SPAN * t + 32 * u + lane;
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
template <bool SEL>
__global__ void __launch_bounds__(THREADS)
unpack16_kernel(const uint8_t* __restrict__ in, uint16_t* __restrict__ out,
                Job job, long long tiles) {
  __shared__ uint4 hs[TC / 2 + 1], ls[TC / 2 + 1];
  const long long n = job.n;
  const long long t = blockIdx.x;
  const int i = threadIdx.x;
  for (long long r = blockIdx.y; r < job.rows; r += gridDim.y) {
    if (skip_row<SEL>(job, r)) continue;
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
      const int k = i + m * THREADS;
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

// Grid (items, rows): an item of `per_item` whole 16-byte chunks of the
// row's widest output stream (`len` bytes) for each `team` of threads,
// rows strided past 65535.
template <typename In, typename Out>
int launch_rows(void (*kernel)(const In*, Out*, Job, long long), const In* in,
                Out* out, Job job, long long len, int per_item, int team,
                int threads, void* stream) {
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
  return launch_rows(pack4_kernel<false>, codes, out,
                     Job{rows, n, h, ld_in, ld_out, nullptr, 0, 1}, h, SPAN,
                     32, WARPS * 32, stream);
}

// packed [rows, >= ceil(n/2)] -> codes [rows, >= n] uint8
extern "C" int unpack_codes4(const uint8_t* packed, uint8_t* out,
                             long long rows, long long n, long long ld_in,
                             long long ld_out, void* stream) {
  const long long h = (n + 1) / 2;
  return launch_rows(unpack4_kernel<false>, packed, out,
                     Job{rows, n, h, ld_in, ld_out, nullptr, 0, 1}, h, SPAN,
                     32, WARPS * 32, stream);
}

// codes [rows, >= n] uint16 (ld_in in codes) -> out [rows, >= 2n] uint8
extern "C" int pack_codes16(const uint16_t* codes, uint8_t* out,
                            long long rows, long long n, long long ld_in,
                            long long ld_out, void* stream) {
  return launch_rows(pack16_kernel<false>, codes, out,
                     Job{rows, n, n, ld_in, ld_out, nullptr, 0, 1}, n, SPAN,
                     32, WARPS * 32, stream);
}

// packed [rows, >= 2n] uint8 -> codes [rows, >= n] uint16 (ld_out in codes)
extern "C" int unpack_codes16(const uint8_t* packed, uint16_t* out,
                              long long rows, long long n, long long ld_in,
                              long long ld_out, void* stream) {
  return launch_rows(unpack16_kernel<false>, packed, out,
                     Job{rows, n, n, ld_in, ld_out, nullptr, 0, 1}, 2 * n, TC,
                     THREADS, THREADS, stream);
}

// The row-predicated forms of the four: the same layouts, and only the
// rows r with sel[r % stages] == k are written (sel: int32 [stages] on the
// device).
extern "C" int pack_codes4_sel(const uint8_t* codes, uint8_t* out,
                               long long rows, long long n, long long ld_in,
                               long long ld_out, const int* sel, int k,
                               long long stages, void* stream) {
  if (sel == nullptr || stages < 1) return (int)cudaErrorInvalidValue;
  const long long h = (n + 1) / 2;
  return launch_rows(pack4_kernel<true>, codes, out,
                     Job{rows, n, h, ld_in, ld_out, sel, k, stages}, h, SPAN,
                     32, WARPS * 32, stream);
}

extern "C" int unpack_codes4_sel(const uint8_t* packed, uint8_t* out,
                                 long long rows, long long n, long long ld_in,
                                 long long ld_out, const int* sel, int k,
                                 long long stages, void* stream) {
  if (sel == nullptr || stages < 1) return (int)cudaErrorInvalidValue;
  const long long h = (n + 1) / 2;
  return launch_rows(unpack4_kernel<true>, packed, out,
                     Job{rows, n, h, ld_in, ld_out, sel, k, stages}, h, SPAN,
                     32, WARPS * 32, stream);
}

extern "C" int pack_codes16_sel(const uint16_t* codes, uint8_t* out,
                                long long rows, long long n, long long ld_in,
                                long long ld_out, const int* sel, int k,
                                long long stages, void* stream) {
  if (sel == nullptr || stages < 1) return (int)cudaErrorInvalidValue;
  return launch_rows(pack16_kernel<true>, codes, out,
                     Job{rows, n, n, ld_in, ld_out, sel, k, stages}, n, SPAN,
                     32, WARPS * 32, stream);
}

extern "C" int unpack_codes16_sel(const uint8_t* packed, uint16_t* out,
                                  long long rows, long long n,
                                  long long ld_in, long long ld_out,
                                  const int* sel, int k, long long stages,
                                  void* stream) {
  if (sel == nullptr || stages < 1) return (int)cudaErrorInvalidValue;
  return launch_rows(unpack16_kernel<true>, packed, out,
                     Job{rows, n, n, ld_in, ld_out, sel, k, stages}, 2 * n, TC,
                     THREADS, THREADS, stream);
}
