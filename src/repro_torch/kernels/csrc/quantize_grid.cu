// quantize_grid: projection onto a uniform grid, and the wire encode/decode,
// elementwise over a flattened tensor. Replaces the Pallas kernels
// repro/kernels/quantize_kernel.py:_project_kernel, _encode_kernel and
// _decode_kernel.
//
// The arithmetic is the jitted reference's, bit for bit:
//   ix      = clamp(rint((x - lo) * inv_step), 0, n - 1)   (half to even)
//   project = fma(ix, step, lo)                             (one rounding)
//   decode  = fma(code, step, lo)
// inv_step = 1/step is formed in f32 on the host, as XLA folds the constant
// division. The _rn intrinsics keep the subtraction and the product
// separately rounded; __fmaf_rn is the one fused step XLA emits. The clamp
// is written with comparisons so that a NaN passes through, as in PyTorch.
//
// One grid-stride pass, four elements per thread per step: 128-bit loads of
// x when the pointers are 16-byte aligned and a scalar tail.
//
// The row-predicated form (encode and decode of the mixed-width ring's
// padded wire) takes rows on gridDim.y, each with its own strides in and
// out, and a device table `sel` of one width index per stage: row r
// belongs to stage r % stages, and a block whose row's sel is not k
// returns before it loads anything. One launch per width of the wire
// covers every stage, whatever the table says, so the launches of a step
// do not depend on the table (the reference's lax.switch, whose branches
// are all in the program).
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 132 * 16;

__device__ __forceinline__ float grid_index(float x, float lo, float inv_step,
                                            float top) {
  const float ix = rintf(__fmul_rn(__fsub_rn(x, lo), inv_step));
  return ix < 0.f ? 0.f : (ix > top ? top : ix);
}

struct Project {
  float lo, step, inv_step, top;
  __device__ __forceinline__ float operator()(float x) const {
    return __fmaf_rn(grid_index(x, lo, inv_step, top), step, lo);
  }
};

template <typename Code>
struct Encode {
  float lo, inv_step, top;
  __device__ __forceinline__ Code operator()(float x) const {
    return static_cast<Code>(grid_index(x, lo, inv_step, top));
  }
};

struct Decode {
  float lo, step;
  template <typename Code>
  __device__ __forceinline__ float operator()(Code c) const {
    return __fmaf_rn(static_cast<float>(c), step, lo);
  }
};

template <typename T>
struct Vec4;
template <>
struct Vec4<float> { using type = float4; };
template <>
struct Vec4<uint8_t> { using type = uchar4; };
template <>
struct Vec4<uint16_t> { using type = ushort4; };

// out[i] = f(in[i]) for i < n, from thread `first` of `stride`; `vec`
// selects 4-wide loads and stores (aligned pointers), whose tail of n % 4
// elements runs scalar.
template <typename In, typename Out, typename F>
__device__ __forceinline__ void elementwise(const In* __restrict__ in,
                                            Out* __restrict__ out,
                                            long long n, const F& f, bool vec,
                                            long long first,
                                            long long stride) {
  long long done = 0;
  if (vec) {
    using VI = typename Vec4<In>::type;
    using VO = typename Vec4<Out>::type;
    const long long n4 = n / 4;
    const VI* in4 = reinterpret_cast<const VI*>(in);
    VO* out4 = reinterpret_cast<VO*>(out);
    for (long long i = first; i < n4; i += stride) {
      const VI v = in4[i];
      VO o;
      o.x = f(v.x);
      o.y = f(v.y);
      o.z = f(v.z);
      o.w = f(v.w);
      out4[i] = o;
    }
    done = n4 * 4;
  }
  for (long long i = done + first; i < n; i += stride) out[i] = f(in[i]);
}

template <typename In, typename Out, typename F>
__global__ void __launch_bounds__(THREADS)
grid_elementwise_kernel(const In* __restrict__ in, Out* __restrict__ out,
                        long long n, F f, int vec) {
  elementwise(in, out, n, f, vec != 0,
              (long long)blockIdx.x * THREADS + threadIdx.x,
              (long long)gridDim.x * THREADS);
}

// The rows of a predicated launch: `rows` rows of n elements, row r at
// in + r * ld_in and out + r * ld_out (elements), stage r % stages.
struct Rows {
  long long rows, n, ld_in, ld_out, stages;
  const int* sel;
  int k;
};

template <typename T>
__device__ __forceinline__ bool aligned_to(const T* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// Grid (blocks a row, rows): each row that is stage-selected runs the
// elementwise pass over its n elements, 4-wide where both of its row
// pointers are aligned to their vector types.
template <typename In, typename Out, typename F>
__global__ void __launch_bounds__(THREADS)
grid_elementwise_kernel_sel(const In* __restrict__ in, Out* __restrict__ out,
                            Rows job, F f) {
  for (long long r = blockIdx.y; r < job.rows; r += gridDim.y) {
    if (job.sel[r % job.stages] != job.k) continue;
    const In* src = in + r * job.ld_in;
    Out* dst = out + r * job.ld_out;
    const bool vec =
        aligned_to(src, sizeof(typename Vec4<In>::type)) &&
        aligned_to(dst, sizeof(typename Vec4<Out>::type));
    elementwise(src, dst, job.n, f, vec,
                (long long)blockIdx.x * THREADS + threadIdx.x,
                (long long)gridDim.x * THREADS);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename In, typename Out, typename F>
int launch(const In* in, Out* out, long long n, F f, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int vec = aligned16(in) && aligned16(out);
  const long long work = vec ? (n + 3) / 4 : n;
  long long blocks = (work + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  grid_elementwise_kernel<In, Out, F><<<(unsigned)blocks, THREADS, 0,
                                        (cudaStream_t)stream>>>(in, out, n, f,
                                                                vec);
  return (int)cudaGetLastError();
}

// The predicated launch: about MAX_BLOCKS blocks in all, split over the
// rows (at most 65535 on gridDim.y, the rest strided), at least one a row.
template <typename In, typename Out, typename F>
int launch_sel(const In* in, Out* out, Rows job, F f, void* stream) {
  if (job.rows < 1 || job.n < 1 || job.stages < 1 || job.sel == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long by = job.rows < 65535 ? job.rows : 65535;
  long long bx = ((job.n + 3) / 4 + THREADS - 1) / THREADS;
  const long long share = MAX_BLOCKS / by > 0 ? MAX_BLOCKS / by : 1;
  if (bx > share) bx = share;
  grid_elementwise_kernel_sel<In, Out, F><<<dim3((unsigned)bx, (unsigned)by),
                                            THREADS, 0,
                                            (cudaStream_t)stream>>>(in, out,
                                                                    job, f);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry point returns cudaGetLastError() after its launch.
extern "C" int grid_project_f32(const float* x, float* out, long long n,
                                float lo, float step, float inv_step,
                                int n_levels, void* stream) {
  return launch(x, out, n, Project{lo, step, inv_step, (float)(n_levels - 1)},
                stream);
}

// code_bytes: 1 (uint8 codes, <= 8 bits) or 2 (uint16, <= 16 bits).
extern "C" int grid_encode_f32(const float* x, void* out, long long n,
                               float lo, float inv_step, int n_levels,
                               int code_bytes, void* stream) {
  const float top = (float)(n_levels - 1);
  if (code_bytes == 1)
    return launch(x, static_cast<uint8_t*>(out), n,
                  Encode<uint8_t>{lo, inv_step, top}, stream);
  if (code_bytes == 2)
    return launch(x, static_cast<uint16_t*>(out), n,
                  Encode<uint16_t>{lo, inv_step, top}, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int grid_decode_f32(const void* codes, float* out, long long n,
                               float lo, float step, int code_bytes,
                               void* stream) {
  if (code_bytes == 1)
    return launch(static_cast<const uint8_t*>(codes), out, n,
                  Decode{lo, step}, stream);
  if (code_bytes == 2)
    return launch(static_cast<const uint16_t*>(codes), out, n,
                  Decode{lo, step}, stream);
  return (int)cudaErrorInvalidValue;
}

// The row-predicated forms: rows [rows, n] at row strides ld_in / ld_out
// (elements); only the rows r with sel[r % stages] == k are written.
extern "C" int grid_encode_f32_sel(const float* x, void* out, long long rows,
                                   long long n, long long ld_in,
                                   long long ld_out, float lo, float inv_step,
                                   int n_levels, int code_bytes,
                                   const int* sel, int k, long long stages,
                                   void* stream) {
  const float top = (float)(n_levels - 1);
  const Rows job{rows, n, ld_in, ld_out, stages, sel, k};
  if (code_bytes == 1)
    return launch_sel(x, static_cast<uint8_t*>(out), job,
                      Encode<uint8_t>{lo, inv_step, top}, stream);
  if (code_bytes == 2)
    return launch_sel(x, static_cast<uint16_t*>(out), job,
                      Encode<uint16_t>{lo, inv_step, top}, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int grid_decode_f32_sel(const void* codes, float* out,
                                   long long rows, long long n,
                                   long long ld_in, long long ld_out,
                                   float lo, float step, int code_bytes,
                                   const int* sel, int k, long long stages,
                                   void* stream) {
  const Rows job{rows, n, ld_in, ld_out, stages, sel, k};
  if (code_bytes == 1)
    return launch_sel(static_cast<const uint8_t*>(codes), out, job,
                      Decode{lo, step}, stream);
  if (code_bytes == 2)
    return launch_sel(static_cast<const uint16_t*>(codes), out, job,
                      Decode{lo, step}, stream);
  return (int)cudaErrorInvalidValue;
}
