// admm_pgrad: g = -nu * (r @ Wᵀ) + u + rho * (p - q), batched over a leading
// layer axis (blockIdx.z). Wᵀ is never formed: both routes load it from rows
// of W. Replaces the Pallas kernel repro/kernels/admm_pgrad.py:admm_pgrad.
//
// Two routes of one function, chosen by the wrapper from n_out (the K of the
// product):
// - n_out > 16 (the hidden layers' [V, 1000] @ [1000, 1000]ᵀ): bound by
//   operations, so the 3xTF32 tensor-core tile core (matmul_tf32x3.cuh)
//   with a transposed B: 128 x 128 output tiles, rows of W copied as
//   K-major slabs. The epilogue runs from the accumulator registers and
//   reads u, p and q once, two columns at a time. The main path's calls
//   are stacked (x8: 1280 tiles, x10: 1600 on 132 SMs), so K is not split.
// - n_out <= 16 (the last layer's [V, 7] @ [1000, 7]ᵀ): a streaming pass,
//   bound by the bytes of u, p, q and g (39.8 MB at V 2485, n_in 1000,
//   against 98 KB of r and W). admm_pgrad_narrow: a block takes a slice of
//   128 columns and a run of rows; it stages the slice of W as [k][column]
//   and its rows of r in shared memory once, and each thread holds its 4
//   columns of W in registers. A warp takes one row: float4 loads of u, p
//   and q and one float4 store of g, 512 contiguous bytes a warp and
//   instruction, two rows in flight a thread, r's values of the row a
//   shared-memory broadcast. K is padded with zeros to a multiple of 4
//   (KP); the sum runs fmaf over k ascending from 0, and a zero term
//   leaves its bits as they are, so they do not depend on KP. The grid is
//   one wave: as many blocks as the SMs hold (the occupancy the runtime
//   reports), rows split evenly among them. An n_in that is not a
//   multiple of 4, or an operand off a 16-byte boundary, takes the same
//   kernel with scalar loads and stores.
#include "matmul_tf32x3.cuh"

namespace {

struct Args {
  const float* r;
  const float* W;
  const float* u;
  const float* p;
  const float* q;
  float* out;
  int V, n_out, n_in;
  long long sr, sw, sv;   // per-layer strides (sv for u, p, q and out)
  float nu, rho;
};

__device__ __forceinline__ float pgrad(const Args& a, float acc, float u,
                                       float p, float q) {
  return (-a.nu) * acc + u + a.rho * (p - q);
}

__global__ void __launch_bounds__(tf32x3::THREADS, 1)
admm_pgrad_tc(Args a) {
  extern __shared__ __align__(128) float smem[];
  const long long layer = blockIdx.z;
  const long long ov = layer * a.sv;
  const float* u = a.u + ov;
  const float* p = a.p + ov;
  const float* q = a.q + ov;
  float* out = a.out + ov;
  const int m0 = blockIdx.y * tf32x3::BM, n0 = blockIdx.x * tf32x3::BN;
  const int nk = (a.n_out + tf32x3::BK - 1) / tf32x3::BK;

  // [V, n_in] = r[V, n_out] @ Wᵀ, W row-major [n_in, n_out]
  float acc[tf32x3::NACC];
  tf32x3::tile<true>(a.r + layer * a.sr, a.W + layer * a.sw, a.V, a.n_in,
                     a.n_out, m0, n0, 0, nk, acc, smem);

  const int N = a.n_in;
  // 8-byte loads and stores where every row and operand allows them
  const uintptr_t addr =
      reinterpret_cast<uintptr_t>(u) | reinterpret_cast<uintptr_t>(p) |
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(out);
  const bool pairs = N % 2 == 0 && addr % 8 == 0;
#pragma unroll
  for (int j = 0; j < tf32x3::NACC; j += 2) {
    const int gm = m0 + tf32x3::acc_row(j);
    const int gn = n0 + tf32x3::acc_col(j);
    if (gm >= a.V || gn >= N) continue;
    const long long o = (long long)gm * N + gn;
    if (pairs) {
      const float2 u2 = *reinterpret_cast<const float2*>(u + o);
      const float2 p2 = *reinterpret_cast<const float2*>(p + o);
      const float2 q2 = *reinterpret_cast<const float2*>(q + o);
      *reinterpret_cast<float2*>(out + o) =
          make_float2(pgrad(a, acc[j], u2.x, p2.x, q2.x),
                      pgrad(a, acc[j + 1], u2.y, p2.y, q2.y));
    } else {
      out[o] = pgrad(a, acc[j], u[o], p[o], q[o]);
      if (gn + 1 < N)
        out[o + 1] = pgrad(a, acc[j + 1], u[o + 1], p[o + 1], q[o + 1]);
    }
  }
}

namespace narrow {

constexpr int TX = 32;              // lanes across a column slice
constexpr int TY = 8;               // rows taken at once, one a warp
constexpr int THREADS = TX * TY;
constexpr int CW = 4 * TX;          // columns of a slice, 4 a thread
constexpr int CWP = CW + 4;         // staged row pitch: spreads the stores
constexpr int MAX_ROWS = 128;       // rows of r a block stages
constexpr int UNROLL = 2;           // rows in flight a thread

// The 4 columns from col of row `row` (row-major, n columns): one float4
// where VEC, else masked scalars (0 past the row's end).
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* p, int col, int n) {
  if (VEC) return __ldg(reinterpret_cast<const float4*>(p));
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (col < n) v.x = p[0];
  if (col + 1 < n) v.y = p[1];
  if (col + 2 < n) v.z = p[2];
  if (col + 3 < n) v.w = p[3];
  return v;
}

template <bool VEC>
__device__ __forceinline__ void store4(float* p, int col, int n, float4 v) {
  if (VEC) {
    *reinterpret_cast<float4*>(p) = v;
    return;
  }
  if (col < n) p[0] = v.x;
  if (col + 1 < n) p[1] = v.y;
  if (col + 2 < n) p[2] = v.z;
  if (col + 3 < n) p[3] = v.w;
}

}  // namespace narrow

// grid (column slices, row runs, layers), block (TX, TY); rows: the rows of
// a run, at most MAX_ROWS.
template <int KP, bool VEC>
__global__ void __launch_bounds__(narrow::THREADS, 2)
admm_pgrad_narrow(Args a, int rows) {
  using namespace narrow;
  __shared__ __align__(16) float Ws[KP][CWP];
  __shared__ __align__(16) float Rs[MAX_ROWS][KP];
  const int K = a.n_out;
  const long long layer = blockIdx.z;
  const int c0 = blockIdx.x * CW;
  const int v0 = blockIdx.y * rows;
  const int nv = min(rows, a.V - v0);   // >= 1: the grid has no empty run
  const int tid = threadIdx.y * TX + threadIdx.x;

  // W[c0 + c][k] -> Ws[k][c] and r[v0 + v][k] -> Rs[v][k], zero past K and
  // past n_in; consecutive threads read consecutive addresses.
  const float* W = a.W + layer * a.sw;
  for (int e = tid; e < KP * CW; e += THREADS) {
    const int c = e / KP, k = e % KP;
    Ws[k][c] = (k < K && c0 + c < a.n_in) ? W[(long long)(c0 + c) * K + k]
                                          : 0.f;
  }
  const float* r = a.r + layer * a.sr + (long long)v0 * K;
  for (int e = tid; e < nv * KP; e += THREADS) {
    const int v = e / KP, k = e % KP;
    Rs[v][k] = k < K ? r[(long long)v * K + k] : 0.f;
  }
  __syncthreads();

  const int col = c0 + 4 * threadIdx.x;
  if (col >= a.n_in) return;
  float4 w[KP];   // W[col .. col + 3][k]
#pragma unroll
  for (int k = 0; k < KP; ++k)
    w[k] = *reinterpret_cast<const float4*>(&Ws[k][4 * threadIdx.x]);

  const long long base = layer * a.sv + (long long)v0 * a.n_in + col;
  const float* u = a.u + base;
  const float* p = a.p + base;
  const float* q = a.q + base;
  float* out = a.out + base;
  for (int v = threadIdx.y; v < nv; v += UNROLL * TY) {
    float4 uu[UNROLL], pp[UNROLL], qq[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const int vj = v + j * TY;
      if (vj < nv) {
        const long long o = (long long)vj * a.n_in;
        uu[j] = load4<VEC>(u + o, col, a.n_in);
        pp[j] = load4<VEC>(p + o, col, a.n_in);
        qq[j] = load4<VEC>(q + o, col, a.n_in);
      }
    }
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const int vj = v + j * TY;
      if (vj < nv) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int k4 = 0; k4 < KP; k4 += 4) {
          const float4 r4 = *reinterpret_cast<const float4*>(&Rs[vj][k4]);
          const float rk[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float4 wk = w[k4 + kk];
            acc[0] = fmaf(rk[kk], wk.x, acc[0]);
            acc[1] = fmaf(rk[kk], wk.y, acc[1]);
            acc[2] = fmaf(rk[kk], wk.z, acc[2]);
            acc[3] = fmaf(rk[kk], wk.w, acc[3]);
          }
        }
        const float4 g = make_float4(
            pgrad(a, acc[0], uu[j].x, pp[j].x, qq[j].x),
            pgrad(a, acc[1], uu[j].y, pp[j].y, qq[j].y),
            pgrad(a, acc[2], uu[j].z, pp[j].z, qq[j].z),
            pgrad(a, acc[3], uu[j].w, pp[j].w, qq[j].w));
        store4<VEC>(out + (long long)vj * a.n_in, col, a.n_in, g);
      }
    }
  }
}

// One wave of admm_pgrad_narrow<KP, VEC>: the blocks an SM holds (asked of
// the runtime once per device) times the SMs, split over column slices and
// layers; each run of rows at most MAX_ROWS.
template <int KP, bool VEC>
int launch_narrow(const Args& a, int batch, cudaStream_t s) {
  using namespace narrow;
  static int wave[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int blocks = dev < 64 ? wave[dev] : 0;
  if (blocks == 0) {
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, admm_pgrad_narrow<KP, VEC>, THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    blocks = per_sm * sms > 0 ? per_sm * sms : 1;
    if (dev < 64) wave[dev] = blocks;
  }
  const long long slices = (a.n_in + CW - 1) / CW;
  long long runs = blocks / (slices * batch);
  if (runs < 1) runs = 1;
  long long rows = (a.V + runs - 1) / runs;
  if (rows > MAX_ROWS) rows = MAX_ROWS;
  runs = (a.V + rows - 1) / rows;   // no empty run
  if (slices > 0x7fffffffLL || runs > 65535) return (int)cudaErrorInvalidValue;
  admm_pgrad_narrow<KP, VEC><<<dim3((unsigned)slices, (unsigned)runs, batch),
                               dim3(TX, TY), 0, s>>>(a, (int)rows);
  return (int)cudaGetLastError();
}

template <int KP>
int launch_narrow(const Args& a, int batch, cudaStream_t s) {
  // float4 rows where every row and operand is 16-byte aligned
  const uintptr_t addr =
      reinterpret_cast<uintptr_t>(a.u) | reinterpret_cast<uintptr_t>(a.p) |
      reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.out);
  return a.n_in % 4 == 0 && addr % 16 == 0
             ? launch_narrow<KP, true>(a, batch, s)
             : launch_narrow<KP, false>(a, batch, s);
}

}  // namespace

// r: [batch, V, n_out], W: [batch, n_in, n_out], u/p/q/out: [batch, V, n_in];
// strides are per layer, in elements (sv for u, p, q and out alike).
// tensor_cores: 1 for the 3xTF32 route, 0 for the narrow streaming route
// (n_out <= 16; the wrapper's route(n_out)). Returns cudaGetLastError() after the launch.
extern "C" int admm_pgrad_f32(const float* r, const float* W, const float* u,
                              const float* p, const float* q, float* out,
                              int batch, int V, int n_out, int n_in,
                              long long sr, long long sw, long long sv,
                              float nu, float rho, int tensor_cores,
                              void* stream) {
  if (batch < 1 || V < 1 || n_out < 1 || n_in < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{r, W, u, p, q, out, V, n_out, n_in, sr, sw, sv, nu, rho};
  cudaStream_t s = (cudaStream_t)stream;
  if (!tensor_cores) {
    if (n_out > 16) return (int)cudaErrorInvalidValue;
    switch ((n_out + 3) / 4) {
      case 1: return launch_narrow<4>(a, batch, s);
      case 2: return launch_narrow<8>(a, batch, s);
      case 3: return launch_narrow<12>(a, batch, s);
      default: return launch_narrow<16>(a, batch, s);
    }
  }
  // The shared-memory opt-in, once per device (as fused_linear_f32's).
  static bool opted_in[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !opted_in[dev]) {
    e = cudaFuncSetAttribute(admm_pgrad_tc,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             tf32x3::SMEM_BYTES_T);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) opted_in[dev] = true;
  }
  admm_pgrad_tc<<<tf32x3::grid(batch, V, n_in), tf32x3::THREADS,
                  tf32x3::SMEM_BYTES_T, s>>>(a);
  return (int)cudaGetLastError();
}
