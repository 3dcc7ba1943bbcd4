// fista_zlast: the whole z_L FISTA solve of Eq. 7 in ONE launch.
// Replaces the Pallas kernel repro/kernels/fista_zlast.py:_fista_step_kernel,
// which the TPU path dispatches n_iters + 1 times.
//
// Every step of every element:
//   y      = z_cur + mom_s * (z_cur - z_prev)
//   g      = (softmax(y[:C]) - onehot(label)) * mask + nu * (y - a)  (j < C)
//          = nu * (y - a)                                           (j >= C)
//   z_next = y - step * g
// mom_s comes from the host's momentum schedule (exact f64, passed as f32).
// Rows are independent; only the first C columns (the classes) couple, and
// only within their row, through the softmax.
//
// What bounds it on an H100. At [V, C] (one host, C = 3..40 in the paper's
// Table II) the solve reads 12 bytes per element once: the launch and 16
// dependent steps, each an expf, a division and two row reductions, set the
// time. At the ring's head-folded last layer [V, h] (h = 1000) almost every
// column is proximal: 12 bytes per element against 109 separately rounded
// f32 operations over 16 steps, so the FP32 instruction rate (one operation
// a lane and clock, no FMA to pair them) bounds it about as tightly as the
// bytes.
//
// Design. Blocks [0, ce_blocks) take the class columns: a group of G lanes
// per row, G the smallest power of two >= C but at most MAX_GROUP (8), each
// lane holding z_prev, z_cur and a of its PER = ceil(C / G) columns in
// registers (PER <= 8 at C <= 64: no spills). The row's max and sum go
// through __shfl_xor_sync inside the group (masks cover the group's lanes
// only; a lane with no column gives -inf / 0) in one fixed butterfly order,
// so a second call gives the same bits. Groups wider than 8 lanes measured
// slower on the H100 at 15 and 40 classes: more of each step's dependent
// chain goes to shuffle levels, and more lanes sit idle.
// The remaining blocks take the proximal columns, which are elementwise: a
// block covers THREADS >> tx_log2 rows with 1 << tx_log2 threads a row and
// one 16-byte chunk a thread (float4 loads and stores), with a scalar head
// up to the row span's first 16-byte boundary and a scalar tail, found per
// row because odd widths move it; no integer division per element, and a
// grid-stride loop over rows past MAX_ROW_SLOTS. The arithmetic is written
// with _rn intrinsics in the plain version's order (no FMA contraction), so
// these columns equal it bit for bit. expf and IEEE division in the class
// part: no fast-math.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_STEPS = 256;
constexpr int THREADS = 128;
constexpr long long MAX_ROW_SLOTS = 65535;  // more rows: the grid strides
constexpr int MAX_GROUP = 8;   // lanes a row's class columns take at most

struct Momentum {
  float v[MAX_STEPS];
};

struct Solve {
  const float* a;
  const float* z_old;
  const int* labels;
  const float* mask;
  float* out;
  int V, N, C, n_steps;
  float step, nu;
};

// The proximal layout: each row's span of columns >= C in units of up to
// four elements; unit u < nb is the u-th 16-byte chunk, unit nb the head
// before the first 16-byte boundary, unit nb + 1 the tail.
struct Prox {
  int units;       // units of the widest row: W / 4 + 2 (0: no span)
  int tx_log2;     // threads per row: 1 << tx_log2 (<= THREADS)
  int px;          // blocks per row
  long long slots; // row slots: a block holds THREADS >> tx_log2 of them
  int vec;         // a, z_old and out agree mod 16 bytes: float4 body
};

template <int G, int PER>
__device__ __forceinline__ void class_row(const Solve& p, long long row,
                                          const Momentum& mom) {
  const int lane = threadIdx.x & 31;
  const int sub = lane & (G - 1);
  const unsigned gmask = (0xffffffffu >> (32 - G)) << (lane & ~(G - 1));
  const long long base = row * p.N;
  float zp[PER], zc[PER], av[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int j = sub + k * G;
    zc[k] = j < p.C ? p.z_old[base + j] : 0.f;
    zp[k] = zc[k];
    av[k] = j < p.C ? p.a[base + j] : 0.f;
  }
  const int lab = p.labels[row];
  const float mk = p.mask[row];

  for (int s = 0; s < p.n_steps; ++s) {
    const float m_s = mom.v[s];
    float y[PER];
    float mx = -INFINITY;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      y[k] = zc[k] + m_s * (zc[k] - zp[k]);
      if (sub + k * G < p.C) mx = fmaxf(mx, y[k]);
    }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(gmask, mx, o, G));
    float e[PER];
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      e[k] = sub + k * G < p.C ? expf(y[k] - mx) : 0.f;
      sum += e[k];
    }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1)
      sum += __shfl_xor_sync(gmask, sum, o, G);
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const float pj = e[k] / sum;
      const float oh = sub + k * G == lab ? 1.f : 0.f;
      const float g = (pj - oh) * mk + p.nu * (y[k] - av[k]);
      zp[k] = zc[k];
      zc[k] = y[k] - p.step * g;
    }
  }
#pragma unroll
  for (int k = 0; k < PER; ++k)
    if (sub + k * G < p.C) p.out[base + sub + k * G] = zc[k];
}

// z⁺ = y − step·(ν(y − a)), y = z + m(z − z₋), on four elements at once,
// each operation rounded on its own as the plain version rounds it. Step 0
// has y = z (z₋ = z).
__device__ __forceinline__ void proximal_steps(float (&z)[4],
                                               const float (&av)[4],
                                               const Solve& p,
                                               const Momentum& mom) {
  float zp[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    zp[i] = z[i];
    z[i] = __fsub_rn(z[i], __fmul_rn(p.step,
                                     __fmul_rn(p.nu, __fsub_rn(z[i], av[i]))));
  }
  for (int s = 1; s < p.n_steps; ++s) {
    const float m = mom.v[s];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float y = __fadd_rn(z[i], __fmul_rn(m, __fsub_rn(z[i], zp[i])));
      const float g = __fmul_rn(p.nu, __fsub_rn(y, av[i]));
      zp[i] = z[i];
      z[i] = __fsub_rn(y, __fmul_rn(p.step, g));
    }
  }
}

// Unit u of one row's proximal span (the layout of Prox).
__device__ __forceinline__ void proximal_unit(const Solve& p, const Prox& x,
                                              long long row, int u,
                                              const Momentum& mom) {
  const int W = p.N - p.C;
  const long long base = row * p.N + p.C;
  const int head =
      x.vec ? min(W, (int)((4u - ((uintptr_t)(p.a + base) >> 2)) & 3u)) : 0;
  const int nb = (W - head) >> 2;
  long long start;
  int cnt;
  if (u < nb) {
    start = base + head + 4LL * u;
    cnt = 4;
  } else if (u == nb) {
    start = base;
    cnt = head;
  } else if (u == nb + 1) {
    start = base + head + 4LL * nb;
    cnt = W - head - 4 * nb;
  } else {
    return;
  }
  if (cnt == 0) return;
  const bool chunk = x.vec && u < nb;
  float z[4], av[4];
  if (chunk) {
    const float4 zv = *reinterpret_cast<const float4*>(p.z_old + start);
    const float4 aq = *reinterpret_cast<const float4*>(p.a + start);
    z[0] = zv.x; z[1] = zv.y; z[2] = zv.z; z[3] = zv.w;
    av[0] = aq.x; av[1] = aq.y; av[2] = aq.z; av[3] = aq.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      z[i] = i < cnt ? p.z_old[start + i] : 0.f;
      av[i] = i < cnt ? p.a[start + i] : 0.f;
    }
  }
  proximal_steps(z, av, p, mom);
  if (chunk) {
    *reinterpret_cast<float4*>(p.out + start) =
        make_float4(z[0], z[1], z[2], z[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < cnt) p.out[start + i] = z[i];
  }
}

template <int G, int PER>
__global__ void __launch_bounds__(THREADS)
fista_zlast_kernel(Solve p, Prox x, int ce_blocks, Momentum mom) {
  if ((int)blockIdx.x < ce_blocks) {
    const long long row =
        (long long)blockIdx.x * (THREADS / G) + threadIdx.x / G;
    if (row < p.V) class_row<G, PER>(p, row, mom);
    return;
  }
  // one division per block: which row slot and which part of the row
  const int b = (int)blockIdx.x - ce_blocks;
  const long long slot = b / x.px;
  const int u = ((b - (int)slot * x.px) << x.tx_log2) +
                (threadIdx.x & ((1 << x.tx_log2) - 1));
  if (u >= x.units) return;
  const long long rpb = THREADS >> x.tx_log2;
  for (long long row = slot * rpb + (threadIdx.x >> x.tx_log2); row < p.V;
       row += x.slots * rpb)
    proximal_unit(p, x, row, u, mom);
}

template <int G, int PER>
int launch(const Solve& p, const Momentum& mom, cudaStream_t stream) {
  const long long ce_blocks = ((long long)p.V * G + THREADS - 1) / THREADS;
  const int W = p.N - p.C;
  Prox x{};
  x.units = W > 0 ? W / 4 + 2 : 0;
  while ((1 << x.tx_log2) < x.units && (1 << x.tx_log2) < THREADS)
    ++x.tx_log2;
  if (x.units > 0) {
    const int tx = 1 << x.tx_log2;
    const long long rpb = THREADS / tx;
    x.px = (x.units + tx - 1) / tx;
    x.slots = (p.V + rpb - 1) / rpb;
    if (x.slots > MAX_ROW_SLOTS) x.slots = MAX_ROW_SLOTS;
    const long long room = (0x7fffffffLL - ce_blocks) / x.px;
    if (x.slots > room) x.slots = room;
    const uintptr_t al = (uintptr_t)p.a & 15u;
    x.vec = ((uintptr_t)p.z_old & 15u) == al && ((uintptr_t)p.out & 15u) == al;
  }
  const long long blocks = ce_blocks + x.slots * x.px;
  if (x.units > 0 && x.slots < 1) return (int)cudaErrorInvalidValue;
  fista_zlast_kernel<G, PER><<<(unsigned)blocks, THREADS, 0, stream>>>(
      p, x, (int)ce_blocks, mom);
  return (int)cudaGetLastError();
}

// A group of MAX_GROUP lanes with PER columns each, PER counted down to
// the row's need.
template <int PER>
int launch_wide(const Solve& p, int per, const Momentum& mom,
                cudaStream_t stream) {
  if constexpr (PER > 1) {
    if (per < PER) return launch_wide<PER - 1>(p, per, mom, stream);
  }
  return launch<MAX_GROUP, PER>(p, mom, stream);
}

}  // namespace

// a, z_old, out: [V, N] f32; labels: [V] int32; mask: [V] f32; C classes in
// the first C columns. moms: n_steps host floats (the initial gradient step
// plus n_iters FISTA steps). More than 64 classes, or more than MAX_STEPS
// steps, are refused.
extern "C" int fista_zlast_f32(const float* a, const float* z_old,
                               const int* labels, const float* mask,
                               float* out, int V, int N, int C,
                               const float* moms, int n_steps, float step,
                               float nu, void* stream) {
  if (V < 1 || N < 1 || C < 1 || C > N || C > 64 || n_steps < 1 ||
      n_steps > MAX_STEPS || (long long)V * N >= (1LL << 40))
    return (int)cudaErrorInvalidValue;
  Momentum mom;
  for (int s = 0; s < n_steps; ++s) mom.v[s] = moms[s];
  const Solve p{a, z_old, labels, mask, out, V, N, C, n_steps, step, nu};
  cudaStream_t st = (cudaStream_t)stream;
  // G: the smallest power of two >= C, at most MAX_GROUP; then PER = C / G
  // rounded up (8 columns a lane at C = 64)
  if (C == 1) return launch<1, 1>(p, mom, st);
  if (C <= 2) return launch<2, 1>(p, mom, st);
  if (C <= 4) return launch<4, 1>(p, mom, st);
  return launch_wide<64 / MAX_GROUP>(p, (C + MAX_GROUP - 1) / MAX_GROUP, mom,
                                     st);
}
