// fista_zlast: the whole z_L FISTA solve of Eq. 7 in ONE launch.
// Replaces the Pallas kernel repro/kernels/fista_zlast.py:_fista_step_kernel,
// which the TPU path dispatches n_iters + 1 times.
//
// Every step of every element:
//   y      = z_cur + mom_s * (z_cur - z_prev)
//   g      = (softmax(y[:C]) - onehot(label)) * mask + nu * (y - a)  (j < C)
//          = nu * (y - a)                                           (j >= C)
//   z_next = y - step * g
// mom_s comes from the host's momentum schedule (exact f64, rounded to f32
// once), in a device buffer of n_steps floats that the wrapper fills once
// per step count: no step cap, and no launch reads host memory.
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
// bytes. With all h columns classes (block-pdADMM's CE route at d classes)
// each class column costs an expf and a division a step: the operations
// bound it.
//
// Three routes, by C; every one runs all steps in this one launch.
//
// Lane groups (C <= 64). Blocks [0, ce_blocks) take the class columns: a
// group of G lanes per row, G the smallest power of two >= C but at most
// MAX_GROUP (8), each lane holding z_prev, z_cur and a of its PER =
// ceil(C / G) columns in registers (PER <= 8 at C <= 64: no spills). The
// row's max and sum go through __shfl_xor_sync inside the group (masks
// cover the group's lanes only; a lane with no column gives -inf / 0) in
// one fixed butterfly order, so a second call gives the same bits. Groups
// wider than 8 lanes measured slower on the H100 at 15 and 40 classes:
// more of each step's dependent chain goes to shuffle levels, and more
// lanes sit idle.
//
// A block a row (C > 64). The row's class columns are striped over the
// block's threads (column j on thread j mod T); each step takes a
// block-wide max and sum: a shuffle butterfly in each warp, one pass
// through shared memory, and every thread adding the warps' partials in
// warp order, so the order is fixed and a second call gives the same bits.
// The arithmetic is written with _rn intrinsics in the plain version's
// order. Where the row's state lives:
//   - registers, C <= REG_CLASSES (2048): T = 256 threads, PER = ceil(C /
//     256) <= 8 columns a thread, z_prev, z_cur, a, y and e of each kept in
//     registers for all steps;
//   - shared memory, C <= SMEM_CLASSES (19349): T = 1024, z_prev, z_cur and
//     a of the row (12 bytes a column) in dynamic shared memory, up to
//     Hopper's 227 KB (232,448 bytes) a block less the reduction slots;
//   - global memory above that (streaming): z_cur in the row of `out`
//     itself, z_prev in a scratch row of the wrapper's [slots, C] buffer (a
//     block owns one slot and strides over the rows), a read where it lies.
// The last two share one kernel body over generic pointers. y and the
// exponentials are recomputed in each of a step's three passes, from the
// same operands by the same instructions, so each pass sees the same bits.
// The only limit kept is V * N < 2^40.
//
// The proximal columns (j >= C) are elementwise: a block of BT threads
// (the route's block size) covers BT >> tx_log2 rows with 1 << tx_log2
// threads a row and one 16-byte chunk a thread (float4 loads and stores),
// with a scalar head up to the row span's first 16-byte boundary and a
// scalar tail, found per row because odd widths move it; no integer
// division per element, and a grid-stride loop over rows past
// MAX_ROW_SLOTS. The arithmetic is written with _rn intrinsics in the plain
// version's order (no FMA contraction), so these columns equal it bit for
// bit. expf and IEEE division in the class part: no fast-math.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;                // the lane-group route's blocks
constexpr long long MAX_ROW_SLOTS = 65535;  // more rows: the grid strides
constexpr int MAX_GROUP = 8;   // lanes a row's class columns take at most
constexpr int LANE_CLASSES = 64;            // the lane-group route's widest
constexpr int WIDE_THREADS = 256;           // the register route's blocks
constexpr int WIDE_PER = 8;                 // its columns a thread at most
constexpr int REG_CLASSES = WIDE_THREADS * WIDE_PER;
constexpr int MEM_THREADS = 1024;           // shared-memory and streaming
constexpr int SMEM_LIMIT = 232448;          // Hopper's opt-in bytes a block
// the reduction slots (two floats a warp) are static shared memory
constexpr int SMEM_CLASSES =
    (SMEM_LIMIT - 2 * (MEM_THREADS / 32) * 4) / (3 * 4);

struct Solve {
  const float* a;
  const float* z_old;
  const int* labels;
  const float* mask;
  float* out;
  const float* moms;   // device, n_steps floats
  int V, N, C, n_steps;
  float step, nu;
};

// The proximal layout: each row's span of columns >= C in units of up to
// four elements; unit u < nb is the u-th 16-byte chunk, unit nb the head
// before the first 16-byte boundary, unit nb + 1 the tail.
struct Prox {
  int units;       // units of the widest row: W / 4 + 2 (0: no span)
  int tx_log2;     // threads per row: 1 << tx_log2 (<= the block's)
  int px;          // blocks per row
  long long slots; // row slots: a block holds BT >> tx_log2 of them
  int vec;         // a, z_old and out agree mod 16 bytes: float4 body
};

template <int G, int PER>
__device__ __forceinline__ void class_row(const Solve& p, long long row) {
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
    const float m_s = p.moms[s];
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
                                               const Solve& p) {
  float zp[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    zp[i] = z[i];
    z[i] = __fsub_rn(z[i], __fmul_rn(p.step,
                                     __fmul_rn(p.nu, __fsub_rn(z[i], av[i]))));
  }
  for (int s = 1; s < p.n_steps; ++s) {
    const float m = p.moms[s];
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
                                              long long row, int u) {
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
  proximal_steps(z, av, p);
  if (chunk) {
    *reinterpret_cast<float4*>(p.out + start) =
        make_float4(z[0], z[1], z[2], z[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < cnt) p.out[start + i] = z[i];
  }
}

// Proximal block b (counted from the first block after the class blocks)
// of a launch with BT threads a block.
template <int BT>
__device__ __forceinline__ void proximal_block(const Solve& p, const Prox& x,
                                               int b) {
  // one division per block: which row slot and which part of the row
  const long long slot = b / x.px;
  const int u = ((b - (int)slot * x.px) << x.tx_log2) +
                (threadIdx.x & ((1 << x.tx_log2) - 1));
  if (u >= x.units) return;
  const long long rpb = BT >> x.tx_log2;
  for (long long row = slot * rpb + (threadIdx.x >> x.tx_log2); row < p.V;
       row += x.slots * rpb)
    proximal_unit(p, x, row, u);
}

template <int G, int PER>
__global__ void __launch_bounds__(THREADS)
fista_zlast_kernel(Solve p, Prox x, int ce_blocks) {
  if ((int)blockIdx.x < ce_blocks) {
    const long long row =
        (long long)blockIdx.x * (THREADS / G) + threadIdx.x / G;
    if (row < p.V) class_row<G, PER>(p, row);
    return;
  }
  proximal_block<THREADS>(p, x, (int)blockIdx.x - ce_blocks);
}

// ---- a block a row (C > 64) ------------------------------------------------

// y = z + m(z − z₋), each operation rounded as the plain version rounds it
__device__ __forceinline__ float extrapolate(float zc, float zp, float m) {
  return __fadd_rn(zc, __fmul_rn(m, __fsub_rn(zc, zp)));
}

// z⁺ = y − step·((p − onehot)·mask + ν(y − a)), in the plain version's order
__device__ __forceinline__ float class_update(const Solve& p, float y,
                                              float e, float sum, float a,
                                              bool hit, float mk) {
  const float pj = __fdiv_rn(e, sum);
  const float g = __fadd_rn(__fmul_rn(__fsub_rn(pj, hit ? 1.f : 0.f), mk),
                            __fmul_rn(p.nu, __fsub_rn(y, a)));
  return __fsub_rn(y, __fmul_rn(p.step, g));
}

// The block's max of v (MAX) or sum (!MAX), the same bits on every thread:
// a butterfly in each warp, the warps' partials through red[], added in
// warp order. One __syncthreads; red[] is rewritten only after the next
// reduction's barrier, which every reader of it has passed.
template <int BT, bool MAX>
__device__ __forceinline__ float block_reduce(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = MAX ? fmaxf(v, w) : v + w;
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < BT / 32; ++w) r = MAX ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

// One row, its C class columns in registers: column t + k·WIDE_THREADS on
// thread t, k < PER.
template <int PER>
__device__ __forceinline__ void wide_row(const Solve& p, long long row,
                                         float* red_max, float* red_sum) {
  const int t = threadIdx.x;
  const long long base = row * p.N;
  float zp[PER], zc[PER], av[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int j = t + k * WIDE_THREADS;
    zc[k] = j < p.C ? p.z_old[base + j] : 0.f;
    zp[k] = zc[k];
    av[k] = j < p.C ? p.a[base + j] : 0.f;
  }
  const int lab = p.labels[row];
  const float mk = p.mask[row];
  for (int s = 0; s < p.n_steps; ++s) {
    const float m = p.moms[s];
    float y[PER], e[PER];
    float mx = -INFINITY;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      y[k] = extrapolate(zc[k], zp[k], m);
      if (t + k * WIDE_THREADS < p.C) mx = fmaxf(mx, y[k]);
    }
    mx = block_reduce<WIDE_THREADS, true>(mx, red_max);
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      e[k] = t + k * WIDE_THREADS < p.C ? expf(__fsub_rn(y[k], mx)) : 0.f;
      sum = __fadd_rn(sum, e[k]);
    }
    sum = block_reduce<WIDE_THREADS, false>(sum, red_sum);
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int j = t + k * WIDE_THREADS;
      zp[k] = zc[k];
      zc[k] = class_update(p, y[k], e[k], sum, av[k], j == lab, mk);
    }
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int j = t + k * WIDE_THREADS;
    if (j < p.C) p.out[base + j] = zc[k];
  }
}

template <int PER>
__global__ void __launch_bounds__(WIDE_THREADS)
fista_zlast_kernel_wide(Solve p, Prox x, int ce_blocks) {
  __shared__ float red[2][WIDE_THREADS / 32];
  if ((int)blockIdx.x < ce_blocks) {
    for (long long row = blockIdx.x; row < p.V; row += ce_blocks)
      wide_row<PER>(p, row, red[0], red[1]);
    return;
  }
  proximal_block<WIDE_THREADS>(p, x, (int)blockIdx.x - ce_blocks);
}

// One row whose state lives in memory: zp and zc (written), av (read), each
// C floats, shared or global; column j on thread j mod MEM_THREADS, which
// alone touches it, so the buffers need no barrier of their own.
__device__ __forceinline__ void mem_row(const Solve& p, long long row,
                                        float* zp, float* zc, const float* av,
                                        float* red_max, float* red_sum) {
  const int lab = p.labels[row];
  const float mk = p.mask[row];
  for (int s = 0; s < p.n_steps; ++s) {
    const float m = p.moms[s];
    float mx = -INFINITY;
    for (int j = threadIdx.x; j < p.C; j += MEM_THREADS)
      mx = fmaxf(mx, extrapolate(zc[j], zp[j], m));
    mx = block_reduce<MEM_THREADS, true>(mx, red_max);
    float sum = 0.f;
    for (int j = threadIdx.x; j < p.C; j += MEM_THREADS)
      sum = __fadd_rn(sum, expf(__fsub_rn(extrapolate(zc[j], zp[j], m), mx)));
    sum = block_reduce<MEM_THREADS, false>(sum, red_sum);
    for (int j = threadIdx.x; j < p.C; j += MEM_THREADS) {
      const float z = zc[j];
      const float y = extrapolate(z, zp[j], m);
      const float e = expf(__fsub_rn(y, mx));
      zp[j] = z;
      zc[j] = class_update(p, y, e, sum, av[j], j == lab, mk);
    }
  }
}

// scratch == nullptr: the row's state in dynamic shared memory (3·C
// floats); else streaming, z_prev in scratch row blockIdx.x ([ce_blocks, C]).
__global__ void __launch_bounds__(MEM_THREADS)
fista_zlast_kernel_wide_mem(Solve p, Prox x, int ce_blocks, float* scratch) {
  __shared__ float red[2][MEM_THREADS / 32];
  extern __shared__ float row_smem[];
  if ((int)blockIdx.x < ce_blocks) {
    for (long long row = blockIdx.x; row < p.V; row += ce_blocks) {
      const long long base = row * p.N;
      float *zp, *zc;
      const float* av;
      if (scratch == nullptr) {
        zp = row_smem;
        zc = row_smem + p.C;
        float* as = row_smem + 2 * p.C;
        for (int j = threadIdx.x; j < p.C; j += MEM_THREADS)
          as[j] = p.a[base + j];
        av = as;
      } else {
        zp = scratch + (long long)blockIdx.x * p.C;
        zc = p.out + base;
        av = p.a + base;
      }
      for (int j = threadIdx.x; j < p.C; j += MEM_THREADS) {
        const float z = p.z_old[base + j];
        zc[j] = z;
        zp[j] = z;
      }
      mem_row(p, row, zp, zc, av, red[0], red[1]);
      if (scratch == nullptr)
        for (int j = threadIdx.x; j < p.C; j += MEM_THREADS)
          p.out[base + j] = zc[j];
    }
    return;
  }
  proximal_block<MEM_THREADS>(p, x, (int)blockIdx.x - ce_blocks);
}

// ---- launches -------------------------------------------------------------

// The proximal layout for blocks of bt threads behind ce_blocks class
// blocks; the launch's whole block count in *blocks (0: refused).
Prox prox_plan(const Solve& p, int bt, long long ce_blocks,
               long long* blocks) {
  const int W = p.N - p.C;
  Prox x{};
  x.units = W > 0 ? W / 4 + 2 : 0;
  while ((1 << x.tx_log2) < x.units && (1 << x.tx_log2) < bt) ++x.tx_log2;
  if (x.units > 0) {
    const int tx = 1 << x.tx_log2;
    const long long rpb = bt / tx;
    x.px = (x.units + tx - 1) / tx;
    x.slots = (p.V + rpb - 1) / rpb;
    if (x.slots > MAX_ROW_SLOTS) x.slots = MAX_ROW_SLOTS;
    const long long room = (0x7fffffffLL - ce_blocks) / x.px;
    if (x.slots > room) x.slots = room;
    const uintptr_t al = (uintptr_t)p.a & 15u;
    x.vec = ((uintptr_t)p.z_old & 15u) == al && ((uintptr_t)p.out & 15u) == al;
  }
  *blocks = (x.units > 0 && x.slots < 1) ? 0 : ce_blocks + x.slots * x.px;
  return x;
}

template <int G, int PER>
int launch(const Solve& p, cudaStream_t stream) {
  const long long ce_blocks = ((long long)p.V * G + THREADS - 1) / THREADS;
  long long blocks;
  const Prox x = prox_plan(p, THREADS, ce_blocks, &blocks);
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  fista_zlast_kernel<G, PER><<<(unsigned)blocks, THREADS, 0, stream>>>(
      p, x, (int)ce_blocks);
  return (int)cudaGetLastError();
}

// A group of MAX_GROUP lanes with PER columns each, PER counted down to
// the row's need.
template <int PER>
int launch_lanes(const Solve& p, int per, cudaStream_t stream) {
  if constexpr (PER > 1) {
    if (per < PER) return launch_lanes<PER - 1>(p, per, stream);
  }
  return launch<MAX_GROUP, PER>(p, stream);
}

long long row_blocks(const Solve& p) {
  return p.V < MAX_ROW_SLOTS ? p.V : MAX_ROW_SLOTS;
}

// The register route with PER columns a thread, counted down to the row's
// need.
template <int PER>
int launch_wide(const Solve& p, int per, cudaStream_t stream) {
  if constexpr (PER > 1) {
    if (per < PER) return launch_wide<PER - 1>(p, per, stream);
  }
  const long long ce_blocks = row_blocks(p);
  long long blocks;
  const Prox x = prox_plan(p, WIDE_THREADS, ce_blocks, &blocks);
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  fista_zlast_kernel_wide<PER><<<(unsigned)blocks, WIDE_THREADS, 0, stream>>>(
      p, x, (int)ce_blocks);
  return (int)cudaGetLastError();
}

int launch_mem(const Solve& p, float* scratch, int scratch_rows,
               cudaStream_t stream) {
  long long ce_blocks = row_blocks(p);
  size_t smem = 0;
  if (scratch == nullptr) {
    smem = (size_t)3 * p.C * sizeof(float);
    const cudaError_t e = cudaFuncSetAttribute(
        fista_zlast_kernel_wide_mem,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  } else if (scratch_rows < ce_blocks) {
    ce_blocks = scratch_rows;
  }
  long long blocks;
  const Prox x = prox_plan(p, MEM_THREADS, ce_blocks, &blocks);
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  fista_zlast_kernel_wide_mem<<<(unsigned)blocks, MEM_THREADS, smem,
                                stream>>>(p, x, (int)ce_blocks, scratch);
  return (int)cudaGetLastError();
}

}  // namespace

// a, z_old, out: [V, N] f32; labels: [V] int32; mask: [V] f32; C classes in
// the first C columns (any C from 1 to N). moms: n_steps device floats (the
// initial gradient step plus n_iters FISTA steps). scratch: [scratch_rows,
// C] device floats, read only by the streaming route (C > SMEM_CLASSES,
// where it may not be null); its rows bound that route's class blocks.
extern "C" int fista_zlast_f32(const float* a, const float* z_old,
                               const int* labels, const float* mask,
                               float* out, float* scratch, int scratch_rows,
                               int V, int N, int C, const float* moms,
                               int n_steps, float step, float nu,
                               void* stream) {
  if (V < 1 || N < 1 || C < 1 || C > N || n_steps < 1 || moms == nullptr ||
      (long long)V * N >= (1LL << 40))
    return (int)cudaErrorInvalidValue;
  const Solve p{a, z_old, labels, mask, out, moms, V, N, C, n_steps, step,
                nu};
  cudaStream_t st = (cudaStream_t)stream;
  // lane groups: G the smallest power of two >= C, at most MAX_GROUP; then
  // PER = C / G rounded up (8 columns a lane at C = 64)
  if (C == 1) return launch<1, 1>(p, st);
  if (C <= 2) return launch<2, 1>(p, st);
  if (C <= 4) return launch<4, 1>(p, st);
  if (C <= LANE_CLASSES)
    return launch_lanes<LANE_CLASSES / MAX_GROUP>(
        p, (C + MAX_GROUP - 1) / MAX_GROUP, st);
  if (C <= REG_CLASSES)
    return launch_wide<WIDE_PER>(p, (C + WIDE_THREADS - 1) / WIDE_THREADS,
                                 st);
  if (C <= SMEM_CLASSES) return launch_mem(p, nullptr, 0, st);
  if (scratch == nullptr || scratch_rows < 1)
    return (int)cudaErrorInvalidValue;
  return launch_mem(p, scratch, scratch_rows, st);
}
