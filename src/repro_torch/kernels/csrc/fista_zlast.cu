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
//
// The row width N may be any size; only the first C columns (the classes)
// couple through the softmax. The launch has two parts:
//   * blocks [0, ce_blocks): one thread owns one row's C class columns for
//     every step, with z_prev, z_cur and a in registers (CAP >= C);
//   * the remaining blocks: one thread per element of a column >= C. Those
//     columns follow only the proximal flow, which is elementwise, so each
//     runs all steps in three registers. Their arithmetic is written with
//     _rn intrinsics in the plain version's operation order (no FMA
//     contraction), so they equal it bit for bit.
// The distributed runtime's head-folded last layer is [V, h] with C classes
// (h = 1000, C = 7 at the paper's size): almost all of it is proximal.
// expf and IEEE division in the class part: no fast-math.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_STEPS = 256;
constexpr int THREADS = 128;

struct Momentum {
  float v[MAX_STEPS];
};

template <int CAP>
__device__ void class_columns(const float* __restrict__ a,
                              const float* __restrict__ z_old,
                              const int* __restrict__ labels,
                              const float* __restrict__ mask,
                              float* __restrict__ out, int row, int N, int C,
                              int n_steps, float step, float nu,
                              const Momentum& mom) {
  const long long base = (long long)row * N;
  float zp[CAP], zc[CAP], av[CAP];
#pragma unroll
  for (int j = 0; j < CAP; ++j) {
    const bool in = j < C;
    zc[j] = in ? z_old[base + j] : 0.f;
    zp[j] = zc[j];
    av[j] = in ? a[base + j] : 0.f;
  }
  const int lab = labels[row];
  const float mk = mask[row];

  for (int s = 0; s < n_steps; ++s) {
    const float m_s = mom.v[s];
    float y[CAP];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < CAP; ++j) {
      y[j] = zc[j] + m_s * (zc[j] - zp[j]);
      if (j < C) mx = fmaxf(mx, y[j]);
    }
    float e[CAP];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < CAP; ++j) {
      e[j] = j < C ? expf(y[j] - mx) : 0.f;
      sum += e[j];
    }
#pragma unroll
    for (int j = 0; j < CAP; ++j) {
      const float pj = e[j] / sum;
      const float oh = j == lab ? 1.f : 0.f;
      const float g = (pj - oh) * mk + nu * (y[j] - av[j]);
      zp[j] = zc[j];
      zc[j] = y[j] - step * g;
    }
  }
#pragma unroll
  for (int j = 0; j < CAP; ++j)
    if (j < C) out[base + j] = zc[j];
}

// One element of a column >= C: z⁺ = y − step·(ν(y − a)), y = z + m(z − z₋),
// each operation rounded on its own as the plain version rounds it.
__device__ void proximal_element(const float* __restrict__ a,
                                 const float* __restrict__ z_old,
                                 float* __restrict__ out, long long k, int N,
                                 int C, int n_steps, float step, float nu,
                                 const Momentum& mom) {
  const int width = N - C;
  const long long row = k / width;
  const long long idx = row * N + C + (k - row * width);
  const float av = a[idx];
  float zp = z_old[idx], zc = zp;
  for (int s = 0; s < n_steps; ++s) {
    const float y = s == 0 ? zc
                           : __fadd_rn(zc, __fmul_rn(mom.v[s],
                                                     __fsub_rn(zc, zp)));
    const float g = __fmul_rn(nu, __fsub_rn(y, av));
    zp = zc;
    zc = __fsub_rn(y, __fmul_rn(step, g));
  }
  out[idx] = zc;
}

template <int CAP>
__global__ void __launch_bounds__(THREADS)
fista_zlast_kernel(const float* __restrict__ a,
                   const float* __restrict__ z_old,
                   const int* __restrict__ labels,
                   const float* __restrict__ mask, float* __restrict__ out,
                   int V, int N, int C, int n_steps, float step, float nu,
                   int ce_blocks, Momentum mom) {
  if ((int)blockIdx.x < ce_blocks) {
    const int row = blockIdx.x * THREADS + threadIdx.x;
    if (row < V)
      class_columns<CAP>(a, z_old, labels, mask, out, row, N, C, n_steps,
                         step, nu, mom);
    return;
  }
  const long long k =
      (long long)(blockIdx.x - ce_blocks) * THREADS + threadIdx.x;
  if (k < (long long)V * (N - C))
    proximal_element(a, z_old, out, k, N, C, n_steps, step, nu, mom);
}

template <int CAP>
void launch(const float* a, const float* z_old, const int* labels,
            const float* mask, float* out, int V, int N, int C, int n_steps,
            float step, float nu, const Momentum& mom, cudaStream_t stream) {
  const int ce_blocks = (V + THREADS - 1) / THREADS;
  const long long prox = (long long)V * (N - C);
  const long long blocks = ce_blocks + (prox + THREADS - 1) / THREADS;
  fista_zlast_kernel<CAP><<<(unsigned)blocks, THREADS, 0, stream>>>(
      a, z_old, labels, mask, out, V, N, C, n_steps, step, nu, ce_blocks,
      mom);
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
  if (V < 1 || N < 1 || C < 1 || C > N || n_steps < 1 ||
      n_steps > MAX_STEPS || (long long)V * N >= (1LL << 40))
    return (int)cudaErrorInvalidValue;
  Momentum mom;
  for (int s = 0; s < n_steps; ++s) mom.v[s] = moms[s];
  cudaStream_t st = (cudaStream_t)stream;
  if (C <= 8)
    launch<8>(a, z_old, labels, mask, out, V, N, C, n_steps, step, nu, mom, st);
  else if (C <= 16)
    launch<16>(a, z_old, labels, mask, out, V, N, C, n_steps, step, nu, mom, st);
  else if (C <= 32)
    launch<32>(a, z_old, labels, mask, out, V, N, C, n_steps, step, nu, mom, st);
  else if (C <= 64)
    launch<64>(a, z_old, labels, mask, out, V, N, C, n_steps, step, nu, mom, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
