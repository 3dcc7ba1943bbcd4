// fista_zlast: the whole z_L FISTA solve of Eq. 7 in ONE launch.
// Replaces the Pallas kernel repro/kernels/fista_zlast.py:_fista_step_kernel,
// which the TPU path dispatches n_iters + 1 times.
//
// Rows are independent, so one thread owns one row for every step, with
// z_prev, z_cur and a held in registers (CAP >= the row width). Each step:
//   y      = z_cur + mom_s * (z_cur - z_prev)
//   p      = softmax(y[:C])                       (0 on columns >= C)
//   g      = (p - onehot(label)) * mask + nu * (y - a)
//   z_next = y - step * g
// mom_s comes from the host's momentum schedule (exact f64, passed as f32).
// expf and IEEE division: no fast-math.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_STEPS = 256;

struct Momentum {
  float v[MAX_STEPS];
};

template <int CAP>
__global__ void fista_zlast_kernel(const float* __restrict__ a,
                                   const float* __restrict__ z_old,
                                   const int* __restrict__ labels,
                                   const float* __restrict__ mask,
                                   float* __restrict__ out, int V, int N,
                                   int C, int n_steps, float step, float nu,
                                   Momentum mom) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= V) return;
  const long long base = (long long)row * N;

  float zp[CAP], zc[CAP], av[CAP];
#pragma unroll
  for (int j = 0; j < CAP; ++j) {
    const bool in = j < N;
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
    if (j < N) out[base + j] = zc[j];
}

template <int CAP>
void launch(const float* a, const float* z_old, const int* labels,
            const float* mask, float* out, int V, int N, int C, int n_steps,
            float step, float nu, const Momentum& mom, cudaStream_t stream) {
  const int threads = 128;
  fista_zlast_kernel<CAP><<<(V + threads - 1) / threads, threads, 0, stream>>>(
      a, z_old, labels, mask, out, V, N, C, n_steps, step, nu, mom);
}

}  // namespace

// a, z_old, out: [V, N] f32; labels: [V] int32; mask: [V] f32.
// moms: n_steps host floats (the initial gradient step plus n_iters FISTA
// steps). Widths above 64 or more than MAX_STEPS steps are refused.
extern "C" int fista_zlast_f32(const float* a, const float* z_old,
                               const int* labels, const float* mask,
                               float* out, int V, int N, int C,
                               const float* moms, int n_steps, float step,
                               float nu, void* stream) {
  if (V < 1 || N < 1 || C < 1 || C > N || n_steps < 1 ||
      n_steps > MAX_STEPS)
    return (int)cudaErrorInvalidValue;
  Momentum mom;
  for (int s = 0; s < n_steps; ++s) mom.v[s] = moms[s];
  cudaStream_t st = (cudaStream_t)stream;
  if (N <= 8)
    launch<8>(a, z_old, labels, mask, out, V, N, C, n_steps, step, nu, mom, st);
  else if (N <= 16)
    launch<16>(a, z_old, labels, mask, out, V, N, C, n_steps, step, nu, mom, st);
  else if (N <= 32)
    launch<32>(a, z_old, labels, mask, out, V, N, C, n_steps, step, nu, mom, st);
  else if (N <= 64)
    launch<64>(a, z_old, labels, mask, out, V, N, C, n_steps, step, nu, mom, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
