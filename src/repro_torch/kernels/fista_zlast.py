"""CUDA kernel wrapper: the whole z_L FISTA solve (Eq. 7) in one launch.

Replaces ``repro/kernels/fista_zlast.py:fista_zlast`` / ``fista_step``
(Pallas body ``_fista_step_kernel``), which the TPU path dispatches
n_iters + 1 times. Source: ``csrc/fista_zlast.cu``.

What bounds it on the H100. At [V, C] (one host; C = 3..40 over the
paper's Table II datasets) the solve reads 12 bytes per element once, well
under a microsecond at cora's [2485, 7]: the launch and the 16 dependent
steps, each an ``expf``, a division and two row reductions, set the time.
At the distributed runtime's head-folded last layer [V, h] (h = 1000, C
classes) almost every column is proximal: 12 bytes per element against
109 separately rounded f32 operations over 16 steps, so the FP32
instruction rate bounds it about as tightly as the bytes. With every
column a class (block-pdADMM's CE route at d classes) the operations bound
it: an ``expf`` and a division a column and step.

Design: all n_iters + 1 steps inside one launch, on one of four routes by
the class count C (``route``):

- ``lanes`` (C <= 64): a group of G lanes per row (G the smallest power of
  two >= C, at most 8; a lane of 8 holds ceil(C / 8) columns, 8 at 64
  classes), each lane keeping z_prev, z_cur and a of its own columns in
  registers, with the row's max and sum reduced by warp shuffles inside
  the group in a fixed order;
- ``registers`` (C <= 2048), ``shared`` (C <= 19349) and ``streaming``
  (any wider row): a block a row, its class columns striped over the
  block's threads, each step's max and sum block-wide in a fixed order
  (warp shuffles, one pass through shared memory). The row's z_prev, z_cur
  and a stay in registers (256 threads, up to 8 columns each), or in
  shared memory (1024 threads, 12 bytes a column up to Hopper's 227 KB a
  block), or stream through global memory: z_cur in ``out``'s row, z_prev
  in a scratch buffer of ``STREAM_ROWS`` rows that the wrapper allocates
  (a block owns one and strides over the rows).

Every route is deterministic (a second call gives the same bits) and is
not bitwise the plain version on the class columns, whose sums run in
another order. The columns >= C follow only the proximal flow, which is
elementwise: each thread runs all steps on one 16-byte chunk of a row
(float4 loads and stores, a scalar head up to the row's first 16-byte
boundary and a scalar tail), with the plain version's roundings, so they
equal it bit for bit. Rows are independent, so this computes the same
iteration map as the TPU's per-step dispatches with one launch instead of
16. The momentum weights are data-independent: ``momentum_schedule`` on
the host, rounded to f32 once into a device buffer kept per device and
step count, so there is no step cap and no launch reads host memory.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build

LANE_CLASSES = 64       # the lane-group route's widest softmax
REG_CLASSES = 2048      # a block a row, the row in registers
SMEM_CLASSES = 19349    # ... in shared memory: (232448 - 256) // 12
STREAM_ROWS = 264       # the streaming route's scratch rows (2 x 132 SMs)
launches = 0
_schedules = {}         # (device, n_iters) -> f32 momentum weights there


def momentum_schedule(n_iters: int) -> list:
    """Extrapolation weights for the initial gradient step plus `n_iters`
    FISTA iterations: [0, (t_1−1)/t_2, ...], t_1 = 1 (exact f64)."""
    ms = [0.0]
    t = 1.0
    for _ in range(n_iters):
        t_new = (1.0 + math.sqrt(1.0 + 4.0 * t * t)) / 2.0
        ms.append((t - 1.0) / t_new)
        t = t_new
    return ms


def momentum_buffer(n_iters: int, device) -> torch.Tensor:
    """``momentum_schedule(n_iters)`` as f32 on ``device``, made once."""
    key = (str(device), n_iters)
    buf = _schedules.get(key)
    if buf is None:
        buf = torch.tensor(momentum_schedule(n_iters), dtype=torch.float32,
                           device=device)
        _schedules[key] = buf
    return buf


def route(n_classes: int) -> str:
    """Which of the kernel's routes takes a softmax over ``n_classes``."""
    if n_classes <= LANE_CLASSES:
        return "lanes"
    if n_classes <= REG_CLASSES:
        return "registers"
    return "shared" if n_classes <= SMEM_CLASSES else "streaming"


def fista_zlast(a, z_old, labels, label_mask, *, nu: float, n_iters: int,
                n_classes: int):
    """a, z_old: [V, N] float32 (any N); labels: [V] int; label_mask: [V]
    float32. Softmax-CE over the first `n_classes` columns (any count up to
    N); the rest follow only the proximal flow. Returns z_L: [V, N]
    float32."""
    global launches
    if a.dim() != 2:
        raise ValueError(f"a: expected [V, N], got {tuple(a.shape)}")
    V, N = a.shape
    if not 1 <= n_classes <= N:
        raise ValueError(f"n_classes must be in [1, {N}], got {n_classes}")
    build.require(a, "a")
    build.require(z_old, "z_old", (V, N))
    build.require(label_mask, "label_mask", (V,))
    labels = labels.to(torch.int32)
    build.require(labels, "labels", (V,), torch.int32)
    moms = momentum_buffer(int(n_iters), a.device)
    out = torch.empty_like(a)
    scratch = (torch.empty((min(V, STREAM_ROWS), n_classes),
                           dtype=torch.float32, device=a.device)
               if route(n_classes) == "streaming" else None)
    err = build.library().fista_zlast_f32(
        a.data_ptr(), z_old.data_ptr(), labels.data_ptr(),
        label_mask.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        0 if scratch is None else scratch.shape[0], V, N, int(n_classes),
        moms.data_ptr(), moms.numel(), 1.0 / (1.0 + nu), float(nu),
        build.stream_handle(a))
    build.check(err, "fista_zlast")
    launches += 1
    return out
