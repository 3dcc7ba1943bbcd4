"""CUDA kernel wrapper: ||r0 − d @ W||² per layer, the data-fit term of φ at
one trial of the projected (pdADMM-G-Q) p-update.

Replaces ``repro/kernels/backtrack_phi.py:backtrack_resnorm`` (Pallas body
``_resnorm_kernel``). Source: ``csrc/backtrack_resnorm.cu`` on the 3xTF32
tile core ``csrc/matmul_tf32x3.cuh`` and the row-parallel core
``csrc/matmul_rows.cuh``.

What bounds it on the H100: operations for the hidden layers. The ×8 block
d [8, 2485, 1000] @ W [8, 1000, 1000] is 39.8 GFLOP against 175 MB of
operands: 0.24 ms as three TF32 passes at 495 TFLOP/s (0.59 ms as SIMT f32
at 67), 0.05 ms at 3.35 TB/s. The last layer's [2485, 1000] @ [1000, 7] is
bytes-bound (10 MB, about 3 µs).

Design, by ``route(N)``: for N > 16 the 3xTF32 tensor-core tile (three TF32
passes, about 22 mantissa bits, 128×128 output tiles); for N ≤ 16 a
row-parallel f32 kernel (Wᵀ in shared memory, each warp walking four rows
of d). The product stays in registers; the epilogue forms r0 − acc,
squares and reduces it inside the block and writes one partial per
(layer, block) (``partials_per_layer``); a second launch sums each layer's
partials in a fixed order (no atomics, so the accept test sees the same
bits on every run). ``blockIdx.z`` walks the layers, so the ×8 block is one
call. An optional device-side ``active`` mask skips the layers whose
backtracking search has already stopped: their blocks write 0 and return
before any load, so the 12 sync-free trials cost one full product only for
the layers still searching.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

launches = 0
NARROW = 16        # rows::MAX_N in csrc/matmul_rows.cuh
TILE = 128         # tf32x3::BM = BN in csrc/matmul_tf32x3.cuh
ROW_BLOCK = 32     # rows::BLOCK_ROWS: rows of d per row-parallel block


def route(N: int) -> str:
    """The kernel's route for an output of N columns: "tensor_cores"
    (3xTF32) or "rows" (the row-parallel f32 kernel)."""
    return "rows" if N <= NARROW else "tensor_cores"


def partials_per_layer(M: int, N: int) -> int:
    """Pass 1's blocks per layer on ``route(N)``: one partial each."""
    if route(N) == "rows":
        return -(-M // ROW_BLOCK)
    return -(-M // TILE) * -(-N // TILE)


def backtrack_resnorm(r0, d, W, active=None):
    """r0: [..., M, N], d: [..., M, K], W: [..., K, N] float32 (at most one
    leading layer axis, the same on every operand); ``active``: int32 of
    the leading shape ([L] or 0-d) or None. Returns float32 of the leading
    shape: one ||r0 − d W||² per layer, 0 for an inactive layer."""
    global launches
    if d.dim() not in (2, 3) or W.dim() != d.dim():
        raise ValueError(f"d, W: expected 2-D or 3-D with equal rank, got "
                         f"{tuple(d.shape)}, {tuple(W.shape)}")
    lead = tuple(d.shape[:-2])
    M, K = d.shape[-2:]
    N = W.shape[-1]
    build.require(d, "d")
    build.require(W, "W", lead + (K, N))
    build.require(r0, "r0", lead + (M, N))
    if active is not None:
        build.require(active, "active", lead, torch.int32)
    batch = lead[0] if lead else 1
    per_layer = partials_per_layer(M, N)
    partials = torch.empty((batch, per_layer), dtype=torch.float32,
                           device=d.device)
    out = torch.empty(lead, dtype=torch.float32, device=d.device)
    err = build.library().backtrack_resnorm_f32(
        r0.data_ptr(), d.data_ptr(), W.data_ptr(),
        None if active is None else active.data_ptr(), partials.data_ptr(),
        out.data_ptr(), batch, M, K, N, M * N, M * K, K * N,
        int(route(N) == "tensor_cores"), per_layer, build.stream_handle(d))
    build.check(err, "backtrack_resnorm")
    launches += 1
    return out
