"""CUDA kernel wrapper: z = p @ W + b and its residual form r = z - (p @ W + b).

Replaces ``repro/kernels/fused_linear.py:fused_linear`` (Pallas body
``_matmul_kernel``). Source: ``csrc/fused_linear.cu`` on the shared tile
core ``csrc/matmul_tile.cuh``.

What bounds it on the H100: f32 operations. At the main path's shapes the
product has 2·V·K·N flops against (V·K + K·N + 2·V·N)·4 bytes — about
285 flops per byte for the layer-0 [2485, 5732] @ [5732, 1000] — far above
the card's f32 ridge (67 TFLOP/s ÷ 3.35 TB/s ≈ 20 flops per byte). The
reference is f32, so neither TF32 nor the tensor cores may be used and the
ceiling is the 67 TFLOP/s of the SIMT FMA pipes.

Design: 64×64 output tiles, BK = 16 slabs staged through shared memory,
4×4 outputs per thread in registers, so each loaded element feeds 4 FMAs
from registers; the bias/residual epilogue is applied in registers and the
product never goes to device memory. ``blockIdx.z`` walks the layers of the
stacked hidden block, so the ×8 block is one launch. Ragged edges are
masked in the loads, which replaces the TPU path's pad-to-tile plan.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

launches = 0


def fused_linear(p, W, b=None, z=None, *, mode: str = "linear"):
    """p: [..., M, K], W: [..., K, N], b: [..., N] or None, z: [..., M, N]
    (residual mode). At most one leading layer axis, the same on every
    operand. Returns [..., M, N] float32 on p's device."""
    global launches
    if mode not in ("linear", "residual"):
        raise ValueError(f"mode must be 'linear' or 'residual', got {mode!r}")
    if p.dim() not in (2, 3) or W.dim() != p.dim():
        raise ValueError(f"p, W: expected 2-D or 3-D with equal rank, got "
                         f"{tuple(p.shape)}, {tuple(W.shape)}")
    lead = tuple(p.shape[:-2])
    M, K = p.shape[-2:]
    N = W.shape[-1]
    build.require(p, "p")
    build.require(W, "W", lead + (K, N))
    if b is not None:
        build.require(b, "b", lead + (N,))
    if mode == "residual":
        if z is None:
            raise ValueError("residual mode needs z")
        build.require(z, "z", lead + (M, N))
    batch = lead[0] if lead else 1
    out = torch.empty(lead + (M, N), dtype=torch.float32, device=p.device)
    residual = mode == "residual"
    err = build.library().fused_linear_f32(
        p.data_ptr(), W.data_ptr(), None if b is None else b.data_ptr(),
        z.data_ptr() if residual else None, out.data_ptr(),
        batch, M, K, N, M * K, K * N, N, M * N, M * N, int(residual),
        build.stream_handle(p))
    build.check(err, "fused_linear")
    launches += 1
    return out
