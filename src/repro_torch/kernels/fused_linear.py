"""CUDA kernel wrapper: z = p @ W + b and its residual form r = z - (p @ W + b).

Replaces ``repro/kernels/fused_linear.py:fused_linear`` (Pallas body
``_matmul_kernel``). Source: ``csrc/fused_linear.cu`` on the 3xTF32 tile
core ``csrc/matmul_tf32x3.cuh``.

What bounds it on the H100: operations. The product has 2·M·K·N flops
against (M·K + K·N + 2·M·N)·4 bytes — about 285 flops per byte for the
layer-0 [2485, 5732] @ [5732, 1000]. The reference is f32, and a single
TF32 pass keeps only 11 bits, so the kernel runs three TF32 passes on the
tensor cores (p and W each split into hi + lo; lo·hi + hi·lo + hi·hi
accumulated in f32, about 22 mantissa bits): its ceiling is 495/3 = 165
TFLOP/s of f32 products, against 67 TFLOP/s of SIMT f32 FMAs.

Design: 128×128 output tiles, two warpgroups issuing wgmma m64n128k8:
f32 slabs of p and W come through a four-stage cp.async ring, all threads
split W's slab into hi/lo tiles in shared memory under the previous slab's
products, and each thread splits its own p fragments in registers (wgmma
takes A from registers). Where the grid would leave SMs idle for a second
wave (layer 0), K is split into parts (``k_splits``) whose partial
products a second kernel adds in a fixed order. The bias/residual
epilogue is applied in registers and the product never goes to device
memory. ``blockIdx.z`` walks the layers of the stacked hidden
block, so the ×8 block is one launch. Ragged and unaligned edges are
handled in the copies (4-byte copies where a row is not 16-byte aligned,
zero-fill past the end), which replaces the TPU path's pad-to-tile plan.
Outputs of at most 16 columns (the last layer) take the row-parallel f32
core ``csrc/matmul_rows.cuh`` instead: bound by the bytes of p.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build

launches = 0
TILE, SLAB, NARROW_N = 128, 32, 16   # csrc: tf32x3::BM = BN, BK; rows::MAX_N


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def k_splits(batch: int, M: int, N: int, K: int, n_sm: int) -> int:
    """Parts to split K into so that the tensor-core grid fills the card
    evenly: the s in 1..4 with the fewest waves of one block per SM per
    unit of work, ceil(tiles·s / n_sm) / s, taken only where it saves at
    least a fifth over s = 1 (the parts' round trip through device memory
    costs the rest) and each part keeps at least 16 slabs of K."""
    if N <= NARROW_N:
        return 1
    tiles = batch * -(-M // TILE) * -(-N // TILE)
    slabs = -(-K // SLAB)
    waves = {s: -(-tiles * s // n_sm) / s for s in range(1, 5)
             if s == 1 or slabs >= 16 * s}
    best = min(waves, key=lambda s: (waves[s], s))
    return best if waves[best] <= 0.8 * waves[1] else 1


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
    splits = k_splits(batch, M, N, K, _sm_count(p.device))
    part = (torch.empty((splits, batch, M, N), dtype=torch.float32,
                        device=p.device) if splits > 1 else None)
    err = build.library().fused_linear_f32(
        p.data_ptr(), W.data_ptr(), None if b is None else b.data_ptr(),
        z.data_ptr() if residual else None, out.data_ptr(),
        batch, M, K, N, M * K, K * N, N, M * N, M * N, int(residual),
        None if part is None else part.data_ptr(), splits,
        build.stream_handle(p))
    build.check(err, "fused_linear")
    launches += 1
    return out
