"""CUDA kernel wrapper: the p-subproblem gradient with the fused ADMM epilogue

    g = -ν (r @ Wᵀ) + u + ρ (p - q)        (r = z - pW - b from fused_linear)

Replaces ``repro/kernels/admm_pgrad.py:admm_pgrad`` (its nested Pallas body
``kernel``). Source: ``csrc/admm_pgrad.cu`` on the 3xTF32 tile core
``csrc/matmul_tf32x3.cuh``, and its own streaming kernel for narrow r.

What bounds it on the H100: operations for the hidden layers
(2·V·n_out·n_in flops; [2485, 1000] @ [1000, 1000]ᵀ is 4.97 GFLOP per layer
against 5·10 MB of operands), bytes for the last layer (n_out = 7: three
[V, 1000] reads and one write, 39.8 MB, against 98 KB of r and W).

Design, by ``route(n_out)``: for n_out > 16 the 3xTF32 tensor-core tile
(three TF32 passes, about 22 mantissa bits, 128×128 output tiles) with a
transposed B: the slabs are copied from rows of W, which are already
K-major, so Wᵀ is never formed; u, p and q are read once in its epilogue
and the product never goes to device memory. For n_out ≤ 16 a streaming
pass (``admm_pgrad_narrow``): a block stages a 128-column slice of W and
its rows of r in shared memory once, each thread keeps its 4 columns of W
in registers, and a warp streams one row of u, p, q and g as float4s (512
contiguous bytes an instruction), two rows in flight a thread, one wave of
blocks over the card's SMs; the sum runs f32 FMAs over k in ascending
order. ``blockIdx.z`` walks the stacked layers on both.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

launches = 0
NARROW = 16   # n_out at or below which the streaming route takes it


def route(n_out: int) -> str:
    """The kernel's route for r of width n_out: "tensor_cores" (3xTF32) or
    "simt" (the narrow last layer's f32 streaming pass)."""
    return "simt" if n_out <= NARROW else "tensor_cores"


def admm_pgrad(r, W, u, p, q, *, nu: float, rho: float):
    """r: [..., V, n_out], W: [..., n_in, n_out], u/p/q: [..., V, n_in]
    (at most one leading layer axis) -> g: [..., V, n_in] float32."""
    global launches
    if r.dim() not in (2, 3) or W.dim() != r.dim():
        raise ValueError(f"r, W: expected 2-D or 3-D with equal rank, got "
                         f"{tuple(r.shape)}, {tuple(W.shape)}")
    lead = tuple(r.shape[:-2])
    V, n_out = r.shape[-2:]
    n_in = W.shape[-2]
    build.require(r, "r")
    build.require(W, "W", lead + (n_in, n_out))
    for t, name in ((u, "u"), (p, "p"), (q, "q")):
        build.require(t, name, lead + (V, n_in))
    batch = lead[0] if lead else 1
    out = torch.empty(lead + (V, n_in), dtype=torch.float32, device=r.device)
    err = build.library().admm_pgrad_f32(
        r.data_ptr(), W.data_ptr(), u.data_ptr(), p.data_ptr(), q.data_ptr(),
        out.data_ptr(), batch, V, n_out, n_in, V * n_out, n_in * n_out,
        V * n_in, float(nu), float(rho), int(route(n_out) == "tensor_cores"),
        build.stream_handle(r))
    build.check(err, "admm_pgrad")
    launches += 1
    return out
