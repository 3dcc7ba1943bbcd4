"""CUDA kernel wrapper: the p-subproblem gradient with the fused ADMM epilogue

    g = -ν (r @ Wᵀ) + u + ρ (p - q)        (r = z - pW - b from fused_linear)

Replaces ``repro/kernels/admm_pgrad.py:admm_pgrad`` (its nested Pallas body
``kernel``). Source: ``csrc/admm_pgrad.cu`` on the shared tile core
``csrc/matmul_tile.cuh``.

What bounds it on the H100: f32 operations for the hidden layers
(2·V·n_out·n_in flops; [2485, 1000] @ [1000, 1000] is 4.97 GFLOP per layer
against 5·10 MB of operands), bytes for the last layer (n_out = 7: three
[V, 1000] reads and one write dominate). SIMT f32 FMAs (fused_linear's
3xTF32 tile core is the next step for it).

Design: the 64×64×16 register-tiled SIMT core (matmul_tile.cuh), with the B
tile loaded from rows of W, so Wᵀ is never materialised; u, p and q are
read once in the epilogue and the product never goes to device memory.
``blockIdx.z`` walks the stacked layers.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

launches = 0


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
        V * n_in, float(nu), float(rho), build.stream_handle(r))
    build.check(err, "admm_pgrad")
    launches += 1
    return out
