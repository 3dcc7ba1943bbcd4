"""CUDA kernel wrapper: the closed-form ReLU z-update (Eq. 6), elementwise.

Replaces ``repro/kernels/relu_zupdate.py:relu_zupdate`` (Pallas body
``_zupdate_kernel``). Source: ``csrc/relu_zupdate.cu``.

What bounds it on the H100: bytes. It reads a, q, z_old and writes z —
16 bytes per element for about 20 flops — so at the stacked hidden block
[9, 2485, 1000] it moves 4 × 89.5 MB, about 0.11 ms at 3.35 TB/s.

Design: one grid-stride pass over the flattened tensor, coalesced, each
input read once and the output written once; both branch candidates and
their objectives stay in registers. The arithmetic uses round-to-nearest
intrinsics with IEEE division (no FMA contraction, no fast-math), so the
branch is chosen on the same objective values as the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

launches = 0


def relu_zupdate(a, q, z_old):
    """a, q, z_old: the same shape (any rank), float32 -> z of that shape."""
    global launches
    build.require(a, "a")
    build.require(q, "q", a.shape)
    build.require(z_old, "z_old", a.shape)
    out = torch.empty_like(a)
    err = build.library().relu_zupdate_f32(
        a.data_ptr(), q.data_ptr(), z_old.data_ptr(), out.data_ptr(),
        a.numel(), build.stream_handle(a))
    build.check(err, "relu_zupdate")
    launches += 1
    return out
