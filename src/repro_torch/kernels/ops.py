"""Dispatch for the port's kernels, by device alone.

A CPU tensor goes to the plain PyTorch version in ``kernels/ref.py``. Any
other tensor goes to the hand-written CUDA kernel, whose wrapper launches it
or raises (wrong device, dtype, shape or layout, or a launch error). There
is no policy switch and no fallback: on the card, the kernels are the path.

The TPU path's pad-to-tile plan has no counterpart: the CUDA kernels mask
their ragged edges themselves.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import (admm_pgrad as _pg, backtrack_phi as _bt,
                                 fista_zlast as _fz, fused_linear as _fl,
                                 quantize_kernel as _qk, ref,
                                 relu_zupdate as _zu)

# Kernel name -> its wrapper module. A module's ``launches`` is an int, or a
# dict keyed by kernel name where one module wraps several entry points.
KERNEL_MODULES = {
    "fused_linear": _fl,
    "admm_pgrad": _pg,
    "relu_zupdate": _zu,
    "fista_zlast": _fz,
    "backtrack_resnorm": _bt,
    "grid_project": _qk,
    "grid_encode": _qk,
    "grid_decode": _qk,
}


def launch_counts() -> dict:
    """Kernel name -> launches since the last reset (CUDA launches only)."""
    return {name: (mod.launches[name] if isinstance(mod.launches, dict)
                   else mod.launches)
            for name, mod in KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for name, mod in KERNEL_MODULES.items():
        if isinstance(mod.launches, dict):
            mod.launches[name] = 0
        else:
            mod.launches = 0


def _on_cpu(t) -> bool:
    return t.device.type == "cpu"


def fused_linear(p, W, b=None, z=None, *, mode="linear"):
    """p @ W + b (``b=None``: no bias) or z - (p @ W + b); optional leading
    layer axis."""
    if _on_cpu(p):
        return ref.fused_linear_ref(p, W, b, z, mode=mode)
    return _fl.fused_linear(p, W, b, z, mode=mode)


def admm_pgrad(r, W, u, p, q, *, nu, rho):
    """-ν (r @ Wᵀ) + u + ρ (p - q); optional leading layer axis."""
    if _on_cpu(r):
        return ref.admm_pgrad_ref(r, W, u, p, q, nu=nu, rho=rho)
    return _pg.admm_pgrad(r, W, u, p, q, nu=nu, rho=rho)


def relu_zupdate(a, q, z_old):
    """Eq.-6 ReLU z-update, elementwise over any shape (the stacked
    [L-1, V, h] block is one launch)."""
    if _on_cpu(a):
        return ref.relu_zupdate_ref(a, q, z_old)
    return _zu.relu_zupdate(a, q, z_old)


def fista_zlast(a, z_old, labels, label_mask, *, nu, n_iters=15,
                n_classes=None):
    """z_L solve (Eq. 7): min_z R(z;y) + (ν/2)||z − a||², R the masked CE
    over z[:, :n_classes] (default: the full width)."""
    if _on_cpu(a):
        return ref.fista_zlast_ref(a, z_old, labels, label_mask, nu=nu,
                                   n_iters=n_iters, n_classes=n_classes)
    C = a.shape[-1] if n_classes is None else int(n_classes)
    return _fz.fista_zlast(a, z_old, labels, label_mask, nu=float(nu),
                           n_iters=int(n_iters), n_classes=C)


def backtrack_resnorm(r0, d, W, active=None):
    """||r0 − d @ W||² per layer (f32 [L] or 0-d); ``active`` (bool or int,
    the leading shape) zeroes and skips the layers whose search stopped."""
    if _on_cpu(d):
        return ref.backtrack_resnorm_ref(r0, d, W, active)
    if active is not None:
        active = active.to(torch.int32)
    return _bt.backtrack_resnorm(r0, d, W, active)


def grid_project(x, grid):
    """Nearest point of ``grid``, elementwise over any shape."""
    if _on_cpu(x):
        return ref.grid_project_ref(x, grid)
    return _qk.grid_project(x, grid)


def grid_encode(x, grid):
    """Wire codes of x on ``grid`` (uint8 <= 8 bits, uint16 above)."""
    if _on_cpu(x):
        return ref.grid_encode_ref(x, grid)
    return _qk.grid_encode(x, grid)


def grid_decode(codes, grid, out_dtype=torch.float32):
    """Grid values of wire codes."""
    if _on_cpu(codes):
        return ref.grid_decode_ref(codes, grid, out_dtype)
    return _qk.grid_decode(codes, grid, out_dtype)
