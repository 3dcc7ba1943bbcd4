"""Plain PyTorch versions of the port's kernels (pdADMM-G and -G-Q paths).

Same signatures and layouts as ``repro.kernels.ref``. A CPU tensor takes
these (``kernels/ops.py``); on the card only the tests and ``chip_smoke.py``
call them, to hold each CUDA kernel against its plain version.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantize import mul_add


def fused_linear_ref(p, W, b=None, z=None, *, mode: str = "linear"):
    """p @ W + b (``b=None``: no bias), or z - (p @ W + b) in residual mode.
    Accepts an optional leading layer axis."""
    out = p.float() @ W.float()
    if b is not None:
        out = out + b.float().unsqueeze(-2)
    if mode == "residual":
        out = z.float() - out
    return out.to(p.dtype)


def admm_pgrad_ref(r, W, u, p, q, *, nu: float, rho: float):
    g = (-nu) * (r.float() @ W.float().mT) + u.float() \
        + rho * (p.float() - q.float())
    return g.to(p.dtype)


def backtrack_resnorm_ref(r0, d, W, active=None):
    """||r0 − d @ W||² in f32, per layer over an optional leading axis
    (f32 [L] or 0-d). ``active`` ([L] or 0-d, any dtype; None = all): an
    inactive layer's value is 0, as the kernel writes it."""
    r = r0.float() - d.float() @ W.float()
    out = (r * r).sum(dim=(-2, -1))
    if active is not None:
        out = torch.where(active.to(torch.bool), out, torch.zeros_like(out))
    return out


def grid_project_ref(x, grid):
    """Nearest point of ``grid``: fma(index(x), step, lo) in x's dtype."""
    return mul_add(grid.index(x), grid.step_in(x.dtype), grid.lo_in(x.dtype),
                   x.dtype)


def grid_encode_ref(x, grid):
    """Integer codes, uint8 for <= 8 bits and uint16 above (through int32:
    the index is at most 65535)."""
    return grid.index(x).to(torch.int32).to(grid.code_dtype)


def grid_decode_ref(codes, grid, out_dtype=torch.float32):
    """lo + codes·step, one rounding, computed for f32 and cast to
    ``out_dtype`` (the reference decodes in f32 and casts)."""
    f32 = torch.float32
    return mul_add(codes.to(torch.int32), grid.step_in(f32),
                   grid.lo_in(f32), f32).to(out_dtype)


def relu_zupdate_ref(a, q, z_old):
    from repro_torch.core.subproblems import update_z_hidden
    return update_z_hidden(a.float(), q.float(), z_old.float(),
                           1.0).to(a.dtype)


def fista_zlast_ref(a, z_old, labels, label_mask, *, nu: float,
                    n_iters: int = 15, n_classes=None):
    """The shared ``subproblems.fista_ce`` loop (masked CE over the first
    ``n_classes`` columns + proximal term, Nesterov momentum)."""
    from repro_torch.core.subproblems import fista_ce
    return fista_ce(a, z_old, labels, label_mask, nu, n_iters, n_classes)
