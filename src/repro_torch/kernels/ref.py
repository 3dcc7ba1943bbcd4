"""Plain PyTorch versions of the four kernels on the pdADMM-G path.

Same signatures and layouts as ``repro.kernels.ref``. A CPU tensor takes
these (``kernels/ops.py``); on the card only the tests and ``chip_smoke.py``
call them, to hold each CUDA kernel against its plain version.
"""
from __future__ import annotations

import torch


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
