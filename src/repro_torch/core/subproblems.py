"""The pdADMM-G subproblem solvers (Appendix A of the paper).

Counterpart of ``repro.core.subproblems`` for the grid-free family. Layout
is node-major: p_l, q_l, z_l, u_l are [V, n], W_l is [n_in, n_out], b_l is
[n_out], and the linear map is z = p @ W + b.

Every solver also takes an optional leading layer axis ([L, V, n],
[L, n_in, n_out], [L, n_out]); scalars such as ``_dot`` then reduce over the
last two dims and give one value per layer. One function serves the
per-layer path and the layer-stacked path, standing in for ``jax.vmap``.

The projected (quantized) p-update needs the ``backtrack_resnorm`` kernel
and comes with pdADMM-G-Q in the port's next slice; ``update_p`` raises
``NotImplementedError`` for a grid until then.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.quantize import QuantGrid


def linear(p, W, b):
    return p @ W + b.unsqueeze(-2)


def _dot(a, b):
    """<a, b> over the last two dims (one value per stacked layer)."""
    return (a * b).sum(dim=(-2, -1))


def _col(s):
    """A per-layer scalar broadcast against [..., rows, cols] tensors."""
    return s[..., None, None]


def phi_first(p, W, b, z, nu):
    """φ(p_1, W_1, b_1, z_1) = (ν/2)||z - pW - b||² (first layer: p = X fixed)."""
    r = z - linear(p, W, b)
    return 0.5 * nu * _dot(r, r)


def phi(p, W, b, z, q_prev, u_prev, nu, rho):
    """φ(p_l, W_l, b_l, z_l, q_{l-1}, u_{l-1}) for l >= 2."""
    r = z - linear(p, W, b)
    d = p - q_prev
    return 0.5 * nu * _dot(r, r) + _dot(u_prev, d) + 0.5 * rho * _dot(d, d)


def grad_p(p, W, b, z, q_prev, u_prev, nu, rho):
    """∇_p φ = -ν (z - pW - b) Wᵀ + u + ρ(p - q)."""
    r = z - linear(p, W, b)
    return -nu * (r @ W.mT) + u_prev + rho * (p - q_prev)


def grad_W(p, W, b, z, nu):
    """∇_W φ = -ν pᵀ (z - pW - b)."""
    r = z - linear(p, W, b)
    return -nu * (p.mT @ r)


# ---------------------------------------------------------------------------
# Backtracking on the exact quadratic restriction of φ along -g
# ---------------------------------------------------------------------------

def _backtrack_scalar(phi0, g_sq, curv, t0, *, max_doublings: int = 12):
    """Matmul-free backtracking:  φ(x0 - g/τ) = φ0 - ||g||²/τ + gᵀHg/(2τ²),
    U(τ) = φ0 - ||g||²/(2τ); τ doubles while φ > U + 1e-6|U|.

    The reference runs a device ``while_loop`` that stops when every entry
    passes or after ``max_doublings`` rounds. Here exactly ``max_doublings``
    rounds of ``where(needs_doubling, 2τ, τ)`` run with no host sync: an
    entry that passes is never doubled again, so τ is the same. τ is f32,
    as in the reference; the tests are in the inputs' dtype.
    """
    t = torch.as_tensor(t0, dtype=torch.float32, device=phi0.device)
    t = t.expand(phi0.shape).clone()
    for _ in range(max_doublings):
        s = 1.0 / t
        phi_x = phi0 - s * g_sq + 0.5 * s * s * curv
        u_val = phi0 - 0.5 * s * g_sq
        t = torch.where(phi_x > u_val + 1e-6 * torch.abs(u_val), t * 2.0, t)
    return t


# -- kernel-dispatch helpers (plain tensor code when use_kernels=False) -----

def _residual(p, W, b, z, use_kernels: bool):
    """r = z - (pW + b), the quantity every solver in the family re-reads."""
    if use_kernels:
        from repro_torch.kernels import ops
        return ops.fused_linear(p, W, b, z, mode="residual")
    return z - linear(p, W, b)


def _pgrad(r0, W, u_prev, p, q_prev, nu, rho, use_kernels: bool):
    if use_kernels:
        from repro_torch.kernels import ops
        return ops.admm_pgrad(r0, W, u_prev, p, q_prev, nu=float(nu),
                              rho=float(rho))
    return -nu * (r0 @ W.mT) + u_prev + rho * (p - q_prev)


def _matmul(a, bmat, use_kernels: bool):
    if use_kernels:
        from repro_torch.kernels import ops
        return ops.fused_linear(a, bmat, None, mode="linear")
    return a @ bmat


def _zupdate(a, q, z_old, nu, use_kernels: bool):
    """Eq.-6 ReLU z-update dispatch (the minimizer is ν-independent, so the
    kernel takes no ν)."""
    if use_kernels:
        from repro_torch.kernels import ops
        return ops.relu_zupdate(a, q, z_old)
    return update_z_hidden(a, q, z_old, nu)


def update_p(p, W, b, z, q_prev, u_prev, nu, rho, tau0,
             grid: Optional[QuantGrid] = None, r0=None,
             use_kernels: bool = False, max_doublings: int = 12):
    """p-subproblem (Eq. 3), matmul-minimal.

    Returns ``(p_new, tau_used, r_new)`` with ``r_new = z - p_new W - b``.
    With ``r0 = z - pW - b`` supplied the solve is exactly 2 matmuls
    (r0 Wᵀ for the gradient, gW for the curvature/residual axpy).
    """
    if grid is not None:
        raise NotImplementedError(
            "update_p with a grid (pdADMM-G-Q) needs the backtrack_resnorm "
            "kernel, which the port's next slice brings")
    if r0 is None:
        r0 = _residual(p, W, b, z, use_kernels)
    g = _pgrad(r0, W, u_prev, p, q_prev, nu, rho, use_kernels)
    d0 = p - q_prev
    phi0 = (0.5 * nu * _dot(r0, r0) + _dot(u_prev, d0)
            + 0.5 * rho * _dot(d0, d0))
    # x⁺(τ) = p - g/τ is linear in 1/τ: the residual moves along gW and
    # every trial is scalar arithmetic.
    gW = _matmul(g, W, use_kernels)
    g_sq = _dot(g, g)
    curv = nu * _dot(gW, gW) + rho * g_sq          # gᵀ(ν WWᵀ + ρI)g
    tau = _backtrack_scalar(phi0, g_sq, curv, tau0,
                            max_doublings=max_doublings)
    return p - g / _col(tau), tau, r0 + gW / _col(tau)


def update_W(p, W, b, z, q_prev, u_prev, nu, rho, theta0, *, first: bool,
             r0=None, use_kernels: bool = False, max_doublings: int = 12):
    """W-subproblem (Eq. 4), matmul-minimal.

    Returns ``(W_new, theta_used, r_new)`` with ``r_new = z - p W_new - b``.
    The gradient pᵀr0 stays a plain ``torch.matmul``, as it stays outside
    any kernel in the reference.
    """
    if r0 is None:
        r0 = _residual(p, W, b, z, use_kernels)
    g = -nu * (p.mT @ r0)
    pg = _matmul(p, g, use_kernels)
    phi0 = 0.5 * nu * _dot(r0, r0)
    if not first:
        d0 = p - q_prev
        phi0 = phi0 + _dot(u_prev, d0) + 0.5 * rho * _dot(d0, d0)
    g_sq = _dot(g, g)
    curv = nu * _dot(pg, pg)                       # gᵀ(ν pᵀp ⊗ I)g
    theta = _backtrack_scalar(phi0, g_sq, curv, theta0,
                              max_doublings=max_doublings)
    return W - g / _col(theta), theta, r0 + pg / _col(theta)


def update_b(p, W, z):
    """Exact minimizer of (ν/2)||z - pW - b||² over b: node mean of z - pW."""
    return (z - p @ W).mean(dim=-2)


# ---------------------------------------------------------------------------
# z-updates
# ---------------------------------------------------------------------------

def update_z_hidden(a, q, z_old, nu):
    """Closed-form ReLU solution of Eq. (6):
       min_z (ν/2)[(z-a)² + (q-relu(z))² + (z-z_old)²]  — elementwise.
    Branch z<=0: z = min((a+z_old)/2, 0); branch z>=0: z = max((a+q+z_old)/3, 0);
    pick the branch with the lower objective value.
    """
    zn = torch.clamp((a + z_old) / 2.0, max=0.0)
    zp = torch.clamp((a + q + z_old) / 3.0, min=0.0)

    def obj(zz):
        return ((zz - a) ** 2 + (q - torch.clamp(zz, min=0.0)) ** 2
                + (zz - z_old) ** 2)

    return torch.where(obj(zn) <= obj(zp), zn, zp)


def _one_hot(labels, n, dtype):
    return F.one_hot(labels.long(), n).to(dtype)


def ce_value_grad(z, labels, label_mask):
    """Summed softmax cross-entropy over labeled nodes. z: [V, C]."""
    logp = torch.log_softmax(z, dim=-1)
    nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
    val = (nll * label_mask).sum()
    grad = ((torch.softmax(z, dim=-1) - _one_hot(labels, z.shape[-1], z.dtype))
            * label_mask[:, None])
    return val, grad


def ce_grad_cols(z, labels, label_mask, n_classes: Optional[int] = None):
    """Masked-CE gradient on z[:, :n_classes], zero-padded back to z's width."""
    C = z.shape[-1] if n_classes is None else n_classes
    zc = z[:, :C]
    g = ((torch.softmax(zc, dim=-1) - _one_hot(labels, C, z.dtype))
         * label_mask[:, None])
    if C == z.shape[-1]:
        return g
    return F.pad(g, (0, z.shape[-1] - C))


def fista_prox(g_grad, z_old, step, n_iters: int):
    """The generic FISTA loop  z⁺ = y − step·g_grad(y)  with Nesterov
    momentum; the momentum sequence is data-independent host arithmetic."""
    z_prev, z_cur, t = z_old, z_old - step * g_grad(z_old), 1.0
    for _ in range(n_iters):
        t_new = (1.0 + math.sqrt(1.0 + 4.0 * t * t)) / 2.0
        y = z_cur + ((t - 1.0) / t_new) * (z_cur - z_prev)
        z_prev, z_cur, t = z_cur, y - step * g_grad(y), t_new
    return z_cur


def fista_ce(a, z_old, labels, label_mask, nu, n_iters: int = 15,
             n_classes: Optional[int] = None):
    """Plain z_L solve: FISTA on min_z R(z;y) + (ν/2)||z − a||², R the
    masked CE over z[:, :n_classes]."""
    step = 1.0 / (1.0 + nu)

    def g_grad(z):
        return ce_grad_cols(z, labels, label_mask, n_classes) + nu * (z - a)

    return fista_prox(g_grad, z_old, step, n_iters)


def update_z_last(a, z_old, labels, label_mask, nu, n_iters: int = 15,
                  n_classes: Optional[int] = None, use_kernels: bool = True):
    """FISTA for min_z R(z;y) + (ν/2)||z - a||² (Eq. 7), step = 1/(1+ν).
    ``use_kernels`` dispatches through ``ops.fista_zlast``."""
    if use_kernels:
        from repro_torch.kernels import ops
        return ops.fista_zlast(a, z_old, labels, label_mask, nu=nu,
                               n_iters=n_iters, n_classes=n_classes)
    return fista_ce(a, z_old, labels, label_mask, nu, n_iters, n_classes)


def update_q(p_next, u, fz, nu, rho, grid: Optional[QuantGrid] = None):
    """Closed form (Eq. 8): q = (ρ p_{l+1} + u_l + ν f(z_l)) / (ρ+ν),
    optionally projected onto ``grid``."""
    q = (rho * p_next + u + nu * fz) / (rho + nu)
    return grid.project(q) if grid is not None else q


def update_u(u, p_next, q, rho):
    """Dual ascent (Eq. 9): u += ρ (p_{l+1} - q_l). Returns (u_new, residual)."""
    r = p_next - q
    return u + rho * r, r
