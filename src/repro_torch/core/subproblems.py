"""The pdADMM-G / pdADMM-G-Q subproblem solvers (Appendix A/B of the paper).

Counterpart of ``repro.core.subproblems``. Layout is node-major: p_l, q_l,
z_l, u_l are [V, n], W_l is [n_in, n_out], b_l is [n_out], and the linear
map is z = p @ W + b.

Every fast solver also takes an optional leading layer axis ([L, V, n],
[L, n_in, n_out], [L, n_out]); scalars such as ``_dot`` then reduce over
the last two dims and give one value per layer. One function serves the
per-layer path and the layer-stacked path, standing in for ``jax.vmap``.
The ``*_reference`` solvers (the naive engine, the ground truth of the
tests) take one layer at a time.
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
# Backtracking quadratic-approximation steps (p- and W-updates)
#
# The accept test at trial τ is  φ(x⁺) <= U(x⁺;τ) = φ0 + gᵀd + (τ/2)||d||²
# (d = x⁺ - x0), with the same 1e-6 relative slack everywhere.
#
#   * `_backtrack` — the naive engine: φ on the full tensors every trial.
#     The ground truth of the `update_*_reference` solvers; one layer, and
#     it stops on the host when the test passes.
#   * `_backtrack_scalar` — the unprojected step x⁺ = x0 - g/τ: φ is
#     exactly quadratic along -g, so every trial is three cached scalars.
#   * the projected step of `update_p` (pdADMM-G-Q) is only piecewise
#     linear in 1/τ, so each trial evaluates φ(x⁺) through ||r0 - dW||²,
#     one `backtrack_resnorm` kernel per trial.
#
# The fast engines run exactly `max_doublings` rounds of
# `where(needs_doubling, 2τ, τ)` with no host sync, where the reference
# runs a device `while_loop` that stops when every entry passes: an entry
# that passed is never tested again, so τ is the same.
# ---------------------------------------------------------------------------

def _tau0(t0, like):
    """τ0 as f32 (as in the reference) of ``like``'s shape and device."""
    t = torch.as_tensor(t0, dtype=torch.float32, device=like.device)
    return t.expand(like.shape).clone()


def _backtrack(x0, g, phi_at, phi0, t0, *, grid: Optional[QuantGrid],
               max_doublings: int = 12):
    """Find τ = t0·2^j with φ(x⁺) <= U(x⁺;τ), x⁺ = proj(x0 - g/τ) (the
    projection only with a grid). One layer; returns (x⁺, τ)."""
    def step(t):
        x = x0 - g / t
        return grid.project(x) if grid is not None else x

    t = _tau0(t0, phi0)
    for _ in range(max_doublings):
        x = step(t)
        d = x - x0
        u_val = phi0 + _dot(g, d) + 0.5 * t * _dot(d, d)
        if not bool(phi_at(x) > u_val + 1e-6 * torch.abs(u_val)):
            break
        t = t * 2.0
    return step(t), t


def _backtrack_scalar(phi0, g_sq, curv, t0, *, max_doublings: int = 12):
    """Matmul-free backtracking:  φ(x0 - g/τ) = φ0 - ||g||²/τ + gᵀHg/(2τ²),
    U(τ) = φ0 - ||g||²/(2τ); τ doubles while φ > U + 1e-6|U|. Every
    input may hold one entry per stacked layer. τ is f32, as in the
    reference; the tests are in the inputs' dtype.
    """
    t = _tau0(t0, phi0)
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


def _resnorm_sq(r0, d, W, active, use_kernels: bool):
    """||r0 - d W||² per layer. With kernels, the layers whose ``active``
    entry is False are skipped (their value is 0 and is not read)."""
    if use_kernels:
        from repro_torch.kernels import ops
        return ops.backtrack_resnorm(r0, d, W, active)
    r = r0 - d @ W
    return _dot(r, r)


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
    """p-subproblem (Eq. 3 / Eq. 10), matmul-minimal.

    Returns ``(p_new, tau_used, r_new)`` with ``r_new = z - p_new W - b``.
    With ``r0 = z - pW - b`` supplied the unprojected solve is exactly 2
    matmuls (r0 Wᵀ for the gradient, gW for the curvature/residual axpy).
    With a ``grid`` (pdADMM-G-Q) x⁺ = proj(p - g/τ), and each trial costs
    one ||r0 - dW||² contraction for the layers still searching.
    """
    if r0 is None:
        r0 = _residual(p, W, b, z, use_kernels)
    g = _pgrad(r0, W, u_prev, p, q_prev, nu, rho, use_kernels)
    d0 = p - q_prev
    phi0 = (0.5 * nu * _dot(r0, r0) + _dot(u_prev, d0)
            + 0.5 * rho * _dot(d0, d0))

    if grid is None:
        # x⁺(τ) = p - g/τ is linear in 1/τ: the residual moves along gW and
        # every trial is scalar arithmetic.
        gW = _matmul(g, W, use_kernels)
        g_sq = _dot(g, g)
        curv = nu * _dot(gW, gW) + rho * g_sq          # gᵀ(ν WWᵀ + ρI)g
        tau = _backtrack_scalar(phi0, g_sq, curv, tau0,
                                max_doublings=max_doublings)
        return p - g / _col(tau), tau, r0 + gW / _col(tau)

    # Projected path: φ(x⁺) = (ν/2)||r0 - dW||² + uᵀ(d + d0) + (ρ/2)||d + d0||²
    # with d = x⁺ - p, evaluated exactly at every trial.
    def trial_d(t):
        return grid.project(p - g / _col(t)) - p

    t = _tau0(tau0, phi0)
    active = torch.ones(phi0.shape, dtype=torch.bool, device=phi0.device)
    for _ in range(max_doublings):
        d = trial_d(t)
        dq = d + d0
        phi_x = (0.5 * nu * _resnorm_sq(r0, d, W, active, use_kernels)
                 + _dot(u_prev, dq) + 0.5 * rho * _dot(dq, dq))
        u_val = phi0 + _dot(g, d) + 0.5 * t * _dot(d, d)
        active = active & (phi_x > u_val + 1e-6 * torch.abs(u_val))
        t = torch.where(active, t * 2.0, t)
    d = trial_d(t)
    if use_kernels:
        from repro_torch.kernels import ops
        r_new = ops.fused_linear(d, W, None, r0, mode="residual")
    else:
        r_new = r0 - d @ W
    return p + d, t, r_new


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


# -- pre-optimization reference solvers (naive full-tensor backtracking) -----

def update_p_reference(p, W, b, z, q_prev, u_prev, nu, rho, tau0,
                       grid: Optional[QuantGrid] = None):
    """The pre-fast-path p-subproblem: a fresh matmul per backtracking trial.
    Ground truth for the fast engines; returns (p_new, tau_used)."""
    g = grad_p(p, W, b, z, q_prev, u_prev, nu, rho)
    phi0 = phi(p, W, b, z, q_prev, u_prev, nu, rho)
    return _backtrack(p, g,
                      lambda x: phi(x, W, b, z, q_prev, u_prev, nu, rho),
                      phi0, tau0, grid=grid)


def update_W_reference(p, W, b, z, q_prev, u_prev, nu, rho, theta0, *,
                       first: bool):
    """The pre-fast-path W-subproblem. Returns (W_new, theta_used)."""
    g = grad_W(p, W, b, z, nu)
    if first:
        phi0 = phi_first(p, W, b, z, nu)
        phi_at = lambda Wx: phi_first(p, Wx, b, z, nu)  # noqa: E731
    else:
        phi0 = phi(p, W, b, z, q_prev, u_prev, nu, rho)
        phi_at = lambda Wx: phi(p, Wx, b, z, q_prev, u_prev, nu, rho)  # noqa: E731
    return _backtrack(W, g, phi_at, phi0, theta0, grid=None)


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


def update_z_last_reference(a, z_old, labels, label_mask, nu,
                            n_iters: int = 15):
    """The pre-kernel z_L solve: FISTA through ``ce_value_grad``. Ground
    truth for the fused kernel and the ``iterate_reference`` oracle."""
    step = 1.0 / (1.0 + nu)

    def g_grad(z):
        _, gr = ce_value_grad(z, labels, label_mask)
        return gr + nu * (z - a)

    return fista_prox(g_grad, z_old, step, n_iters)


def update_q(p_next, u, fz, nu, rho, grid: Optional[QuantGrid] = None):
    """Closed form (Eq. 8): q = (ρ p_{l+1} + u_l + ν f(z_l)) / (ρ+ν),
    optionally projected onto ``grid``."""
    q = (rho * p_next + u + nu * fz) / (rho + nu)
    return grid.project(q) if grid is not None else q


def update_u(u, p_next, q, rho):
    """Dual ascent (Eq. 9): u += ρ (p_{l+1} - q_l). Returns (u_new, residual)."""
    r = p_next - q
    return u + rho * r, r
