"""block-pdADMM (beyond the paper): the pdADMM-G splitting generalized from
affine+ReLU layers to arbitrary blocks, stacked over a leading layer axis.

Counterpart of ``repro.core.block_admm`` (its docstring has the
formulation). Per block l with params W_l and input p_l:
  z_l = Block_l(p_l; W_l),  constraint p_{l+1} = q_l,
  F = R(z_L; y) + (ν/2) Σ ||z_l - Block_l(p_l)||² + (ν/2) Σ ||q_l - z_l||².

``jax.lax.scan`` becomes a loop over the blocks, ``jax.vmap`` and
``jax.grad`` become ``torch.func.vmap`` and ``torch.func.grad``; the
stacked params are a tensor or a tree (e.g. a dict) of tensors with a
leading [L] axis. Kernels never run under ``vmap`` (a CUDA kernel cannot
take a batched tensor): the p-update's gradient step is vmapped and the
grid projection, which is elementwise, runs on the stacked result after
it; the z_L solve runs on the flattened rows.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.utils import _pytree as pytree

from repro_torch import resolve_device
from repro_torch.core import subproblems as sp
from repro_torch.core.pdadmm import ADMMConfig


class BlockState(NamedTuple):
    p: torch.Tensor     # [L, B, S, d] block inputs
    W: Any              # tensor or tree, leaves stacked [L, ...]
    z: torch.Tensor     # [L, B, S, d] block outputs (pre-split)
    q: torch.Tensor     # [L, B, S, d]
    u: torch.Tensor     # [L, B, S, d]


def _dot(a, b):
    return (a * b).sum()


def init_block_state(block_fn, params_stacked, x0, L: int,
                     config: ADMMConfig, *, device=None) -> BlockState:
    """Forward-consistent init: run the blocks in order, recording inputs
    and outputs. With ``quantize_p`` q starts on the grid, as in the
    reference."""
    device = resolve_device(device)
    params_stacked = pytree.tree_map(lambda w: w.to(device), params_stacked)
    x = x0.to(device)
    ps, zs = [], []
    for l in range(L):
        z = block_fn(pytree.tree_map(lambda w: w[l], params_stacked), x)
        ps.append(x)
        zs.append(z)
        x = z
    ps, zs = torch.stack(ps), torch.stack(zs)
    qs = zs
    if config.quantize_p and config.grid is not None:
        qs = config.grid.project(zs)
    return BlockState(p=ps, W=params_stacked, z=zs, q=qs,
                      u=torch.zeros_like(zs))


def make_block_iterate(block_fn: Callable, risk_fn: Callable,
                       config: ADMMConfig, *, lr_w: float = 1e-3,
                       fista_iters: int = 10, labels=None, label_mask=None,
                       n_classes: Optional[int] = None):
    """Build one block-pdADMM iteration (vmapped over stacked blocks).

    block_fn(params_l, p_l) -> z_l ; risk_fn(z_last) -> scalar.

    With ``labels`` [B, S] (and optionally ``label_mask``, ``n_classes``) the
    risk is the masked softmax-CE and the z_L solve is ``ops.fista_zlast``
    over the flattened token rows (risk_fn must compute the same CE; it
    still gives the objective). On the card that is the CUDA kernel, which
    takes any class count up to d (``n_classes=None`` means d classes):
    up to 64 on its lane-group route, above that on a block a row, the row
    in registers, shared memory or global memory by its width
    (``kernels.fista_zlast.route``). With ``labels=None``
    the solve is ``subproblems.fista_prox`` on ``torch.func.grad(risk_fn)``.
    """
    nu, rho = config.nu, config.rho
    p_grid = config.grid if config.quantize_p else None
    q_grid = config.grid if config.quantize_q else None
    grad = torch.func.grad      # of argument 0, as jax.grad

    def phi_p(p, W, z, qp, up, first):
        r = z - block_fn(W, p)
        d = p - qp
        dual = torch.where(first, 0.0, _dot(up, d) + 0.5 * rho * _dot(d, d))
        return 0.5 * nu * _dot(r, r) + dual

    def p_step(p, W, z, qp, up, first):
        return p - grad(phi_p)(p, W, z, qp, up, first) / config.tau0

    def loss_w(W, p_, z_):
        r = z_ - block_fn(W, p_)
        return 0.5 * nu * _dot(r, r)

    def w_upd(W, p_, z_):
        g = grad(loss_w)(W, p_, z_)
        return pytree.tree_map(lambda w, gw: w - lr_w * gw.to(w.dtype), W, g)

    def fista_last(a, z_old):
        if labels is not None:
            from repro_torch.kernels import ops
            d = a.shape[-1]
            mask = (torch.ones(labels.shape, dtype=a.dtype, device=a.device)
                    if label_mask is None else label_mask)
            z = ops.fista_zlast(
                a.reshape(-1, d), z_old.reshape(-1, d), labels.reshape(-1),
                mask.reshape(-1), nu=nu, n_iters=fista_iters,
                n_classes=n_classes)
            return z.reshape(a.shape)
        return sp.fista_prox(lambda z: grad(risk_fn)(z) + nu * (z - a),
                             z_old, 1.0 / (1.0 + nu), fista_iters)

    def iterate(st: BlockState, x0):
        L = st.p.shape[0]
        layer = torch.arange(L, device=st.p.device)
        q_prev = torch.cat([x0[None], st.q[:-1]], dim=0)
        u_prev = torch.cat([torch.zeros_like(st.u[:1]), st.u[:-1]], dim=0)
        is_first = (layer == 0).reshape((L,) + (1,) * (st.p.dim() - 1))
        is_last = (layer == L - 1).reshape(is_first.shape)

        # ---- p-update: local VJP, quadratic-approx step; the projection
        # is elementwise, so it runs on the stacked result outside vmap
        p_new = torch.func.vmap(p_step)(st.p, st.W, st.z, q_prev, u_prev,
                                        layer == 0)
        if p_grid is not None:
            p_new = p_grid.project(p_new)
        p = torch.where(is_first, x0[None], p_new)

        # ---- W-update: one local gradient step ------------------------------
        W = torch.func.vmap(w_upd)(st.W, p, st.z)

        # ---- z-update --------------------------------------------------------
        Bz = torch.func.vmap(block_fn)(W, p)
        z_hidden = (Bz + st.q + st.z) / 3.0
        z_last = fista_last(Bz[-1], st.z[-1])
        z = torch.where(is_last, z_last[None], z_hidden)

        # ---- q / u -----------------------------------------------------------
        p_next = torch.cat([p[1:], p[-1:]], dim=0)     # last slot unused
        q = (rho * p_next + st.u + nu * z) / (rho + nu)
        if q_grid is not None:
            q = q_grid.project(q)
        q = torch.where(is_last, st.q, q)
        r = torch.where(is_last, 0.0, p_next - q)
        u = st.u + rho * r

        new = BlockState(p, W, z, q, u)
        # Bz is Block(W, p) of the new W and p, which the objective reads
        obj = (risk_fn(z[-1])
               + 0.5 * nu * torch.square(z - Bz).sum()
               + 0.5 * nu * torch.square(torch.where(is_last, 0.0,
                                                     q - z)).sum()
               + (u * r).sum() + 0.5 * rho * (r * r).sum())
        return new, {"objective": obj, "residual": torch.sqrt((r * r).sum())}

    return iterate
