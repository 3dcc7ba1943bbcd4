"""Optimizers over trees of tensors (counterpart of ``repro.train.optim``).

``gd``, ``adadelta``, ``adagrad`` and ``adam`` are the paper's comparison
methods (Section V-B), driven by ``core.gd_baseline``; ``adamw`` and
``adamw8bit`` are the LM training step's.

Each is an (init, update) pair over a tree of tensors (dicts, lists and
tuples, as ``torch.utils._pytree`` walks them); ``update(grads, state,
params)`` returns (new_params, new_state) and changes nothing in place.
The arithmetic is the reference's, operation for operation: moments are
f32 whatever the parameter's dtype, the step is formed in f32 and cast
back, Adam's correction is ``(m / bc1) / (sqrt(v / bc2) + eps)`` and
weight decay is added to the step. ``torch.optim`` keeps its moments in
the parameter's dtype and orders Adam's correction otherwise, so it is
not used.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch
from torch.utils import _pytree as pytree
from torch.utils._pytree import tree_map as _map

F32 = torch.float32


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]   # (grads, state, params)


def _zeros_like_f32(params):
    """f32 zeros laid out as each param (a DTensor's placements too)."""
    return _map(lambda p: torch.zeros_like(p, dtype=F32), params)


def _step_count(params):
    leaves = pytree.tree_leaves(params)
    device = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=device)


def _bias_corrections(t, b1: float, b2: float):
    """(1 − b1^t, 1 − b2^t) in f32 on t's device (no host sync)."""
    tf = t.to(F32)
    one = torch.ones((), dtype=F32, device=t.device)
    return (one - torch.pow(torch.tensor(b1, dtype=F32, device=t.device), tf),
            one - torch.pow(torch.tensor(b2, dtype=F32, device=t.device), tf))


def gd(lr: float) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params):
        new = _map(lambda p, g: (p.to(F32) - lr * g.to(F32)).to(p.dtype),
                   params, grads)
        return new, state
    return Optimizer(init, update)


def adagrad(lr: float, eps: float = 1e-10) -> Optimizer:
    def init(params):
        return _zeros_like_f32(params)

    def update(grads, acc, params):
        acc = _map(lambda a, g: a + torch.square(g.to(F32)), acc, grads)
        new = _map(lambda p, g, a: (p.to(F32) - lr * g.to(F32)
                                    / (torch.sqrt(a) + eps)).to(p.dtype),
                   params, grads, acc)
        return new, acc
    return Optimizer(init, update)


def adadelta(lr: float = 1.0, rho: float = 0.95, eps: float = 1e-6) -> Optimizer:
    def init(params):
        return (_zeros_like_f32(params), _zeros_like_f32(params))

    def update(grads, state, params):
        eg, ex = state
        eg = _map(lambda a, g: rho * a + (1 - rho) * torch.square(g.to(F32)),
                  eg, grads)
        dx = _map(lambda g, a, x: -torch.sqrt(x + eps) / torch.sqrt(a + eps)
                  * g.to(F32), grads, eg, ex)
        ex = _map(lambda x, d: rho * x + (1 - rho) * torch.square(d), ex, dx)
        new = _map(lambda p, d: (p.to(F32) + lr * d).to(p.dtype), params, dx)
        return new, (eg, ex)
    return Optimizer(init, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return (_zeros_like_f32(params), _zeros_like_f32(params),
                _step_count(params))

    def update(grads, state, params):
        m, v, t = state
        t = t + 1
        m = _map(lambda a, g: b1 * a + (1 - b1) * g.to(F32), m, grads)
        v = _map(lambda a, g: b2 * a + (1 - b2) * torch.square(g.to(F32)),
                 v, grads)
        bc1, bc2 = _bias_corrections(t, b1, b2)

        def upd(p, mi, vi):
            step = lr * (mi / bc1) / (torch.sqrt(vi / bc2) + eps)
            p32 = p.to(F32)
            if weight_decay:
                step = step + lr * weight_decay * p32
            return (p32 - step).to(p.dtype)

        return _map(upd, params, m, v), (m, v, t)
    return Optimizer(init, update)


def adamw(lr: float = 3e-4, weight_decay: float = 0.1, **kw) -> Optimizer:
    return adam(lr, weight_decay=weight_decay, **kw)


# ---------------------------------------------------------------------------
# 8-bit Adam: m and v stored as int8 codes with one f32 scale per row of the
# last dimension (the reference's ``_q8_sym`` / ``_dq8``)
# ---------------------------------------------------------------------------

def _q8_sym(x):
    """f32 -> (int8 codes, row scales). Symmetric, one scale per row;
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    s = torch.amax(torch.abs(x), dim=-1, keepdim=True) / 127.0
    s = torch.clamp(s, min=1e-12)
    return torch.clamp(torch.round(x / s), -127, 127).to(torch.int8), s


def _dq8(codes, s):
    return codes.to(F32) * s


def _is_q8(x) -> bool:
    return (isinstance(x, tuple) and len(x) == 2
            and all(isinstance(e, torch.Tensor) for e in x))


def _row_ones(p):
    """f32 ones of shape p.shape[:-1] + (1,) (one scale a row), laid out
    as ``p`` with its last dim whole."""
    shape = p.shape[:-1] + (1,)
    from repro_torch.parallel.sharding import _is_dtensor
    if not _is_dtensor(p):
        return torch.ones(shape, dtype=F32, device=p.device)
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.parallel.sharding import local_shape_and_offset
    pl = [Replicate() if s == Shard(p.dim() - 1) else s for s in p.placements]
    local, _ = local_shape_and_offset(shape, p.device_mesh, pl)
    return DTensor.from_local(
        torch.ones(local, dtype=F32, device=p.device), p.device_mesh, pl,
        run_check=False, shape=shape,
        stride=torch.empty(shape, device="meta").stride())


def adamw8bit(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.999,
              eps: float = 1e-8, weight_decay: float = 0.1) -> Optimizer:
    """AdamW with int8 m/v storage: 2 bytes a parameter of optimizer state
    instead of 8 (plus one f32 scale a row). Scalars and 1-d leaves stay
    f32."""
    def small(p):
        return p.dim() < 2

    def init(params):
        def z(p):
            if small(p):
                return torch.zeros_like(p, dtype=F32)
            return (torch.zeros_like(p, dtype=torch.int8), _row_ones(p))
        return (_map(z, params), _map(z, params), _step_count(params))

    def update(grads, state, params):
        m_q, v_q, t = state
        t = t + 1
        bc1, bc2 = _bias_corrections(t, b1, b2)

        def upd(p, g, mq, vq):
            g = g.to(F32)
            if small(p):
                m = b1 * mq + (1 - b1) * g
                v = b2 * vq + (1 - b2) * torch.square(g)
                new_m, new_v = m, v
            else:
                m = b1 * _dq8(*mq) + (1 - b1) * g
                v = (torch.clamp(b2 * _dq8(*vq), min=0.0)
                     + (1 - b2) * torch.square(g))
                new_m, new_v = _q8_sym(m), _q8_sym(v)
            step = lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
            p32 = p.to(F32)
            if weight_decay:
                step = step + lr * weight_decay * p32
            return (p32 - step).to(p.dtype), new_m, new_v

        flat_p, spec = pytree.tree_flatten(params)
        flat_g = pytree.tree_leaves(grads)
        flat_m = pytree.tree_leaves(m_q, is_leaf=_is_q8)
        flat_v = pytree.tree_leaves(v_q, is_leaf=_is_q8)
        out = [upd(p, g, m, v) for p, g, m, v
               in zip(flat_p, flat_g, flat_m, flat_v)]
        new_p = pytree.tree_unflatten([o[0] for o in out], spec)
        new_m = pytree.tree_unflatten([o[1] for o in out], spec)
        new_v = pytree.tree_unflatten([o[2] for o in out], spec)
        return new_p, (new_m, new_v, t)
    return Optimizer(init, update)


def _leaves_sorted(tree, is_leaf=None):
    """Leaves in JAX's order: a dict's by sorted key (PyTorch's pytree
    keeps insertion order)."""
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_sorted(tree[k],
                                                                  is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves_sorted(v, is_leaf)]
    return [tree]


def make_opt_pspecs(opt_state_shape, param_pspecs_tree, params_shape):
    """PSpecs for an opt state: leaves matching a param shape reuse the
    param's pspec; 8-bit scale leaves (shape[:-1] + (1,)) reuse it minus
    the last axis; scalars replicate. As the reference matches shapes, the
    first param of a shape (in its sorted-key order) gives the spec of every
    state leaf of that shape. Leaves are anything with a ``shape``."""
    from repro_torch.parallel.sharding import PSpec
    shape_to_spec = {}
    scale_to_spec = {}
    is_spec = lambda x: isinstance(x, PSpec)
    for sds, spec in zip(_leaves_sorted(params_shape),
                         _leaves_sorted(param_pspecs_tree, is_spec)):
        shape_to_spec.setdefault(tuple(sds.shape), spec)
        sc_shape = tuple(sds.shape[:-1]) + (1,)
        parts = list(spec) + [None] * (len(sds.shape) - len(spec))
        scale_to_spec.setdefault(sc_shape, PSpec(*parts[:-1], None))

    def spec_for(leaf):
        shp = tuple(leaf.shape)
        if shp in shape_to_spec:
            return shape_to_spec[shp]
        return scale_to_spec.get(shp, PSpec())

    return _map(spec_for, opt_state_shape)
