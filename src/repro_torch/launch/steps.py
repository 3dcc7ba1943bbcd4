"""Train and serve steps of one (arch x shape) cell: the port of
``repro/launch/steps.py``. PyTorch runs eagerly, so a step is a closure
over the bundle (the reference returns functions to ``jax.jit``).
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs.base import ShapeConfig
from repro_torch.models.api import ModelBundle


def value_and_grad(bundle: ModelBundle, params, batch):
    """(loss, grads) of ``bundle.loss`` at ``params``: the loss detached and
    the gradients in ``params``' structure and dtypes (zeros for a leaf
    the loss does not reach, as ``jax.grad`` gives). The params are plain
    tensors; the backward pass runs on detached aliases of them that
    require grad, so no ``.grad`` is left on the caller's tensors."""
    leaves, spec = pytree.tree_flatten(params)
    leaves = [p.detach().requires_grad_() for p in leaves]
    loss = bundle.loss(pytree.tree_unflatten(leaves, spec), batch)
    loss.backward()
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in leaves]
    return loss.detach(), pytree.tree_unflatten(grads, spec)


def make_train_step(bundle: ModelBundle, opt):
    """(params, opt_state, batch) -> (params, opt_state, loss): the
    backward pass, then ``opt.update`` (outside autograd), which returns
    new trees."""

    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(bundle, params, batch)
        with torch.no_grad():
            params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss

    return train_step


def make_serve_step(bundle: ModelBundle, shape: ShapeConfig):
    """One decode step at a full cache (length = seq_len - 1)."""
    length = shape.seq_len - 1

    def serve_step(params, state, batch):
        return bundle.serve_step(params, state, batch, length=length)

    return serve_step


def make_prefill_step(bundle: ModelBundle, shape: ShapeConfig):
    def prefill_step(params, batch):
        return bundle.prefill(params, batch, max_len=shape.seq_len)

    return prefill_step
