"""Train and serve steps of one (arch x shape) cell: the port of
``repro/launch/steps.py``. PyTorch runs eagerly, so a step is a closure
over the bundle (the reference returns functions to ``jax.jit``).

On a mesh the params, batch and state are DTensors and the steps run on
them as they stand: there are no in/out shardings to hand to a compiler.
``shardings_for_train`` gives the params' and optimizer state's PSpecs
and ``to_named`` turns a PSpec tree into DTensor placements (the
reference's ``NamedSharding`` tree). A gradient leaves the backward pass
as DTensor lays it out (a replicated weight's is a partial sum over the
data shards); ``on_param_placements`` brings it to its param's
placements, which is the data-parallel all-reduce (or, for an FSDP
weight, reduce-scatter).
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs.base import ShapeConfig
from repro_torch.models import common
from repro_torch.models.api import ModelBundle
from repro_torch.parallel import sharding as sh
from repro_torch.train import optim


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
        grads = on_param_placements(grads, params)
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


def on_param_placements(grads, params):
    """Each DTensor gradient redistributed to its param's placements (the
    gradient all-reduce over the data shards); plain tensors as they
    are."""
    return pytree.tree_map(
        lambda g, p: (g.redistribute(p.device_mesh, p.placements)
                      if sh._is_dtensor(g) else g), grads, params)


def shardings_for_train(bundle: ModelBundle, opt: optim.Optimizer):
    """(param PSpecs, optimizer-state PSpecs) of a train step: the state's
    shapes from ``opt.init`` on meta params, matched to the params'
    (``optim.make_opt_pspecs``)."""
    p_ps = bundle.param_pspecs()
    params_shape = common.abstract_params(bundle.param_specs())
    opt_shape = opt.init(params_shape)
    o_ps = optim.make_opt_pspecs(opt_shape, p_ps, params_shape)
    return p_ps, o_ps


def to_named(mesh, tree):
    """A tree of PSpecs as a tree of DTensor placements on ``mesh`` (the
    reference's ``NamedSharding``s); a spec's rank is its entry count, so
    a placement names no dim past it."""
    return pytree.tree_map(
        lambda ps: sh.placements(mesh, ps, len(ps)), tree,
        is_leaf=lambda x: isinstance(x, sh.PSpec))
