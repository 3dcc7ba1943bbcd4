"""Param-spec machinery shared by the port's models.

A model is described by a nested dict of :class:`Spec` leaves (shape,
logical axes, init scale, dtype), as in the reference's
``repro/models/common.py``. From it the port derives the materialized
params (``init_params``), their sizes (``count_params``,
``param_bytes``), their PSpecs under a rules table (``param_pspecs``),
shape-only stand-ins (``abstract_params``: the reference's
``ShapeDtypeStruct``s) and, on a ``DeviceMesh``, DTensors (``abstract_params``
with a mesh, ``distribute_params``).

On a mesh every leaf is a DTensor whose placements come from its PSpec
(``parallel.sharding.placements``). A shape-only DTensor is made from its
local shard alone (``shard_shape``), ``DTensor.from_local`` with the
global shape and stride: a 1.1B-parameter model over 256 ranks never
exists as a global tensor, which ``distribute_tensor`` would scatter.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.parallel import sharding as sh


@dataclasses.dataclass(frozen=True)
class Spec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones | small
    scale: Optional[float] = None  # default: 1/sqrt(fan_in)
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


class TensorSpec(NamedTuple):
    """Shape and dtype of one tensor (the reference's
    ``jax.ShapeDtypeStruct``)."""
    shape: tuple
    dtype: torch.dtype


def leaves(tree, prefix=()):
    """(path, leaf) pairs of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def tree_map(fn, tree):
    """``fn`` applied to every leaf of a nested dict, keeping its keys."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def unstack(tree) -> list:
    """A nested dict of stacked [n, ...] leaves as n nested dicts of views
    (entry i: every leaf's [i]), one ``unbind`` a leaf: the backward pass
    then stacks the n gradients of a leaf once, where indexing entry by
    entry would add each into an [n, ...] zeros."""
    paths, ts = zip(*leaves(tree))
    out = []
    for ws in zip(*(t.unbind(0) for t in ts)):
        d = {}
        for path, w in zip(paths, ws):
            node = d
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = w
        out.append(d)
    return out


def _init_one(spec: Spec, generator: torch.Generator, device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else max(spec.shape[-1], 1)
    scale = spec.scale if spec.scale is not None else 1.0 / math.sqrt(fan_in)
    if spec.init == "small":
        scale = 0.02
    x = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                    device=device)
    return x.mul_(scale).to(spec.dtype)


def init_params(specs, generator: torch.Generator, device):
    """Draw every leaf from ``generator`` (on ``device``) in f32 with the
    reference's scales, then cast to the leaf's dtype. The numbers are not
    ``jax.random``'s: a test that needs the reference's weights converts
    them (``models.interop.lm_params_from_numpy``)."""
    return tree_map(lambda s: _init_one(s, generator, device), specs)


def param_bytes(specs) -> int:
    return sum(math.prod(s.shape) * s.dtype.itemsize
               for _, s in leaves(specs))


def count_params(specs) -> int:
    return sum(math.prod(s.shape) for _, s in leaves(specs))


# ---------------------------------------------------------------------------
# Shardings and shape-only params
# ---------------------------------------------------------------------------

def param_pspecs(specs, rules: sh.Rules):
    """Each leaf's PSpec under ``rules`` (from its logical axes)."""
    return tree_map(lambda s: sh.pspec(s.axes, rules), specs)


def _is_leaf(x) -> bool:
    return isinstance(x, (sh.PSpec, TensorSpec, Spec))


def _strides(shape) -> Tuple[int, ...]:
    out, n = [], 1
    for d in reversed(shape):
        out.append(n)
        n *= d
    return tuple(reversed(out))


def _shape_only(shape, dtype) -> torch.Tensor:
    """An empty tensor carrying ``shape`` and ``dtype``: fake under an
    active ``FakeTensorMode`` (the dry run's), else on the meta device."""
    from torch._guards import detect_fake_mode
    if detect_fake_mode() is not None:
        return torch.empty(shape, dtype=dtype)
    return torch.empty(shape, dtype=dtype, device="meta")


def placed(local: torch.Tensor, shape, spec: sh.PSpec, mesh):
    """The DTensor of global ``shape`` laid out by ``spec`` on ``mesh``
    whose local shard (this rank's) is ``local``."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, mesh, sh.placements(mesh, spec,
                                                         len(shape)),
                              run_check=False, shape=torch.Size(shape),
                              stride=_strides(shape))


def abstract_tensor(shape, dtype, spec=None, mesh=None):
    """Shape-only stand-in of a ``shape`` tensor: the whole tensor without
    a mesh, else a DTensor made of its local shard under ``spec``."""
    if mesh is None:
        return _shape_only(tuple(shape), dtype)
    local = _shape_only(sh.shard_shape(shape, spec, mesh), dtype)
    return placed(local, shape, spec, mesh)


def abstract_params(specs, mesh=None, rules=None):
    """The params as shape-only tensors (``_shape_only``): whole without a
    mesh, DTensors of their local shards on one."""
    if mesh is None:
        return tree_map(lambda s: abstract_tensor(s.shape, s.dtype), specs)
    return tree_map(lambda s: abstract_tensor(
        s.shape, s.dtype, sh.pspec(s.axes, rules), mesh), specs)


def abstract_tree(shapes, pspecs, mesh=None):
    """``abstract_tensor`` over a tree of tensors or ``TensorSpec``s and the
    matching tree of PSpecs; other leaves (a cache's ``length``) pass."""
    def one(x, spec):
        if isinstance(x, (torch.Tensor, TensorSpec)):
            return abstract_tensor(tuple(x.shape), x.dtype, spec, mesh)
        return x
    return pytree.tree_map(one, shapes, pspecs, is_leaf=_is_leaf)


def distribute_tree(tree, pspecs, mesh):
    """Real tensors (every rank holding the whole of each) as DTensors on
    ``mesh`` under the matching PSpecs: each rank keeps its own shard,
    nothing moves. Other leaves pass."""
    from torch.distributed.tensor import distribute_tensor

    def one(x, spec):
        if not isinstance(x, torch.Tensor):
            return x
        return distribute_tensor(x, mesh, sh.placements(mesh, spec, x.ndim),
                                 src_data_rank=None)
    return pytree.tree_map(one, tree, pspecs, is_leaf=_is_leaf)


def distribute_params(params, specs, mesh, rules):
    """``params`` (whole, the same on every rank) on ``mesh``."""
    return distribute_tree(params, param_pspecs(specs, rules), mesh)

