"""Param-spec machinery shared by the port's models.

A model is described by a nested dict of :class:`Spec` leaves (shape,
logical axes, init scale, dtype), as in the reference's
``repro/models/common.py``. From it the port derives the materialized
params (``init_params``) and their sizes (``count_params``,
``param_bytes``). The reference's shardings and abstract shapes have no
counterpart: the port runs on one card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Spec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones | small
    scale: Optional[float] = None  # default: 1/sqrt(fan_in)
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


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
