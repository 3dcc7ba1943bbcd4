"""Hand-over of a state from the JAX reference to the port.

The reference draws its initial weights from ``jax.random``, which PyTorch
cannot reproduce. A caller that has both packages converts the reference's
``ADMMState``, ``init_mlp`` parameters or ``BlockState`` leaves to numpy
and passes them here, so both start from the same weights. This module
imports neither JAX nor the reference.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.block_admm import BlockState
from repro_torch.core.pdadmm import ADMMState


def _leaf(x, device, dtype):
    """A numpy array as a tensor on ``device``: floating leaves in
    ``dtype``, others in their own dtype."""
    t = torch.from_numpy(np.array(x, copy=True))
    if t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def state_from_numpy(arrays: Sequence, *, device,
                     dtype=torch.float32) -> ADMMState:
    """``arrays``: the eight families of an ``ADMMState`` in its field order
    (p, W, b, z, q, u, tau, theta), each a list of numpy arrays. Floating
    leaves become ``dtype`` tensors on ``device``; others keep their dtype."""
    fields = ADMMState._fields
    families = list(arrays)
    if len(families) != len(fields):
        raise ValueError(f"expected {len(fields)} families {fields}, "
                         f"got {len(families)}")
    return ADMMState(*[[_leaf(x, device, dtype) for x in fam]
                       for fam in families])


def mlp_params_from_numpy(params, *, device, dtype=torch.float32) -> dict:
    """The reference's ``gd_baseline.init_mlp`` dict, ``{"W": [...], "b":
    [...]}`` with numpy leaves, as the port's parameters."""
    return {k: [_leaf(x, device, dtype) for x in params[k]]
            for k in ("W", "b")}


def block_state_from_numpy(arrays: Sequence, *, device,
                           dtype=torch.float32) -> BlockState:
    """A stacked ``BlockState`` in its field order (p, W, z, q, u), each a
    numpy array; W may also be a dict of numpy arrays."""
    p, W, z, q, u = (_leaf(x, device, dtype) if not isinstance(x, dict)
                     else {k: _leaf(v, device, dtype) for k, v in x.items()}
                     for x in arrays)
    return BlockState(p, W, z, q, u)
