"""Hand-over of a state from the JAX reference to the port.

The reference draws its initial weights from ``jax.random``, which PyTorch
cannot reproduce. A caller that has both packages converts the reference's
``ADMMState`` leaves to numpy and passes them here, so both start from the
same weights. This module imports neither JAX nor the reference.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.pdadmm import ADMMState


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

    def leaf(x):
        t = torch.from_numpy(np.array(x, copy=True))
        if t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    return ADMMState(*[[leaf(x) for x in fam] for fam in families])
