"""Hand-over of LM weights from the JAX reference to the port.

The reference draws its weights from ``jax.random``, which PyTorch cannot
reproduce. A caller that has both packages converts the reference's params
pytree to numpy and passes it here, so both run the same model. This
module imports neither JAX nor the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import tree_map


def _leaf(x, device, dtype):
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":     # ml_dtypes' bf16: via f32, lossless
        x, dtype = x.astype(np.float32), dtype or torch.bfloat16
    t = torch.from_numpy(np.array(x, copy=True))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def lm_params_from_numpy(tree, *, device, dtype=None):
    """The reference's params (a nested dict of numpy leaves: the
    transformer's and mamba2's ``{"embed", "ln_f", "head", "blocks"}`` with
    layer-stacked [L, ...] block weights, jamba's ``blocks["pos{i}"]``
    dicts of period-stacked attention, mamba, MLP or MoE weights, whisper's
    ``encoder`` and ``decoder``) as the port's, key for key. Floating
    leaves become ``dtype`` (default: each keeps its own, so the f32
    routers, dt_bias, A_log and D stay f32 among bf16 weights) on
    ``device``."""
    return tree_map(lambda x: _leaf(x, device, dtype), tree)
