"""Serving steps of one (arch x shape) cell: the port of the serve half of
``repro/launch/steps.py``. PyTorch runs eagerly, so a step is a closure
over the bundle (the reference returns functions to ``jax.jit``). The
train step waits for the training slice.
"""
from __future__ import annotations

from repro_torch.configs.base import ShapeConfig
from repro_torch.models.api import ModelBundle


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
