"""Quantized collectives with error feedback (a thin layer over
``repro_torch.comm.transport``).

Counterpart of ``repro.parallel.collectives``. The paper quantizes the
model-parallel neighbour exchange; the same shared-scale codes carry the
data-parallel all-reduce: stochastic-rounding encode, an exact int32 code
sum, decode, and an error-feedback residual so compression noise does not
bias the sum over rounds. Tensors lead with the ring's ``[data, model]``
shard axes; pytrees are lists, tuples or dicts of tensors.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.comm import transport
from repro_torch.comm.codecs import AffineCodec


def quantized_psum(x, ring, axis: str, *, bits: int = 8,
                   generator: Optional[torch.Generator] = None,
                   mode: Optional[str] = None):
    """psum of ``x`` over ``axis`` with the payload on a shared-scale
    ``bits``-bit affine grid (unbiased stochastic rounding iff a generator
    is given). The physical collective follows ``transport.psum_mode``
    unless ``mode`` pins it; both give the same bits."""
    return transport.quantized_psum(x, ring, axis, AffineCodec(bits),
                                    generator=generator, mode=mode)


def psum_with_error_feedback(grad, err, ring, axis: str, *, bits: int = 8,
                             generator: Optional[torch.Generator] = None,
                             mode: Optional[str] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compressed psum of (grad + carried error); returns (summed,
    new_error)."""
    return transport.psum_with_error_feedback(grad, err, ring, axis,
                                              AffineCodec(bits),
                                              generator=generator, mode=mode)


def _leaves(tree):
    if isinstance(tree, dict):
        return list(tree.values())
    return list(tree)


def _rebuild(like, leaves):
    if isinstance(like, dict):
        return dict(zip(like.keys(), leaves))
    return type(like)(leaves)


def compressed_grad_tree(grads, errs, ring, axis: str, *, bits: int = 8):
    """Error-feedback compressed all-reduce of every tensor in ``grads``
    (with its carried error from ``errs``, same structure); returns
    (summed, new errors) in that structure."""
    out_g, out_e = [], []
    for g, e in zip(_leaves(grads), _leaves(errs)):
        s, ne = psum_with_error_feedback(g, e, ring, axis, bits=bits)
        out_g.append(s.to(g.dtype))
        out_e.append(ne)
    return _rebuild(grads, out_g), _rebuild(errs, out_e)
