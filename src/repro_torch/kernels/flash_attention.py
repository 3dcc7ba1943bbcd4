"""CUDA kernel wrapper: exact causal (or full) softmax attention for the LM
prefill, with an online softmax.

Replaces ``repro/kernels/flash_attention.py:flash_attention`` (Pallas body
``_flash_kernel``). Source: ``csrc/flash_attention.cu``.

What bounds it on the H100: operations. At the prefill's shape (B 4,
S = T = 2048, Hq 32, Hkv 4, D 64, bf16, causal) one call does about
69 GFLOP on 8 MB of q, k, v and output: 0.07 ms at the 989 TFLOP/s bf16
tensor-core rate, far above the 2.5 µs its bytes take.

Two routes by dtype, one function (neither is a fallback of the other):

- bf16 (the prefill): tensor cores. Both products are wgmma (bf16 in, f32
  accumulate); K/V tiles come through a two-stage cp.async ring. P is
  rounded to bf16 before the PV product, as the model's own attention
  rounds ``p.to(v.dtype)`` (``models/layers.py``); the plain counterpart
  is ``ref.flash_attention_ref(..., p_dtype=torch.bfloat16)``. The copies
  move 16-byte chunks, so q, k and v must have their head dimension
  contiguous, every batch, row and head stride a multiple of 8 elements
  and 16-byte-aligned data: the model's [B, S, H, D] tensors, views of
  [B, H, S, D] ones and key-range slices all are. Any other layout raises
  ``ValueError``; nothing is copied.
- f32: SIMT (f32 FMAs, P kept in f32), any strides with the head
  dimension contiguous.

Design: q stays [B, S, Hq, D] and k, v [B, T, Hkv, D] as the model makes
them; the kernel takes their strides and maps query head h to KV head
h // (Hq / Hkv), so there is no transpose and no GQA copy. A block owns a
(batch·head, query tile) (128 rows in bf16, 64 in f32) and keeps the
tile's running max, denominator and f32 accumulator in registers over
64-key K/V tiles in shared memory, skips the key tiles above the diagonal
and masks the ragged ends (no padding). ``q_offset`` is the absolute
position of query row 0 (``layers.attention``; 0 in the prefill).

The kernel computes the forward pass only: its output is written into a
fresh tensor through ctypes and has no ``grad_fn``. Under grad mode it
refuses q, k or v that require grad (``RuntimeError``), since a loss
taken through it would train the projections before attention with no
gradient from attention at all. Training takes the plain attention
(``models.transformer.block_forward``); nothing switches to it here.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0
HEAD_DIMS = (16, 32, 64, 96, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0):
    """q: [B, S, Hq, D]; k, v: [B, T, Hkv, D], Hq % Hkv == 0, D in
    ``HEAD_DIMS``, all CUDA, one dtype (f32 or bf16), the last dimension
    contiguous (bf16: the other strides multiples of 8, data 16-byte
    aligned; f32: free) -> [B, S, Hq, D] in q's dtype. Under grad mode
    none of q, k, v may require grad: the kernel has no backward."""
    global launches
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention: the CUDA kernel has no backward pass, so its "
            "output would carry no gradient to q, k and v; call it under "
            "torch.no_grad() / inference_mode(), or train through the plain "
            "attention (models.layers.attention(..., use_kernel=False))")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
        if t.dim() != 4:
            raise ValueError(f"{name}: expected [B, S, H, D], got "
                             f"{tuple(t.shape)}")
        if t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise ValueError(f"{name}: expected f32 or bf16 like q, got "
                             f"{t.dtype}")
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name}: the head dimension must be contiguous")
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, T, Hkv, D) or v.shape != k.shape:
        raise ValueError(f"k, v: expected [{B}, T, Hkv, {D}] each, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not group over {Hkv} KV heads")
    if T < 1 or q_offset < 0:
        raise ValueError(f"need T >= 1 and q_offset >= 0 (T {T}, q_offset "
                         f"{q_offset})")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if any(st % 8 for st in t.stride()[:3]) or t.data_ptr() % 16:
                raise ValueError(
                    f"{name}: the bf16 kernel copies 16-byte chunks; it needs "
                    f"batch, row and head strides that are multiples of 8 "
                    f"elements and 16-byte-aligned data, got strides "
                    f"{t.stride()}")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if B * S == 0:
        return out
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    err = build.library().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], B, S, T, Hq, Hkv, D, int(bool(causal)),
        int(q_offset), D ** -0.5, strides, build.stream_handle(q))
    build.check(err, "flash_attention")
    launches += 1
    return out
