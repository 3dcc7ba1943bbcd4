"""Model API of the port: ``ModelBundle`` binds an architecture config to a
device and exposes what training and serving need.

The port of ``repro/models/api.py`` for the transformer's families (dense,
MoE, VLM):
  param_specs / init / n_params      — params as Specs / tensors
  loss(params, batch)                — the training objective
  serve_state_shape / serve_step     — decode with a KV cache
  prefill                            — the prompt, with its KV cache
  input_specs / make_inputs          — the inputs of a shape cell
One card has no mesh, so there are no shardings. The SSM, hybrid and
audio families wait for later slices: ``build`` raises for them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import common, layers, transformer

PORTED_FAMILIES = ("dense", "moe", "vlm")


class TensorSpec(NamedTuple):
    """Shape and dtype of one model input (the reference's
    ``jax.ShapeDtypeStruct``)."""
    shape: tuple
    dtype: torch.dtype


def padded_vocab(cfg: ArchConfig) -> int:
    """Vocab padded to a multiple of 256: the reference's rule on its
    (1, 1) host mesh, where the model axis adds no factor."""
    if cfg.vocab == 0:
        return 0
    return ((cfg.vocab + 255) // 256) * 256


@dataclasses.dataclass
class ModelBundle:
    cfg: ArchConfig
    device: Optional[torch.device] = None
    moe_impl: str = "einsum"   # the MoE dispatch: "einsum" or "gather"
    attn_chunk: int = 1024
    dtype: torch.dtype = torch.bfloat16
    use_kernels: bool = True   # False: the plain attention on any device

    def __post_init__(self):
        if self.cfg.family not in PORTED_FAMILIES:
            raise NotImplementedError(
                f"family {self.cfg.family!r} not ported yet (the port serves "
                f"{', '.join(PORTED_FAMILIES)})")
        self.device = resolve_device(self.device)
        self.vocab_padded = padded_vocab(self.cfg)

    # -- params ---------------------------------------------------------
    def param_specs(self):
        return transformer.param_specs(self.cfg, self.vocab_padded, self.dtype)

    def init(self, generator: torch.Generator):
        """Random weights from ``generator``, which lives on this bundle's
        device (``torch.Generator(device=bundle.device).manual_seed(s)``)."""
        return common.init_params(self.param_specs(), generator, self.device)

    def n_params(self) -> int:
        return common.count_params(self.param_specs())

    # -- train ----------------------------------------------------------
    def loss(self, params, batch):
        """Mean next-token cross-entropy over ``batch["mask"]`` (all
        positions without one) plus 0.01 × the routers' aux loss per
        layer (0 for the dense family). Differentiable: training takes the
        plain attention whatever ``use_kernels`` says."""
        return transformer.loss_fn(self.cfg, params, batch, self.cfg.vocab,
                                   moe_impl=self.moe_impl,
                                   attn_chunk=self.attn_chunk)

    # -- serve ----------------------------------------------------------
    def serve_state_shape(self, shape: ShapeConfig):
        """The zero decode state for ``shape.global_batch`` sequences of
        ``shape.seq_len`` tokens: a ``KVCacheQ`` if the config quantizes
        the cache to 8 bits, else a ``KVCache``."""
        cfg = self.cfg
        cls = layers.KVCacheQ if cfg.kv_cache_bits == 8 else layers.KVCache
        return cls.zeros(shape.global_batch, shape.seq_len, cfg.n_kv_heads,
                         cfg.hd, self.dtype, layers=cfg.n_layers,
                         device=self.device)

    def serve_step(self, params, state, batch, *, length):
        """One greedy-decode step for every sequence: the new token's KV row
        is written at ``length`` (in place) and attended with the rows
        before it. Returns (logits [B,1,Vp] f32, the state at length + 1)."""
        return transformer.decode_step(self.cfg, params,
                                       state._replace(length=int(length)),
                                       batch, moe_impl=self.moe_impl)

    def prefill(self, params, batch, max_len: int):
        return transformer.prefill(self.cfg, params, batch, max_len,
                                   moe_impl=self.moe_impl,
                                   attn_chunk=self.attn_chunk,
                                   use_kernels=self.use_kernels)

    # -- inputs ----------------------------------------------------------
    def input_specs(self, shape: ShapeConfig) -> Dict[str, TensorSpec]:
        """The inputs of ``shape``: tokens (and targets to train), or one
        token a sequence to decode; the VLM also takes its 3-D (t/h/w)
        positions, [B, S, 3] or [B, 1, 3]."""
        B, S = shape.global_batch, shape.seq_len
        i32 = torch.int32
        if shape.kind == "train":
            d = {"tokens": TensorSpec((B, S), i32),
                 "targets": TensorSpec((B, S), i32)}
        elif shape.kind == "prefill":
            d = {"tokens": TensorSpec((B, S), i32)}
        elif shape.kind == "decode":
            d = {"token": TensorSpec((B, 1), i32)}
        else:
            raise ValueError(f"unknown shape kind {shape.kind!r}")
        if self.cfg.family == "vlm":
            d["positions"] = TensorSpec(
                (B, S, 3) if shape.kind != "decode" else (B, 1, 3), i32)
        return d

    def make_inputs(self, shape: ShapeConfig, generator: torch.Generator):
        """Random inputs of ``shape`` from ``generator`` (on this bundle's
        device): tokens in [0, vocab), positions in [0, 16)."""
        out = {}
        for k, s in self.input_specs(shape).items():
            hi = self.cfg.vocab if k in ("tokens", "targets", "token") else 16
            out[k] = torch.randint(0, max(hi, 2), s.shape, generator=generator,
                                   dtype=s.dtype, device=self.device)
        return out


def build(cfg: ArchConfig, **kw) -> ModelBundle:
    """The bundle for ``cfg`` (the reference's ``build`` also takes a mesh
    and a shape for its sharding rules; one card needs neither)."""
    return ModelBundle(cfg=cfg, **kw)
