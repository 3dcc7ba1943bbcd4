"""Model API of the port: ``ModelBundle`` binds an architecture config to a
device and exposes what training and serving need.

The port of ``repro/models/api.py`` for every family: the transformer's
(dense, MoE, VLM), the SSM (mamba2), the hybrid (jamba) and audio
(whisper):
  param_specs / init / n_params      — params as Specs / tensors
  forward_hidden / loss              — the forward pass, the training
                                       objective
  serve_state_shape / serve_step     — decode with a KV cache or SSM state
  prefill                            — the prompt (the transformer's with
                                       its KV cache; the others' last-
                                       position logits and no state, as the
                                       reference's)
  input_specs / make_inputs          — the inputs of a shape cell
One card has no mesh, so there are no shardings.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import (common, jamba, layers, mamba2, transformer,
                                whisper)

# each family's model module (forward_hidden, param_specs, decode_step)
_MODULES = {"dense": transformer, "moe": transformer, "vlm": transformer,
            "ssm": mamba2, "hybrid": jamba, "audio": whisper}
PORTED_FAMILIES = tuple(_MODULES)


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
        if self.cfg.family not in _MODULES:
            raise ValueError(f"no LM model for family {self.cfg.family!r}")
        self._mod = _MODULES[self.cfg.family]
        self.device = resolve_device(self.device)
        self.vocab_padded = padded_vocab(self.cfg)

    # -- params ---------------------------------------------------------
    def param_specs(self):
        return self._mod.param_specs(self.cfg, self.vocab_padded, self.dtype)

    def init(self, generator: torch.Generator):
        """Random weights from ``generator``, which lives on this bundle's
        device (``torch.Generator(device=bundle.device).manual_seed(s)``)."""
        return common.init_params(self.param_specs(), generator, self.device)

    def n_params(self) -> int:
        return common.count_params(self.param_specs())

    # -- train ----------------------------------------------------------
    def forward_hidden(self, params, batch, *, use_kernel: bool = False):
        """(the final hidden states [B,S,d], the routers' aux loss summed
        over layers): the forward pass that ``loss`` and, for mamba2,
        jamba and whisper, ``prefill`` run. The transformer's always takes
        the plain attention (its prefill is its own); the other families'
        take the flash kernel on a CUDA tensor with ``use_kernel``."""
        kw = dict(moe_impl=self.moe_impl, attn_chunk=self.attn_chunk)
        if self._mod is not transformer:
            kw["use_kernel"] = use_kernel
        return self._mod.forward_hidden(self.cfg, params, batch, **kw)

    def _head(self, params):
        if self.cfg.family == "audio":
            return params["embed"].T
        return transformer._head_weight(self.cfg, params)

    def loss(self, params, batch):
        """Mean next-token cross-entropy over ``batch["mask"]`` (all
        positions without one) plus 0.01 × the routers' aux loss per
        layer (0 without a router). Differentiable: training takes the
        plain attention whatever ``use_kernels`` says."""
        cfg = self.cfg
        hidden, aux = self.forward_hidden(params, batch)
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones(batch["targets"].shape, dtype=torch.float32,
                              device=hidden.device)
        ce = transformer.chunked_ce_loss(cfg, hidden, self._head(params),
                                         batch["targets"], mask, cfg.vocab)
        return ce + 0.01 * aux / max(cfg.n_layers, 1)

    # -- serve ----------------------------------------------------------
    def serve_state_shape(self, shape: ShapeConfig):
        """The zero decode state for ``shape.global_batch`` sequences of
        ``shape.seq_len`` tokens: a ``KVCacheQ`` if the config quantizes
        the cache to 8 bits, else a ``KVCache`` (the transformer); an
        ``SSMState`` stacked over layers (mamba2); per position a (k, v)
        or ``SSMState`` stacked over periods (jamba); self and cross K/V
        (whisper, the cross K/V zero as the reference serves it)."""
        cfg, B, T = self.cfg, shape.global_batch, shape.seq_len
        kw = dict(dtype=self.dtype, device=self.device)
        if self._mod is transformer:
            cls = layers.KVCacheQ if cfg.kv_cache_bits == 8 else layers.KVCache
            return cls.zeros(B, T, cfg.n_kv_heads, cfg.hd,
                             layers=cfg.n_layers, **kw)
        if self._mod is mamba2:
            return mamba2.mixer_init_state(cfg, B, layers=cfg.n_layers, **kw)
        return self._mod.init_decode_state(cfg, B, T, **kw)

    def serve_step(self, params, state, batch, *, length):
        """One greedy-decode step for every sequence: the new token's KV row
        (or SSM state) is written in place, at ``length`` for a KV cache;
        mamba2 ignores ``length``, as the reference does. Returns (logits
        [B,1,Vp] f32, the state one token on)."""
        cfg = self.cfg
        if self._mod is transformer:
            return transformer.decode_step(cfg, params,
                                           state._replace(length=int(length)),
                                           batch, moe_impl=self.moe_impl)
        return self._mod.decode_step(cfg, params, state, batch,
                                     length=int(length),
                                     moe_impl=self.moe_impl)

    def prefill(self, params, batch, max_len: int):
        """The prompt: the transformer's (last-position logits [B,1,Vp] f32,
        its KV cache of ``max_len`` rows); for mamba2, jamba and whisper,
        as the reference, the full forward pass and (the last position's
        logits, None). The attention takes the flash kernel on a CUDA
        tensor unless ``use_kernels`` is False."""
        cfg = self.cfg
        if self._mod is transformer:
            return transformer.prefill(cfg, params, batch, max_len,
                                       moe_impl=self.moe_impl,
                                       attn_chunk=self.attn_chunk,
                                       use_kernels=self.use_kernels)
        hidden, _ = self.forward_hidden(params, batch,
                                        use_kernel=self.use_kernels)
        return (hidden[:, -1:] @ self._head(params)).float(), None

    # -- inputs ----------------------------------------------------------
    def input_specs(self, shape: ShapeConfig) -> Dict[str, TensorSpec]:
        """The inputs of ``shape``: tokens (and targets to train), or one
        token a sequence to decode; the VLM also takes its 3-D (t/h/w)
        positions, [B, S, 3] or [B, 1, 3], and the audio model its frame
        embeddings [B, encoder_seq, d] to train and prefill."""
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
        if self.cfg.family == "audio" and shape.kind != "decode":
            d["frames"] = TensorSpec((B, self.cfg.encoder_seq,
                                      self.cfg.d_model), self.dtype)
        return d

    def make_inputs(self, shape: ShapeConfig, generator: torch.Generator):
        """Random inputs of ``shape`` from ``generator`` (on this bundle's
        device): tokens in [0, vocab), positions in [0, 16), frames normal
        (drawn in f32, cast to the bundle's dtype)."""
        out = {}
        for k, s in self.input_specs(shape).items():
            if s.dtype.is_floating_point:
                out[k] = torch.randn(s.shape, generator=generator,
                                     dtype=torch.float32,
                                     device=self.device).to(s.dtype)
                continue
            hi = self.cfg.vocab if k in ("tokens", "targets", "token") else 16
            out[k] = torch.randint(0, max(hi, 2), s.shape, generator=generator,
                                   dtype=s.dtype, device=self.device)
        return out


def build(cfg: ArchConfig, **kw) -> ModelBundle:
    """The bundle for ``cfg`` (the reference's ``build`` also takes a mesh
    and a shape for its sharding rules; one card needs neither)."""
    return ModelBundle(cfg=cfg, **kw)
