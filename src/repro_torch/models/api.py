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
  param_pspecs / input_pspecs /
  serve_state_specs / serve_state_pspecs / abstract_params
                                     — the shardings on a mesh, and
                                       shape-only stand-ins

``build(cfg, mesh, shape)`` binds a mesh (a ``DeviceMesh``, or a plain
``{axis: size}`` dict for the rules alone) and the rules of its
(arch, shape, mesh) cell (``parallel.sharding.make_rules``); the vocab is
padded so the model axis shards it. Without a mesh every path is the
one-card port's, with plain tensors. On a ``DeviceMesh`` the params,
inputs and decode state are DTensors (``distribute`` / ``abstract_params``
/ ``serve_state_shape``), and every family runs on them: each model
module takes the bundle's ``rules`` for its ``constrain`` sites.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch.utils import _pytree as pytree

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import (common, jamba, layers, mamba2, transformer,
                                whisper)
from repro_torch.models.common import TensorSpec
from repro_torch.parallel import sharding as sh

# each family's model module (forward_hidden, param_specs, decode_step)
_MODULES = {"dense": transformer, "moe": transformer, "vlm": transformer,
            "ssm": mamba2, "hybrid": jamba, "audio": whisper}
PORTED_FAMILIES = tuple(_MODULES)


@dataclasses.dataclass
class ModelBundle:
    cfg: ArchConfig
    device: Optional[torch.device] = None
    moe_impl: str = "einsum"   # the MoE dispatch: "einsum" or "gather"
    attn_chunk: int = 1024
    dtype: torch.dtype = torch.bfloat16
    use_kernels: bool = True   # False: the plain attention on any device
    mesh: Any = None           # a DeviceMesh, an {axis: size} dict, or None
    rules: Optional[sh.Rules] = None

    def __post_init__(self):
        if self.cfg.family not in _MODULES:
            raise ValueError(f"no LM model for family {self.cfg.family!r}")
        self._mod = _MODULES[self.cfg.family]
        if self.device is None and self.on_mesh:
            self.device = torch.device(self.mesh.device_type)
        self.device = resolve_device(self.device)
        if self.mesh is not None and self.rules is None:
            self.rules = sh.make_rules(self.mesh, self.cfg)
        self.vocab_padded = sh.padded_vocab(self.cfg, self.mesh)

    @property
    def on_mesh(self) -> bool:
        """Whether the bundle's tensors are DTensors (a ``DeviceMesh``)."""
        return hasattr(self.mesh, "device_type")

    # -- params ---------------------------------------------------------
    def param_specs(self):
        return self._mod.param_specs(self.cfg, self.vocab_padded, self.dtype)

    def param_pspecs(self):
        return common.param_pspecs(self.param_specs(), self.rules)

    def abstract_params(self):
        """Shape-only params: whole tensors without a mesh, DTensors of
        their local shards on one (fake inside the dry run's
        ``FakeTensorMode``, else on the meta device)."""
        if not self.on_mesh:
            return common.abstract_params(self.param_specs())
        return common.abstract_params(self.param_specs(), self.mesh,
                                      self.rules)

    def init(self, generator: torch.Generator):
        """Random weights from ``generator``, which lives on this bundle's
        device (``torch.Generator(device=bundle.device).manual_seed(s)``).
        On a mesh every rank draws the whole of each leaf (the same seed
        gives the same weights) and keeps its shard."""
        params = common.init_params(self.param_specs(), generator,
                                    self.device)
        if self.on_mesh:
            params = common.distribute_params(params, self.param_specs(),
                                              self.mesh, self.rules)
        return params

    def distribute(self, tree, pspecs):
        """``tree`` (whole tensors, the same on every rank) as DTensors
        under ``pspecs`` on the bundle's ``DeviceMesh``; as it is without
        one."""
        if not self.on_mesh:
            return tree
        return common.distribute_tree(tree, pspecs, self.mesh)

    def n_params(self) -> int:
        return common.count_params(self.param_specs())

    # -- train ----------------------------------------------------------
    def forward_hidden(self, params, batch, *, use_kernel: bool = False):
        """(the final hidden states [B,S,d], the routers' aux loss summed
        over layers): the forward pass that ``loss`` and, for mamba2,
        jamba and whisper, ``prefill`` run. The transformer's always takes
        the plain attention (its prefill is its own); the other families'
        take the flash kernel on a CUDA tensor with ``use_kernel``."""
        kw = dict(moe_impl=self.moe_impl, attn_chunk=self.attn_chunk,
                  rules=self.rules)
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
            mask = torch.ones_like(batch["targets"], dtype=torch.float32)
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
        if self.on_mesh:
            return pytree.tree_map(
                lambda x, spec: (self._zeros(x, spec)
                                 if isinstance(x, torch.Tensor) else x),
                self._state(shape, "meta"), self.serve_state_pspecs(shape),
                is_leaf=lambda x: isinstance(x, sh.PSpec))
        return self._state(shape, self.device)

    def _zeros(self, x, spec):
        """Zeros like the meta tensor ``x``, laid out by ``spec`` (fake in
        the dry run's ``FakeTensorMode``)."""
        local = sh.shard_shape(x.shape, spec, self.mesh)
        return common.placed(torch.zeros(local, dtype=x.dtype,
                                         device=self.device),
                             tuple(x.shape), spec, self.mesh)

    def _state(self, shape: ShapeConfig, device):
        cfg, B, T = self.cfg, shape.global_batch, shape.seq_len
        kw = dict(dtype=self.dtype, device=device)
        if self._mod is transformer:
            cls = layers.KVCacheQ if cfg.kv_cache_bits == 8 else layers.KVCache
            return cls.zeros(B, T, cfg.n_kv_heads, cfg.hd,
                             layers=cfg.n_layers, **kw)
        if self._mod is mamba2:
            return mamba2.mixer_init_state(cfg, B, layers=cfg.n_layers, **kw)
        return self._mod.init_decode_state(cfg, B, T, **kw)

    def serve_state_specs(self, shape: ShapeConfig):
        """The decode state's structure with a ``TensorSpec`` for each
        tensor (the reference's ``jax.eval_shape`` of it): nothing is
        allocated."""
        return pytree.tree_map(
            lambda x: (TensorSpec(tuple(x.shape), x.dtype)
                       if isinstance(x, torch.Tensor) else x),
            self._state(shape, "meta"))

    def serve_state_pspecs(self, shape: ShapeConfig):
        """The decode state's PSpecs, leaf for leaf (a KV cache's
        ``length`` replicated)."""
        cfg, r = self.cfg, self.rules
        kv = sh.pspec(("layers", "batch", "kv_seq", "act_kv_heads", None), r)
        kv_mha = sh.pspec(("layers", "batch", "kv_seq", "act_heads", None), r)
        cross = sh.pspec(("layers", "batch", None, "act_heads", None), r)
        scalar = sh.pspec((), r)

        def ssm_pspecs():
            return mamba2.SSMState(
                sh.pspec(("layers", "batch", None, "ssm_inner"), r),
                sh.pspec(("layers", "batch", None, None), r),
                sh.pspec(("layers", "batch", None, None), r),
                sh.pspec(("layers", "batch", "ssm_heads", None, None), r))

        kv_scale = sh.pspec(("layers", "batch", "kv_seq", "act_kv_heads"), r)
        fam = cfg.family
        if fam in ("dense", "moe", "vlm"):
            if cfg.kv_cache_bits == 8:
                return layers.KVCacheQ(kv, kv, kv_scale, kv_scale, scalar)
            return layers.KVCache(kv, kv, scalar)
        if fam == "ssm":
            return ssm_pspecs()
        if fam == "hybrid":
            out = {}
            for i, (mixer, _) in enumerate(jamba._positions(cfg)):
                out[f"pos{i}"] = (kv, kv) if mixer == "attn" else ssm_pspecs()
            return out
        if fam == "audio":
            return {"self_k": kv_mha, "self_v": kv_mha,
                    "cross_k": cross, "cross_v": cross}
        raise ValueError(fam)

    def serve_step(self, params, state, batch, *, length):
        """One greedy-decode step for every sequence: the new token's KV row
        (or SSM state) is written in place, at ``length`` for a KV cache;
        mamba2 ignores ``length``, as the reference does. ``length`` is an
        int or a 0-d int tensor on the bundle's device (the reference's
        traced ``jnp.int32``), which no family reads on the host. Returns
        (logits [B,1,Vp] f32, the state one token on)."""
        cfg = self.cfg
        if not isinstance(length, torch.Tensor):
            length = int(length)
        if self._mod is transformer:
            return transformer.decode_step(cfg, params,
                                           state._replace(length=length),
                                           batch, moe_impl=self.moe_impl,
                                           rules=self.rules)
        return self._mod.decode_step(cfg, params, state, batch,
                                     length=length, moe_impl=self.moe_impl,
                                     rules=self.rules)

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
                                       use_kernels=self.use_kernels,
                                       rules=self.rules)
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
        (drawn in f32, cast to the bundle's dtype); on a mesh, each rank
        draws them whole and keeps its shard."""
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
        if self.on_mesh:
            out = self.distribute(out, self.input_pspecs(shape))
        return out

    def input_pspecs(self, shape: ShapeConfig):
        """The inputs' PSpecs: tokens, targets and masks by ("batch",
        "act_seq"), positions and frames by batch and sequence too."""
        out = {}
        for k, v in self.input_specs(shape).items():
            if k in ("tokens", "targets", "token", "mask"):
                out[k] = sh.pspec(("batch", "act_seq")[: len(v.shape)],
                                  self.rules)
            elif k == "positions":
                out[k] = sh.pspec(("batch", "act_seq", None), self.rules)
            elif k == "frames":
                out[k] = sh.pspec(("batch", "act_seq", "act_embed"),
                                  self.rules)
        return out

    def abstract_inputs(self, shape: ShapeConfig):
        """Shape-only inputs of ``shape``, laid out by ``input_pspecs`` on
        a mesh."""
        specs = self.input_specs(shape)
        if not self.on_mesh:
            return {k: common.abstract_tensor(s.shape, s.dtype)
                    for k, s in specs.items()}
        pspecs = self.input_pspecs(shape)
        return {k: common.abstract_tensor(s.shape, s.dtype, pspecs[k],
                                          self.mesh)
                for k, s in specs.items()}


def build(cfg: ArchConfig, mesh=None, shape: Optional[ShapeConfig] = None,
          **kw) -> ModelBundle:
    """The bundle for ``cfg``; with a ``mesh``, bound to it and to the
    sharding rules of the (``cfg``, ``shape``, ``mesh``) cell."""
    rules = sh.make_rules(mesh, cfg, shape) if mesh is not None else None
    return ModelBundle(cfg=cfg, mesh=mesh, rules=rules, **kw)
