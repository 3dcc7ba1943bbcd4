"""Config system: architecture + shape descriptors and the registry.

A copy of the reference's ``repro/configs/base.py`` (the port imports
nothing of the JAX package). Every architecture has one
``repro_torch/configs/<id>.py`` exporting ``CONFIG`` with the published
numbers. ``reduced()`` yields the same-family small config of the CPU
tests. The port builds every family of the reference (dense, MoE, VLM,
SSM, hybrid, audio), so all ten LM configs are here.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, field, replace
from typing import Optional, Sequence


# ---------------------------------------------------------------------------
# Shapes (assigned; identical set for every LM arch)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

ALL_SHAPES: Sequence[ShapeConfig] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    # Apply MoE every `every` layers (jamba uses 2: alternating MoE/dense MLP).
    every: int = 1
    capacity_factor: float = 1.0


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256  # SSD chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str            # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (jamba): period-P block with attention at one index, rest mamba
    hybrid_period: int = 0                  # 0 = not hybrid
    hybrid_attn_index: int = 0
    # enc-dec (whisper): encoder stack mirrors decoder dims
    encoder_layers: int = 0
    encoder_seq: int = 0                    # stubbed frame count
    rope_theta: float = 10_000.0
    mrope_sections: Optional[Sequence[int]] = None   # qwen2-vl M-RoPE
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    source: str = ""
    # distribution hints
    use_fsdp: bool = False                  # shard params over the data axis too
    remat: bool = True
    microbatches: int = 1                   # grad-accumulation splits (train)
    remat_group: int = 1                    # layers per remat group (saves /g)
    kv_cache_bits: int = 16                 # 8 = int8-quantized KV (decode)
    opt_bits: int = 32                      # 8 = int8 Adam moments
    accum_bf16: bool = False                # bf16 microbatch grad accumulator
    # which assigned shapes to skip entirely, name -> reason
    shape_skips: dict = field(default_factory=dict)

    # -- derived -----------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    def is_subquadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (embedding + stacked blocks + head)."""
        d, L = self.d_model, self.n_layers
        total = self.vocab * d  # embedding
        if not self.tie_embeddings:
            total += self.vocab * d  # lm head
        for i in range(L):
            total += self.layer_param_count(i)
        if self.encoder_layers:
            enc_attn = 4 * d * self.hd * self.n_heads
            enc_ffn = 2 * d * self.d_ff  # GELU mlp (up+down)
            total += self.encoder_layers * (enc_attn + enc_ffn + 2 * d)
        return total

    def layer_param_count(self, i: int) -> int:
        d = self.d_model
        qkv = d * self.hd * self.n_heads + 2 * d * self.hd * self.n_kv_heads
        o = self.hd * self.n_heads * d
        attn = qkv + o
        if self.moe is not None and (i % self.moe.every == self.moe.every - 1
                                     if self.moe.every > 1 else True):
            ffn = self.moe.num_experts * 3 * d * self.moe.d_ff_expert + d * self.moe.num_experts
        else:
            ffn = 3 * d * self.d_ff  # SwiGLU
        if self.family == "ssm":
            s = self.ssm
            di = s.d_inner(d)
            nh = s.n_heads(d)
            ssm = (d * (2 * di + 2 * s.d_state * (di // s.head_dim) // (di // s.head_dim)))
            # in_proj: d -> 2*di + 2*n_groups*d_state + n_heads ; out_proj di->d
            ssm = d * (2 * di + 2 * s.d_state + nh) + di * d + s.d_conv * (di + 2 * s.d_state)
            return ssm + d  # + norm
        if self.hybrid_period:
            # average: 1 attn + (P-1) mamba per period, MoE per `every`
            pass
        return attn + ffn + 2 * d  # two RMSNorm scales

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k experts only)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        total = self.param_count()
        moe_layers = sum(1 for i in range(self.n_layers)
                         if (i % self.moe.every == self.moe.every - 1
                             if self.moe.every > 1 else True))
        dense_exp = self.moe.num_experts * 3 * d * self.moe.d_ff_expert
        active_exp = self.moe.top_k * 3 * d * self.moe.d_ff_expert
        return total - moe_layers * (dense_exp - active_exp)

    # -- reduced config for smoke tests -------------------------------------
    def reduced(self) -> "ArchConfig":
        d = 64
        n_heads = 4
        n_kv = max(1, self.n_kv_heads * n_heads // self.n_heads)
        kw = dict(
            n_layers=min(self.n_layers, 2 if not self.hybrid_period else self.hybrid_period),
            d_model=d, n_heads=n_heads, n_kv_heads=n_kv, d_ff=128,
            vocab=256, head_dim=16, use_fsdp=False, remat=False,
            microbatches=1,
        )
        if self.moe is not None:
            kw["moe"] = replace(self.moe, num_experts=4, top_k=2, d_ff_expert=32)
        if self.ssm is not None:
            kw["ssm"] = replace(self.ssm, d_state=16, head_dim=16, chunk=32)
        if self.hybrid_period:
            kw["n_layers"] = self.hybrid_period
        if self.encoder_layers:
            kw["encoder_layers"] = 2
            kw["encoder_seq"] = 32
        if self.mrope_sections is not None:
            kw["mrope_sections"] = (4, 6, 6)  # sums to head_dim/2 = 8? -> fixed below
            kw["head_dim"] = 32
            kw["mrope_sections"] = (4, 6, 6)
        return replace(self, **kw)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

# The reference's ten LM configs, in its order. "gamlp-paper" is the
# paper's own GA-MLP, registered (as in the reference) but not an LM arch.
ARCH_IDS = (
    "yi-9b", "phi3-mini-3.8b", "tinyllama-1.1b", "granite-8b", "mamba2-130m",
    "whisper-tiny", "granite-moe-3b-a800m", "qwen3-moe-235b-a22b",
    "jamba-v0.1-52b", "qwen2-vl-7b",
)

_MODULE_BY_ID = {
    "yi-9b": "yi_9b",
    "phi3-mini-3.8b": "phi3_mini",
    "tinyllama-1.1b": "tinyllama",
    "granite-8b": "granite_8b",
    "mamba2-130m": "mamba2_130m",
    "whisper-tiny": "whisper_tiny",
    "granite-moe-3b-a800m": "granite_moe",
    "qwen3-moe-235b-a22b": "qwen3_moe",
    "jamba-v0.1-52b": "jamba",
    "qwen2-vl-7b": "qwen2_vl",
    "gamlp-paper": "gamlp_paper",
}


def get_arch(name: str) -> ArchConfig:
    if name not in _MODULE_BY_ID:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULE_BY_ID)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_BY_ID[name]}")
    return mod.CONFIG


def arch_shape_cells(arch: ArchConfig):
    """Yield (shape, skip_reason|None) for all 4 assigned shapes."""
    for s in ALL_SHAPES:
        reason = arch.shape_skips.get(s.name)
        if reason is None and s.name == "long_500k" and not arch.is_subquadratic():
            reason = "full quadratic attention; 512k decode assigned only to SSM/hybrid"
        yield s, reason
