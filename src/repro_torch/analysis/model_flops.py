"""Analytic MODEL_FLOPS per (arch x shape): the useful-math floor a step's
measured flops are compared against (the 6·N·D convention, extended with
attention and decode terms).

A copy of ``repro.analysis.model_flops`` (the port imports nothing of the
JAX package); it reads the port's own ``configs.base``.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, ShapeConfig


def _attn_flops_full(cfg: ArchConfig, B: int, S: int) -> float:
    """Causal self-attention einsum flops for a full forward: QK^T + AV."""
    n_attn_layers = cfg.n_layers
    if cfg.hybrid_period:
        n_attn_layers = cfg.n_layers // cfg.hybrid_period
    if cfg.family == "ssm":
        n_attn_layers = 0
    # 2 matmuls x 2 flops x B x S^2/2 (causal) x H x hd
    per_layer = 2 * 2 * B * (S * S / 2) * cfg.n_heads * cfg.hd
    total = n_attn_layers * per_layer
    if cfg.encoder_layers:   # whisper: encoder full + decoder cross
        total += cfg.encoder_layers * 2 * 2 * B * cfg.encoder_seq ** 2 \
            * cfg.n_heads * cfg.hd
        total += cfg.n_layers * 2 * 2 * B * S * cfg.encoder_seq \
            * cfg.n_heads * cfg.hd
    return total


def _ssd_flops(cfg: ArchConfig, B: int, S: int) -> float:
    if cfg.ssm is None:
        return 0.0
    s = cfg.ssm
    n_ssm_layers = cfg.n_layers
    if cfg.hybrid_period:
        n_ssm_layers = cfg.n_layers * (cfg.hybrid_period - 1) // cfg.hybrid_period
    d_in = s.d_inner(cfg.d_model)
    q = s.chunk
    # intra-chunk quadratic + state path, both ~ 2*B*S*q*d_in (+ state dim)
    return n_ssm_layers * (2 * 2 * B * S * q * d_in
                           + 2 * 2 * B * S * s.d_state * d_in)


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """Global useful flops for one step of this cell."""
    B, S = shape.global_batch, shape.seq_len
    N = cfg.active_param_count()
    if shape.kind == "train":
        tokens = B * S
        base = 6.0 * N * tokens
        extra = 3.0 * (_attn_flops_full(cfg, B, S) + _ssd_flops(cfg, B, S))
    elif shape.kind == "prefill":
        tokens = B * S
        base = 2.0 * N * tokens
        extra = _attn_flops_full(cfg, B, S) + _ssd_flops(cfg, B, S)
    else:  # decode: one token per sequence against an S-long context
        base = 2.0 * N * B
        n_attn_layers = cfg.n_layers
        if cfg.hybrid_period:
            n_attn_layers = cfg.n_layers // cfg.hybrid_period
        if cfg.family == "ssm":
            n_attn_layers = 0
        extra = n_attn_layers * 2 * 2 * B * S * cfg.n_kv_heads * cfg.hd \
            * (cfg.n_heads // cfg.n_kv_heads)
        if cfg.encoder_layers:
            extra += cfg.n_layers * 2 * 2 * B * cfg.encoder_seq \
                * cfg.n_heads * cfg.hd
        extra += _ssd_flops(cfg, B, 1)
    return base + extra
