"""Jamba (arXiv:2403.19887): a hybrid of Mamba and attention layers, 7:1,
with an MoE in place of the MLP on every other layer.

The port of ``repro/models/jamba.py``. A period of 8 sublayers [M M M M
A M M M] (attention at index 4); the MoE replaces the MLP at odd indices,
a dense SwiGLU otherwise. The params are stacked over periods
([n_periods, ...] leaves under ``blocks["pos{i}"]``), and a loop over the
periods runs the 8 unlike sublayers in turn. Jamba has no positional
encoding (the Mamba layers carry position), so its attention is NoPE.
Its Mamba layers are the reference's Mamba2 (SSD) mixers
(``models.mamba2``); the published Jamba v0.1 uses Mamba-1 layers.

The prefill (``ModelBundle.prefill``, no grad) launches the flash kernel
once per period on a CUDA tensor; the loss takes the plain attention
(``use_kernel=False``), since the kernel has no backward. The decode
state, a (k, v) pair or an ``SSMState`` per position, each stacked over
periods, is written in place in the period's view.

On a mesh (the bundle's ``rules``) the reference's ``constrain`` sites
are kept (q by heads, each sublayer's output as the activations, the
embedding), plus one after the attention's residual (the tensor-parallel
all-reduce, as the transformer has); the mixers run as ``mamba2``'s on a
mesh, the MoE sublayers as ``layers.moe``'s, and the decode state is
written into each rank's shard.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models.common import Spec, unstack
from repro_torch.models.transformer import (ACT, _head_weight, _heads,
                                            embed_tokens)
from repro_torch.parallel.sharding import constrain, on_mesh_of, project


def _attn_specs(cfg, n: int, dtype) -> dict:
    d, hd, Hq, Hkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    return {
        "ln": Spec((n, d), ("layers", None), "ones", dtype=dtype),
        "wq": Spec((n, d, Hq * hd), ("layers", "embed", "q_heads"), dtype=dtype),
        "wk": Spec((n, d, Hkv * hd), ("layers", "embed", "kv_heads"), dtype=dtype),
        "wv": Spec((n, d, Hkv * hd), ("layers", "embed", "kv_heads"), dtype=dtype),
        "wo": Spec((n, Hq * hd, d), ("layers", "q_heads", "embed"), dtype=dtype),
    }


def _mlp_specs(cfg, n: int, dtype) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "ln": Spec((n, d), ("layers", None), "ones", dtype=dtype),
        "w_gate": Spec((n, d, f), ("layers", "embed", "ffn"), dtype=dtype),
        "w_up": Spec((n, d, f), ("layers", "embed", "ffn"), dtype=dtype),
        "w_down": Spec((n, f, d), ("layers", "ffn", "embed"), dtype=dtype),
    }


def _moe_specs(cfg, n: int, dtype) -> dict:
    d, E, f = cfg.d_model, cfg.moe.num_experts, cfg.moe.d_ff_expert
    return {
        "ln": Spec((n, d), ("layers", None), "ones", dtype=dtype),
        "w_router": Spec((n, d, E), ("layers", "embed", "experts"), "small",
                         dtype=torch.float32),
        "w_gate_e": Spec((n, E, d, f), ("layers", "experts", "embed", "ffn_exp"), dtype=dtype),
        "w_up_e": Spec((n, E, d, f), ("layers", "experts", "embed", "ffn_exp"), dtype=dtype),
        "w_down_e": Spec((n, E, f, d), ("layers", "experts", "ffn_exp", "embed"), dtype=dtype),
    }


def _positions(cfg):
    """(mixer, ffn) of each sublayer of a period: "attn" or "mamba", "moe"
    or "mlp"."""
    period, attn_i = cfg.hybrid_period, cfg.hybrid_attn_index
    out = []
    for i in range(period):
        mixer = "attn" if i == attn_i else "mamba"
        ffn = "moe" if (cfg.moe and i % cfg.moe.every == 1) else "mlp"
        out.append((mixer, ffn))
    return out


def param_specs(cfg, vocab_padded: int, dtype=torch.bfloat16) -> dict:
    n_periods = cfg.n_layers // cfg.hybrid_period
    blocks = {}
    for i, (mixer, ffn) in enumerate(_positions(cfg)):
        b = {}
        if mixer == "attn":
            b["attn"] = _attn_specs(cfg, n_periods, dtype)
        else:
            b["mamba"] = M2.mixer_specs(cfg, n_periods, dtype)
        b[ffn] = _moe_specs(cfg, n_periods, dtype) if ffn == "moe" \
            else _mlp_specs(cfg, n_periods, dtype)
        blocks[f"pos{i}"] = b
    d = cfg.d_model
    specs = {
        "embed": Spec((vocab_padded, d), ("vocab", "embed"), "small", dtype=dtype),
        "ln_f": Spec((d,), (None,), "ones", dtype=dtype),
        "blocks": blocks,
    }
    if not cfg.tie_embeddings:
        specs["head"] = Spec((d, vocab_padded), ("embed", "vocab"), "small",
                             dtype=dtype)
    return specs


def _qkv(cfg, p, x, rules, *, split_kv: bool):
    """q, k, v [B,S,H,hd] of the attention sublayer, each projection laid
    out by its heads first on a mesh (``transformer._heads``). With
    ``split_kv`` (the full sequence) k and v go through ``project``, as
    the transformer's do."""
    hd, Hq, Hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    kv = project if split_kv else (lambda a, w: a @ w)
    return (_heads(h @ p["wq"], Hq, hd, "act_heads", rules),
            _heads(kv(h, p["wk"]), Hkv, hd, "act_kv_heads", rules),
            _heads(kv(h, p["wv"]), Hkv, hd, "act_kv_heads", rules))


def _attn_fwd(cfg, p, x, attn_chunk, use_kernel, rules=None):
    """NoPE causal attention sublayer, the residual added (and laid out as
    the activations: the tensor-parallel all-reduce on a mesh)."""
    B, S, _ = x.shape
    q, k, v = _qkv(cfg, p, x, rules, split_kv=True)
    q = constrain(q, None, ("batch", "act_seq", "act_heads", None), rules)
    o = L.attention(q, k, v, causal=True, chunk=attn_chunk,
                    use_kernel=use_kernel)
    o = constrain(o.reshape(B, S, cfg.n_heads * cfg.hd), None,
                  ("batch", "act_seq", "act_heads"), rules)
    return constrain(x + o @ p["wo"], None, ACT, rules)


def _ffn_fwd(cfg, p, x, ffn_kind, moe_impl, rules=None):
    """The MoE or SwiGLU sublayer: (x with the residual added, laid out as
    the activations, and the router's aux loss or 0.0)."""
    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    if ffn_kind == "moe":
        y, aux = L.moe(h, p, cfg.moe.top_k, cfg.moe.capacity_factor,
                       impl=moe_impl)
    else:
        y, aux = L.swiglu(h, p["w_gate"], p["w_up"], p["w_down"]), 0.0
    return constrain(x + y, None, ACT, rules), aux


def forward_hidden(cfg, params, batch, *, moe_impl="einsum", attn_chunk=1024,
                   use_kernel: bool = False, rules=None, **_):
    """Embed + every period + the final norm. Returns (hidden [B,S,d], the
    aux loss summed over the MoE sublayers, f32). ``use_kernel``: the
    attention's flash kernel on a CUDA tensor (the prefill; never under
    grad). With ``cfg.remat`` under grad mode each sublayer and each period
    runs under a checkpoint that keeps only its input, as the reference's
    two ``jax.checkpoint``s."""
    x = constrain(embed_tokens(params, batch["tokens"]), None, ACT, rules)
    positions = _positions(cfg)
    remat = cfg.remat and torch.is_grad_enabled()

    def sublayer(mixer, ffn, x, b):
        if mixer == "attn":
            x = _attn_fwd(cfg, b["attn"], x, attn_chunk, use_kernel, rules)
        else:
            x = M2.mixer_forward(cfg, b["mamba"], x, rules)
        return _ffn_fwd(cfg, b[ffn], x, ffn, moe_impl, rules)

    def period(x, p):
        aux = on_mesh_of(torch.zeros((), dtype=torch.float32,
                                     device=x.device), x)
        for i, (mixer, ffn) in enumerate(positions):
            args = (mixer, ffn, x, p[f"pos{i}"])
            x, a = (checkpoint(sublayer, *args, use_reentrant=False) if remat
                    else sublayer(*args))
            aux = aux + a
        return x, aux

    aux = 0.0
    for p in unstack(params["blocks"]):
        x, a = (checkpoint(period, x, p, use_reentrant=False) if remat
                else period(x, p))
        aux = aux + a
    return L.rms_norm(x, params["ln_f"], cfg.norm_eps), aux


# --- decode ---------------------------------------------------------------

def init_decode_state(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                      device=None):
    """The zero decode state: for each position ``pos{i}`` a (k, v) KV
    cache (the attention's) or an ``SSMState`` (a mixer's), stacked over
    periods."""
    n_periods = cfg.n_layers // cfg.hybrid_period
    state = {}
    for i, (mixer, _) in enumerate(_positions(cfg)):
        if mixer == "attn":
            state[f"pos{i}"] = tuple(L.KVCache.zeros(
                batch, max_len, cfg.n_kv_heads, cfg.hd, dtype,
                layers=n_periods, device=device))[:2]
        else:
            state[f"pos{i}"] = M2.mixer_init_state(
                cfg, batch, layers=n_periods, dtype=dtype, device=device)
    return state


def decode_step(cfg, params, state, batch, *, length,
                moe_impl="einsum", rules=None, **_):
    """One token for every sequence: the attention's new K/V row written at
    ``length`` (an int, or a 0-d tensor read on the device) and the
    mixers' states, each in the period's view of the stacked ``state`` (in
    place; on a mesh into each rank's shard). Returns (logits [B,1,Vp]
    f32, the state)."""
    if not isinstance(length, torch.Tensor):
        length = int(length)
    x = constrain(embed_tokens(params, batch["token"]), None, ACT, rules)
    positions = _positions(cfg)
    B = x.shape[0]
    for j, p in enumerate(unstack(params["blocks"])):
        for i, (mixer, ffn) in enumerate(positions):
            b, st = p[f"pos{i}"], state[f"pos{i}"]
            if mixer == "attn":
                q, k, v = _qkv(cfg, b["attn"], x, rules, split_kv=False)
                cache = L.cache_update(L.KVCache(st[0][j], st[1][j],
                                                 length), k, v)
                o = L.decode_attention(q, cache)
                x = constrain(x + o.reshape(B, 1, cfg.n_heads * cfg.hd)
                              @ b["attn"]["wo"], None, ACT, rules)
            else:
                x, new = M2.mixer_decode(cfg, b["mamba"], x,
                                         M2.SSMState(*(t[j] for t in st)),
                                         rules)
                M2.write_state(st, j, new)
            x, _ = _ffn_fwd(cfg, b[ffn], x, ffn, moe_impl, rules)
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = (x @ _head_weight(cfg, params)).float()
    return logits, state
