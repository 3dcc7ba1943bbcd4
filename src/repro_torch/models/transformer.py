"""Decoder-only transformer, dense family (yi / phi3 / tinyllama / granite):
param specs, prefill and single-token decode.

The port of the dense path of ``repro/models/transformer.py``. The params
keep the reference's layer-stacked layout ([L, ...] per block weight), so
specs and shapes match it leaf for leaf; the ``lax.scan`` over layers is a
loop over ``params["blocks"][name][i]``. One card needs no mesh: the
reference's ``mesh``, ``rules`` and ``constrain`` are dropped, and so is
``jax.checkpoint`` (serving takes no gradient). Training (``forward_hidden``,
the loss) and the MoE and VLM branches wait for later slices.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models.common import Spec

_BLOCK_KEYS = ("ln1", "ln2", "wq", "wk", "wv", "wo", "w_gate", "w_up",
               "w_down")


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------

def _layer_specs(cfg, n_layers: int, dtype) -> dict:
    d, hd = cfg.d_model, cfg.hd
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    Ls, f = n_layers, cfg.d_ff
    return {
        "ln1": Spec((Ls, d), ("layers", None), "ones", dtype=dtype),
        "ln2": Spec((Ls, d), ("layers", None), "ones", dtype=dtype),
        "wq": Spec((Ls, d, Hq * hd), ("layers", "embed", "q_heads"), dtype=dtype),
        "wk": Spec((Ls, d, Hkv * hd), ("layers", "embed", "kv_heads"), dtype=dtype),
        "wv": Spec((Ls, d, Hkv * hd), ("layers", "embed", "kv_heads"), dtype=dtype),
        "wo": Spec((Ls, Hq * hd, d), ("layers", "q_heads", "embed"), dtype=dtype),
        "w_gate": Spec((Ls, d, f), ("layers", "embed", "ffn"), dtype=dtype),
        "w_up": Spec((Ls, d, f), ("layers", "embed", "ffn"), dtype=dtype),
        "w_down": Spec((Ls, f, d), ("layers", "ffn", "embed"), dtype=dtype),
    }


def param_specs(cfg, vocab_padded: int, dtype=torch.bfloat16) -> dict:
    d = cfg.d_model
    specs = {
        "embed": Spec((vocab_padded, d), ("vocab", "embed"), "small", dtype=dtype),
        "ln_f": Spec((d,), (None,), "ones", dtype=dtype),
        "blocks": _layer_specs(cfg, cfg.n_layers, dtype),
    }
    if not cfg.tie_embeddings:
        specs["head"] = Spec((d, vocab_padded), ("embed", "vocab"), "small",
                             dtype=dtype)
    return specs


def layer(params, i: int) -> dict:
    """Layer ``i``'s weights: views into the stacked [L, ...] blocks."""
    return {k: params["blocks"][k][i] for k in _BLOCK_KEYS}


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _positions_for(cfg, batch, B, S, offset=0, device=None):
    if cfg.mrope_sections is not None:
        raise NotImplementedError("M-RoPE (the vlm family) is not ported yet")
    return torch.arange(S, device=device)[None, :] + offset


def _apply_rope(cfg, x, positions):
    return L.apply_rope(x, positions, cfg.rope_theta)


def block_decode(cfg, p, x, cache, positions):
    """One decoder block, single-token decode. x: [B,1,d]; the cache (this
    layer's) is updated in place."""
    B = x.shape[0]
    hd, Hq, Hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    q = (h @ p["wq"]).reshape(B, 1, Hq, hd)
    k = (h @ p["wk"]).reshape(B, 1, Hkv, hd)
    v = (h @ p["wv"]).reshape(B, 1, Hkv, hd)
    q = _apply_rope(cfg, q, positions)
    k = _apply_rope(cfg, k, positions)
    if isinstance(cache, L.KVCacheQ):
        cache = L.cache_update_q(cache, k, v)
        o = L.decode_attention_q(q, cache, dtype=x.dtype)
    else:
        cache = L.cache_update(cache, k, v)
        o = L.decode_attention(q, cache)
    x = x + o.reshape(B, 1, Hq * hd) @ p["wo"]
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + L.swiglu(h, p["w_gate"], p["w_up"], p["w_down"]), cache


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

def embed_tokens(params, tokens):
    return params["embed"][tokens]


def _head_weight(cfg, params):
    return params["embed"].T if cfg.tie_embeddings else params["head"]


def prefill(cfg, params, batch, max_len: int, *, attn_chunk=1024,
            use_kernels: bool = True):
    """Run the full prompt; return (last-token logits [B,1,Vp] f32, KV
    caches [L,B,max_len,Hkv,hd] holding the prompt's keys (after RoPE) and
    values, zero beyond). ``use_kernels=False`` takes the reference's
    chunked attention on any device."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = batch["embeds"] if "embeds" in batch else embed_tokens(params, tokens)
    positions = _positions_for(cfg, batch, B, S, device=x.device)
    hd, Hq, Hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    kc = torch.zeros((cfg.n_layers, B, max_len, Hkv, hd), dtype=x.dtype,
                     device=x.device)
    vc = torch.zeros_like(kc)
    for i in range(cfg.n_layers):
        p = layer(params, i)
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        q = (h @ p["wq"]).reshape(B, S, Hq, hd)
        k = (h @ p["wk"]).reshape(B, S, Hkv, hd)
        v = (h @ p["wv"]).reshape(B, S, Hkv, hd)
        q = _apply_rope(cfg, q, positions)
        k = _apply_rope(cfg, k, positions)
        o = L.attention(q, k, v, causal=True, chunk=attn_chunk,
                        use_kernel=use_kernels)
        x = x + o.reshape(B, S, Hq * hd) @ p["wo"]
        h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + L.swiglu(h, p["w_gate"], p["w_up"], p["w_down"])
        kc[i, :, :S] = k
        vc[i, :, :S] = v
    x = L.rms_norm(x[:, -1:], params["ln_f"], cfg.norm_eps)
    logits = (x @ _head_weight(cfg, params)).float()
    return logits, L.KVCache(kc, vc, S)


def decode_step(cfg, params, cache, batch):
    """One token for every sequence. cache leaves: [L,B,T,Hkv,hd] (a
    ``KVCache`` or ``KVCacheQ``), written in place at ``cache.length``;
    returns (logits [B,1,Vp] f32, the cache at length + 1)."""
    token = batch["token"]                                  # [B,1]
    B = token.shape[0]
    x = embed_tokens(params, token)
    pos = int(cache.length)
    quant = isinstance(cache, L.KVCacheQ)
    positions = _positions_for(cfg, batch, B, 1, offset=pos,
                               device=x.device).expand(B, 1)
    for i in range(cfg.n_layers):
        if quant:
            c = L.KVCacheQ(cache.k[i], cache.v[i], cache.k_scale[i],
                           cache.v_scale[i], pos)
        else:
            c = L.KVCache(cache.k[i], cache.v[i], pos)
        x, _ = block_decode(cfg, layer(params, i), x, c, positions)
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = (x @ _head_weight(cfg, params)).float()
    return logits, cache._replace(length=pos + 1)
