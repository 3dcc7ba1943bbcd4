"""Whisper-tiny's backbone (arXiv:2212.04356): an encoder-decoder
transformer.

The port of ``repro/models/whisper.py``. The conv audio frontend is a
stub there too: ``ModelBundle.input_specs`` supplies precomputed frame
embeddings [B, encoder_seq, d] (what the two conv layers would emit). The
encoder is bidirectional; the decoder has causal self-attention and
cross-attention to the encoded frames. LayerNorm (not RMSNorm), GELU
MLPs and sinusoidal positions, as in the original.

Every attention (the encoder's, the decoder's self and cross) is one
flash-kernel launch on a CUDA tensor under ``use_kernel=True`` (the
prefill); the loss takes the plain attention, since the kernel has no
backward. The decoder's self K/V cache is written in place; the cross
K/V (``precompute_cross``) is read whole at every step.

On a mesh (the bundle's ``rules``) the sinusoids join the activations'
mesh, each layer's end is laid out as the reference's ``constrain``s lay
it out, and so is each attention's residual (the tensor-parallel
all-reduce), in decode too; the projections go through ``project``.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models.common import Spec, unstack
from repro_torch.models.transformer import ACT, _heads, embed_tokens
from repro_torch.parallel.sharding import constrain, on_mesh_of, project


def sinusoidal(n: int, d: int, device=None):
    """[n, d] f32: sin of position / 10000^(i / (d/2)) in the first half,
    cos in the second."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (dim / (d // 2)))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _attn_specs(cfg, n, dtype, prefix=""):
    d, hd, H = cfg.d_model, cfg.hd, cfg.n_heads
    return {
        f"{prefix}ln_s": Spec((n, d), ("layers", None), "ones", dtype=dtype),
        f"{prefix}ln_b": Spec((n, d), ("layers", None), "zeros", dtype=dtype),
        f"{prefix}wq": Spec((n, d, H * hd), ("layers", "embed", "q_heads"), dtype=dtype),
        f"{prefix}wk": Spec((n, d, H * hd), ("layers", "embed", "q_heads"), dtype=dtype),
        f"{prefix}wv": Spec((n, d, H * hd), ("layers", "embed", "q_heads"), dtype=dtype),
        f"{prefix}wo": Spec((n, H * hd, d), ("layers", "q_heads", "embed"), dtype=dtype),
    }


def _mlp_specs(cfg, n, dtype):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mlp_ln_s": Spec((n, d), ("layers", None), "ones", dtype=dtype),
        "mlp_ln_b": Spec((n, d), ("layers", None), "zeros", dtype=dtype),
        "w_up": Spec((n, d, f), ("layers", "embed", "ffn"), dtype=dtype),
        "b_up": Spec((n, f), ("layers", "ffn"), "zeros", dtype=dtype),
        "w_down": Spec((n, f, d), ("layers", "ffn", "embed"), dtype=dtype),
        "b_down": Spec((n, d), ("layers", None), "zeros", dtype=dtype),
    }


def param_specs(cfg, vocab_padded: int, dtype=torch.bfloat16) -> dict:
    d = cfg.d_model
    enc = {**_attn_specs(cfg, cfg.encoder_layers, dtype),
           **_mlp_specs(cfg, cfg.encoder_layers, dtype)}
    dec = {**_attn_specs(cfg, cfg.n_layers, dtype),
           **_attn_specs(cfg, cfg.n_layers, dtype, prefix="x_"),
           **_mlp_specs(cfg, cfg.n_layers, dtype)}
    return {
        "embed": Spec((vocab_padded, d), ("vocab", "embed"), "small", dtype=dtype),
        "enc_ln_f_s": Spec((d,), (None,), "ones", dtype=dtype),
        "enc_ln_f_b": Spec((d,), (None,), "zeros", dtype=dtype),
        "dec_ln_f_s": Spec((d,), (None,), "ones", dtype=dtype),
        "dec_ln_f_b": Spec((d,), (None,), "zeros", dtype=dtype),
        "encoder": enc,
        "decoder": dec,
    }


def _mha(cfg, p, xq, xkv, *, causal, prefix="", chunk=1024,
         use_kernel=False, rules=None):
    """Attention of xq over xkv, its output projected. On a mesh each
    projection goes through ``project`` (whisper-tiny's 6 heads do not
    divide a model axis of 16: the contraction is split instead) and is
    laid out by heads before the view into them (``transformer._heads``)."""
    B, Sq, _ = xq.shape
    H, hd = cfg.n_heads, cfg.hd
    q = _heads(project(xq, p[f"{prefix}wq"]), H, hd, "act_heads", rules)
    k = _heads(project(xkv, p[f"{prefix}wk"]), H, hd, "act_heads", rules)
    v = _heads(project(xkv, p[f"{prefix}wv"]), H, hd, "act_heads", rules)
    o = L.attention(q, k, v, causal=causal, chunk=chunk,
                    use_kernel=use_kernel)
    o = constrain(o.reshape(B, Sq, H * hd), None,
                  ("batch", "act_seq", "act_heads"), rules)
    return project(o, p[f"{prefix}wo"])


def _mlp(cfg, p, x, rules=None):
    h = L.layer_norm(x, p["mlp_ln_s"], p["mlp_ln_b"], cfg.norm_eps)
    return constrain(x + L.gelu_mlp(h, p["w_up"], p["b_up"], p["w_down"],
                                    p["b_down"]), None, ACT, rules)


def _sinusoid_rows(n: int, d: int, like):
    """``sinusoidal(n, d)`` in ``like``'s dtype, on its mesh."""
    return on_mesh_of(sinusoidal(n, d, like.device).to(like.dtype), like)


def encode(cfg, params, frames, *, use_kernel: bool = False, rules=None):
    """frames: [B, F, d] (the stub frontend's output) -> [B, F, d]."""
    x = frames + _sinusoid_rows(frames.shape[1], cfg.d_model, frames)
    for p in unstack(params["encoder"]):
        h = L.layer_norm(x, p["ln_s"], p["ln_b"], cfg.norm_eps)
        x = constrain(x + _mha(cfg, p, h, h, causal=False,
                               use_kernel=use_kernel, rules=rules),
                      None, ACT, rules)
        x = _mlp(cfg, p, x, rules)
    return L.layer_norm(x, params["enc_ln_f_s"], params["enc_ln_f_b"],
                        cfg.norm_eps)


def forward_hidden(cfg, params, batch, *, attn_chunk=1024,
                   use_kernel: bool = False, rules=None, **_):
    """The decoder over ``batch["tokens"]`` with cross-attention to the
    encoded ``batch["frames"]``. Returns (hidden [B,S,d], 0.0: no aux
    loss). With ``cfg.remat`` under grad mode each decoder layer runs
    under a checkpoint that keeps only its input (the reference
    checkpoints the decoder's scan body, not the encoder's)."""
    enc = encode(cfg, params, batch["frames"], use_kernel=use_kernel,
                 rules=rules)
    tokens = batch["tokens"]
    S = tokens.shape[1]
    x = embed_tokens(params, tokens)
    x = constrain(x + _sinusoid_rows(S, cfg.d_model, x), None, ACT, rules)

    def layer(x, p):
        h = L.layer_norm(x, p["ln_s"], p["ln_b"], cfg.norm_eps)
        x = constrain(x + _mha(cfg, p, h, h, causal=True, chunk=attn_chunk,
                               use_kernel=use_kernel, rules=rules),
                      None, ACT, rules)
        h = L.layer_norm(x, p["x_ln_s"], p["x_ln_b"], cfg.norm_eps)
        x = constrain(x + _mha(cfg, p, h, enc, causal=False, prefix="x_",
                               chunk=attn_chunk, use_kernel=use_kernel,
                               rules=rules), None, ACT, rules)
        return _mlp(cfg, p, x, rules)

    remat = cfg.remat and torch.is_grad_enabled()
    for p in unstack(params["decoder"]):
        x = (checkpoint(layer, x, p, use_reentrant=False) if remat
             else layer(x, p))
    return L.layer_norm(x, params["dec_ln_f_s"], params["dec_ln_f_b"],
                        cfg.norm_eps), 0.0


def init_decode_state(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                      device=None):
    """Zero self K/V [L, B, max_len, H, hd] and zero cross K/V [L, B,
    encoder_seq, H, hd]: the reference's serving state, whose cross K/V
    only ``precompute_cross`` fills."""
    H, hd = cfg.n_heads, cfg.hd

    def z(t):
        return torch.zeros((cfg.n_layers, batch, t, H, hd), dtype=dtype,
                           device=device)
    return {"self_k": z(max_len), "self_v": z(max_len),
            "cross_k": z(cfg.encoder_seq), "cross_v": z(cfg.encoder_seq)}


def precompute_cross(cfg, params, frames, *, use_kernel: bool = False,
                     rules=None):
    """The encoder pass and every decoder layer's cross K/V: ([L, B, F, H,
    hd], [L, B, F, H, hd]); on a mesh laid out by batch and heads, as
    ``ModelBundle.serve_state_pspecs`` lays out the cross K/V."""
    enc = encode(cfg, params, frames, use_kernel=use_kernel, rules=rules)
    H, hd = cfg.n_heads, cfg.hd
    ks, vs = [], []
    for p in unstack(params["decoder"]):
        h = L.layer_norm(enc, p["x_ln_s"], p["x_ln_b"], cfg.norm_eps)
        ks.append(_heads(project(h, p["x_wk"]), H, hd, "act_heads", rules))
        vs.append(_heads(project(h, p["x_wv"]), H, hd, "act_heads", rules))
    return torch.stack(ks), torch.stack(vs)


def decode_step(cfg, params, state, batch, *, length, rules=None, **_):
    """One token for every sequence at position ``length``: its self K/V row
    written there (in place), attended with the rows before it, then
    cross-attention over every row of the cross K/V. Returns (logits
    [B,1,Vp] f32, the state). The position's sinusoid is row ``length`` of
    a [max_len, d] table, the index wrapped (a negative one from the end)
    and clamped into range as JAX indexes with a traced scalar. A 0-d
    tensor ``length`` is read on the device alone (``index_select``)."""
    token = batch["token"]
    B = token.shape[0]
    H, hd = cfg.n_heads, cfg.hd
    T = int(state["self_k"].shape[2])
    x = embed_tokens(params, token)
    table = sinusoidal(T, cfg.d_model, x.device)
    if isinstance(length, torch.Tensor):
        idx = torch.where(length < 0, length + T, length).clamp(0, T - 1)
        row = table.index_select(0, idx.reshape(1))[None]
    else:
        length = int(length)
        idx = min(max(length + T if length < 0 else length, 0), T - 1)
        row = table[idx][None, None]
    x = constrain(x + on_mesh_of(row.to(x.dtype), x), None, ACT, rules)
    F_ = state["cross_k"].shape[2]
    for i, p in enumerate(unstack(params["decoder"])):
        h = L.layer_norm(x, p["ln_s"], p["ln_b"], cfg.norm_eps)
        q = _heads(project(h, p["wq"]), H, hd, "act_heads", rules)
        k = _heads(project(h, p["wk"]), H, hd, "act_heads", rules)
        v = _heads(project(h, p["wv"]), H, hd, "act_heads", rules)
        cache = L.cache_update(L.KVCache(state["self_k"][i],
                                         state["self_v"][i], length), k, v)
        o = L.decode_attention(q, cache)
        x = constrain(x + project(o.reshape(B, 1, H * hd), p["wo"]),
                      None, ACT, rules)
        h = L.layer_norm(x, p["x_ln_s"], p["x_ln_b"], cfg.norm_eps)
        q = _heads(project(h, p["x_wq"]), H, hd, "act_heads", rules)
        o = L.decode_attention(q, L.KVCache(state["cross_k"][i],
                                            state["cross_v"][i], F_))
        x = constrain(x + project(o.reshape(B, 1, H * hd), p["x_wo"]),
                      None, ACT, rules)
        x = _mlp(cfg, p, x, rules)
    x = L.layer_norm(x, params["dec_ln_f_s"], params["dec_ln_f_b"],
                     cfg.norm_eps)
    logits = (x @ params["embed"].T).float()
    return logits, state
