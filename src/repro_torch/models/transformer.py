"""Decoder-only transformer: dense (yi / phi3 / tinyllama / granite), MoE
(granite-moe / qwen3-moe) and the VLM backbone (qwen2-vl, M-RoPE): param
specs, the training forward pass and the chunked cross-entropy (which
``ModelBundle.loss`` combines for every family), prefill and
single-token decode.

The port of ``repro/models/transformer.py``. The params
keep the reference's layer-stacked layout ([L, ...] per block weight), so
specs and shapes match it leaf for leaf; the ``lax.scan`` over layers is a
loop over the layers' views of ``params["blocks"]``. The reference's
``constrain`` sites are kept (``parallel.sharding.constrain``, by the
bundle's ``rules``): a no-op on plain tensors, a ``redistribute`` of
DTensors on a mesh. There the port needs one more after each embedding
lookup, whose vocab-sharded result is a partial sum that the next norm
cannot read (XLA places that all-reduce by itself), one after each
attention's residual (the tensor-parallel all-reduce: left to choose,
DTensor may scatter that partial sum along the sequence into a strided
shard that the MLP's matmul then has to gather), and in decode at each
block's end as in the full-sequence block. The full-sequence k and v
projections go through ``project``, which splits their contraction over a
model axis that their heads do not divide (as XLA does) rather than
repeat them on every rank; decode's, one token a sequence, stay whole (as
XLA leaves them: the all-reduce would cost more than it saves). The tensors the model makes (positions, the CE's vocab mask
and sums, the prefill's cache) join the mesh of what they meet
(``on_mesh_of``, ``zeros_like_cache``). On a mesh the CE takes the
target's logit as a masked sum over the sharded vocab, not a gather.
Its ``jax.checkpoint`` becomes ``torch.utils.checkpoint.checkpoint``
(non-reentrant), taken under grad mode only: a remat group keeps only its
input (``forward_hidden``), the loss keeps nothing of a sequence chunk
(``chunked_ce_loss``).

An MoE block holds ``w_router`` (f32 in a bf16 model, as the reference
keeps it) and stacked experts in place of the SwiGLU weights; its layer
returns the router's load-balance loss, which ``forward_hidden`` sums over
the layers. The VLM's positions are the caller's ([B, S, 3] t/h/w in
``batch["positions"]``): its patch frontend is a stub in the reference
too, whose precomputed ``embeds`` take the token embeddings' place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models.common import Spec, unstack
from repro_torch.parallel.sharding import (_is_dtensor, constrain, gathered,
                                          on_mesh_of, project, settle)

ACT = ("batch", "act_seq", "act_embed")

# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------

def _layer_specs(cfg, n_layers: int, dtype) -> dict:
    d, hd = cfg.d_model, cfg.hd
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    Ls = n_layers
    s = {
        "ln1": Spec((Ls, d), ("layers", None), "ones", dtype=dtype),
        "ln2": Spec((Ls, d), ("layers", None), "ones", dtype=dtype),
        "wq": Spec((Ls, d, Hq * hd), ("layers", "embed", "q_heads"), dtype=dtype),
        "wk": Spec((Ls, d, Hkv * hd), ("layers", "embed", "kv_heads"), dtype=dtype),
        "wv": Spec((Ls, d, Hkv * hd), ("layers", "embed", "kv_heads"), dtype=dtype),
        "wo": Spec((Ls, Hq * hd, d), ("layers", "q_heads", "embed"), dtype=dtype),
    }
    if cfg.moe is not None and cfg.moe.every == 1:
        E, f = cfg.moe.num_experts, cfg.moe.d_ff_expert
        s.update({
            "w_router": Spec((Ls, d, E), ("layers", "embed", "experts"),
                             "small", dtype=torch.float32),
            "w_gate_e": Spec((Ls, E, d, f), ("layers", "experts", "embed", "ffn_exp"), dtype=dtype),
            "w_up_e": Spec((Ls, E, d, f), ("layers", "experts", "embed", "ffn_exp"), dtype=dtype),
            "w_down_e": Spec((Ls, E, f, d), ("layers", "experts", "ffn_exp", "embed"), dtype=dtype),
        })
    else:
        f = cfg.d_ff
        s.update({
            "w_gate": Spec((Ls, d, f), ("layers", "embed", "ffn"), dtype=dtype),
            "w_up": Spec((Ls, d, f), ("layers", "embed", "ffn"), dtype=dtype),
            "w_down": Spec((Ls, f, d), ("layers", "ffn", "embed"), dtype=dtype),
        })
    return s


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


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _positions_for(cfg, batch, B, S, like):
    if cfg.mrope_sections is not None:
        return _caller_positions(batch, like)  # [B, S, 3]
    return on_mesh_of(torch.arange(S, device=like.device)[None, :], like)


def _caller_positions(batch, like):
    """The VLM's 3-D positions from ``batch``: on a mesh a DTensor laid out
    by the bundle's ``input_pspecs``, as the tokens are."""
    positions = batch["positions"]
    if _is_dtensor(like) and not _is_dtensor(positions):
        raise ValueError("on a mesh batch['positions'] must be a DTensor "
                         "(ModelBundle.distribute with input_pspecs)")
    return positions


def _apply_rope(cfg, x, positions):
    if cfg.mrope_sections is not None:
        return L.apply_mrope(x, positions, cfg.mrope_sections, cfg.rope_theta)
    return L.apply_rope(x, positions, cfg.rope_theta)


def _heads(t, n: int, hd: int, axis: str, rules):
    """A projection [B, S, n·hd] as heads [B, S, n, hd], laid out first by
    the heads' rule ``axis`` (a no-op without a mesh): DTensor may shard
    the product's last dim over a mesh dim that the heads do not divide
    (torch 2.11 does for an FSDP weight, qwen2-vl's 28 heads on 16), and
    a view into heads cannot split such a shard."""
    t = constrain(t, None, ("batch", "act_seq", axis), rules)
    return t.reshape(t.shape[:-1] + (n, hd))


def _mlp(cfg, p, h, moe_impl):
    """The block's MLP on h: (y, the router's aux loss) for an MoE block,
    (y, 0.0) for a dense one."""
    if "w_router" in p:
        return L.moe(h, p, cfg.moe.top_k, cfg.moe.capacity_factor,
                     impl=moe_impl)
    return L.swiglu(h, p["w_gate"], p["w_up"], p["w_down"]), 0.0


def block_forward(cfg, p, x, positions, *, moe_impl="einsum",
                  attn_chunk=1024, rules=None):
    """One decoder block (full-sequence path). x: [B,S,d]. Returns (x, the
    block's aux loss: the router's, 0.0 for a dense block)."""
    B, S, _ = x.shape
    hd, Hq, Hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    q = _heads(h @ p["wq"], Hq, hd, "act_heads", rules)
    k = _heads(project(h, p["wk"]), Hkv, hd, "act_kv_heads", rules)
    v = _heads(project(h, p["wv"]), Hkv, hd, "act_kv_heads", rules)
    q = _apply_rope(cfg, q, positions)
    k = _apply_rope(cfg, k, positions)
    q = constrain(q, None, ("batch", "act_seq", "act_heads", None), rules)
    k = constrain(k, None, ("batch", "act_seq", "act_kv_heads", None), rules)
    # the plain attention, as the reference trains through L.attention: the
    # flash kernel has no backward and refuses inputs that require grad
    o = L.attention(q, k, v, causal=True, chunk=attn_chunk, use_kernel=False)
    # the heads merged, laid out by heads as q was: so is the gradient
    # that the backward pass splits into heads again (``_heads``)
    o = constrain(o.reshape(B, S, Hq * hd), None,
                  ("batch", "act_seq", "act_heads"), rules)
    x = constrain(x + o @ p["wo"], None, ACT, rules)
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    y, aux = _mlp(cfg, p, h, moe_impl)
    return constrain(x + y, None, ACT, rules), aux


def block_decode(cfg, p, x, cache, positions, *, moe_impl="einsum",
                 rules=None):
    """One decoder block, single-token decode. x: [B,1,d]; the cache (this
    layer's) is updated in place."""
    B = x.shape[0]
    hd, Hq, Hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    q = _heads(h @ p["wq"], Hq, hd, "act_heads", rules)
    k = _heads(h @ p["wk"], Hkv, hd, "act_kv_heads", rules)
    v = _heads(h @ p["wv"], Hkv, hd, "act_kv_heads", rules)
    q = _apply_rope(cfg, q, positions)
    k = _apply_rope(cfg, k, positions)
    if isinstance(cache, L.KVCacheQ):
        cache = L.cache_update_q(cache, k, v)
        o = L.decode_attention_q(q, cache, dtype=x.dtype)
    else:
        cache = L.cache_update(cache, k, v)
        o = L.decode_attention(q, cache)
    x = constrain(x + o.reshape(B, 1, Hq * hd) @ p["wo"], None, ACT, rules)
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    return constrain(x + _mlp(cfg, p, h, moe_impl)[0], None, ACT,
                     rules), cache


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

def embed_tokens(params, tokens):
    """The embedding rows of ``tokens``. ``F.embedding``, not indexing,
    for its backward on CUDA, which sums a token's gradient rows in f32:
    with a bf16 table, indexing's backward lost most of a frequent token's
    sum (on an H100 at 4 × 4096 Zipf tokens the embedding gradient lay at
    a relative L2 distance of 0.40 from the f32 model's; through
    ``F.embedding``, 3.9e-3, as the other leaves). On a mesh the rows of
    a vocab-sharded table come back as a masked partial sum, which
    ``settle`` reduces. Under FSDP rules the table's embed dim is sharded
    over the data axes too, and is gathered first: DTensor's lookup into
    a table sharded on the mesh dim that shards the tokens makes a mask
    of the tokens' local shape for rows of another (an ``IndexError``)."""
    return settle(F.embedding(tokens, gathered(params["embed"], 1)))


def _head_weight(cfg, params):
    return params["embed"].T if cfg.tie_embeddings else params["head"]


def forward_hidden(cfg, params, batch, *, moe_impl="einsum",
                   attn_chunk=1024, rules=None):
    """Embed + all blocks + final norm. Returns hidden [B,S,d] and the aux
    loss summed over the layers (an f32 scalar; 0.0 for a dense model,
    which has no router).

    With ``cfg.remat`` and grad mode on, each group of ``cfg.remat_group``
    layers (single layers when that does not divide ``n_layers``) runs
    under a checkpoint that keeps only the group's input, the reference's
    ``save_only_these_names("block_in")``; the backward pass recomputes
    the rest. ``cfg.remat=False`` keeps every activation."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = batch["embeds"] if "embeds" in batch else embed_tokens(params, tokens)
    x = constrain(x, None, ACT, rules)
    positions = _positions_for(cfg, batch, B, S, x)
    layers = unstack(params["blocks"])

    def group(x, ps):
        aux = 0.0
        for p in ps:
            x, a = block_forward(cfg, p, x, positions, moe_impl=moe_impl,
                                 attn_chunk=attn_chunk, rules=rules)
            aux = aux + a
        return x, aux

    g = max(cfg.remat_group, 1)
    if cfg.n_layers % g:
        g = 1
    remat = cfg.remat and torch.is_grad_enabled()
    aux = 0.0
    for i in range(0, cfg.n_layers, g):
        ps = layers[i:i + g]
        x, a = (checkpoint(group, x, ps, use_reentrant=False) if remat
                else group(x, ps))
        aux = aux + a
    return L.rms_norm(x, params["ln_f"], cfg.norm_eps), aux


def chunked_ce_loss(cfg, hidden, w_head, targets, mask, vocab: int,
                    chunk: int = 512):
    """Mean cross-entropy over the mask without materializing [B,S,V]: a
    loop over sequence chunks of ``chunk`` positions (all of S when S is no
    multiple of it). Logits are f32; head columns at or beyond ``vocab``
    (the padding) are masked to -1e30. Under grad mode each chunk runs
    under a checkpoint that keeps nothing, so the backward pass recomputes
    its [B, chunk, Vp] logits."""
    B, S, _ = hidden.shape
    chunk = min(chunk, S)
    if S % chunk:
        chunk = S
    ids = on_mesh_of(torch.arange(w_head.shape[-1], device=hidden.device),
                     hidden)
    valid = ids < vocab

    def body(h, t, m):
        logits = (h @ w_head).float()                     # [B,chunk,Vp]
        logits = torch.where(valid, logits, -1e30)
        lse = torch.logsumexp(logits, dim=-1)
        if _is_dtensor(logits):
            # the target's logit as a masked sum over the vocab, which stays
            # sharded with it: DTensor's gather backward builds a zero
            # [B, chunk, Vp] on every rank (16.8 GB a rank at train_4k).
            # One term is nonzero: the same value as the gather
            tl = settle(torch.where(ids == t.long()[..., None], logits,
                                    0.0).sum(-1))
        else:
            # gather takes int64 indices
            tl = logits.gather(-1, t.long()[..., None])[..., 0]
        return torch.sum((lse - tl) * m), torch.sum(m)

    remat = torch.is_grad_enabled()
    tot = cnt = on_mesh_of(torch.zeros((), dtype=torch.float32,
                                       device=hidden.device), hidden)
    for i in range(0, S, chunk):
        args = (hidden[:, i:i + chunk], targets[:, i:i + chunk],
                mask[:, i:i + chunk])
        loss, n = (checkpoint(body, *args, use_reentrant=False) if remat
                   else body(*args))
        tot, cnt = tot + loss, cnt + n
    return tot / torch.clamp(cnt, min=1.0)


def zeros_like_cache(shape, like, rules):
    """Zeros of a stacked cache ``shape`` [L, B, T, Hkv, hd] in ``like``'s
    dtype and device: on a mesh, a DTensor laid out as the rules lay out
    the kv heads' projections (batch by "batch", heads by "kv_heads")."""
    if not _is_dtensor(like):
        return torch.zeros(shape, dtype=like.dtype, device=like.device)
    from repro_torch.models import common
    from repro_torch.parallel import sharding as sh
    spec = sh.pspec(("layers", "batch", None, "kv_heads", None), rules)
    mesh = like.device_mesh
    local = torch.zeros(sh.shard_shape(shape, spec, mesh), dtype=like.dtype,
                        device=like.device)
    return common.placed(local, shape, spec, mesh)


def _store(cache, i: int, x):
    """cache[i, :, :S] = x, in place: on a mesh into this rank's shard, x
    brought to the cache's placements first."""
    if _is_dtensor(cache):
        from torch.distributed.tensor import Shard
        pl = [Shard(p.dim - 1) if isinstance(p, Shard) else p
              for p in cache.placements]
        x = x.redistribute(cache.device_mesh, pl).to_local()
        cache = cache.to_local()
    cache[i, :, :x.shape[1]] = x


def prefill(cfg, params, batch, max_len: int, *, moe_impl="einsum",
            attn_chunk=1024, use_kernels: bool = True, rules=None):
    """Run the full prompt; return (last-token logits [B,1,Vp] f32, KV
    caches [L,B,max_len,Hkv,hd] holding the prompt's keys (after RoPE) and
    values, zero beyond). ``use_kernels=False`` takes the reference's
    chunked attention on any device."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = batch["embeds"] if "embeds" in batch else embed_tokens(params, tokens)
    x = constrain(x, None, ACT, rules)
    positions = _positions_for(cfg, batch, B, S, x)
    hd, Hq, Hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    kc = zeros_like_cache((cfg.n_layers, B, max_len, Hkv, hd), x, rules)
    vc = torch.zeros_like(kc)
    for i, p in enumerate(unstack(params["blocks"])):
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        q = _heads(h @ p["wq"], Hq, hd, "act_heads", rules)
        k = _heads(project(h, p["wk"]), Hkv, hd, "act_kv_heads", rules)
        v = _heads(project(h, p["wv"]), Hkv, hd, "act_kv_heads", rules)
        q = _apply_rope(cfg, q, positions)
        k = _apply_rope(cfg, k, positions)
        o = L.attention(q, k, v, causal=True, chunk=attn_chunk,
                        use_kernel=use_kernels)
        x = constrain(x + o.reshape(B, S, Hq * hd) @ p["wo"], None, ACT,
                      rules)
        h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        x = constrain(x + _mlp(cfg, p, h, moe_impl)[0], None, ACT, rules)
        _store(kc, i, k)
        _store(vc, i, v)
    x = L.rms_norm(x[:, -1:], params["ln_f"], cfg.norm_eps)
    logits = (x @ _head_weight(cfg, params)).float()
    return logits, L.KVCache(kc, vc, S)


def decode_step(cfg, params, cache, batch, *, moe_impl="einsum",
                rules=None):
    """One token for every sequence. cache leaves: [L,B,T,Hkv,hd] (a
    ``KVCache`` or ``KVCacheQ``), written in place at ``cache.length``;
    returns (logits [B,1,Vp] f32, the cache at length + 1). The VLM reads
    the token's 3-D positions from ``batch["positions"]`` [B,1,3]. A 0-d
    tensor ``cache.length`` stays on the device: the positions are it,
    broadcast to [B, 1], and no step reads it on the host."""
    token = batch["token"]                                  # [B,1]
    B = token.shape[0]
    x = constrain(embed_tokens(params, token), None, ACT, rules)
    pos = cache.length
    if not isinstance(pos, torch.Tensor):
        pos = int(pos)
    quant = isinstance(cache, L.KVCacheQ)
    if cfg.mrope_sections is not None:
        positions = _caller_positions(batch, x)              # [B,1,3]
    elif isinstance(pos, torch.Tensor):
        positions = on_mesh_of(pos.reshape(1, 1).expand(B, 1), x)
    else:
        positions = on_mesh_of(torch.full((B, 1), pos, dtype=torch.int64,
                                          device=x.device), x)
    for i, p in enumerate(unstack(params["blocks"])):
        if quant:
            c = L.KVCacheQ(cache.k[i], cache.v[i], cache.k_scale[i],
                           cache.v_scale[i], pos)
        else:
            c = L.KVCache(cache.k[i], cache.v[i], pos)
        x, _ = block_decode(cfg, p, x, c, positions, moe_impl=moe_impl,
                            rules=rules)
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = (x @ _head_weight(cfg, params)).float()
    return logits, cache._replace(length=L._advance(pos, 1))
