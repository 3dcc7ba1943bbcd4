"""Core neural layers of the LMs: RMSNorm and LayerNorm, RoPE and M-RoPE,
GQA attention (the prefill's, and decode against a KV cache, bf16 or
int8), SwiGLU and the GELU MLP, the mixture of experts (router, einsum
and gather dispatch), and the causal depthwise conv of the Mamba front.

The port of ``repro/models/layers.py``, with its layouts: activations
[B, S, d], heads [B, S, H, D]. ``attention`` on a CUDA tensor is one
launch of the hand-written flash kernel (``kernels.ops.flash_attention``);
on a CPU tensor, or with ``use_kernel=False``, it is the reference's
chunked exact softmax (``_attend_block``). The two compute the same
function, except that the reference casts the probabilities to v's dtype
before the PV product and the kernel keeps them in f32 (ROADMAP Queue 3).
The kernel has no backward and refuses inputs that require grad, so
every training forward pass asks for the plain version with
``use_kernel=False``, as the reference trains through its jnp attention.

Everything but the attention is plain PyTorch, as the reference's is
plain jnp: no Pallas kernel stands behind it. The expert products are
``torch.einsum`` (cuBLAS on the card).

The KV caches are updated in place (the reference returns new arrays): a
decode step writes one row of the cache it is given.

On a mesh (``parallel.sharding``) the tensors are DTensors and the same
functions run on them. A tensor made here (RoPE's frequencies, a mask's
positions) joins its operand's mesh through ``on_mesh_of``. Attention is
per head and per sequence, so ``attention`` and ``decode_attention`` run
on each rank's local heads and rows under ``local_map`` (the flash kernel
sees local tensors), with the kv heads its local q heads read. A cache row
is written into the shard that holds it (``_write_at``);
``decode_attention``'s softmax over a sequence-sharded cache is DTensor's
(it gathers the scores). The MoE's router runs on DTensors, its logits
gathered whole over the experts; its dispatch, experts and combine run
per rank under ``local_map`` (``_experts_on_mesh``), each rank on its own
experts (E sharded) or on its slice of every expert's f, and then the
einsum dispatch on its slice of d (``_TPGroup``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.parallel.sharding import (_is_dtensor, gathered,
                                          on_mesh_of, settle)


def rms_norm(x, scale, eps: float = 1e-5):
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale


def layer_norm(x, scale, bias, eps: float = 1e-5):
    """Statistics in f32 (the biased variance, as ``jnp.var``), the
    normalized x cast back to x's dtype before the scale and bias."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * scale + bias


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    d2 = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, d2, dtype=torch.float32,
                                         device=device) / d2))


def apply_rope(x, positions, theta: float):
    """x: [..., S, H, D]; positions: broadcastable to [..., S]. The rotation
    is f32 (x · cos promotes, as in the reference) and cast back."""
    d2 = x.shape[-1] // 2
    freqs = on_mesh_of(rope_freqs(x.shape[-1], theta, x.device),
                       positions)                                 # [d2]
    ang = positions[..., None].float() * freqs                    # [..., S, d2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :d2], x[..., d2:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x, positions3, sections, theta: float):
    """Qwen2-VL M-RoPE. x: [..., S, H, D]; positions3: [..., S, 3] (t/h/w);
    ``sections`` (summing to D/2) say how many of the D/2 frequencies
    rotate by each of the three positions, in that order."""
    d2 = x.shape[-1] // 2
    assert sum(sections) == d2, (sections, d2)
    freqs = on_mesh_of(rope_freqs(x.shape[-1], theta, x.device),
                       positions3)                                # [d2]
    # [..., S, 3] -> [..., S, d2]: stream i's position over its section
    # (the reference's gather by jnp.repeat(arange(3), sections)), as
    # views and one cat: no index tensor, no host copy, and on a mesh
    # nothing but the positions' own shards
    p = positions3.float()
    pos = torch.cat([p[..., i:i + 1].expand(p.shape[:-1] + (n,))
                     for i, n in enumerate(sections)], dim=-1)    # [..., S, d2]
    ang = pos * freqs
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :d2], x[..., d2:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA)
# ---------------------------------------------------------------------------

def _attend_block(q, k, v, q_pos, causal: bool):
    """q: [B,Sq,Hkv,G,D]; k,v: [B,T,Hkv,D]; q_pos: [Sq] absolute positions."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqkgd,btkd->bkgqt", q.float() * scale, k.float())
    if causal:
        t_pos = torch.arange(k.shape[1], device=k.device)
        mask = q_pos[:, None] >= t_pos[None, :]                    # [Sq, T]
        s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgqt,btkd->bqkgd", p.to(v.dtype), v)


def attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
              chunk: int = 1024, use_kernel: bool = True):
    """Exact attention. q: [B, Sq, Hq, D]; k, v: [B, T, Hkv, D], Hq % Hkv
    == 0 (GQA). q_offset: absolute position of q[0] (prefill: 0).

    On a CUDA tensor with ``use_kernel``: one flash-kernel launch, which
    has no backward and raises ``RuntimeError`` on inputs that require
    grad under grad mode (it never hands over to the plain version). Else
    the reference's path: query chunks of ``chunk`` rows (when Sq is a
    multiple of it above it), each an exact softmax over all keys. Under
    grad mode each chunk is checkpointed, as the reference wraps it in
    ``jax.checkpoint(..., nothing_saveable)``: the backward pass recomputes
    a chunk's [chunk, T] f32 scores instead of keeping every chunk's."""
    if _is_dtensor(q):
        return _per_head_on_mesh(
            lambda ql, kl, vl: attention(ql, kl, vl, causal=causal,
                                         q_offset=q_offset, chunk=chunk,
                                         use_kernel=use_kernel), q, k, v)
    if use_kernel and not ops._on_cpu(q):
        return ops.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D)
    if Sq % chunk != 0 or Sq <= chunk:
        pos = q_offset + torch.arange(Sq, device=q.device)
        return _attend_block(qg, k, v, pos, causal).reshape(B, Sq, Hq, D)
    remat = torch.is_grad_enabled()
    out = []
    for i in range(0, Sq, chunk):
        args = (qg[:, i:i + chunk], k, v,
                q_offset + i + torch.arange(chunk, device=q.device), causal)
        out.append(checkpoint(_attend_block, *args, use_reentrant=False)
                   if remat else _attend_block(*args))
    return torch.cat(out, dim=1).reshape(B, Sq, Hq, D)


def _offset(t, dim: int) -> int:
    """The global index of this rank's first element of a DTensor along
    ``dim``."""
    from repro_torch.parallel.sharding import local_shape_and_offset
    return local_shape_and_offset(t.shape, t.device_mesh, t.placements)[1][dim]


def select_kv_heads(k, v, q_lo: int, n_q: int, kv_lo: int, group: int):
    """The kv heads that q heads [q_lo, q_lo + n_q) read, q head i reading
    kv head i // ``group`` (GQA), out of local k, v [B, T, h, D] whose
    first head is global head ``kv_lo``. Equal runs of q heads on one kv
    head keep a slice (a GQA of the local heads); otherwise each q head
    gets its own kv head (group 1)."""
    want = [(q_lo + j) // group - kv_lo for j in range(n_q)]
    lo, n = want[0], want[-1] - want[0] + 1
    if n_q % n == 0 and want == [lo + j // (n_q // n) for j in range(n_q)]:
        return k[:, :, lo:lo + n], v[:, :, lo:lo + n]
    idx = torch.tensor(want, device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def _per_head_on_mesh(fn, q, k, v):
    """``fn(q, k, v)`` of DTensors, for an ``fn`` that works head by head
    and sequence by sequence (attention): q [B, S, Hq, D] sharded by batch
    and heads (or replicated), k and v [B, T, Hkv, D] brought to q's batch
    shards and to its head shards where Hkv divides them (replicated
    otherwise). Each rank runs ``fn`` on its local tensors under
    ``local_map``, its q heads against the kv heads they read
    (``select_kv_heads``); the output is laid out as q. The gradient of a
    replicated k or v is a partial sum over the q-head shards."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    Hq, Hkv = q.shape[2], k.shape[2]
    kv_pl, kv_grad_pl = [], []
    for p, n in zip(q.placements, mesh.shape):
        if p == Shard(0) or isinstance(p, Replicate):
            kv_pl.append(p)
            kv_grad_pl.append(p)
        elif p == Shard(2):
            kv_pl.append(p if Hkv % n == 0 else Replicate())
            # a replicated kv head read by this rank's q heads only: its
            # gradient here is this rank's part of the sum
            kv_grad_pl.append(p if Hkv % n == 0 else Partial())
        else:
            raise ValueError("attention on a mesh takes q sharded by batch "
                             f"and heads, not {q.placements}")
    k = k.redistribute(mesh, kv_pl)
    v = v.redistribute(mesh, kv_pl)
    q_lo, kv_lo = _offset(q, 2), _offset(k, 2)

    def local(ql, kl, vl):
        kl, vl = select_kv_heads(kl, vl, q_lo, ql.shape[2], kv_lo,
                                 Hq // Hkv)
        return fn(ql, kl, vl)

    return local_map(local, out_placements=list(q.placements),
                     in_placements=(q.placements, tuple(kv_pl),
                                    tuple(kv_pl)),
                     in_grad_placements=(q.placements, tuple(kv_grad_pl),
                                         tuple(kv_grad_pl)),
                     device_mesh=mesh)(q, k, v)


class KVCache(NamedTuple):
    """``length`` (the tokens filled) is an int, or a 0-d int tensor on the
    cache's device as the reference's ``[] int32``: decode then reads and
    moves the position on the device alone (what a captured decode step
    needs). Prefill, the dry run and the mesh give an int."""
    k: torch.Tensor  # [..., B, T, Hkv, D]
    v: torch.Tensor
    length: int      # tokens filled: an int or a 0-d int tensor

    @staticmethod
    def zeros(batch, max_len, n_kv, head_dim, dtype=torch.bfloat16,
              layers=None, device=None):
        shp = (batch, max_len, n_kv, head_dim)
        if layers is not None:
            shp = (layers,) + shp
        return KVCache(torch.zeros(shp, dtype=dtype, device=device),
                       torch.zeros(shp, dtype=dtype, device=device), 0)


def _write_at(buf, new, idx):
    """buf[:, idx:idx+n] = new, in place, with the start placed as
    ``lax.dynamic_update_slice`` places it (jax 0.9): a negative start
    counts from the end (+ T), then the start is clamped into [0, T − n].
    A tensor ``idx`` (0-d, on ``buf``'s device) is read on the device: the
    rows start + arange(n) are written by ``index_copy_``, with no host
    read. A DTensor ``buf`` sharded along dim 1 (a sequence-sharded cache)
    is written in the shard that holds the rows (an int ``idx``); ``new``
    comes to ``buf``'s other shards first."""
    n, T = new.shape[1], buf.shape[1]
    if isinstance(idx, torch.Tensor) and not _is_dtensor(buf):
        start = torch.where(idx < 0, idx + T, idx).clamp(0, T - n)
        buf.index_copy_(1, start + torch.arange(n, device=buf.device),
                        new.to(buf.dtype))
        return
    start = int(idx)
    start = min(max(start + T if start < 0 else start, 0), T - n)
    if not _is_dtensor(buf):
        buf[:, start:start + n] = new.to(buf.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard
    mesh = buf.device_mesh
    pl = [Replicate() if p == Shard(1) else p for p in buf.placements]
    new = new.redistribute(mesh, pl).to_local()
    local, off = buf.to_local(), _offset(buf, 1)
    lo = max(start, off)
    hi = min(start + n, off + local.shape[1])
    if lo < hi:
        local[:, lo - off:hi - off] = new[:, lo - start:hi - start].to(
            local.dtype)


def cache_update(cache: KVCache, k_new, v_new) -> KVCache:
    """Insert [B,n,Hkv,D] at cache.length (in place); the new length is
    length + n, a tensor where ``length`` is one."""
    _write_at(cache.k, k_new, cache.length)
    _write_at(cache.v, v_new, cache.length)
    return KVCache(cache.k, cache.v, _advance(cache.length, k_new.shape[1]))


def _advance(length, n: int):
    """length + n: an int for an int, a tensor (on the device) for a
    tensor."""
    if isinstance(length, torch.Tensor):
        return length + n
    return int(length) + n


class KVCacheQ(NamedTuple):
    """int8-quantized KV cache: codes int8 + per-(token, head) f32 scales
    (phi3-mini's MHA cache needs it to fit)."""
    k: torch.Tensor        # int8 [..., B, T, Hkv, D]
    v: torch.Tensor
    k_scale: torch.Tensor  # f32 [..., B, T, Hkv]
    v_scale: torch.Tensor
    length: int            # an int or a 0-d int tensor, as ``KVCache``'s

    @staticmethod
    def zeros(batch, max_len, n_kv, head_dim, dtype=torch.bfloat16,
              layers=None, device=None):
        shp = (batch, max_len, n_kv, head_dim)
        sshp = (batch, max_len, n_kv)
        if layers is not None:
            shp = (layers,) + shp
            sshp = (layers,) + sshp
        return KVCacheQ(torch.zeros(shp, dtype=torch.int8, device=device),
                        torch.zeros(shp, dtype=torch.int8, device=device),
                        torch.zeros(sshp, dtype=torch.float32, device=device),
                        torch.zeros(sshp, dtype=torch.float32, device=device),
                        0)


# 1/127 in f32: the jitted reference multiplies by it (XLA turns the
# division by the constant into a multiply by its reciprocal)
_INV_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()


def _kv_quant(x):
    """[B,S,H,D] -> (int8 codes, f32 scale [B,S,H])."""
    x32 = x.float()
    s = (x32.abs().amax(dim=-1) * _INV_127).clamp_min(1e-8)
    c = torch.clamp(torch.round(x32 / s[..., None]), -127, 127)
    return c.to(torch.int8), s


def cache_update_q(cache: KVCacheQ, k_new, v_new) -> KVCacheQ:
    """Quantize [B,n,Hkv,D] and insert it at cache.length (in place)."""
    idx = cache.length
    kc, ks = _kv_quant(k_new)
    vc, vs = _kv_quant(v_new)
    for buf, new in ((cache.k, kc), (cache.v, vc), (cache.k_scale, ks),
                     (cache.v_scale, vs)):
        _write_at(buf, new, idx)
    return KVCacheQ(cache.k, cache.v, cache.k_scale, cache.v_scale,
                    _advance(idx, k_new.shape[1]))


def decode_attention_q(q, cache: KVCacheQ, dtype=torch.bfloat16):
    k = (cache.k.float() * cache.k_scale[..., None]).to(dtype)
    v = (cache.v.float() * cache.v_scale[..., None]).to(dtype)
    return decode_attention(q, KVCache(k, v, cache.length))


def decode_attention(q, cache: KVCache):
    """q: [B,1,Hq,D] against a cache of T entries (masked beyond length).
    On a mesh: per rank on its heads and rows (``_per_head_on_mesh``),
    unless the cache is sharded along the sequence; then as DTensor runs
    the ops, q's heads replicated where they do not split into whole kv
    groups and the softmax over the sequence shards DTensor's (it gathers
    the scores)."""
    B, _, Hq, D = q.shape
    Hkv = cache.k.shape[2]
    if _is_dtensor(q):
        from torch.distributed.tensor import Shard
        if Shard(1) not in cache.k.placements:     # local heads and rows
            return _per_head_on_mesh(
                lambda ql, kl, vl: decode_attention(
                    ql, KVCache(kl, vl, cache.length)), q, cache.k, cache.v)
        q = _groupable_heads(q, Hkv)
    qg = q.reshape(B, 1, Hkv, Hq // Hkv, D)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg.float() * D ** -0.5,
                     cache.k.float())
    t_pos = on_mesh_of(torch.arange(cache.k.shape[1], device=q.device), s)
    s = torch.where(t_pos < cache.length, s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqt,btkd->bqkgd", p.to(cache.v.dtype), cache.v)
    return o.reshape(B, 1, Hq, D)


def _groupable_heads(q, n_kv: int):
    """A DTensor q [B, 1, Hq, D] replicated over every mesh dim whose head
    shards do not split into whole kv groups (Hkv not divisible by it), so
    that the [Hkv, G] reshape is even."""
    from torch.distributed.tensor import Replicate, Shard
    pl = [Replicate() if p == Shard(2) and n_kv % n else p
          for p, n in zip(q.placements, q.device_mesh.shape)]
    return q.redistribute(q.device_mesh, pl)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def gelu_mlp(x, w_up, b_up, w_down, b_down):
    """GELU MLP with biases; the tanh approximation, as the reference's
    ``jax.nn.gelu(..., approximate=True)``."""
    return F.gelu(x @ w_up + b_up, approximate="tanh") @ w_down + b_down


# ---------------------------------------------------------------------------
# Mixture of Experts
# ---------------------------------------------------------------------------

def _one_hot(idx, n: int):
    """f32 one-hot of ``idx`` over ``n`` classes, by comparison with
    ``arange(n)`` (``F.one_hot``'s bits; on a mesh the arange joins
    ``idx``'s)."""
    classes = on_mesh_of(torch.arange(n, device=idx.device), idx)
    return (idx[..., None] == classes).float()


def _router(x, w_gate, top_k: int):
    """Return (probs [B,S,E] f32, topk_idx [B,S,K] int64, topk_p [B,S,K],
    aux, kmask [B,S,K,E] f32: the picks' one-hots). The logits are an f32
    product of f32 operands: the package keeps TF32 off, which would flip
    near-tied routes on the card. On a mesh the
    logits come out sharded as the router's experts are and are gathered
    whole (E on every rank) before the softmax and top-k, the tokens
    staying on their shards; the aux loss's means over the sharded batch
    are settled into the global means."""
    logits = x.float() @ w_gate.float()
    logits = gathered(logits, logits.ndim - 1)
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k breaks ties toward the lower index; torch.topk makes no
    # promise. Exact ties among f32 softmax outputs of distinct logits do
    # not arise, so the picks agree wherever the probabilities do. The
    # picked probabilities are read by their one-hots (one nonzero term a
    # sum: topk's values, bit for bit): topk's backward scatters into a
    # plain zeros tensor, which a DTensor gradient cannot meet (torch 2.11)
    E = w_gate.shape[-1]
    topk_idx = torch.topk(probs.detach(), top_k, dim=-1).indices
    kmask = _one_hot(topk_idx, E)                                 # [B,S,K,E]
    topk_p = (kmask * probs[..., None, :]).sum(dim=-1)           # [B,S,K]
    topk_p = topk_p / topk_p.sum(dim=-1, keepdim=True)
    # switch-style load-balance loss
    me = settle(probs.mean(dim=(0, 1)))
    ce = settle(kmask[..., 0, :].mean(dim=(0, 1)))
    aux = E * torch.sum(me * ce)
    return probs, topk_idx, topk_p, aux, kmask


def _capacity(S: int, top_k: int, E: int, factor: float) -> int:
    c = int(S * top_k * factor) // E
    return max(8, min(S, ((c + 7) // 8) * 8))


def _group(x, group_size: int):
    """[B, S, ...] -> [B*S/g, g, ...]: bounds the O(g*E*C) dispatch buffers.
    Routing becomes per-group (Mesh-TF style grouping). A batch sharded by
    rows keeps whole groups on each rank (g divides S)."""
    B, S = x.shape[:2]
    g = min(group_size, S)
    if S % g:
        g = S
    return x.reshape((B * (S // g), g) + x.shape[2:]), (B, S)


def _ungroup(y, bs):
    B, S = bs
    return y.reshape((B, S) + y.shape[2:])


def _expert_ffn(xe, w_gate_e, w_up_e, w_down_e):
    """xe: [B,E,C,d]; weights: [E,d,f] / [E,f,d]."""
    h = F.silu(torch.einsum("becd,edf->becf", xe, w_gate_e))
    h = h * torch.einsum("becd,edf->becf", xe, w_up_e)
    return torch.einsum("becf,efd->becd", h, w_down_e)


def _arrivals(kmask):
    """(emask [B,S,E] f32, pos [B,S,E] f32) from the picks' one-hots
    (kmask [B,S,K,E], ``_router``'s): which experts each token picked, and
    each token's arrival order at each expert (the count of earlier tokens
    in the group that picked it)."""
    emask = kmask.sum(dim=2)
    return emask, torch.cumsum(emask, dim=1) - emask


def moe_einsum(x, params, top_k: int, capacity_factor: float = 1.0,
               group_size: int = 512):
    """Capacity-based one-hot dispatch (Mesh-TF style). x: [B,S,d]. A pick
    that arrives at its expert after C others is dropped: it adds
    nothing. On a mesh the router runs on DTensors and the dispatch, the
    experts and the combine per rank (``_experts_on_mesh``)."""
    return _moe(_einsum_experts, x, params, top_k, capacity_factor,
                group_size)


def moe_gather(x, params, top_k: int, capacity_factor: float = 1.0,
               group_size: int = 512):
    """Gather/scatter dispatch: no O(S*E*C*d) einsum FLOPs. The same
    function as ``moe_einsum``; dropped picks contribute zero.

    Two faults of the reference's version are not copied (ROADMAP Queue
    3): a dropped pick of the last expert indexes past the E*C slots,
    which JAX fills with NaN (NaN × its zero weight stays NaN), so the
    slot of a dropped pick is set to 0 here and its weight zeroes it; and
    a group of fewer than C tokens (every decode step: C is at least 8)
    fails the reference's reshape, so here the slots past the group's
    tokens stay empty."""
    return _moe(_gather_experts, x, params, top_k, capacity_factor,
                group_size)


def _moe(experts, x, params, top_k, capacity_factor, group_size):
    """Group the tokens, route them (``_router``) and run ``experts`` (a
    dispatch, the expert FFN and the combine): on a mesh per rank on its
    experts (``_experts_on_mesh``). Returns (y [B,S,d], aux)."""
    x, bs = _group(x, group_size)
    E = params["w_router"].shape[-1]
    C = _capacity(x.shape[1], top_k, E, capacity_factor)
    _, topk_idx, topk_p, aux, kmask = _router(x, params["w_router"], top_k)
    w = (params["w_gate_e"], params["w_up_e"], params["w_down_e"])
    if _is_dtensor(x):
        y = _experts_on_mesh(experts, x, topk_idx, topk_p, kmask, w, E, C)
    else:
        y = experts(x, topk_idx, topk_p, kmask, *w, E=E, C=C, e_lo=0)
    return _ungroup(y, bs), aux


def _einsum_experts(x, topk_idx, topk_p, kmask, w_gate_e, w_up_e, w_down_e,
                    *, E: int, C: int, e_lo: int, tp=None):
    """The one-hot dispatch, the FFN and the combine of the experts
    [e_lo, e_lo + n) that the weights [n, ...] hold, of E in all: a
    token's picks of other experts add nothing here. x: [B,S,d] grouped;
    topk_idx, topk_p: [B,S,K]; kmask: their one-hots. With ``tp``
    (``_TPGroup``: the weights' f split over a group whose ranks hold the
    same tokens) the dispatch
    and the combine's gradient of the experts' output run on this rank's
    slice of d and are gathered, as XLA partitions them: each rank does a
    share of them and not all."""
    n = w_gate_e.shape[0]
    emask, pos = _arrivals(kmask)
    keep = emask * (pos < C)
    gate_e = torch.sum(kmask * topk_p[..., None], dim=2)         # [B,S,E]
    if n < E:
        pos, keep, gate_e = (t[..., e_lo:e_lo + n]
                             for t in (pos, keep, gate_e))
    # jax.nn.one_hot gives a zero row for an index >= C where F.one_hot
    # raises, so the one-hot of the arrival slot is built by comparison
    slots = torch.arange(C, device=x.device, dtype=pos.dtype)
    disp = (pos[..., None] == slots).to(x.dtype) \
        * keep[..., None].to(x.dtype)                             # [B,S,n,C]
    comb = disp * gate_e[..., None].to(x.dtype)

    if tp is None:
        xe = torch.einsum("bsec,bsd->becd", disp, x)
        he = _expert_ffn(xe, w_gate_e, w_up_e, w_down_e)
        return torch.einsum("bsec,becd->bsd", comb, he)
    xe = _GatherD.apply(torch.einsum("bsec,bsd->becd", disp, tp.part(x)),
                        tp)
    he = _expert_ffn(xe, w_gate_e, w_up_e, w_down_e)     # a partial sum
    return _CombinePartial.apply(comb, he, tp)


def _gather_experts(x, topk_idx, topk_p, kmask, w_gate_e, w_up_e, w_down_e,
                    *, E: int, C: int, e_lo: int):
    """The gather dispatch, the FFN and the combine of the experts
    [e_lo, e_lo + n) that the weights [n, ...] hold, as
    ``_einsum_experts``."""
    B, S, d = x.shape
    n = w_gate_e.shape[0]
    emask, pos = _arrivals(kmask)
    keep = (emask > 0) & (pos < C)                                # [B,S,E]

    # token index per (expert, slot): sort token ids by (chosen, arrival);
    # jnp.argsort is stable, torch.argsort only when asked
    key = torch.where(keep, pos, float(S + 1))[..., e_lo:e_lo + n]
    order = torch.argsort(key, dim=1, stable=True)[:, :C, :]      # [B,min(S,C),n]
    tok_idx = order.transpose(1, 2)                               # [B,n,.]
    slot_valid = keep[..., e_lo:e_lo + n].transpose(1, 2).gather(
        2, tok_idx)                                               # [B,n,.]
    if tok_idx.shape[2] < C:                  # fewer tokens than slots
        pad = C - tok_idx.shape[2]
        tok_idx = F.pad(tok_idx, (0, pad))
        slot_valid = F.pad(slot_valid, (0, pad))
    xe = x[:, None].expand(B, n, S, d).gather(
        2, tok_idx[..., None].expand(B, n, C, d))                 # [B,n,C,d]
    xe = xe * slot_valid[..., None].to(x.dtype)
    he = _expert_ffn(xe, w_gate_e, w_up_e, w_down_e)

    # combine: each token reads its K slots back (those of these experts)
    pos_k = pos.gather(-1, topk_idx)                              # [B,S,K]
    keep_k = keep.gather(-1, topk_idx)                            # [B,S,K]
    if n < E:
        keep_k = keep_k & (topk_idx >= e_lo) & (topk_idx < e_lo + n)
    slot = torch.where(keep_k, (topk_idx - e_lo) * C + pos_k.long(),
                       0)                                         # in range
    K = topk_idx.shape[-1]
    yk = he.reshape(B, n * C, d).gather(
        1, slot.reshape(B, S * K, 1).expand(B, S * K, d)).reshape(B, S, K, d)
    w = (topk_p * keep_k).to(x.dtype)[..., None]
    return torch.sum(yk * w, dim=2)


class _TPGroup(NamedTuple):
    """The mesh dim over which the expert weights split f while the tokens
    are whole: its process group's name, this rank's index and the
    group's size."""
    name: str
    rank: int
    size: int

    def part(self, t):
        """This rank's slice of ``t``'s last dim."""
        n = t.shape[-1] // self.size
        return t[..., self.rank * n:(self.rank + 1) * n]


def _gather_last(t, tp: _TPGroup):
    """``t`` all-gathered along its last dim over ``tp``, ranks in order
    (the functional collective DTensor issues, on dim 0 of a view)."""
    c10d = torch.ops._c10d_functional
    return c10d.wait_tensor(c10d.all_gather_into_tensor(
        t.movedim(-1, 0).contiguous(), tp.size, tp.name)).movedim(0, -1)


class _GatherD(torch.autograd.Function):
    """All-gather of the last dim over ``tp``; the backward reduce-scatters
    the gradient, which each rank holds as a partial sum (its share of
    f)."""

    @staticmethod
    def forward(ctx, t, tp):
        ctx.tp = tp
        return _gather_last(t, tp)

    @staticmethod
    def backward(ctx, g):
        c10d, tp = torch.ops._c10d_functional, ctx.tp
        return c10d.wait_tensor(c10d.reduce_scatter_tensor(
            g.movedim(-1, 0).contiguous(), "sum", tp.size,
            tp.name)).movedim(0, -1), None


class _CombinePartial(torch.autograd.Function):
    """y = einsum("bsec,becd->bsd", comb, he) with ``he`` a partial sum over
    ``tp`` (so y is one too); the gradient of ``comb`` is a partial sum
    alike, and that of ``he`` is taken on this rank's slice of d (the
    gradient of y being whole on every rank) and gathered."""

    @staticmethod
    def forward(ctx, comb, he, tp):
        ctx.save_for_backward(comb, he)
        ctx.tp = tp
        return torch.einsum("bsec,becd->bsd", comb, he)

    @staticmethod
    def backward(ctx, dy):
        comb, he = ctx.saved_tensors
        d_comb = torch.einsum("bsd,becd->bsec", dy, he)
        d_he = torch.einsum("bsec,bsd->becd", comb, ctx.tp.part(dy))
        return d_comb, _gather_last(d_he, ctx.tp), None


def _experts_on_mesh(experts, x, topk_idx, topk_p, kmask, w, E: int,
                     C: int):
    """``experts`` (``_einsum_experts`` or ``_gather_experts``) of
    DTensors, per rank under ``local_map``. The tokens (x [B,S,d], their
    picks and the picks' one-hots) come sharded by batch or replicated;
    each expert weight keeps its sharding of E (dim 0: expert parallel,
    the rank's own experts) or of f (tensor parallel inside every
    expert) on the mesh dims that do
    not shard the tokens, and is gathered whole on those that do and
    wherever it shards d (FSDP's embed dim, which a decode batch that the
    data axes do not divide leaves sharded beside replicated tokens). So
    no rank runs an expert or a slice of f twice, and
    DTensor, which has no strategy for a sort's indices into another
    tensor's shards, runs none of it. A rank holding a part of the
    experts or of f returns its part of y, a partial sum over those mesh
    dims (the block's residual reduces it), as are its gradients of x and
    of the pick weights; a weight's gradient is a partial sum over the
    mesh dims that shard the tokens."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    tok_pl = tuple(x.placements)
    if any(p not in (Shard(0), Replicate()) for p in tok_pl):
        raise ValueError("the MoE on a mesh takes tokens sharded by batch, "
                         f"not {x.placements}")
    topk_idx, topk_p, kmask = (t.redistribute(mesh, tok_pl)
                               for t in (topk_idx, topk_p, kmask))
    w_pl, w_grad_pl = [], []
    # d is dim 1 of w_gate_e and w_up_e [E, d, f], dim 2 of w_down_e
    for t, d_dim in zip(w, (1, 1, 2)):
        pl = tuple(pw if pt == Replicate() and pw != Shard(d_dim)
                   else Replicate()
                   for pt, pw in zip(tok_pl, t.placements))
        w_pl.append(pl)
        w_grad_pl.append(tuple(Partial() if pt == Shard(0) else pw
                               for pt, pw in zip(tok_pl, pl)))
    w = [t.redistribute(mesh, pl) for t, pl in zip(w, w_pl)]
    split = [any(pl[i] != Replicate() for pl in w_pl)
             for i in range(mesh.ndim)]
    out_pl = tuple(Partial() if s else p for s, p in zip(split, tok_pl))
    e_lo = _offset(w[0], 0)
    kw = dict(E=E, C=C, e_lo=e_lo)
    # the einsum dispatch under f split over a mesh dim (the experts whole
    # there): its d split over that dim too (``_einsum_experts``)
    f_dims = [i for i, s in enumerate(split)
              if s and w_pl[0][i] != Shard(0) and mesh.size(i) > 1]
    if (experts is _einsum_experts and len(f_dims) == 1
            and x.shape[-1] % mesh.size(f_dims[0]) == 0):
        i = f_dims[0]
        kw["tp"] = _TPGroup(mesh.get_group(i).group_name,
                            mesh.get_local_rank(i), mesh.size(i))

    def local(xl, il, pl, kl, wg, wu, wd):
        return experts(xl, il, pl, kl, wg, wu, wd, **kw)

    return local_map(local, out_placements=list(out_pl),
                     in_placements=(tok_pl,) * 4 + tuple(w_pl),
                     in_grad_placements=(out_pl, tok_pl, out_pl, tok_pl)
                     + tuple(w_grad_pl),
                     device_mesh=mesh)(x, topk_idx, topk_p, kmask, *w)


def moe(x, params, top_k: int, capacity_factor: float = 1.0,
        impl: str = "einsum", group_size: int = 512):
    fn = moe_einsum if impl == "einsum" else moe_gather
    return fn(x, params, top_k, capacity_factor, group_size)


# ---------------------------------------------------------------------------
# Causal depthwise conv (the Mamba front)
# ---------------------------------------------------------------------------

def causal_conv1d(x, w):
    """x: [B,S,D]; w: [K,D] depthwise. Causal: output[t] uses x[t-K+1..t].
    The reference's K-term loop in x's dtype, in its order (in bf16 each
    product and partial sum rounds; ``F.conv1d`` sums in another order).
    On a mesh per rank under ``local_map`` (``_per_channel_on_mesh``):
    torch 2.11's DTensor fails to redistribute for ``F.pad``."""
    if _is_dtensor(x):
        return _per_channel_on_mesh(causal_conv1d, x, w)
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for i in range(K):
        out = out + xp[:, i:i + S, :] * w[i]
    return out


def _per_channel_on_mesh(fn, x, w):
    """``fn(x, w)`` of DTensors for an ``fn`` that works sequence by
    sequence and channel by channel (the depthwise conv): x [B,S,D] laid
    out by batch and channels (the sequence whole), w [K,D] sliced as x's
    channels (a local chunk where it is replicated). The output is laid
    out as x; w's gradient is a partial sum over the batch's shards."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    x_pl = tuple(x.placements)
    if any(p not in (Shard(0), Shard(2), Replicate()) for p in x_pl):
        raise ValueError("the conv on a mesh takes x sharded by batch and "
                         f"channels, not {x.placements}")
    w_pl = tuple(Shard(1) if p == Shard(2) else Replicate() for p in x_pl)
    w = w.redistribute(w.device_mesh, w_pl)
    w_grad = tuple(Partial() if p == Shard(0) else q
                   for p, q in zip(x_pl, w_pl))
    return local_map(fn, out_placements=list(x_pl),
                     in_placements=(x_pl, w_pl),
                     in_grad_placements=(x_pl, w_grad),
                     device_mesh=x.device_mesh)(x, w)


def causal_conv1d_update(state, x_new, w):
    """Decode step. state: [B,K-1,D]; x_new: [B,1,D] -> (new_state, out
    [B,1,D]). Returns a new state (the caller writes it where it keeps
    it)."""
    window = torch.cat([state, x_new], dim=1)                   # [B,K,D]
    out = torch.einsum("bkd,kd->bd", window, w)[:, None]
    return window[:, 1:], out
