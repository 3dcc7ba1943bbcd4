"""Mamba2 (SSD, state-space duality, arXiv:2405.21060): the SSD scan, the
Mamba2 mixer block and the mamba2 LM.

The port of ``repro/models/mamba2.py``. The chunked SSD algorithm: a
quadratic, attention-like term within each chunk of ``chunk`` positions,
and the state carried from chunk to chunk. Decode is the exact linear
recurrence (an O(1) state a sequence). Plain PyTorch, as the reference is
plain jnp: no Pallas kernel stands behind the scan.

Where the reference differs in form:
- its ``jax.lax.associative_scan`` over the chunks is the decay matrix
  over the chunks here (``segsum`` of the chunk-end cumulative sums, as
  the SSD paper's minimal code has it): the same combination with no
  Python loop, rounded in another order, so it is held to the reference
  by a tolerance in f32;
- its four-operand einsums are contracted pairwise in the order
  ``jnp.einsum`` takes at the tests' shapes (C·Bᵀ, then ·L, then ·x), so
  that no [b,c,i,j,h,p] tensor is formed;
- the decode state is written in place: ``decode_step`` writes each
  layer's new conv windows and SSM state into its view of the stacked
  [L, ...] state it is given, as the transformer writes its KV cache.

On a mesh the tensors are DTensors, and each rank computes its own
columns of d_inner: the rules lay d_inner out by heads ("ssm_heads")
where the model axis divides them, else by columns ("ssm_inner"), and
the d_inner weights that the heads' layout keeps replicated are taken
in the rank's slice (a local chunk, as XLA slices them by the heads
that dt carries). The scan runs per rank under ``local_map``
(``_ssd_on_mesh``) on its columns as runs of heads and of parts of heads
(``_segments``: the scan is elementwise in a head's columns), so no head
is split by a DTensor reshape. The new state is written into each rank's
shard of the stacked state (``write_state``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models.common import Spec, unstack
from repro_torch.models.transformer import ACT, _head_weight, embed_tokens
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.sharding import _is_dtensor, constrain, on_mesh_of

NEG_INF = -1e30


def segsum(a):
    """a: [..., q] -> [..., q, q] with out[i,j] = sum(a[j+1..i]) (i>=j) else
    -inf."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = on_mesh_of(torch.ones((q, q), dtype=torch.bool,
                                 device=a.device).tril(), a)
    return torch.where(mask, diff, NEG_INF)


def ssd_chunked(xdt, a, B, C, chunk: int):
    """SSD scan. xdt: [b,l,h,p] (x pre-multiplied by dt); a: [b,l,h] (dt*A,
    < 0); B, C: [b,l,n]. Returns y: [b,l,h,p] in xdt's dtype and the final
    state [b,h,p,n] f32. A length that is no multiple of ``chunk`` is one
    chunk of all l positions, as in the reference."""
    b, l, h, p = xdt.shape
    n = B.shape[-1]
    chunk = min(chunk, l)
    if l % chunk:
        chunk = l
    c, q = l // chunk, chunk
    xc = xdt.reshape(b, c, q, h, p)
    ac = a.reshape(b, c, q, h)
    Bc = B.reshape(b, c, q, n)
    Cc = C.reshape(b, c, q, n)

    cum = torch.cumsum(ac, dim=2)                                  # [b,c,q,h]
    Lmat = torch.exp(segsum(ac.transpose(2, 3)))                   # [b,c,h,q,q]
    # "bcin,bcjn,bchij,bcjhp->bcihp" as C·Bᵀ, then ·L, then ·x
    CB = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    y_diag = torch.einsum("bchij,bcjhp->bcihp",
                          CB[:, :, None] * Lmat.to(Cc.dtype), xc)

    decay_end = torch.exp(cum[:, :, -1:, :] - cum)                 # [b,c,q,h]
    # "bcjn,bcjh,bcjhp->bchpn" as x·decay, then ·B
    states = torch.einsum("bcjhp,bcjn->bchpn",
                          xc * decay_end.to(Bc.dtype)[..., None], Bc)
    # the state after each chunk: spref[z] = sum over k <= z of states[k]
    # times the decay of the chunks k+1..z, the matrix exp(segsum) over the
    # chunks' total decays (the reference's associative scan)
    chunk_decay = torch.exp(segsum(cum[:, :, -1, :].transpose(1, 2)))  # [b,h,c,c]
    spref = torch.einsum("bhzk,bkhpn->bzhpn", chunk_decay, states.float())
    h_prev = torch.cat([torch.zeros_like(spref[:, :1]), spref[:, :-1]],
                       dim=1)                                      # [b,c,h,p,n]
    # "bcin,bchpn,bcih->bcihp" as h_prev·C, then ·exp(cum)
    y_off = torch.einsum("bchpn,bcin->bcihp", h_prev, Cc.float()) \
        * torch.exp(cum)[..., None]
    y = (y_diag.float() + y_off).reshape(b, l, h, p)
    return y.to(xdt.dtype), spref[:, -1]


def ssd_ref(xdt, a, B, C):
    """Quadratic "duality" reference: y = (L ∘ (C Bᵀ)) xdt over the full
    sequence, in f32. O(l²): small shapes only; the oracle for
    ``ssd_chunked`` in tests."""
    Lmat = torch.exp(segsum(a.transpose(1, 2)))                    # [b,h,l,l]
    return torch.einsum("bin,bjn,bhij,bjhp->bihp", C.float(), B.float(),
                        Lmat.float(), xdt.float()).to(xdt.dtype)


def ssd_decode(state, x_t, a_t, B_t, C_t):
    """One-token recurrence. state: [b,h,p,n] f32; x_t: [b,h,p] (pre-mul by
    dt); a_t: [b,h]; B_t, C_t: [b,n]. Returns (new state, y [b,h,p] in
    x_t's dtype)."""
    decay = torch.exp(a_t)[..., None, None]                        # [b,h,1,1]
    state = state * decay + torch.einsum("bhp,bn->bhpn", x_t.float(),
                                         B_t.float())
    y = torch.einsum("bhpn,bn->bhp", state, C_t.float())
    return state, y.to(x_t.dtype)


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------

def mixer_specs(cfg, n_layers: int, dtype) -> dict:
    d = cfg.d_model
    s = cfg.ssm
    di, n, nh, K = s.d_inner(d), s.d_state, s.n_heads(d), s.d_conv
    Ls = n_layers
    f32 = torch.float32
    return {
        "ln": Spec((Ls, d), ("layers", None), "ones", dtype=dtype),
        "w_z": Spec((Ls, d, di), ("layers", "embed", "ssm_inner"), dtype=dtype),
        "w_x": Spec((Ls, d, di), ("layers", "embed", "ssm_inner"), dtype=dtype),
        "w_B": Spec((Ls, d, n), ("layers", "embed", None), dtype=dtype),
        "w_C": Spec((Ls, d, n), ("layers", "embed", None), dtype=dtype),
        "w_dt": Spec((Ls, d, nh), ("layers", "embed", "ssm_heads"), dtype=dtype),
        "conv_x": Spec((Ls, K, di), ("layers", "conv", "ssm_inner"), "small", dtype=dtype),
        "conv_B": Spec((Ls, K, n), ("layers", "conv", None), "small", dtype=dtype),
        "conv_C": Spec((Ls, K, n), ("layers", "conv", None), "small", dtype=dtype),
        "dt_bias": Spec((Ls, nh), ("layers", "ssm_heads"), "zeros", dtype=f32),
        "A_log": Spec((Ls, nh), ("layers", "ssm_heads"), "zeros", dtype=f32),
        "D": Spec((Ls, nh), ("layers", "ssm_heads"), "ones", dtype=f32),
        "norm": Spec((Ls, di), ("layers", "ssm_inner"), "ones", dtype=dtype),
        "w_out": Spec((Ls, di, d), ("layers", "ssm_inner", "embed"), dtype=dtype),
    }


def _dt(p, h):
    """(dt [.., nh] f32, A [nh] f32): softplus of the projection plus
    dt_bias, and A = -exp(A_log)."""
    dt = F.softplus((h @ p["w_dt"]).float() + p["dt_bias"])
    return dt, -torch.exp(p["A_log"])


def _inner_name(rules) -> str:
    """The logical axis that lays d_inner out: "ssm_heads" where the rules
    shard the heads, else "ssm_inner" (which the rules map where the model
    axis does not divide the heads but divides d_inner)."""
    return "ssm_heads" if rules and rules.get("ssm_heads") else "ssm_inner"


def _inner_weights(p, rules):
    """(w_z, w_x, conv_x, norm, w_out) of one layer's ``p``, their d_inner
    dim split over the mesh dims that split it (``_inner_name``'s): under
    "ssm_heads" the rules keep these weights replicated, and taking each
    rank's slice of heads is a local chunk (no collective). Plain tensors
    come back as they are."""
    names = ("w_z", "w_x", "conv_x", "norm", "w_out")
    if not _is_dtensor(p["w_z"]):
        return tuple(p[k] for k in names)
    from torch.distributed.tensor import Shard
    mesh = p["w_z"].device_mesh
    axes = list(sh.mesh_shape(mesh))
    split = [axes.index(a) for a in rules.get(_inner_name(rules)) or ()]
    out = []
    for k in names:
        t = p[k]
        dim = 0 if k == "w_out" else t.ndim - 1
        pl = list(t.placements)
        for i in split:
            pl[i] = Shard(dim)
        out.append(t if pl == list(t.placements)
                   else t.redistribute(mesh, pl))
    return tuple(out)


def _segments(lo: int, w: int, hd: int):
    """Columns [lo, lo + w) of d_inner (heads of ``hd`` side by side) as
    runs of equal head slices: [(h0, h1, p0, p1, c0, c1)], heads [h0, h1)
    at columns [p0, p1) of each, local columns [c0, c1). A run is a part
    of one head (where a rank's columns start or end inside a head) or
    whole heads."""
    out, c, end = [], lo, lo + w
    while c < end:
        h, p0 = divmod(c, hd)
        if p0 or end - c < hd:
            p1 = min(hd, p0 + end - c)
            out.append((h, h + 1, p0, p1, c - lo, c - lo + p1 - p0))
            c += p1 - p0
        else:
            n = (end - c) // hd
            out.append((h, h + n, 0, hd, c - lo, c - lo + n * hd))
            c += n * hd
    return out


def _ssd_local(xs, dt, A, D, Bs, Cs, hd: int, chunk: int, x_lo: int = 0,
               h_lo: int = 0):
    """The SSD of d_inner's columns [x_lo, x_lo + w) of xs [b,l,w] (after
    the conv): y [b,l,w], the D skip added. dt [b,l,·], A and D [·] hold
    heads from ``h_lo`` on. The scan works head by head and, within a
    head, column by column, so each run of ``_segments`` is a scan of its
    own. Without a mesh this is one run of every head."""
    b, l, _ = xs.shape
    ys = []
    for h0, h1, p0, p1, c0, c1 in _segments(x_lo, xs.shape[-1], hd):
        xh = xs[..., c0:c1].reshape(b, l, h1 - h0, p1 - p0)
        dth = dt[..., h0 - h_lo:h1 - h_lo]
        xdt = xh * dth[..., None].to(xh.dtype)
        y, _ = ssd_chunked(xdt, dth * A[h0 - h_lo:h1 - h_lo], Bs, Cs, chunk)
        y = y + xh * D[h0 - h_lo:h1 - h_lo][None, None, :, None].to(xh.dtype)
        ys.append(y.reshape(b, l, c1 - c0))
    return ys[0] if len(ys) == 1 else torch.cat(ys, dim=-1)


def _ssd_decode_local(h, xs, dt, A, D, Bs, Cs, hd: int, x_lo: int = 0,
                      h_lo: int = 0, s_lo: int = 0):
    """One token's SSD of d_inner's columns [x_lo, x_lo + w) of xs [b,w]:
    (the new state of those columns [b,w,n] f32, y [b,w] with the D skip).
    h [b,·,hd,n] holds heads from ``s_lo`` on; dt [b,·], A, D [·] heads
    from ``h_lo`` on."""
    b = xs.shape[0]
    hs, ys = [], []
    for h0, h1, p0, p1, c0, c1 in _segments(x_lo, xs.shape[-1], hd):
        xh = xs[:, c0:c1].reshape(b, h1 - h0, p1 - p0)
        dth = dt[:, h0 - h_lo:h1 - h_lo]
        xdt = xh * dth[..., None].to(xh.dtype)
        st, y = ssd_decode(h[:, h0 - s_lo:h1 - s_lo, p0:p1], xdt,
                           dth * A[h0 - h_lo:h1 - h_lo], Bs, Cs)
        y = y + xh * D[h0 - h_lo:h1 - h_lo][None, :, None].to(xh.dtype)
        hs.append(st.reshape(b, c1 - c0, st.shape[-1]))
        ys.append(y.reshape(b, c1 - c0))
    if len(ys) == 1:
        return hs[0], ys[0]
    return torch.cat(hs, dim=1), torch.cat(ys, dim=-1)


def _grad_placements(pl, x_pl):
    """The gradient placements of a ``local_map`` input laid out by ``pl``
    beside xs laid out by ``x_pl``: its own where it is sharded; a partial
    sum where it is replicated and xs is split (by the tokens' batch or by
    d_inner's columns: each rank reads it for its own part)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    return tuple(p if not isinstance(p, Replicate)
                 else Partial() if isinstance(xp, Shard) else p
                 for p, xp in zip(pl, x_pl))


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward hands on a contiguous gradient: the
    scan's gradients leave ``local_map`` as strided views (its chunk
    reshapes and transposes), which DTensor's ``view`` in a matmul's
    backward (flattening [B, S, ·]) cannot take."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _ssd_on_mesh(xs, dt, A, D, Bs, Cs, hd: int, chunk: int):
    """``_ssd_local`` of DTensors, per rank under ``local_map``: xs [B,S,di]
    laid out by batch and d_inner's columns, dt [B,S,nh] by batch and heads
    (or replicated over the mesh dims of a model axis that does not divide
    the heads), A and D as dt's heads, Bs and Cs [B,S,n] by batch. Each
    rank scans its own columns; y is laid out as xs."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = xs.device_mesh
    x_pl, h_pl = tuple(xs.placements), tuple(dt.placements)
    w_pl = tuple(Shard(0) if p == Shard(dt.ndim - 1) else Replicate()
                 for p in h_pl)
    A, D = A.redistribute(mesh, w_pl), D.redistribute(mesh, w_pl)
    bc_pl = tuple(Bs.placements)
    x_lo, h_lo = L._offset(xs, xs.ndim - 1), L._offset(dt, dt.ndim - 1)

    def local(*ts):
        ts = [_ContiguousGrad.apply(t) if t.requires_grad else t for t in ts]
        return _ssd_local(*ts, hd, chunk, x_lo, h_lo)

    grad = [_grad_placements(pl, x_pl)
            for pl in (h_pl, w_pl, w_pl, bc_pl, bc_pl)]
    return local_map(local, out_placements=list(x_pl),
                     in_placements=(x_pl, h_pl, w_pl, w_pl, bc_pl, bc_pl),
                     in_grad_placements=(x_pl, *grad),
                     device_mesh=mesh)(xs, dt, A, D, Bs, Cs)


def mixer_forward(cfg, p, x, rules=None):
    """Full-sequence Mamba2 mixer (one layer's ``p``). x: [B,S,d] -> [B,S,d],
    the residual added. On a mesh the d_inner products run on each rank's
    columns of d_inner (``_inner_weights``), the scan per rank
    (``_ssd_on_mesh``), and the output is laid out as the reference's."""
    s = cfg.ssm
    w_z, w_x, conv_x, norm, w_out = _inner_weights(p, rules)
    inner = ("batch", "act_seq", _inner_name(rules))

    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    z = constrain(h @ w_z, None, inner, rules)
    xs = F.silu(L.causal_conv1d(constrain(h @ w_x, None, inner, rules),
                                conv_x))
    Bs = F.silu(L.causal_conv1d(h @ p["w_B"], p["conv_B"]))
    Cs = F.silu(L.causal_conv1d(h @ p["w_C"], p["conv_C"]))
    dt, A = _dt(p, h)
    if _is_dtensor(xs):
        tok = ("batch", "act_seq", None)
        y = _ssd_on_mesh(
            constrain(xs, None, inner, rules),
            constrain(dt, None, ("batch", "act_seq", "ssm_heads"), rules),
            A, p["D"], constrain(Bs, None, tok, rules),
            constrain(Cs, None, tok, rules), s.head_dim, s.chunk)
    else:
        y = _ssd_local(xs, dt, A, p["D"], Bs, Cs, s.head_dim, s.chunk)
    y = L.rms_norm(y * F.silu(z), norm, cfg.norm_eps)
    return constrain(x + y @ w_out, None, ACT, rules)


class SSMState(NamedTuple):
    conv_x: torch.Tensor   # [..., B, K-1, di]
    conv_B: torch.Tensor   # [..., B, K-1, n]
    conv_C: torch.Tensor   # [..., B, K-1, n]
    h: torch.Tensor        # [..., B, nh, hd, n] f32


def mixer_init_state(cfg, batch: int, layers=None, dtype=torch.bfloat16,
                     device=None) -> SSMState:
    """The zero state (``layers``: stacked over that many layers); the
    conv windows in ``dtype``, the SSM state h in f32."""
    s = cfg.ssm
    d = cfg.d_model
    di, n, nh, hd, K = (s.d_inner(d), s.d_state, s.n_heads(d), s.head_dim,
                        s.d_conv)

    def z(shp, dt=dtype):
        if layers is not None:
            shp = (layers,) + shp
        return torch.zeros(shp, dtype=dt, device=device)
    return SSMState(z((batch, K - 1, di)), z((batch, K - 1, n)),
                    z((batch, K - 1, n)), z((batch, nh, hd, n), torch.float32))


def _like(t, ref):
    """DTensor ``t`` laid out as ``ref`` (a state's window brought to the
    new token's columns: a local chunk where it is replicated); a plain
    tensor as it is."""
    if not _is_dtensor(t) or tuple(t.placements) == tuple(ref.placements):
        return t
    return t.redistribute(ref.device_mesh, ref.placements)


def _ssd_decode_on_mesh(h, xs, dt, A, D, Bs, Cs, hd: int):
    """``_ssd_decode_local`` of DTensors per rank under ``local_map``: xs
    [B,di] by batch and d_inner's columns, dt [B,nh] and A, D by heads (or
    replicated), Bs, Cs [B,n] by batch, the state h [B,nh,hd,n] as the
    decode state lays it out. Returns (the new state's columns [B,di,n]
    laid out as xs, y [B,di])."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = xs.device_mesh
    x_pl, h_pl, s_pl = (tuple(xs.placements), tuple(dt.placements),
                        tuple(h.placements))
    w_pl = tuple(Shard(0) if p == Shard(1) else Replicate() for p in h_pl)
    A, D = A.redistribute(mesh, w_pl), D.redistribute(mesh, w_pl)
    x_lo, h_lo, s_lo = (L._offset(xs, 1), L._offset(dt, 1),
                        L._offset(h, 1))
    bc_pl = tuple(Bs.placements)

    def local(hl, xl, dl, al, Dl, bl, cl):
        return _ssd_decode_local(hl, xl, dl, al, Dl, bl, cl, hd, x_lo, h_lo,
                                 s_lo)

    return local_map(local, out_placements=(list(x_pl), list(x_pl)),
                     in_placements=(s_pl, x_pl, h_pl, w_pl, w_pl, bc_pl,
                                    bc_pl),
                     device_mesh=mesh)(h, xs, dt, A, D, Bs, Cs)


def _as_state(hn, like):
    """The new state's columns [B,di,n] as the state ``like`` [B,nh,hd,n]:
    gathered over the mesh dims where ``like`` is replicated (the heads
    then whole), then viewed by heads, on each rank's shard (the columns
    of a head-sharded state are its heads' columns)."""
    if not _is_dtensor(hn):
        return hn.reshape(like.shape)
    from torch.distributed.tensor import DTensor, Replicate
    pl = [Replicate() if isinstance(q, Replicate) else p
          for p, q in zip(hn.placements, like.placements)]
    if pl != list(hn.placements):
        hn = hn.redistribute(hn.device_mesh, pl)
    return DTensor.from_local(hn.to_local().reshape(like.to_local().shape),
                              like.device_mesh, like.placements,
                              run_check=False, shape=like.shape,
                              stride=like.stride())


def mixer_decode(cfg, p, x, state: SSMState, rules=None):
    """Single-token Mamba2 step (one layer's ``p`` and state). x: [B,1,d].
    Returns (x with the residual added, the new state: new tensors). On a
    mesh each rank computes its columns of d_inner, as the forward pass;
    the new state comes out laid out by those columns (``write_state``
    brings it to the state's layout)."""
    s = cfg.ssm
    B_, _, d = x.shape
    w_z, w_x, conv_x, norm, w_out = _inner_weights(p, rules)
    inner = ("batch", "act_seq", _inner_name(rules))

    hx = L.rms_norm(x, p["ln"], cfg.norm_eps)
    z = constrain(hx @ w_z, None, inner, rules)
    xin = constrain(hx @ w_x, None, inner, rules)
    cx, xr = L.causal_conv1d_update(_like(state.conv_x, xin), xin, conv_x)
    cB, Br = L.causal_conv1d_update(state.conv_B, hx @ p["w_B"], p["conv_B"])
    cC, Cr = L.causal_conv1d_update(state.conv_C, hx @ p["w_C"], p["conv_C"])
    xs, Bs, Cs = F.silu(xr), F.silu(Br), F.silu(Cr)
    dt, A = _dt(p, hx)
    if _is_dtensor(xs):
        tok = ("batch", None)
        hn, y = _ssd_decode_on_mesh(
            state.h, constrain(xs[:, 0], None, (("batch",) + inner[2:]),
                               rules),
            constrain(dt[:, 0], None, ("batch", "ssm_heads"), rules), A,
            p["D"], constrain(Bs[:, 0], None, tok, rules),
            constrain(Cs[:, 0], None, tok, rules), s.head_dim)
    else:
        hn, y = _ssd_decode_local(state.h, xs[:, 0], dt[:, 0], A, p["D"],
                                  Bs[:, 0], Cs[:, 0], s.head_dim)
    hstate = _as_state(hn, state.h)
    y = y.reshape(B_, 1, y.shape[-1])
    y = L.rms_norm(y * F.silu(z), norm, cfg.norm_eps)
    return (constrain(x + y @ w_out, None, ACT, rules),
            SSMState(cx, cB, cC, hstate))


def write_state(state: SSMState, i: int, new: SSMState) -> None:
    """Write one layer's ``new`` state into view ``i`` of the stacked
    ``state`` (in place). On a mesh each rank writes its shard: ``new``
    is brought to the state's placements first (the layers dim is never
    sharded)."""
    for buf, t in zip(state, new):
        if _is_dtensor(buf):
            from torch.distributed.tensor import Shard
            pl = [Shard(q.dim - 1) if isinstance(q, Shard) else q
                  for q in buf.placements]
            buf.to_local()[i].copy_(
                t.redistribute(buf.device_mesh, pl).to_local())
        else:
            buf[i].copy_(t)


# ---------------------------------------------------------------------------
# Full mamba2 LM
# ---------------------------------------------------------------------------

def param_specs(cfg, vocab_padded: int, dtype=torch.bfloat16) -> dict:
    d = cfg.d_model
    specs = {
        "embed": Spec((vocab_padded, d), ("vocab", "embed"), "small", dtype=dtype),
        "ln_f": Spec((d,), (None,), "ones", dtype=dtype),
        "blocks": mixer_specs(cfg, cfg.n_layers, dtype),
    }
    if not cfg.tie_embeddings:
        specs["head"] = Spec((d, vocab_padded), ("embed", "vocab"), "small",
                             dtype=dtype)
    return specs


def forward_hidden(cfg, params, batch, *, rules=None, **_):
    """Embed + every mixer + the final norm. Returns (hidden [B,S,d], 0.0:
    no aux loss). With ``cfg.remat`` under grad mode each layer runs under
    a checkpoint that keeps only its input, as the reference's
    ``jax.checkpoint`` around the scan body."""
    x = constrain(embed_tokens(params, batch["tokens"]), None, ACT, rules)
    remat = cfg.remat and torch.is_grad_enabled()
    for p in unstack(params["blocks"]):
        x = (checkpoint(mixer_forward, cfg, p, x, rules, use_reentrant=False)
             if remat else mixer_forward(cfg, p, x, rules))
    return L.rms_norm(x, params["ln_f"], cfg.norm_eps), 0.0


def decode_step(cfg, params, state: SSMState, batch, *, rules=None, **_):
    """One token for every sequence. ``state``: an ``SSMState`` stacked over
    the layers ([L, B, ...]), written in place. Returns (logits [B,1,Vp]
    f32, the state)."""
    x = constrain(embed_tokens(params, batch["token"]), None, ACT, rules)
    for i, p in enumerate(unstack(params["blocks"])):
        x, new = mixer_decode(cfg, p, x, SSMState(*(t[i] for t in state)),
                              rules)
        write_state(state, i, new)
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = (x @ _head_weight(cfg, params)).float()
    return logits, state
