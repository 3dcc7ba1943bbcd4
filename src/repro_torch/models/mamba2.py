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
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models.common import Spec, unstack
from repro_torch.models.transformer import _head_weight, embed_tokens

NEG_INF = -1e30


def segsum(a):
    """a: [..., q] -> [..., q, q] with out[i,j] = sum(a[j+1..i]) (i>=j) else
    -inf."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=a.device).tril()
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


def mixer_forward(cfg, p, x):
    """Full-sequence Mamba2 mixer (one layer's ``p``). x: [B,S,d] -> [B,S,d],
    the residual added."""
    s = cfg.ssm
    B_, S, d = x.shape
    di, nh, hd = s.d_inner(d), s.n_heads(d), s.head_dim

    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    z = h @ p["w_z"]
    xs = F.silu(L.causal_conv1d(h @ p["w_x"], p["conv_x"]))
    Bs = F.silu(L.causal_conv1d(h @ p["w_B"], p["conv_B"]))
    Cs = F.silu(L.causal_conv1d(h @ p["w_C"], p["conv_C"]))
    dt, A = _dt(p, h)

    xh = xs.reshape(B_, S, nh, hd)
    xdt = xh * dt[..., None].to(xh.dtype)
    y, _ = ssd_chunked(xdt, dt * A, Bs, Cs, s.chunk)
    y = y + xh * p["D"][None, None, :, None].to(xh.dtype)
    y = y.reshape(B_, S, di)
    y = L.rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return x + y @ p["w_out"]


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


def mixer_decode(cfg, p, x, state: SSMState):
    """Single-token Mamba2 step (one layer's ``p`` and state). x: [B,1,d].
    Returns (x with the residual added, the new state: new tensors)."""
    s = cfg.ssm
    B_, _, d = x.shape
    di, nh, hd = s.d_inner(d), s.n_heads(d), s.head_dim

    hx = L.rms_norm(x, p["ln"], cfg.norm_eps)
    z = hx @ p["w_z"]
    cx, xr = L.causal_conv1d_update(state.conv_x, hx @ p["w_x"], p["conv_x"])
    cB, Br = L.causal_conv1d_update(state.conv_B, hx @ p["w_B"], p["conv_B"])
    cC, Cr = L.causal_conv1d_update(state.conv_C, hx @ p["w_C"], p["conv_C"])
    xs, Bs, Cs = F.silu(xr), F.silu(Br), F.silu(Cr)
    dt, A = _dt(p, hx)

    xh = xs.reshape(B_, nh, hd)
    xdt = xh * dt.reshape(B_, nh, 1).to(xh.dtype)
    hstate, y = ssd_decode(state.h, xdt, dt.reshape(B_, nh) * A, Bs[:, 0],
                           Cs[:, 0])
    y = y + xh * p["D"][None, :, None].to(xh.dtype)
    y = y.reshape(B_, 1, di)
    y = L.rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return x + y @ p["w_out"], SSMState(cx, cB, cC, hstate)


def write_state(state: SSMState, i: int, new: SSMState) -> None:
    """Write one layer's ``new`` state into view ``i`` of the stacked
    ``state`` (in place)."""
    for buf, t in zip(state, new):
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


def forward_hidden(cfg, params, batch, **_):
    """Embed + every mixer + the final norm. Returns (hidden [B,S,d], 0.0:
    no aux loss). With ``cfg.remat`` under grad mode each layer runs under
    a checkpoint that keeps only its input, as the reference's
    ``jax.checkpoint`` around the scan body."""
    x = embed_tokens(params, batch["tokens"])
    remat = cfg.remat and torch.is_grad_enabled()
    for p in unstack(params["blocks"]):
        x = (checkpoint(mixer_forward, cfg, p, x, use_reentrant=False)
             if remat else mixer_forward(cfg, p, x))
    return L.rms_norm(x, params["ln_f"], cfg.norm_eps), 0.0


def decode_step(cfg, params, state: SSMState, batch, **_):
    """One token for every sequence. ``state``: an ``SSMState`` stacked over
    the layers ([L, B, ...]), written in place. Returns (logits [B,1,Vp]
    f32, the state)."""
    x = embed_tokens(params, batch["token"])
    for i, p in enumerate(unstack(params["blocks"])):
        x, new = mixer_decode(cfg, p, x, SSMState(*(t[i] for t in state)))
        write_state(state, i, new)
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = (x @ _head_weight(cfg, params)).float()
    return logits, state
