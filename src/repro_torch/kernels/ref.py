"""Plain PyTorch versions of the port's kernels (pdADMM-G and -G-Q paths,
and the LM prefill's attention).

Same signatures and layouts as ``repro.kernels.ref`` (but attention in the
kernel's [B, S, H, D] layout, ungrouped K/V); the pack
layout is ``comm.codecs.pack_codes_jnp`` / ``unpack_codes_jnp``, here with
a leading row axis (one row per shard) as the kernel takes it. A CPU tensor takes
these (``kernels/ops.py``); on the card only the tests and ``chip_smoke.py``
call them, to hold each CUDA kernel against its plain version.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantize import mul_add


def fused_linear_ref(p, W, b=None, z=None, *, mode: str = "linear"):
    """p @ W + b (``b=None``: no bias), or z - (p @ W + b) in residual mode.
    Accepts an optional leading layer axis."""
    out = p.float() @ W.float()
    if b is not None:
        out = out + b.float().unsqueeze(-2)
    if mode == "residual":
        out = z.float() - out
    return out.to(p.dtype)


def admm_pgrad_ref(r, W, u, p, q, *, nu: float, rho: float):
    g = (-nu) * (r.float() @ W.float().mT) + u.float() \
        + rho * (p.float() - q.float())
    return g.to(p.dtype)


def backtrack_resnorm_ref(r0, d, W, active=None):
    """||r0 − d @ W||² in f32, per layer over an optional leading axis
    (f32 [L] or 0-d). ``active`` ([L] or 0-d, any dtype; None = all): an
    inactive layer's value is 0, as the kernel writes it."""
    r = r0.float() - d.float() @ W.float()
    out = (r * r).sum(dim=(-2, -1))
    if active is not None:
        out = torch.where(active.to(torch.bool), out, torch.zeros_like(out))
    return out


def grid_project_ref(x, grid):
    """Nearest point of ``grid``: fma(index(x), step, lo) in x's dtype."""
    return mul_add(grid.index(x), grid.step_in(x.dtype), grid.lo_in(x.dtype),
                   x.dtype)


def grid_encode_ref(x, grid):
    """Integer codes, uint8 for <= 8 bits and uint16 above (through int32:
    the index is at most 65535)."""
    return grid.index(x).to(torch.int32).to(grid.code_dtype)


def grid_decode_ref(codes, grid, out_dtype=torch.float32):
    """lo + codes·step, one rounding, computed for f32 and cast to
    ``out_dtype`` (the reference decodes in f32 and casts)."""
    f32 = torch.float32
    return mul_add(codes.to(torch.int32), grid.step_in(f32),
                   grid.lo_in(f32), f32).to(out_dtype)


def stage_rows(sel, k: int, rows: int, device):
    """The predicated kernels' row mask, [rows, 1]: row r is stage
    r % len(sel), and runs where that stage's sel is k."""
    stage = torch.arange(rows, device=device) % sel.numel()
    return (sel.to(device)[stage] == k).unsqueeze(-1)


def _write_rows(out, keep, new):
    """out[:, :w] = new where ``keep`` (w = new's width); other rows as
    they were. Returns ``out``."""
    head = out[:, :new.shape[-1]]
    if new.dtype == torch.uint16:       # no CUDA where for uint16: its bits
        head, new = head.view(torch.int16), new.view(torch.int16)
    head.copy_(torch.where(keep, new, head))
    return out


def grid_encode_sel_ref(x, grid, out, sel, k: int):
    """The predicated encode: every row encoded, then kept where its
    stage's sel is k."""
    return _write_rows(out, stage_rows(sel, k, x.shape[0], x.device),
                       grid_encode_ref(x, grid))


def grid_decode_sel_ref(codes, grid, out, sel, k: int):
    """The predicated decode of the first out.shape[-1] codes a row."""
    vals = grid_decode_ref(codes[:, :out.shape[-1]], grid)
    return _write_rows(out, stage_rows(sel, k, out.shape[0], out.device),
                       vals)


def pack_codes_sel_ref(codes, bits: int, out, sel, k: int):
    """The predicated pack, into the head of each kept row of ``out``."""
    return _write_rows(out, stage_rows(sel, k, codes.shape[0], codes.device),
                       pack_codes_ref(codes, bits))


def unpack_codes_sel_ref(packed, bits: int, out, sel, k: int):
    """The predicated unpack of the first out.shape[-1] codes a row."""
    return _write_rows(out, stage_rows(sel, k, out.shape[0], out.device),
                       unpack_codes_ref(packed, bits, out.shape[-1]))


def relu_zupdate_ref(a, q, z_old):
    from repro_torch.core.subproblems import update_z_hidden
    return update_z_hidden(a.float(), q.float(), z_old.float(),
                           1.0).to(a.dtype)


def fista_zlast_ref(a, z_old, labels, label_mask, *, nu: float,
                    n_iters: int = 15, n_classes=None):
    """The shared ``subproblems.fista_ce`` loop (masked CE over the first
    ``n_classes`` columns + proximal term, Nesterov momentum)."""
    from repro_torch.core.subproblems import fista_ce
    return fista_ce(a, z_old, labels, label_mask, nu, n_iters, n_classes)


def pack_codes_ref(codes, bits: int):
    """``pack_codes_jnp`` of each row of [n] or [rows, n] codes."""
    from repro_torch.comm.codecs import _body_bytes, pack_codes_jnp
    if codes.dim() == 1:
        return pack_codes_jnp(codes, bits)
    if codes.shape[0] == 0:
        return torch.empty((0, _body_bytes(bits, codes.shape[-1])),
                           dtype=torch.uint8, device=codes.device)
    return torch.stack([pack_codes_jnp(row, bits) for row in codes])


def unpack_codes_ref(packed, bits: int, n: int):
    """``unpack_codes_jnp`` of each row of [≥ body] or [rows, ≥ body]."""
    from repro_torch.comm.codecs import _container_dtype, unpack_codes_jnp
    if packed.dim() == 1:
        return unpack_codes_jnp(packed, bits, n)
    if packed.shape[0] == 0:
        return torch.empty((0, n), dtype=_container_dtype(bits),
                           device=packed.device)
    return torch.stack([unpack_codes_jnp(row, bits, n) for row in packed])


def flash_attention_ref(q, k, v, *, causal: bool = True, q_offset: int = 0,
                        p_dtype=None):
    """Exact softmax attention: the reference's ``flash_attention_ref``
    (``repro/kernels/ref.py:69``) in the layout the kernel takes, q
    [B, S, Hq, D] and k, v [B, T, Hkv, D], query head h reading KV head
    h // (Hq / Hkv) (the reference takes [B, H, S, D] with K/V already
    expanded). f32 logits scaled by D^-0.5, keys j > i + q_offset masked at
    -1e30 when causal, softmax, an f32 PV product cast to q's dtype. With
    ``p_dtype`` (the bf16 kernel's counterpart: ``torch.bfloat16``), p and v
    are cast to it and the PV product runs in it, as the model's
    ``layers._attend_block`` does with ``p.to(v.dtype)``. One KV head at a
    time, so one group's [B, G, S, T] scores are the largest temporary."""
    S, Hq, D = q.shape[1:]
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    keep = None
    if causal:
        keep = (torch.arange(S, device=q.device)[:, None] + q_offset
                >= torch.arange(T, device=q.device)[None, :])
    out = []
    for h in range(Hkv):
        s = torch.einsum("bqgd,btd->bgqt", q[:, :, h * G:(h + 1) * G].float(),
                         k[:, :, h].float()) * (D ** -0.5)
        if keep is not None:
            s.masked_fill_(~keep, -1e30)
        p = torch.softmax(s, dim=-1)
        vh = v[:, :, h].float()
        if p_dtype is not None:
            p, vh = p.to(p_dtype), v[:, :, h].to(p_dtype)
        out.append(torch.einsum("bgqt,btd->bqgd", p, vh))
    return torch.cat(out, dim=2).to(q.dtype)
